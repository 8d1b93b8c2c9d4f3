"""The pair walk's CPU cases shared by ``test_torch_pair_walk.py`` (a
small rook grid with random populations and boundary lengths) and
``test_torch_pair_dual.py`` (a synthetic precinct dual graph): the port's
general runner against the JAX package's ``run_chains`` from the same
seed, under ``_parity.assert_chain_run_matches``."""

import dataclasses

import jax
import numpy as np
import torch
from _parity import assert_chain_run_matches

import flipcomplexityempirical_tpu as fce

import flipcomplexityempirical_tpu_torch as port
from flipcomplexityempirical_tpu_torch import convert, sampling

STEPS, CHUNK, CHAINS = 80, 30, 4


def grid_pair(seed=1):
    """(JAX graph, port graph) of a 5 x 6 rook grid with random
    populations and boundary lengths (the dual graphs' kind of data)."""
    jg, pg = fce.graphs.square_grid(5, 6), port.graphs.square_grid(5, 6)
    rng = np.random.default_rng(seed)
    pop = rng.integers(1, 5, jg.n_nodes).astype(np.int32)
    el = rng.uniform(0.5, 2.0, jg.n_edges).astype(np.float32)
    return (dataclasses.replace(jg, pop=pop, edge_len=el),
            dataclasses.replace(pg, pop=pop, edge_len=el))


def dual_pair(side: int, seed=0):
    """(JAX graph, port graph) of a side x side synthetic precinct map,
    each built by its own package's ``from_geojson``."""
    fc = fce.graphs.synthetic_precincts(side, side, seed=seed)
    jg, _ = fce.graphs.from_geojson(fc, pop_property="POP")
    pg, _ = port.graphs.from_geojson(fc, pop_property="POP")
    return jg, pg


def run_both(jg, pg, k: int, weighted: bool, path: str, pop_tol=0.3,
             steps=STEPS, scaled=False) -> int:
    """Run the pair walk in both packages and hold the port's run to the
    JAX package's (``scaled``: ``_parity``'s wait rule of the k-district
    walks); returns the counted log ties."""
    plan = fce.graphs.stripes_plan(jg, k)
    kw = dict(n_districts=k, proposal="pair", weighted_cut=weighted)
    jspec, pspec = fce.Spec(**kw), port.Spec(**kw)
    jdg, jst, jpar = fce.init_batch(jg, plan, n_chains=CHAINS, seed=3,
                                    spec=jspec, base=0.8, pop_tol=pop_tol)
    pdg, pst, ppar = sampling.init_batch(pg, plan, n_chains=CHAINS, seed=3,
                                         spec=pspec, base=0.8,
                                         pop_tol=pop_tol, device="cpu")
    jr = fce.run_chains(jdg, jspec, jpar, jst, n_steps=steps, chunk=CHUNK,
                        kernel_path=path)
    with torch.no_grad():
        pr = sampling.run_chains(pdg, pspec, ppar, pst, n_steps=steps,
                                 chunk=CHUNK, kernel_path=path)
    assert int(pr.state.accept_count.sum()) > 0
    return assert_chain_run_matches(
        convert.to_numpy(pr.state), pr.history, pr.waits_total,
        jax.tree.map(np.asarray, jr.state),
        {k: np.asarray(v) for k, v in jr.history.items()}, jr.waits_total,
        scaled=scaled)
