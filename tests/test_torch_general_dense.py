"""The port's general runner on the rejection-free dense body (its plain
PyTorch version, ``kernel/dense.py``, the general-dense kernel's plain
version) against the JAX package's ``run_chains(kernel_path=
'general_dense')``, on the CPU.

Both packages start from the same seed (``init_batch``: the same threefry
keys, plan and initial waits) and draw the same stream. Tolerance
(``_parity.assert_chain_run_matches``): every state field and history
key equal; waits equal except counted log ties (torch's and XLA's f32
``log`` may round one input apart, moving a wait by exactly 1.0).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _parity import assert_chain_run_matches, state_dict

import flipcomplexityempirical_tpu as fce

import flipcomplexityempirical_tpu_torch as port
from flipcomplexityempirical_tpu_torch import convert, sampling
from flipcomplexityempirical_tpu_torch.kernel import cuda_dense, dense

C = 6
BASE = 0.8
STEPS, CHUNK = 80, 30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(name, m, n, spec_kw, tol, seed=3, pop_seed=None):
    jg = getattr(fce.graphs, name)(m, n)
    pg = getattr(port.graphs, name)(m, n)
    if pop_seed is not None:
        pop = _random_pop(pg, pop_seed)
        jg = dataclasses.replace(jg, pop=pop)
        pg = dataclasses.replace(pg, pop=pop)
    plan = fce.graphs.stripes_plan(jg, 2)
    jspec, pspec = fce.Spec(**spec_kw), port.Spec(**spec_kw)
    j = fce.init_batch(jg, plan, n_chains=C, seed=seed, spec=jspec,
                       base=BASE, pop_tol=tol)
    p = sampling.init_batch(pg, plan, n_chains=C, seed=seed, spec=pspec,
                            base=BASE, pop_tol=tol, device="cpu")
    return (jspec, *j), (pspec, *p)


def _check(jr, pr):
    return assert_chain_run_matches(
        convert.to_numpy(pr.state), pr.history, pr.waits_total,
        jax.tree.map(np.asarray, jr.state),
        {k: np.asarray(v) for k, v in jr.history.items()}, jr.waits_total)


CASES = {
    "hex": ("hex_lattice", 3, 4, {}, 0.1),
    "tri-nobacktrack-lazy": ("triangular_lattice", 4, 6,
                             dict(nobacktrack=True, lazy_uniform=True), 0.1),
    "hex-contiguity-none": ("hex_lattice", 4, 4, dict(contiguity="none"),
                            0.1),
    "hex-tight-pop": ("hex_lattice", 3, 4, {}, 0.1),
    "hex-random-pop": ("hex_lattice", 4, 4, {}, 0.1),
}
# the cases on a random population plane, by its seed: the kernel's
# per-node population gate
RANDOM_POP = {"hex-random-pop": 5}


def _random_pop(graph, seed):
    return np.random.default_rng(seed).integers(
        1, 10, graph.n_nodes).astype(np.int32)


# per-chain population tolerances of "hex-tight-pop": 0 leaves a balanced
# plan no valid move (every step self-loops), 0.1 leaves it moves
TIGHT = np.array([0.0, 0.1] * (C // 2))


def _tighten(jpar, ppar, graph):
    ideal = float(graph.pop.sum()) / 2
    lo, hi = (1 - TIGHT) * ideal, (1 + TIGHT) * ideal
    ppar.pop_lo = torch.tensor(lo, dtype=torch.float32)
    ppar.pop_hi = torch.tensor(hi, dtype=torch.float32)
    return jpar.replace(pop_lo=jax.numpy.asarray(lo, jax.numpy.float32),
                        pop_hi=jax.numpy.asarray(hi, jax.numpy.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_run_matches_jax(case):
    """Two segments, the second continuing the first without recording
    its start (the checkpoint-resume path)."""
    name, m, n, spec_kw, tol = CASES[case]
    (jspec, jdg, jst, jpar), (pspec, pdg, pst, ppar) = _both(
        name, m, n, spec_kw, tol, pop_seed=RANDOM_POP.get(case))
    if case == "hex-tight-pop":
        jpar = _tighten(jpar, ppar, getattr(port.graphs, name)(m, n))
    # the initial states agree field for field, initial waits included
    np.testing.assert_equal(state_dict(convert.to_numpy(pst)),
                            {k: v.astype(np.int64) if k == "key" else v
                             for k, v in state_dict(
                                 jax.tree.map(np.asarray, jst)).items()})
    for first in (True, False):
        jr = fce.run_chains(jdg, jspec, jpar, jst, n_steps=STEPS,
                            chunk=CHUNK, kernel_path="general_dense",
                            record_initial=first)
        pr = sampling.run_chains(pdg, pspec, ppar, pst, n_steps=STEPS,
                                 chunk=CHUNK, kernel_path="general_dense",
                                 record_initial=first)
        _check(jr, pr)
        assert pr.state.conn_bits is None     # stripped on exit
        jst, pst = jr.state, pr.state
    s = convert.to_numpy(pst)
    assert s["accept_count"].sum() > 0
    if case == "hex-tight-pop":
        # every step of a tol-0 chain self-loops, none of the others does
        np.testing.assert_array_equal(s["exhausted_count"] > 0, TIGHT == 0)
        np.testing.assert_array_equal(s["accept_count"] > 0, TIGHT > 0)
    if "lazy_uniform" in spec_kw:
        assert "weight" in pr.history
    if case in RANDOM_POP:
        # the bounds bind node by node: some boundary node may flip and
        # some may not
        gate = dense._pop_plane_bi(pdg, ppar, pst.assignment.long(),
                                   pst.dist_pop.float())
        edge = pst.cut_deg > 0
        assert bool((gate & edge).any()) and bool((~gate & edge).any())


def test_refresh_keeps_the_conn_plane_exact():
    """After steps of the dense body, the incrementally refreshed conn
    planes equal a full recompute (after tests/test_dense.py:96)."""
    pg = port.graphs.hex_lattice(4, 4)
    spec = port.Spec()
    dg, st, par = sampling.init_batch(pg, port.graphs.stripes_plan(pg, 2),
                                      n_chains=8, seed=1, spec=spec,
                                      base=1.0, pop_tol=0.3, device="cpu")
    st = dense.ensure_conn_bits(dg, spec, st)
    moved = 0
    for _ in range(60):
        st = dense.transition(dg, spec, par, st)
        moved += int(st.accept_count.sum())
        want = dense.init_conn_bits(dg, spec, st.assignment)
        assert torch.equal(st.conn_bits, want)
    assert moved > 0


def test_patch_balls_are_symmetric():
    """The refresh rests on u in patch(v) iff v in patch(u)."""
    for g in (port.graphs.hex_lattice(4, 4),
              port.graphs.triangular_lattice(4, 6)):
        pairs = {(v, int(u)) for v in range(g.n_nodes)
                 for u in g.patch_nodes[v][:g.patch_size[v]]}
        assert all((u, v) in pairs for v, u in pairs)


def test_runner_thinning_device_history_and_waits_drain():
    """record_every, history_device and the per-chunk waits drain agree
    with the JAX package's runner."""
    (jspec, jdg, jst, jpar), (pspec, pdg, pst, ppar) = _both(
        "hex_lattice", 3, 4, {}, 0.1, seed=11)
    jr = fce.run_chains(jdg, jspec, jpar, jst, n_steps=61, chunk=20,
                        record_every=3)
    pr = sampling.run_chains(pdg, pspec, ppar, pst, n_steps=61, chunk=20,
                             record_every=3, history_device=True)
    assert all(isinstance(v, torch.Tensor) for v in pr.history.values())
    pr.history = {k: v.numpy() for k, v in pr.history.items()}
    assert pr.history["cut_count"].shape == (C, 21)
    _check(jr, pr)
    # the host total is the f64 sum of the recorded per-step waits
    full = sampling.run_chains(pdg, pspec, ppar, pst, n_steps=61, chunk=20)
    np.testing.assert_allclose(full.waits_total,
                               full.history["wait"].astype(np.float64)
                               .sum(axis=1), rtol=1e-6)


def test_kernel_path_resolution_and_refusals():
    pg = port.graphs.hex_lattice(3, 4)
    plan = port.graphs.stripes_plan(pg, 2)
    spec = port.Spec()
    dg, st, par = sampling.init_batch(pg, plan, n_chains=2, seed=0,
                                      spec=spec, base=1.0, pop_tol=0.1,
                                      device="cpu")
    assert sampling.runner.resolve_kernel_path(dg, spec) == "general_dense"
    exact = port.Spec(contiguity="exact")
    assert sampling.runner.resolve_kernel_path(dg, exact) == "general"
    with pytest.raises(ValueError, match="general_dense"):
        sampling.runner.resolve_kernel_path(dg, exact, "general_dense")
    with pytest.raises(ValueError, match="cuda_pair"):
        cuda_dense.check(dg, port.Spec(n_districts=3, proposal="pair"), par)
    assert cuda_dense.supports(dg, port.Spec(record_interface=True))
    for kw, item in ((dict(accept="corrected"), "B4"),
                     (dict(weighted_cut=True), "B4"),
                     (dict(record_assignment_bits=True), "B9")):
        assert not cuda_dense.supports(dg, port.Spec(**kw))
        with pytest.raises(ValueError, match=item):
            cuda_dense.check(dg, port.Spec(**kw), par)
    assert cuda_dense.supports(dg, port.Spec(nobacktrack=True,
                                             lazy_uniform=True))
    # the wrapper on host tensors is the plain version, one chunk
    st2, rows = cuda_dense.run_general_dense_chunk_cuda(
        dg, cuda_dense.make_static_inputs(dg), spec, par, st, 5)
    assert rows["cut_count"].shape == (5, 2)
    assert st2.conn_bits is not None and cuda_dense.run_general_dense_chunk_cuda.launches == 0
