"""The port's general-path graph tables, contiguity checks and packed node
sets against the JAX package's, on the CPU.

Inputs come from numpy seeds; the JAX side runs through the JAX package's
own functions (no Pallas on this path). Tolerance: every comparison here
is exact (integers and booleans).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.kernel import contiguity as jcontig
from flipcomplexityempirical_tpu.kernel import dense as jdense

import flipcomplexityempirical_tpu_torch as port
from flipcomplexityempirical_tpu_torch import convert
from flipcomplexityempirical_tpu_torch.kernel import contiguity as pcontig
from flipcomplexityempirical_tpu_torch.kernel import dense as pdense

GRAPHS = [("hex_lattice", 3, 4), ("hex_lattice", 4, 4), ("hex_lattice", 14, 28),
          ("triangular_lattice", 4, 6), ("triangular_lattice", 5, 7),
          ("triangular_lattice", 14, 28)]
TABLES = ("edges", "nbr", "nbr_mask", "nbr_edge", "deg", "pop", "coords",
          "frame_mask", "frame_idx", "wall_id", "edge_len", "patch_nodes",
          "patch_adj", "patch_size", "center")


def _pair(name, m, n):
    return getattr(fce.graphs, name)(m, n), getattr(port.graphs, name)(m, n)


@pytest.mark.parametrize("name,m,n", GRAPHS)
def test_graph_tables_equal_jax(name, m, n):
    jg, pg = _pair(name, m, n)
    assert pg.labels == jg.labels
    assert pg.center == jg.center and pg.patch_ok == jg.patch_ok
    assert pg.name == jg.name
    jd, pd = jg.device(), pg.device("cpu")
    for f in TABLES:
        want = np.asarray(getattr(jd, f))
        got = getattr(pd, f).numpy()
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=f)
    assert pd.max_patch == jd.max_patch and pd.max_deg == jd.max_deg


def test_hex_bench_graph_shape():
    """bench.py's graph: hex_lattice(64, 64), P <= 32 (one warp lane a
    patch slot)."""
    pg = port.graphs.hex_lattice(64, 64)
    assert (pg.n_nodes, pg.n_edges, pg.max_deg) == (8448, 12543, 3)
    assert pg.patch_ok and pg.patch_nodes.shape[1] == 18


def test_device_graph_converter():
    jg, pg = _pair("hex_lattice", 3, 4)
    got = convert.device_graph(jax.tree.map(np.asarray, jg.device()),
                               device="cpu")
    want = pg.device("cpu")
    for f in TABLES:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def _trajectory_assignments(jg, n_states=6, seed=0):
    """Assignments along a JAX general_dense trajectory (after
    tests/test_contiguity.py:65), plus random plans."""
    plan = fce.graphs.stripes_plan(jg, 2)
    spec = fce.Spec()
    dg, st, par = fce.init_batch(jg, plan, n_chains=3, seed=seed, spec=spec,
                                 base=0.8, pop_tol=0.3)
    res = fce.run_chains(dg, spec, par, st, n_steps=41, chunk=20,
                         record_history=False)
    traj = np.asarray(res.state.assignment)
    rand = np.random.default_rng(seed).integers(
        0, 2, (n_states - traj.shape[0], jg.n_nodes)).astype(np.int8)
    return np.concatenate([np.asarray(plan)[None].astype(np.int8), traj,
                           rand])


@pytest.mark.parametrize("blocks", ["one", "several"])
@pytest.mark.parametrize("name,m,n", [("hex_lattice", 4, 4),
                                      ("triangular_lattice", 4, 6)])
def test_contiguity_checks_equal_jax(name, m, n, blocks, monkeypatch):
    """The patch and exact checks against the JAX package's, the patch
    rows taken in one block or split into several."""
    if blocks == "several":
        monkeypatch.setattr(pcontig, "_BLOCK", 256)
    jg, pg = _pair(name, m, n)
    jd, pd = jg.device(), pg.device("cpu")
    A = _trajectory_assignments(jg)
    nodes = jnp.arange(jg.n_nodes)
    for fn_j, fn_p in ((jcontig.patch_connected, pcontig.patch_connected),
                       (jcontig.exact_connected, pcontig.exact_connected)):
        check = jax.jit(jax.vmap(
            lambda a: jax.vmap(lambda u: fn_j(
                jd, a, u, a[u].astype(jnp.int32)))(nodes)))
        want = np.asarray(check(jnp.asarray(A)))
        a = torch.as_tensor(A)
        got = fn_p(pd, a, torch.arange(jg.n_nodes).expand(len(A), -1),
                   a.long()).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < want.mean() < 1
    want = np.stack([np.asarray(jdense.conn_plane(jd, fce.Spec(),
                                                  jnp.asarray(a)))
                     for a in A])
    got = pdense.conn_plane(pd, port.Spec(), torch.as_tensor(A)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [1, 31, 32, 33, 64, 95])
def test_pack_unpack_equal_jax(m):
    mask = np.random.default_rng(m).random((3, m)) < 0.4
    want = np.stack([np.asarray(jdense.pack_mask(jnp.asarray(x)))
                     for x in mask]).astype(np.int64)
    got = pdense.pack_mask(torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pdense.unpack_mask(got, m).numpy(), mask)


def test_select_nth_set_equal_jax():
    """Every rank of sets that fill whole words, cross word boundaries and
    use bit 31 (after tests/test_dense.py:57, :70)."""
    rs = np.random.default_rng(7)
    masks = [np.ones(96, bool), rs.random(96) < 0.3, np.zeros(96, bool)]
    masks[2][[0, 31, 32, 63, 64, 95]] = True
    sel = jax.jit(jdense.select_nth_set)
    for mask in masks:
        words = jdense.pack_mask(jnp.asarray(mask))
        pw = pdense.pack_mask(torch.as_tensor(mask))
        total = int(mask.sum())
        ranks = np.arange(max(total, 1))
        want = np.array([int(sel(words, jnp.int32(r))) for r in ranks])
        got = pdense.select_nth_set(pw.expand(len(ranks), -1),
                                    torch.as_tensor(ranks)).numpy()
        np.testing.assert_array_equal(got, want)
        if total:
            np.testing.assert_array_equal(got, np.nonzero(mask)[0])
    np.testing.assert_array_equal(
        pdense.popcount(torch.tensor([0, 1, 0xFFFFFFFF, 0x80000001])).numpy(),
        [0, 1, 32, 2])
