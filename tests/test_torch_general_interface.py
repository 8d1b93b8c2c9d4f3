"""The wall-interface metrics on the port's general path against the JAX
package's, on the CPU.

``kernel/step.py::interface_metrics`` (the two wall-cut edges of smallest
edge index, their midpoints' slope and the angle they subtend at the
center) on random cut planes of sec11 and the Frankengraph, and the
general runner under ``record_interface``: sec11 with ``nobacktrack`` and
the Frankengraph with ``lazy_uniform`` on the dense body (the plain
version of the general-dense kernel's interface form), the Frankengraph
with ``contiguity='exact'`` on the legacy body.

Tolerance (``_parity``): slope and angle within 4 ulp, NaN exactly where
the JAX value is NaN; every other field and history key equal; waits
equal except counted log ties (each off by exactly 1.0, at most 1e-3 of
them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _parity import assert_chain_run_matches, assert_ulps_close

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.kernel import step as jstep

import flipcomplexityempirical_tpu_torch as port
from flipcomplexityempirical_tpu_torch import convert, sampling
from flipcomplexityempirical_tpu_torch.kernel import cuda_dense
from flipcomplexityempirical_tpu_torch.kernel import step as pstep

GRAPHS = {"sec11": ("grid_sec11", "sec11_plan"),
          "frank": ("frankengraph", "frank_plan")}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("which", sorted(GRAPHS))
def test_interface_metrics_match_jax(which):
    """Random cut planes, dense and sparse (most rows with fewer than two
    wall-cut edges: NaN), against the JAX function row by row."""
    name, _ = GRAPHS[which]
    jg = getattr(fce.graphs, name)()
    pdg = getattr(port.graphs, name)().device("cpu")
    rng = np.random.default_rng(7)
    walls = np.nonzero(np.asarray(jg.wall_id) >= 0)[0]
    cut = (rng.random((48, jg.n_edges)) < 0.3).astype(np.int8)
    for r in range(16, 48):                  # few or no wall edges cut
        cut[r, walls] = 0
        cut[r, rng.choice(walls, size=r % 3)] = 1
    got = pstep.interface_metrics(pdg, torch.as_tensor(cut))
    jdg = jg.device()
    fn = jax.jit(jax.vmap(lambda c: jstep.interface_metrics(jdg, c)))
    want = fn(jnp.asarray(cut))
    for g, w, k in zip(got, want, ("slope", "angle")):
        assert_ulps_close(g.numpy(), np.asarray(w), name=k)
    assert np.isnan(got[0].numpy()).sum() > 0      # the NaN rows exist


def _run_both(which, spec_kw, path, steps, chains=3, chunk=40):
    name, planf = GRAPHS[which]
    jg, pg = getattr(fce.graphs, name)(), getattr(port.graphs, name)()
    plan = getattr(fce.graphs, planf)(jg, 0)
    kw = dict(record_interface=True, **spec_kw)
    jspec, pspec = fce.Spec(**kw), port.Spec(**kw)
    jdg, jst, jpar = fce.init_batch(jg, plan, n_chains=chains, seed=3,
                                    spec=jspec, base=0.8, pop_tol=0.1)
    pdg, pst, ppar = sampling.init_batch(pg, plan, n_chains=chains, seed=3,
                                         spec=pspec, base=0.8, pop_tol=0.1,
                                         device="cpu")
    jr = fce.run_chains(jdg, jspec, jpar, jst, n_steps=steps, chunk=chunk,
                        kernel_path=path)
    pr = sampling.run_chains(pdg, pspec, ppar, pst, n_steps=steps,
                             chunk=chunk, kernel_path=path)
    assert {"slope", "angle"} <= set(pr.history)
    return assert_chain_run_matches(
        convert.to_numpy(pr.state), pr.history, pr.waits_total,
        jax.tree.map(np.asarray, jr.state),
        {k: np.asarray(v) for k, v in jr.history.items()}, jr.waits_total)


RUNS = {
    "sec11-nobacktrack-dense": ("sec11", dict(nobacktrack=True),
                                "general_dense", 120),
    "frank-lazy-dense": ("frank", dict(lazy_uniform=True), "general_dense",
                         120),
    "frank-exact-legacy": ("frank", dict(contiguity="exact"), "general",
                           400),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_interface_run_matches_jax(case):
    which, spec_kw, path, steps = RUNS[case]
    _run_both(which, spec_kw, path, steps)


def test_dense_kernel_takes_record_interface():
    """The general-dense kernel's scope now holds record_interface (its
    interface form), and its plain version writes the rows the kernel
    writes: slope and angle beside the four rows, folded as rows 5, 6."""
    dg = port.graphs.grid_sec11().device("cpu")
    spec = port.Spec(record_interface=True, nobacktrack=True)
    assert cuda_dense.supports(dg, spec)
    assert cuda_dense.fold_row_index(spec) == {
        "cut_count": 0, "b_count": 1, "wait": 2, "accepts": 3, "slope": 5,
        "angle": 6}
    static = cuda_dense.interface_inputs(dg)
    walls = torch.nonzero(dg.wall_id >= 0)[:, 0]
    assert torch.equal(static.wall_edges.long(), walls)
    assert torch.equal(static.wall_rank[walls].long(),
                       torch.arange(walls.numel()))
    assert int((static.wall_rank >= 0).sum()) == walls.numel() == 152
