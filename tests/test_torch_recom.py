"""The port's ReCom chain against the JAX package's, on the CPU.

The port runs on ``device='cpu'`` (the plain versions of
``flipcomplexityempirical_tpu_torch/sampling/recom.py``); inputs are made
from seeds with numpy and handed to both packages. Held here:

- the array draws: ``rng.permutation`` against ``jax.random.permutation``
  at E in {1, 2, 112, 1625, 1626, 1984} (one sort round, then two),
  ``rng.uniform_n(minval=tiny)`` and ``rng.gumbel`` against JAX's;
- ``spanning_forest`` on the full graph and on a merged pair (8 x 8 and
  32 x 32), ``tree_structure``, ``subtree_populations`` and
  ``mark_subtree`` on the JAX package's own trees;
- ``recom_move`` for 3 moves at 8 x 8, k in {2, 4}, C=8, with and without
  ``label_values``; ``run_recom`` at 16 x 16, k = 4, 2 chains, 41 steps,
  chunk 16, ``record_every`` 2; a sec11 run with ``record_interface``;
- the driver: ``tests/fixtures/torch/experiment_recom.npz`` holds what the
  JAX package's ``run_config`` returns for kpair-recom K4 on the 32 x 32
  rook grid (pop_tol 0.25, base 1.0, 2 chains, seed 0, 41 steps in
  segments of 20) and
  ``experiment_recom_dual.npz`` for the dual fixture map at k = 4
  (``recom-dual``'s overrides: pop_tol 0.4, 2 chains, 31 steps);
  ``experiment_recom_ckpt/`` is the JAX checkpoint of the first after its
  first 20-step segment. The port's ``run_config`` equals both, resumes
  the JAX checkpoint to the JAX run's end, resumes its own checkpoint bit
  for bit, and the sweep service runs a ReCom job solo, equal to its
  ``run_config``;
- the refusals, each by the name of its ROADMAP.md item.

The card's machine has no JAX, so ``chip_smoke.py`` holds the card's runs
against the same fixtures. Regenerate them with ``python
tests/test_torch_recom.py`` (JAX on the CPU, about a minute).

Tolerance: integers bit-equal, every state field and history row. Waits
under ``_parity``'s rule (a differing f32 ``log`` counted as a tie, each
such wait off by exactly 1.0), its ``scaled`` form for k = 4, whose waits
(n**4 - 1 over the pair count) reach ~1e7 at 16 x 16 and ~1e9 at
32 x 32; the driver's fixtures are held under its ``relative`` rule
(each differing wait, and the float state fields per differing wait,
within 2**-20 of the wait plus 1: a log tie moves a wait of 1e9 by a
few units in the last place of its f32, not by 1.0; the wait totals
within the waits' differences plus a unit in the last place a later
yield). ``gumbel``: entries equal but for counted ties of the two
``log``s, each within 8 units of 2**-23 of max(1, |g|); the ranks and the
draws of integers bit-equal.
"""

import os
import pathlib
import shutil
import sys
import tempfile

if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.sampling import recom as jrecom
from flipcomplexityempirical_tpu_torch import convert, rng
from flipcomplexityempirical_tpu_torch import graphs as tgraphs
from flipcomplexityempirical_tpu_torch.kernel import cuda_recom
from flipcomplexityempirical_tpu_torch.kernel.step import Spec as TSpec
from flipcomplexityempirical_tpu_torch.sampling import recom as trecom
from flipcomplexityempirical_tpu_torch.sampling import runner as trunner
from _parity import (assert_chain_run_matches, assert_experiment_matches,
                     assert_waits_close, experiment_arrays)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch"
RUNS = {
    "recom": dict(family="kpair", chain="recom", n_districts=4, grid=32,
                  alignment=0, base=1.0, pop_tol=0.25, total_steps=41,
                  checkpoint_every=20),
    "recom_dual": dict(family="dual", chain="recom", n_districts=4,
                       dual_source="fixture", alignment=0, base=1.0,
                       pop_tol=0.4, total_steps=31),
}
SHAPE = dict(n_chains=2, seed=0)
CKPT_EVERY = 20
GUMBEL_ULPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(seed: int, c: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=(c, 2), dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# the array draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e", [1, 2, 112, 1625, 1626, 1984])
def test_permutation_matches_jax(e):
    keys = _keys(e, 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, e))(
        jnp.asarray(keys)))
    got = rng.permutation(torch.as_tensor(keys.astype(np.int64)), e)
    np.testing.assert_array_equal(got.numpy(), want)
    assert rng.permutation_rounds(e) == (0 if e == 1 else
                                         1 if e <= 1625 else 2)


def test_uniform_and_gumbel_match_jax():
    keys = _keys(7, 4)
    tk = torch.as_tensor(keys.astype(np.int64))
    n = 20000
    tiny = np.finfo(np.float32).tiny
    u_want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), minval=tiny))(jnp.asarray(keys)))
    np.testing.assert_array_equal(
        rng.uniform_n(tk, n, minval=rng.F32_TINY).numpy(), u_want)
    np.testing.assert_array_equal(
        rng.uniform_n(tk, n).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(
            jnp.asarray(keys))))
    g_want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(
        jnp.asarray(keys)))
    g_got = rng.gumbel(tk, n).numpy()
    ties = g_got != g_want
    bound = GUMBEL_ULPS * 2.0 ** -23 * np.maximum(1.0, np.abs(g_want))
    assert (np.abs(g_got - g_want) <= bound).all()
    print(f"gumbel: {int(ties.sum())} of {ties.size} entries differ by a "
          "log tie")


# ---------------------------------------------------------------------------
# the tree bodies
# ---------------------------------------------------------------------------

def _pair(n: int, k: int, chains: int, seed: int):
    """The JAX and port graphs of the n x n grid, a stripes plan of k
    districts and per chain a merged pair (districts c % (k - 1) and the
    next)."""
    g = fce.graphs.square_grid(n, n)
    plan = np.asarray(fce.graphs.stripes_plan(g, k))
    d1 = np.arange(chains) % (k - 1)
    member = (plan[None] == d1[:, None]) | (plan[None] == d1[:, None] + 1)
    dg = g.device()
    tdg = tgraphs.square_grid(n, n).device("cpu")
    return g, dg, tdg, member, _keys(seed, chains)


@pytest.mark.parametrize("n", [8, 32])
@pytest.mark.parametrize("subset", [False, True])
def test_spanning_forest_matches_jax(n, subset):
    g, dg, tdg, member, keys = _pair(n, 4, 3, n)
    if not subset:
        member = np.ones_like(member)
    want = np.asarray(jax.vmap(lambda m, k: jrecom.spanning_forest(
        dg, m, k))(jnp.asarray(member), jnp.asarray(keys)))
    got = trecom.spanning_forest(tdg, torch.as_tensor(member),
                                 torch.as_tensor(keys.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    # a spanning forest: |members| - 1 edges per connected member set
    assert (want.sum(axis=1) == member.sum(axis=1) - 1).all()


@pytest.mark.parametrize("n", [8, 16])
def test_tree_bodies_match_jax(n):
    g, dg, tdg, member, keys = _pair(n, 4, 4, 100 + n)
    root = np.argmax(member, axis=1)
    in_tree = jax.vmap(lambda m, k: jrecom.spanning_forest(dg, m, k))(
        jnp.asarray(member), jnp.asarray(keys))
    par, dep = jax.vmap(lambda t, m, r: jrecom.tree_structure(dg, t, m, r))(
        in_tree, jnp.asarray(member), jnp.asarray(root))
    sub = jax.vmap(lambda p, d: jrecom.subtree_populations(dg, p, d))(
        par, dep)
    cc = np.asarray([np.flatnonzero(np.asarray(d) > 2)[i % 3]
                     for i, d in enumerate(np.asarray(dep))])
    mark = jax.vmap(lambda p, d, c: jrecom.mark_subtree(dg, p, d, c))(
        par, dep, jnp.asarray(cc))
    tin = torch.as_tensor(np.array(in_tree))
    tm = torch.as_tensor(member)
    tp, td = trecom.tree_structure(tdg, tin, tm, torch.as_tensor(root))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(par))
    np.testing.assert_array_equal(td.numpy(), np.asarray(dep))
    ts = trecom.subtree_populations(tdg, tp, td)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(sub))
    tmark = trecom.mark_subtree(tdg, tp, td, torch.as_tensor(cc))
    np.testing.assert_array_equal(tmark.numpy(), np.asarray(mark))


# ---------------------------------------------------------------------------
# the move and the runner
# ---------------------------------------------------------------------------

def _batches(n: int, k: int, chains: int, seed: int, pop_tol: float):
    g = fce.graphs.square_grid(n, n)
    plan = np.asarray(fce.graphs.stripes_plan(g, k))
    proposal = "pair" if k > 2 else "bi"
    spec = fce.Spec(n_districts=k, proposal=proposal)
    jb = fce.init_batch(g, plan, n_chains=chains, seed=seed, spec=spec,
                        base=1.0, pop_tol=pop_tol)
    tspec = TSpec(n_districts=k, proposal=proposal)
    tb = trunner.init_batch(tgraphs.square_grid(n, n), plan, chains, seed,
                            tspec, 1.0, pop_tol, device="cpu")
    return spec, jb, tspec, tb


def _hold_state(got, want, scaled=False):
    """Every field of a port ChainState equal to a JAX one; waits (and the
    wait sums) under the tie rule."""
    want = convert.chain_state(want, device="cpu")
    bad = assert_waits_close(got.cur_wait.numpy()[None],
                             want.cur_wait.numpy()[None], "cur_wait",
                             scaled=scaled)
    for f in want.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if b is None or f in ("cur_wait", "waits_sum"):
            assert a is None or f in ("cur_wait", "waits_sum"), f
            continue
        np.testing.assert_array_equal(a.numpy().astype(np.int64),
                                      b.numpy().astype(np.int64), err_msg=f)
    return int(bad.sum())


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("labels", [False, True])
def test_recom_move_matches_jax(k, labels):
    n, chains, eps = 8, 8, 0.25
    spec, (dg, js, jp), tspec, (tdg, ts, tp) = _batches(n, k, chains, 3, eps)
    target = n * n / k
    lv = jnp.asarray(jp.label_values) if labels else None
    move = jax.jit(jax.vmap(lambda s: jrecom.recom_move(
        dg, spec, s, epsilon=eps, pop_target=target, label_values=lv)))
    for _ in range(3):
        js = move(js)
        ts = trecom.recom_move(tdg, tspec, ts, epsilon=eps,
                               pop_target=target,
                               label_values=tp.label_values if labels
                               else None)
        _hold_state(ts, js)
    assert int(np.asarray(js.accept_count).sum()) > 0


def test_recom_move_retries_and_exhaustion_match_jax():
    """The 6 x 6 grid at k = 2, eps 0.06 (``tests/test_recom.py``'s
    tight-tolerance setting) with two attempts a move: some moves need
    the second tree (its key from the JAX retry chain), some find no
    balanced edge in either."""
    spec, (dg, js, _), tspec, (tdg, ts, _) = _batches(6, 2, 16, 9, 0.06)
    move = jax.jit(jax.vmap(lambda s: jrecom.recom_move(
        dg, spec, s, epsilon=0.06, pop_target=18.0, tree_retries=2)))
    for _ in range(4):
        js = move(js)
        ts = trecom.recom_move(tdg, tspec, ts, epsilon=0.06,
                               pop_target=18.0, tree_retries=2)
        _hold_state(ts, js)
    assert int(np.asarray(js.exhausted_count).sum()) > 0
    assert int(np.asarray(js.accept_count).sum()) > 0


def test_recom_move_default_target_matches_jax():
    spec, (dg, js, _), tspec, (tdg, ts, _) = _batches(8, 4, 6, 5, 0.3)
    move = jax.jit(jax.vmap(lambda s: jrecom.recom_move(
        dg, spec, s, epsilon=0.3)))
    for _ in range(2):
        js = move(js)
        ts = trecom.recom_move(tdg, tspec, ts, epsilon=0.3)
        _hold_state(ts, js)


def test_run_recom_matches_jax():
    spec, (dg, js, jp), tspec, (tdg, ts, tp) = _batches(16, 4, 2, 11, 0.25)
    kw = dict(n_steps=41, epsilon=0.25, pop_target=64.0, chunk=16,
              record_every=2)
    want = jrecom.run_recom(dg, spec, jp, js, **kw)
    got = trecom.run_recom(tdg, tspec, tp, ts, **kw)
    assert got.n_yields == want.n_yields == 41
    assert got.history["cut_count"].shape == (2, 21)
    assert_chain_run_matches(
        got.state, got.history, got.waits_total,
        convert.chain_state(want.state, device="cpu"), want.history,
        want.waits_total, scaled=True)


def test_run_recom_continues_a_segment_and_keeps_history_on_device():
    """Two segments (the second with record_initial=False) equal one run;
    history_device keeps tensors."""
    _, _, tspec, (tdg, ts, tp) = _batches(8, 4, 3, 2, 0.25)
    kw = dict(epsilon=0.25, pop_target=16.0)
    whole = trecom.run_recom(tdg, tspec, tp, ts, n_steps=21, **kw)
    a = trecom.run_recom(tdg, tspec, tp, ts, n_steps=11, chunk=4, **kw)
    b = trecom.run_recom(tdg, tspec, tp, a.state, n_steps=10,
                         record_initial=False, history_device=True, **kw)
    assert isinstance(b.history["cut_count"], torch.Tensor)
    for key in whole.history:
        np.testing.assert_array_equal(
            np.concatenate([a.history[key], b.history[key].numpy()], axis=1),
            whole.history[key], err_msg=key)
    np.testing.assert_array_equal(b.state.assignment, whole.state.assignment)


def test_record_interface_on_the_plain_version_matches_jax():
    """sec11 at k = 2 with its wall-interface records, 5 steps: the plain
    version serves it (the kernel refuses it, ROADMAP A9b)."""
    g = fce.graphs.grid_sec11()
    plan = np.asarray(fce.graphs.sec11_plan(g, 0))
    spec = fce.Spec(n_districts=2, record_interface=True)
    dg, js, jp = fce.init_batch(g, plan, n_chains=2, seed=4, spec=spec,
                                base=1.0, pop_tol=0.1)
    tspec = TSpec(n_districts=2, record_interface=True)
    tdg, ts, tp = trunner.init_batch(tgraphs.grid_sec11(), plan, 2, 4,
                                     tspec, 1.0, 0.1, device="cpu")
    kw = dict(n_steps=5, epsilon=0.1, pop_target=g.n_nodes / 2)
    want = jrecom.run_recom(dg, spec, jp, js, **kw)
    got = trecom.run_recom(tdg, tspec, tp, ts, **kw)
    assert "slope" in got.history
    assert_chain_run_matches(
        got.state, got.history, got.waits_total,
        convert.chain_state(want.state, device="cpu"), want.history,
        want.waits_total)
    with pytest.raises(ValueError, match="A9b"):
        cuda_recom.check(tdg, tspec, tp)


def test_refusals():
    _, _, tspec, (tdg, ts, tp) = _batches(8, 4, 2, 1, 0.25)
    with pytest.raises(ValueError, match="A11a"):
        trecom.run_recom(tdg, tspec, tp, ts, n_steps=3, recorder=object())
    rej = ts.replace(reject_count=torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="A11a"):
        trecom.run_recom(tdg, tspec, tp, rej, n_steps=3)
    with pytest.raises(ValueError, match="A11a"):
        cuda_recom.run_recom_chunk_cuda(tdg, None, tspec, tp, rej, 2)
    cuda_recom.check(tdg, tspec, tp)
    heavy = tgraphs.square_grid(8, 8)
    heavy.pop[:] = 2 ** 18
    with pytest.raises(ValueError, match="B11b"):
        cuda_recom.check(heavy.device("cpu"), tspec, tp)
    big = tgraphs.square_grid(200, 200).device("cpu")
    with pytest.raises(ValueError, match="B11b"):
        cuda_recom.check(big, tspec, tp)
    # the kpair family's full 64 x 64 grid fits one block's shared memory
    assert cuda_recom.supports(tgraphs.square_grid(64, 64).device("cpu"),
                               tspec)
    assert cuda_recom.smem_bytes(4096, 8064) <= cuda_recom.SMEM_LIMIT
    with pytest.raises(ValueError, match="t_inner"):
        cuda_recom.run_recom_chunk_cuda(tdg, None, tspec, tp, ts, 0)


def test_driver_refusals():
    from flipcomplexityempirical_tpu_torch.experiments import (
        ExperimentConfig, driver)
    cfg = ExperimentConfig(**RUNS["recom"], **SHAPE, analytics="summary")
    with pytest.raises(ValueError, match="recom chain stays on the history"):
        driver.run_config(cfg, "unused", device="cpu")
    with pytest.raises(ValueError, match="chain 'gibbs'"):
        driver._check_ported(ExperimentConfig(
            **dict(RUNS["recom"], chain="gibbs"), **SHAPE))


# ---------------------------------------------------------------------------
# the driver and the service against the JAX-made fixtures
# ---------------------------------------------------------------------------

def fixture_path(which: str) -> pathlib.Path:
    return FIXTURES / f"experiment_{which}.npz"


def ckpt_dir() -> pathlib.Path:
    return FIXTURES / "experiment_recom_ckpt"


def _jax_config(which: str, **kw):
    from flipcomplexityempirical_tpu.experiments import ExperimentConfig
    return ExperimentConfig(**{**RUNS[which], **SHAPE, **kw})


def make_fixture(which: str) -> dict:
    from flipcomplexityempirical_tpu.experiments import run_config
    cfg = _jax_config(which)
    with tempfile.TemporaryDirectory() as out:
        data = run_config(cfg, out)
        wait_txt = pathlib.Path(out, cfg.tag + "wait.txt").read_text()
    return experiment_arrays(data, wait_txt)


def make_checkpoint(path) -> None:
    from flipcomplexityempirical_tpu.experiments import driver as drv
    cfg = _jax_config("recom", checkpoint_every=CKPT_EVERY)
    g, plan, _ = drv.build_graph_and_plan(cfg)
    with pytest.raises(drv._SegmentStop):
        drv._run_jax(cfg, g, plan, checkpoint_dir=str(path),
                     _stop_after_segments=1)


def port_config(which: str, **kw):
    from flipcomplexityempirical_tpu_torch.experiments import (
        ExperimentConfig)
    return ExperimentConfig(**{**RUNS[which], **SHAPE, **kw})


def port_arrays(cfg, out, **kw) -> dict:
    from flipcomplexityempirical_tpu_torch.experiments import run_config
    data = run_config(cfg, str(out), device="cpu", **kw)
    wait_txt = pathlib.Path(out, cfg.tag + "wait.txt").read_text()
    return experiment_arrays(data, wait_txt)


@pytest.mark.parametrize("which", sorted(RUNS))
def test_run_config_matches_jax(which, tmp_path):
    from flipcomplexityempirical_tpu_torch.experiments import driver
    cfg = port_config(which)
    assert cfg.tag.startswith("recom-")
    got = port_arrays(cfg, tmp_path)
    assert_experiment_matches(got, dict(np.load(fixture_path(which))),
                              waits="relative")
    assert driver.is_done(cfg, str(tmp_path))


def test_jax_checkpoint_resumes_to_jax_end(tmp_path):
    ck = tmp_path / "ck"
    shutil.copytree(ckpt_dir(), ck)
    got = port_arrays(port_config("recom", checkpoint_every=CKPT_EVERY),
                      tmp_path / "out", checkpoint_dir=str(ck))
    assert_experiment_matches(got, dict(np.load(fixture_path("recom"))),
                              waits="relative")


def test_port_resume_is_bit_identical(tmp_path):
    from flipcomplexityempirical_tpu_torch.experiments import driver as drv
    cfg = port_config("recom", checkpoint_every=CKPT_EVERY)
    clean = port_arrays(cfg, tmp_path / "a")
    ck = str(tmp_path / "ck")
    g, plan, _ = drv.build_graph_and_plan(cfg)
    with pytest.raises(drv._SegmentStop):
        drv._run_torch(cfg, g, plan, checkpoint_dir=ck,
                       _stop_after_segments=1, device="cpu")
    resumed = port_arrays(cfg, tmp_path / "b", checkpoint_dir=ck)
    assert sorted(resumed) == sorted(clean)
    for k in clean:
        np.testing.assert_array_equal(resumed[k], clean[k], err_msg=k)
    for kind in ("wait.txt", "end.png", "edges.png"):
        assert ((tmp_path / "a" / (cfg.tag + kind)).read_bytes()
                == (tmp_path / "b" / (cfg.tag + kind)).read_bytes()), kind


def test_service_runs_recom_solo(tmp_path):
    """Two ReCom jobs of one fingerprint are not coalesced: each runs solo
    through the driver and equals its run_config."""
    from flipcomplexityempirical_tpu_torch.experiments import driver
    from flipcomplexityempirical_tpu_torch.service import SweepService
    cfgs = [port_config("recom", grid=8, total_steps=9, alignment=a)
            for a in (0, 1)]
    assert cfgs[0].fingerprint() == cfgs[1].fingerprint()
    svc = SweepService(str(tmp_path / "svc"), device="cpu", verbose=False)
    jobs = [svc.submit(c) for c in cfgs]
    svc.run_until_idle()
    assert svc.exit_code == 0
    assert len({j.batch for j in jobs}) == 2
    for job, cfg in zip(jobs, cfgs):
        want = driver.run_config(cfg, str(tmp_path / cfg.tag),
                                 device="cpu")
        for key in want["history"]:
            np.testing.assert_array_equal(job.result["history"][key],
                                          want["history"][key], err_msg=key)
        np.testing.assert_array_equal(job.result["assignments"],
                                      want["assignments"])


@pytest.mark.slow
@pytest.mark.parametrize("which", sorted(RUNS))
def test_fixture_is_current(which, tmp_path):
    want = dict(np.load(fixture_path(which)))
    got = make_fixture(which)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if which == "recom":
        make_checkpoint(tmp_path)
        assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(ckpt_dir()))


if __name__ == "__main__":
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for name in RUNS:
        path = fixture_path(name)
        np.savez_compressed(path, **make_fixture(name))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
    shutil.rmtree(ckpt_dir(), ignore_errors=True)
    make_checkpoint(ckpt_dir())
    for p in sorted(ckpt_dir().iterdir()):
        print(f"wrote {p} ({p.stat().st_size} bytes)")
