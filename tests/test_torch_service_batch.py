"""The port's sweep service runs coalesced batches bit-identical to solo
runs, on the CPU (the kernels' plain versions).

- A batch of two fingerprint-equal tenants that differ in alignment,
  base, pop_tol, seed and chain count (C = 5, not a multiple of any block
  of chains): each tenant's rows equal the port's solo run of its config
  (``driver._run_torch``) bit for bit in every state field, history key,
  wait total and final accumulator, on the board path (frank,
  ``lowered_bits``; kpair's K4 pair walk on the 16 x 16 rook grid,
  ``board``) and the general path (hex, ``general_dense``; the dual
  graph's K4 pair walk, ``general_dense``). The
  first tenant is the config of a JAX-made fixture
  (``tests/fixtures/torch/experiment_frank.npz``: frank 0B30P50, 401
  steps, 2 chains, seed 0; ``experiment_hex.npz``: hex 6 x 10, 300 steps,
  3 chains, seed 0; ``experiment_dual.npz``: dual-K4-0B263P25, 401
  steps, 2 chains, seed 0; ``experiment_kpair.npz``: kpair-K4-0B263P50
  on 16 x 16, 401 steps in two segments, 2 chains, seed 0) and equals it
  under ``_parity``'s rule (integers bit-equal, waits under the log-tie
  rule, the k = 4 runs' under its ``scaled`` form, kpair's wait totals
  under the ``scaled_ulps`` rule).
- A batch writes each tenant its own checkpoint, in the JAX package's
  format, from its sliced rows; a resubmission runs solo from it and ends
  where the batch ended.
- A job whose checkpoint is the JAX package's
  (``tests/fixtures/torch/experiment_frank_ckpt/``, after 200 of 401
  steps) runs solo, beside a fresh fingerprint-equal tenant, to the
  fixture's end.
"""

import pathlib
import shutil

import numpy as np
import pytest
from _parity import assert_experiment_matches, experiment_arrays

from flipcomplexityempirical_tpu_torch.experiments import (
    ExperimentConfig, load_checkpoint)
from flipcomplexityempirical_tpu_torch.experiments import driver as drv
from flipcomplexityempirical_tpu_torch.experiments.artifacts import (
    render_generic)
from flipcomplexityempirical_tpu_torch.service import SweepService

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch"
# (fixture, its config, a second fingerprint-equal tenant, kernel path)
RUNS = {
    "frank": (dict(family="frank", alignment=0, base=0.3, pop_tol=0.5,
                   total_steps=401, n_chains=2, seed=0),
              dict(alignment=2, base=1 / 0.3, pop_tol=0.1, n_chains=3,
                   seed=7),
              "lowered_bits"),
    "hex": (dict(family="hex", alignment=0, base=1 / 0.3, pop_tol=0.1,
                 total_steps=300, n_chains=3, lattice_m=6, lattice_n=10,
                 seed=0),
            dict(alignment=1, base=0.3, pop_tol=0.3, n_chains=2, seed=5),
            "general_dense"),
    # the dual family's seed draws its map: tenants share it
    "dual": (dict(family="dual", alignment=0, base=2.63815853,
                  pop_tol=0.25, n_districts=4, total_steps=401, n_chains=2,
                  seed=0),
             dict(alignment=1, base=0.3, pop_tol=0.3, n_chains=3),
             "general_dense"),
    "kpair": (dict(family="kpair", n_districts=4, grid=16, alignment=0,
                   base=2.63815853, pop_tol=0.5, total_steps=401,
                   checkpoint_every=200, n_chains=2, seed=0),
              dict(alignment=1, base=0.8, pop_tol=0.3, n_chains=3, seed=4),
              "board"),
}
RESULT_KEYS = ("end_signed", "cut_times", "part_sum", "num_flips",
               "slopes", "angles", "waits_sum", "waits_all", "assignments")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The runs here are small: one intra-op thread is as fast alone and
    keeps parallel test workers from oversubscribing the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _solo(cfg) -> dict:
    g, plan, _ = drv.build_graph_and_plan(cfg)
    return drv._run_torch(cfg, g, plan, None, device="cpu")


def assert_same_run(got: dict, want: dict) -> None:
    for part in ("history", "state"):
        assert sorted(got[part]) == sorted(want[part]), part
        for k in want[part]:
            np.testing.assert_array_equal(np.asarray(got[part][k]),
                                          np.asarray(want[part][k]),
                                          err_msg=f"{part}[{k}]")
            assert np.asarray(got[part][k]).dtype == np.asarray(
                want[part][k]).dtype, k
    for k in RESULT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _fixture_arrays(cfg, data, out) -> dict:
    """A service result as the fixture's arrays: the partisan scores and
    wait.txt made by the driver's own code."""
    g, _, _ = drv.build_graph_and_plan(cfg)
    if cfg.n_districts == 2 or cfg.family == "dual":
        data = dict(data, partisan=drv._partisan_summary(cfg, g, data))
    render_generic(g, str(out), cfg.tag, kinds=["wait.txt"],
                   end_signed=data["end_signed"],
                   cut_times=data["cut_times"],
                   num_flips=data["num_flips"],
                   waits_sum=data["waits_sum"])
    return experiment_arrays(data, (out / (cfg.tag + "wait.txt"))
                             .read_text())


@pytest.mark.parametrize("which", sorted(RUNS))
def test_coalesced_batch_bit_identical_to_solo(which, tmp_path):
    base_kw, other, path = RUNS[which]
    cfgs = [ExperimentConfig(**base_kw),
            ExperimentConfig(**{**base_kw, **other})]
    assert cfgs[0].fingerprint() == cfgs[1].fingerprint()
    svc = SweepService(str(tmp_path / "out"), device="cpu")
    jobs = [svc.submit(c) for c in cfgs]
    svc.run_until_idle()
    assert [j.status for j in jobs] == ["done", "done"], \
        [(j.tag, j.error) for j in jobs]
    assert svc.exit_code == 0
    assert len(svc.batch_stats) == 1
    stat = svc.batch_stats[0]
    assert stat.kernel_path == path and stat.launches == 0
    assert stat.chains == 5 and stat.jobs == [j.job_id for j in jobs]
    for job, cfg in zip(jobs, cfgs):
        assert job.batch == stat.batch_id
        assert job.result["batch"] == stat.batch_id
        assert job.result["batch_chains"] == 5
        assert job.result["seconds"] == stat.wall_s
        assert len(job.result["waits_all"]) == cfg.n_chains
        assert_same_run(job.result, _solo(cfg))
    want = dict(np.load(FIXTURES / f"experiment_{which}.npz"))
    for k in ("artifacts", "compactness_json", "partisan_json"):
        want.pop(k, None)
    assert_experiment_matches(
        _fixture_arrays(cfgs[0], jobs[0].result, tmp_path), want,
        waits={"dual": "scaled", "kpair": "scaled_ulps"}.get(which, "unit"))


@pytest.mark.parametrize("family", ["frank", "hex"])
def test_batched_run_checkpoints_per_tenant(family, tmp_path):
    """Each tenant of a batch writes its own checkpoint from its sliced
    rows; with the checkpoints on disk a resubmission runs solo (two
    singleton batches) and ends where the batch ended."""
    ck = tmp_path / "ckpt"
    shape = dict(family=family, pop_tol=0.1, total_steps=121, n_chains=2,
                 lattice_m=4, lattice_n=6, checkpoint_every=60)
    cfgs = [ExperimentConfig(alignment=al, base=0.3 + 0.1 * al,
                             seed=3 + al, **shape) for al in (0, 1)]
    svc = SweepService(str(tmp_path / "a"), checkpoint_dir=str(ck),
                       device="cpu")
    jobs = [svc.submit(c) for c in cfgs]
    svc.run_until_idle()
    assert [j.status for j in jobs] == ["done", "done"]
    assert len(svc.batch_stats) == 1
    for cfg in cfgs:
        d = load_checkpoint(str(ck), cfg)
        total = cfg.total_steps - (1 if family == "frank" else 0)
        assert int(d["meta_done"]) == total
        assert int(d["meta_n_parts"]) == -(-total // 60)  # a segment each
        assert d["state_key"].shape == (2, 2)
        assert d["state_key"].dtype == np.uint32
        assert d["hist_cut_count"].shape == (2, total)
    svc2 = SweepService(str(tmp_path / "b"), checkpoint_dir=str(ck),
                        device="cpu")
    again = [svc2.submit(c) for c in cfgs]
    svc2.run_until_idle()
    assert [j.status for j in again] == ["done", "done"]
    assert [s.jobs for s in svc2.batch_stats] == [[j.job_id]
                                                  for j in again]
    for first, second in zip(jobs, again):
        assert "batch" not in second.result
        assert_same_run(second.result, first.result)


def test_jax_checkpoint_resumes_solo(tmp_path):
    """The JAX package's checkpoint after 200 of 401 steps: the job runs
    solo from it (a fresh fingerprint-equal tenant is not coalesced with
    it) and ends where the JAX package's uninterrupted run ends."""
    ck = tmp_path / "ck"
    shutil.copytree(FIXTURES / "experiment_frank_ckpt", ck)
    base_kw = RUNS["frank"][0]
    cfg = ExperimentConfig(**base_kw, checkpoint_every=200)
    fresh = ExperimentConfig(**{**base_kw, "alignment": 1})
    svc = SweepService(str(tmp_path / "out"), checkpoint_dir=str(ck),
                       device="cpu")
    job, other = svc.submit(cfg), svc.submit(fresh)
    svc.run_until_idle()
    assert (job.status, other.status) == ("done", "done")
    assert [s.jobs for s in svc.batch_stats] == [[job.job_id],
                                                 [other.job_id]]
    want = dict(np.load(FIXTURES / "experiment_frank.npz"))
    assert_experiment_matches(_fixture_arrays(cfg, job.result, tmp_path),
                              want)


def test_failed_job_is_marked(tmp_path, monkeypatch, capsys):
    """A job that raises ends 'failed' with its error, no retry, and the
    exit code is 2; the other jobs of the queue still run."""
    kw = dict(RUNS["frank"][0], total_steps=21)
    cfgs = [ExperimentConfig(**kw),
            ExperimentConfig(**{**RUNS["hex"][0], "total_steps": 21})]
    svc = SweepService(str(tmp_path), device="cpu", verbose=True)
    jobs = [svc.submit(c) for c in cfgs]
    orig = drv._init_run

    def broken(cfg, *args):
        if cfg.family == "frank":
            raise RuntimeError("no plan")
        return orig(cfg, *args)
    monkeypatch.setattr(drv, "_init_run", broken)
    svc.run_until_idle()
    assert [j.status for j in jobs] == ["failed", "done"]
    assert jobs[0].error == "RuntimeError: no plan"
    assert svc.exit_code == 2
    out = capsys.readouterr().out
    assert "[failed] j0000 0B30P50 (RuntimeError: no plan)" in out
    assert "[done] j0001" in out
