"""Summary mode end to end on the CPU: the port's ``run_config`` with
``analytics='summary'`` against its own history mode and against the JAX
package's driver in summary mode, the JAX driver's refusals, the CLI flag
and a summary sweep through the service (``bench --ess`` is in
``test_torch_bench.py``).

``tests/fixtures/torch/summary_driver.npz`` holds what the JAX package's
``run_config`` returns in summary mode for sec11 0B263P10 (401 steps, 2
chains, the ``experiment_sec11.npz`` run) and hex-0B333P10 on a 6x10
lattice (300 steps, 3 chains, the ``experiment_hex.npz`` run): every
field of ``data["summary"]``, ``readback_bytes`` and the series kept in
``data["history"]``. Regenerate with ``python
tests/test_torch_analytics_driver.py`` (JAX on the CPU).

Tolerance: the port's two modes write byte-equal artifacts and equal
trajectories. Against the JAX driver: n, kept, stride and accepts
bit-equal; mean to rtol 1e-6 and m2 to rtol 1e-5 (the JAX tests' bars,
``tests/test_accumulators.py``: XLA may fuse the float32 fold); the
wait-weighted fields the same where no wait of the run differs (the
``_parity`` log-tie rule), and the series within 4 ulp with NaN where
the JAX value is NaN.
"""

import dataclasses
import hashlib
import os
import pathlib
import tempfile

import numpy as np
import pytest
import torch
from _parity import assert_ulps_close, assert_waits_close

from flipcomplexityempirical_tpu_torch.experiments import __main__ as tcli
from flipcomplexityempirical_tpu_torch.experiments import config as tconfig
from flipcomplexityempirical_tpu_torch.experiments import driver as tdriver
from flipcomplexityempirical_tpu_torch.service import SweepService
from flipcomplexityempirical_tpu_torch.service import queue as tqueue
from flipcomplexityempirical_tpu_torch.stats import accumulators as tacc

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures" / "torch"
           / "summary_driver.npz")
MU = 2.63815853
RUNS = {
    "sec11": dict(family="sec11", alignment=0, base=MU, pop_tol=0.1,
                  total_steps=401, n_chains=2, seed=0),
    "hex": dict(family="hex", alignment=0, base=1 / 0.3, pop_tol=0.1,
                total_steps=300, n_chains=3, lattice_m=6, lattice_n=10,
                seed=0),
}
HISTORY_FIXTURE = {"sec11": "experiment_sec11.npz",
                   "hex": "experiment_hex.npz"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_fixture() -> dict:
    """The JAX package's summary-mode ``run_config`` of both runs."""
    from flipcomplexityempirical_tpu.experiments import (ExperimentConfig,
                                                         run_config)
    out = {}
    for which, kw in RUNS.items():
        with tempfile.TemporaryDirectory() as tmp:
            data = run_config(ExperimentConfig(analytics="summary", **kw),
                              tmp)
        for k, v in data["summary"].items():
            out[f"{which}_{k}"] = np.asarray(v)
        out[f"{which}_readback_bytes"] = np.asarray(data["readback_bytes"])
        for k, v in data["history"].items():
            out[f"{which}_hist_{k}"] = np.asarray(v)
    return out


def _digests(out, tag) -> dict:
    return {n: hashlib.sha256((pathlib.Path(out) / n).read_bytes())
            .hexdigest() for n in sorted(os.listdir(out))
            if n.startswith(tag)}


def _run(which, out, analytics):
    cfg = tconfig.ExperimentConfig(analytics=analytics, **RUNS[which])
    data = tdriver.run_config(cfg, str(out), device="cpu")
    return cfg, data


@pytest.mark.parametrize("which", sorted(RUNS))
def test_summary_run_config_matches_history_and_jax(which, tmp_path):
    cfg, hist = _run(which, tmp_path / "history", "history")
    _, summ = _run(which, tmp_path / "summary", "summary")
    # the port's two modes: the same artifacts, byte for byte, and the
    # same trajectory
    got_files = _digests(tmp_path / "summary", cfg.tag)
    assert got_files == _digests(tmp_path / "history", cfg.tag)
    assert len(got_files) == (13 if which == "sec11" else 7)
    for k in ("end_signed", "cut_times", "part_sum", "num_flips",
              "assignments", "waits_all"):
        np.testing.assert_array_equal(summ[k], hist[k], err_msg=k)
    assert sorted(summ["history"]) == (["angle", "slope"]
                                       if which == "sec11" else [])
    # the summary equals the plain fold of the history-mode rows
    rows = {k: torch.as_tensor(hist["history"][k]).T.contiguous()
            for k in ("cut_count", "wait", "accepts")}
    ref = tacc.summary_host(tacc.fold_block(
        tacc.init_summary(cfg.n_chains), rows))
    for k in tacc.SUMMARY_FIELDS:
        np.testing.assert_array_equal(summ["summary"][k], ref[k],
                                      err_msg=k)
    # against the JAX driver's summary mode
    want = np.load(FIXTURE)
    jhist = np.load(FIXTURE.parent / HISTORY_FIXTURE[which])
    n_bad = assert_waits_close(hist["history"]["wait"],
                               jhist["hist_wait"]).sum()
    s = summ["summary"]
    for k in ("n", "kept", "stride", "accepts"):
        np.testing.assert_array_equal(s[k], want[f"{which}_{k}"],
                                      err_msg=k)
    np.testing.assert_allclose(s["mean"], want[f"{which}_mean"], rtol=1e-6)
    np.testing.assert_allclose(s["m2"], want[f"{which}_m2"], rtol=1e-5)
    if n_bad == 0:
        np.testing.assert_array_equal(s["waits"], want[f"{which}_waits"])
        np.testing.assert_array_equal(s["wsum"], want[f"{which}_wsum"])
        np.testing.assert_allclose(s["wmean"], want[f"{which}_wmean"],
                                   rtol=1e-6)
        np.testing.assert_allclose(s["wm2"], want[f"{which}_wm2"],
                                   rtol=1e-5)
    assert summ["readback_bytes"] == int(want[f"{which}_readback_bytes"])
    for k, v in summ["history"].items():
        assert_ulps_close(v, want[f"{which}_hist_{k}"], name=k)


@pytest.mark.parametrize("kw, words", [
    (dict(record_every=2), "record_every > 1 only thins"),
    (dict(chain="recom"), "the recom chain stays on the"),
], ids=["record_every", "recom"])
def test_summary_refusals_keep_jax_words(kw, words, tmp_path):
    cfg = tconfig.ExperimentConfig(analytics="summary", **dict(
        RUNS["sec11"], total_steps=41), **kw)
    with pytest.raises(ValueError, match=words):
        tdriver.run_config(cfg, str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)


def test_summary_refuses_a_checkpoint_dir(tmp_path):
    cfg = tconfig.ExperimentConfig(analytics="summary", **dict(
        RUNS["sec11"], total_steps=41))
    with pytest.raises(ValueError, match="no host history to checkpoint"):
        tdriver.run_config(cfg, str(tmp_path / "out"),
                           checkpoint_dir=str(tmp_path / "ck"), device="cpu")


def test_cli_analytics_summary(tmp_path, capsys):
    out = tmp_path / "out"
    tcli.main(["--family", "frank", "--only", "0B30P50", "--out", str(out),
               "--steps", "60", "--chains", "2", "--analytics", "summary",
               "--device", "cpu"])
    assert capsys.readouterr().out.startswith("[done] frank 0B30P50")
    assert len(os.listdir(out)) == 13


def test_service_summary_sweep_is_one_batch(tmp_path):
    """A frank summary sweep coalesces into one batch (its fingerprint
    apart from history-mode jobs) and each tenant equals its solo
    history-mode run, as the JAX service runs such a batch."""
    shape = dict(total_steps=40, n_chains=2)
    svc = SweepService(str(tmp_path / "svc"), device="cpu")
    cfgs = list(tconfig.frank_sweep(analytics="summary", **shape))[:4]
    jobs = [svc.submit(c) for c in cfgs]
    assert dataclasses.replace(cfgs[0], analytics="history").fingerprint() \
        != cfgs[0].fingerprint()
    svc.run_until_idle()
    assert len(svc.batch_stats) == 1 and svc.batch_stats[0].chains == 8
    for job, cfg in zip(jobs, cfgs):
        assert job.status == tqueue.DONE, job.error
        solo = tdriver._run_torch(
            dataclasses.replace(cfg, analytics="history"),
            *tdriver.build_graph_and_plan(cfg)[:2], device="cpu")
        for k in ("end_signed", "cut_times", "part_sum", "num_flips",
                  "waits_all", "assignments"):
            np.testing.assert_array_equal(job.result[k], solo[k], err_msg=k)
        for k, v in solo["history"].items():
            np.testing.assert_array_equal(job.result["history"][k], v,
                                          err_msg=k)


if __name__ == "__main__":
    arrays = make_fixture()
    np.savez_compressed(FIXTURE, **arrays)
    print(f"wrote {FIXTURE}: {sorted(arrays)}")
