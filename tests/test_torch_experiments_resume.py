"""Segmented runs of the port's experiment driver: resume and rejection.

Every run is on the CPU (``device="cpu"``, the kernel's plain version).
Tolerance: a resumed run equals the uninterrupted run bit for bit in
every history key, every state field, the wait totals and the finalised
accumulators.
"""

import os

import numpy as np
import pytest

from flipcomplexityempirical_tpu_torch.experiments import (
    CheckpointIdentityError, ExperimentConfig, load_checkpoint, run_config)
from flipcomplexityempirical_tpu_torch.experiments import driver as drv

FRANK = dict(family="frank", alignment=0, base=0.3, pop_tol=0.5, n_chains=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The runs here are small: one intra-op thread is as fast alone and
    keeps parallel test workers from oversubscribing the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_runs_equal(a: dict, b: dict) -> None:
    assert sorted(a["history"]) == sorted(b["history"])
    for k in a["history"]:
        np.testing.assert_array_equal(a["history"][k], b["history"][k],
                                      err_msg=k)
    assert sorted(a["state"]) == sorted(b["state"])
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)
    for k in ("waits_all", "part_sum", "num_flips", "cut_times",
              "end_signed", "assignments", "slopes", "angles"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mid_config_resume_is_bit_identical(tmp_path):
    """A crash between checkpoint segments resumes exactly: the
    interrupted and resumed run reproduces the uninterrupted,
    unsegmented run bit for bit."""
    kw = dict(FRANK, total_steps=241)
    clean = run_config(ExperimentConfig(**kw), str(tmp_path / "a"),
                       device="cpu")
    cfg = ExperimentConfig(**kw, checkpoint_every=100)
    ck = str(tmp_path / "ck")
    g, plan, _ = drv.build_graph_and_plan(cfg)
    with pytest.raises(drv._SegmentStop):
        drv._run_torch(cfg, g, plan, checkpoint_dir=ck,
                       _stop_after_segments=1, device="cpu")
    partial = load_checkpoint(ck, cfg)
    assert int(partial["meta_done"]) == 100
    assert partial["state_key"].dtype == np.uint32
    assert partial["hist_cut_count"].shape == (2, 100)
    resumed = run_config(cfg, str(tmp_path / "b"), checkpoint_dir=ck,
                         device="cpu")
    assert_runs_equal(clean, resumed)
    for kind in ("wait.txt", "end.png", "slope.png"):
        assert ((tmp_path / "a" / (cfg.tag + kind)).read_bytes()
                == (tmp_path / "b" / (cfg.tag + kind)).read_bytes()), kind


def test_checkpoint_mismatch_and_stale_formats_ignored(tmp_path):
    """Resume never crashes on, or silently reuses, an incompatible
    checkpoint: a wrong config identity, a too-long run or an old format
    start fresh; a checkpoint missing a state field of this run's state
    raises CheckpointIdentityError."""
    ck = str(tmp_path / "ck")
    cfg = ExperimentConfig(**FRANK, total_steps=41)
    data = run_config(cfg, str(tmp_path / "o1"), checkpoint_dir=ck,
                      device="cpu")
    assert load_checkpoint(ck, cfg) is not None
    # different seed => identity mismatch => fresh start
    assert load_checkpoint(ck, ExperimentConfig(**FRANK, total_steps=41,
                                                seed=9)) is None
    # shorter rerun than the checkpoint => ignored
    assert load_checkpoint(ck, ExperimentConfig(**FRANK,
                                                total_steps=21)) is None
    # a main file without the state field the template needs
    main = os.path.join(ck, cfg.tag + ".npz")
    d = dict(np.load(main))
    del d["state_cut_times_se"]
    os.remove(os.path.join(ck, cfg.tag + ".manifest.json"))
    np.savez(main, **d)
    with pytest.raises(CheckpointIdentityError, match="cut_times_se"):
        run_config(cfg, str(tmp_path / "o2"), checkpoint_dir=ck,
                   device="cpu")
    # pre-versioned format (bare field names) => ignored, fresh run
    np.savez(main, board=data["state"]["board"])
    assert load_checkpoint(ck, cfg) is None
    run2 = run_config(cfg, str(tmp_path / "o3"), checkpoint_dir=ck,
                      device="cpu")
    assert_runs_equal(data, run2)


def test_corrupt_newest_generation_falls_back_one(tmp_path, capsys):
    ck = tmp_path / "ck"
    cfg = ExperimentConfig(**FRANK, total_steps=41, checkpoint_every=10)
    g, plan, _ = drv.build_graph_and_plan(cfg)
    with pytest.raises(drv._SegmentStop):
        drv._run_torch(cfg, g, plan, checkpoint_dir=str(ck),
                       _stop_after_segments=2, device="cpu")
    main = ck / (cfg.tag + ".npz")
    main.write_bytes(main.read_bytes()[:100])       # a torn write
    loaded = load_checkpoint(str(ck), cfg)
    assert int(loaded["meta_done"]) == 10            # generation 0
    assert "generation 1 corrupt" in capsys.readouterr().out
    assert sorted(os.listdir(ck / ".corrupt")) == [
        f"g0001.{cfg.tag}.h0001.npz", f"g0001.{cfg.tag}.npz"]
    resumed = run_config(cfg, str(tmp_path / "b"), checkpoint_dir=str(ck),
                         device="cpu")
    clean = run_config(ExperimentConfig(**FRANK, total_steps=41),
                       str(tmp_path / "a"), device="cpu")
    assert_runs_equal(clean, resumed)
