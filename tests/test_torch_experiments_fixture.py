"""The port's experiment driver against the JAX package's, on the CPU.

``tests/fixtures/torch/experiment_frank.npz`` and ``experiment_sec11.npz``
hold what the JAX package's ``run_config`` returns for the Frankengraph
config 0B30P50 and the sec11 config 0B263P10 at 401 steps, 2 chains, seed
0: the end plan, cut_times, part_sum, num_flips, slopes, angles, the wait
totals, every history key, the partisan scores, the final chain state and
the text of ``wait.txt``. ``tests/fixtures/torch/experiment_frank_ckpt/``
is the JAX package's checkpoint directory after the first 200-step segment
of the same Frankengraph config with ``checkpoint_every=200``. The card's
machine has no JAX, so ``chip_smoke.py`` holds the card's run against the
same files.

Regenerate with ``python tests/test_torch_experiments_fixture.py`` (JAX on
the CPU; it renders with matplotlib).

Tolerance: integers bit-equal; slope and angle within 4 ulp, NaN where the
JAX value is NaN; waits under ``_parity``'s log-tie rule (each
differing wait off by exactly 1.0, at most 1e-3 of them), the wait totals
and float state fields within the number of differing waits of their
chain; ``wait.txt`` equal unless a tie was counted in chain 0.
"""

import os
import pathlib
import shutil
import sys
import tempfile

import numpy as np
import pytest
from _parity import assert_experiment_matches, experiment_arrays

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch"
CKPT_DIR = FIXTURES / "experiment_frank_ckpt"
MU = 2.63815853
RUNS = {
    "frank": dict(family="frank", alignment=0, base=0.3, pop_tol=0.5),
    "sec11": dict(family="sec11", alignment=0, base=MU, pop_tol=0.1),
}
SHAPE = dict(total_steps=401, n_chains=2, seed=0)
CKPT_EVERY = 200


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The runs here are small: one intra-op thread is as fast alone and
    keeps parallel test workers from oversubscribing the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fixture_path(which: str) -> pathlib.Path:
    return FIXTURES / f"experiment_{which}.npz"


def _jax_config(which: str, **kw):
    from flipcomplexityempirical_tpu.experiments import ExperimentConfig
    return ExperimentConfig(**RUNS[which], **SHAPE, **kw)


def make_fixture(which: str) -> dict:
    """The JAX package's ``run_config`` of one run, as arrays."""
    from flipcomplexityempirical_tpu.experiments import run_config

    cfg = _jax_config(which)
    with tempfile.TemporaryDirectory() as out:
        data = run_config(cfg, out)
        wait_txt = pathlib.Path(out, cfg.tag + "wait.txt").read_text()
    return experiment_arrays(data, wait_txt)


def make_checkpoint(ckpt_dir) -> None:
    """The JAX package's checkpoint directory after the first segment of
    the Frankengraph run."""
    from flipcomplexityempirical_tpu.experiments import driver as drv

    cfg = _jax_config("frank", checkpoint_every=CKPT_EVERY)
    g, plan, _ = drv.build_graph_and_plan(cfg)
    with pytest.raises(drv._SegmentStop):
        drv._run_jax(cfg, g, plan, checkpoint_dir=str(ckpt_dir),
                     _stop_after_segments=1)


def port_config(which: str, **kw):
    from flipcomplexityempirical_tpu_torch.experiments import (
        ExperimentConfig)
    return ExperimentConfig(**RUNS[which], **SHAPE, **kw)


def port_arrays(cfg, out, **kw) -> dict:
    from flipcomplexityempirical_tpu_torch.experiments import run_config

    data = run_config(cfg, str(out), device="cpu", **kw)
    wait_txt = pathlib.Path(out, cfg.tag + "wait.txt").read_text()
    return experiment_arrays(data, wait_txt)


@pytest.mark.parametrize("which", sorted(RUNS))
def test_run_config_matches_jax(which, tmp_path):
    assert_experiment_matches(port_arrays(port_config(which), tmp_path),
            dict(np.load(fixture_path(which))))


def test_jax_checkpoint_resumes_to_jax_end(tmp_path):
    """The JAX package's checkpoint after one segment resumes in the port
    and ends where the JAX package's uninterrupted run ends."""
    ck = tmp_path / "ck"
    shutil.copytree(CKPT_DIR, ck)
    got = port_arrays(port_config("frank", checkpoint_every=CKPT_EVERY),
                      tmp_path / "out", checkpoint_dir=str(ck))
    assert_experiment_matches(got, dict(np.load(fixture_path("frank"))))


@pytest.mark.slow
@pytest.mark.parametrize("which", sorted(RUNS))
def test_fixture_is_current(which):
    want = dict(np.load(fixture_path(which)))
    got = make_fixture(which)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.slow
def test_checkpoint_fixture_is_current(tmp_path):
    make_checkpoint(tmp_path)
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(CKPT_DIR))
    for name in os.listdir(CKPT_DIR):
        if name.endswith(".npz"):
            got, want = np.load(tmp_path / name), np.load(CKPT_DIR / name)
            assert sorted(got.files) == sorted(want.files), name
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(FIXTURES.parents[2]))
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for name in RUNS:
        path = fixture_path(name)
        np.savez_compressed(path, **make_fixture(name))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    make_checkpoint(CKPT_DIR)
    for p in sorted(CKPT_DIR.iterdir()):
        print(f"wrote {p} ({p.stat().st_size} bytes)")
