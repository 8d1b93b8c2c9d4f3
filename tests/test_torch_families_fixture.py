"""The port's kpair and temper families against the JAX package's driver,
on the CPU.

``tests/fixtures/torch/experiment_kpair.npz`` holds what the JAX
package's ``run_config`` returns for kpair K4 (the k = 4 pair walk on the
16 x 16 rook grid, base 2.63815853, pop_tol 0.5) at 401 steps, 2 chains,
seed 0; ``experiment_temper.npz`` the temper config (the Frankengraph,
betas (1.0, 0.9, 0.8), a swap round every 10 transitions, base 1 / 0.3,
pop_tol 0.1) at 201 steps, 2 ladders, seed 0 (kpair in two 200-step
segments, as its waits' per-chunk f32 sums need for a resume to be bit
for bit; the temper rounds drain their sums alike): the end plan, cut_times,
part_sum, num_flips, the wait totals, every history key, the partisan
scores (temper), the per-rung cut trajectories and swap counts (temper),
the final chain state and the text of ``wait.txt``. The ``*_ckpt``
directories are the JAX package's checkpoint after the first segment of
the same runs (kpair at ``checkpoint_every=200``, temper at 100: the
ladder's betas, swap key, parity and pair counts in its extra_* arrays).
The card's machine has no JAX, so ``chip_smoke.py`` holds the card's runs
against the same files.

Regenerate with ``python tests/test_torch_families_fixture.py`` (JAX on the
CPU, about half a minute; it renders with matplotlib).

Tolerance (``_parity``): integers bit-equal, the per-rung trajectories
and swap counts included; waits under the log-tie rule, its ``scaled``
form for kpair's k = 4 (each differing wait off by exactly 1.0), the
wait totals and float state fields within the number of differing waits
of their chain (kpair's totals, f32 chunk sums of waits ~1e7, within
that many units in the last place of the f32 sum: the ``scaled_ulps``
rule);
``wait.txt`` equal unless a tie was counted in chain 0.
A checkpointed run of the port resumes bit for bit to its uninterrupted
run.
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
MU = 2.63815853
RUNS = {
    # run in two 200-step segments: the f32 per-chunk wait sums of k = 4
    # (waits ~1e7) round differently at other chunk boundaries
    "kpair": dict(family="kpair", n_districts=4, grid=16, alignment=0,
                  base=MU, pop_tol=0.5, total_steps=401,
                  checkpoint_every=200),
    "temper": dict(family="temper", betas=(1.0, 0.9, 0.8), swap_every=10,
                   alignment=0, base=1 / 0.3, pop_tol=0.1, total_steps=201),
}
SHAPE = dict(n_chains=2, seed=0)
CKPT_EVERY = {"kpair": 200, "temper": 100}
WAITS = {"kpair": "scaled_ulps", "temper": "unit"}


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


def ckpt_dir(which: str) -> pathlib.Path:
    return FIXTURES / f"experiment_{which}_ckpt"


def _jax_config(which: str, **kw):
    from flipcomplexityempirical_tpu.experiments import ExperimentConfig
    return ExperimentConfig(**dict(RUNS[which], **kw), **SHAPE)


def make_fixture(which: str) -> dict:
    """The JAX package's ``run_config`` of one run, as arrays."""
    from flipcomplexityempirical_tpu.experiments import run_config

    cfg = _jax_config(which)
    with tempfile.TemporaryDirectory() as out:
        data = run_config(cfg, out)
        wait_txt = pathlib.Path(out, cfg.tag + "wait.txt").read_text()
    return experiment_arrays(data, wait_txt)


def make_checkpoint(which: str, path) -> None:
    """The JAX package's checkpoint directory after the first segment."""
    from flipcomplexityempirical_tpu.experiments import driver as drv

    cfg = _jax_config(which, checkpoint_every=CKPT_EVERY[which])
    g, plan, _ = drv.build_graph_and_plan(cfg)
    run = drv._run_temper if which == "temper" else drv._run_jax
    with pytest.raises(drv._SegmentStop):
        run(cfg, g, plan, checkpoint_dir=str(path), _stop_after_segments=1)


def port_config(which: str, **kw):
    from flipcomplexityempirical_tpu_torch.experiments import (
        ExperimentConfig)
    return ExperimentConfig(**dict(RUNS[which], **kw), **SHAPE)


def port_arrays(cfg, out, **kw) -> dict:
    from flipcomplexityempirical_tpu_torch.experiments import run_config

    data = run_config(cfg, str(out), device="cpu", **kw)
    wait_txt = pathlib.Path(out, cfg.tag + "wait.txt").read_text()
    return experiment_arrays(data, wait_txt)


@pytest.mark.parametrize("which", sorted(RUNS))
def test_run_config_matches_jax(which, tmp_path):
    from flipcomplexityempirical_tpu_torch.experiments import driver
    cfg = port_config(which)
    got = port_arrays(cfg, tmp_path)
    assert_experiment_matches(got, dict(np.load(fixture_path(which))),
                              waits=WAITS[which])
    assert driver.is_done(cfg, str(tmp_path))


@pytest.mark.parametrize("which", sorted(RUNS))
def test_jax_checkpoint_resumes_to_jax_end(which, tmp_path):
    """The JAX package's checkpoint after one segment resumes in the port
    and ends where the JAX package's uninterrupted run ends."""
    ck = tmp_path / "ck"
    shutil.copytree(ckpt_dir(which), ck)
    got = port_arrays(port_config(which, checkpoint_every=CKPT_EVERY[which]),
                      tmp_path / "out", checkpoint_dir=str(ck))
    assert_experiment_matches(got, dict(np.load(fixture_path(which))),
                              waits=WAITS[which])


@pytest.mark.parametrize("which", sorted(RUNS))
def test_port_resume_is_bit_identical(which, tmp_path):
    """The port's own checkpoint: a run stopped after its first segment
    and resumed equals the uninterrupted run bit for bit, artifacts
    included (kpair's uninterrupted run in the same segments)."""
    from flipcomplexityempirical_tpu_torch.experiments import driver as drv

    clean = port_arrays(port_config(which), tmp_path / "a")
    cfg = port_config(which, checkpoint_every=CKPT_EVERY[which])
    ck = str(tmp_path / "ck")
    g, plan, _ = drv.build_graph_and_plan(cfg)
    run = drv._run_temper if which == "temper" else drv._run_torch
    with pytest.raises(drv._SegmentStop):
        run(cfg, g, plan, checkpoint_dir=ck, _stop_after_segments=1,
            device="cpu")
    resumed = port_arrays(cfg, tmp_path / "b", checkpoint_dir=ck)
    assert sorted(resumed) == sorted(clean)
    for k in clean:
        np.testing.assert_array_equal(resumed[k], clean[k], err_msg=k)
    for kind in ("wait.txt", "end.png", "edges.png"):
        assert ((tmp_path / "a" / (cfg.tag + kind)).read_bytes()
                == (tmp_path / "b" / (cfg.tag + kind)).read_bytes()), kind


@pytest.mark.slow
@pytest.mark.parametrize("which", sorted(RUNS))
def test_fixture_is_current(which, tmp_path):
    want = dict(np.load(fixture_path(which)))
    got = make_fixture(which)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    make_checkpoint(which, tmp_path)
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(ckpt_dir(which)))


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(FIXTURES.parents[2]))
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for name in RUNS:
        path = fixture_path(name)
        np.savez_compressed(path, **make_fixture(name))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
        shutil.rmtree(ckpt_dir(name), ignore_errors=True)
        make_checkpoint(name, ckpt_dir(name))
        for p in sorted(ckpt_dir(name).iterdir()):
            print(f"wrote {p} ({p.stat().st_size} bytes)")
