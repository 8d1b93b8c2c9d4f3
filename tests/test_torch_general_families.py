"""The port's experiment driver on the triangular and hexagonal families
against the JAX package's, on the CPU.

``tests/fixtures/torch/experiment_<run>.npz`` hold what the JAX package's
``run_config`` returns for four configs at 300 steps, 3 chains, a 6 x 10
lattice, seed 0, alignment 0, base 1/0.3, pop_tol 0.1: the tri family (the
lowered board path), the hex family (the general path's dense body), hex
with the ``nobacktrack`` variant and hex with ``contiguity='exact'`` (the
legacy body). Each holds the end plan, cut_times, part_sum, num_flips,
the wait totals, every history key, the partisan scores, the final chain
state, the text of ``wait.txt`` and the artifact names.
``tests/fixtures/torch/experiment_hex_ckpt/`` is the JAX package's
checkpoint directory after the first 150-step segment of the hex config
with ``checkpoint_every=150``. The card's machine has no JAX, so
``chip_smoke.py`` holds the card's runs against the same files.

Regenerate with ``python tests/test_torch_general_families.py`` (JAX on
the CPU; it renders with matplotlib).

Tolerance (``_parity.assert_experiment_matches``): integers bit-equal;
waits under the log-tie rule, the wait totals and float state fields
within the number of differing waits of their chain.
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
CKPT_DIR = FIXTURES / "experiment_hex_ckpt"
SHAPE = dict(alignment=0, base=1 / 0.3, pop_tol=0.1, total_steps=300,
             n_chains=3, lattice_m=6, lattice_n=10, seed=0)
RUNS = {
    "tri": dict(family="tri"),
    "hex": dict(family="hex"),
    "hex_nobacktrack": dict(family="hex", variant="nobacktrack"),
    "hex_exact": dict(family="hex", contiguity="exact"),
}
CKPT_EVERY = 150


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def port_config(which: str, **kw):
    from flipcomplexityempirical_tpu_torch.experiments import (
        ExperimentConfig)
    return ExperimentConfig(**RUNS[which], **SHAPE, **kw)


def _with_files(arrays: dict, out) -> dict:
    arrays["artifacts"] = np.array(sorted(os.listdir(out)))
    return arrays


def make_fixture(which: str) -> dict:
    """The JAX package's ``run_config`` of one run, as arrays."""
    from flipcomplexityempirical_tpu.experiments import run_config

    cfg = _jax_config(which)
    with tempfile.TemporaryDirectory() as out:
        data = run_config(cfg, out)
        wait_txt = pathlib.Path(out, cfg.tag + "wait.txt").read_text()
        return _with_files(experiment_arrays(data, wait_txt), out)


def make_checkpoint(ckpt_dir) -> None:
    """The JAX package's checkpoint directory after the first segment of
    the hex run."""
    from flipcomplexityempirical_tpu.experiments import driver as drv

    cfg = _jax_config("hex", checkpoint_every=CKPT_EVERY)
    g, plan, _ = drv.build_graph_and_plan(cfg)
    with pytest.raises(drv._SegmentStop):
        drv._run_jax(cfg, g, plan, checkpoint_dir=str(ckpt_dir),
                     _stop_after_segments=1)


def port_arrays(cfg, out, **kw) -> dict:
    from flipcomplexityempirical_tpu_torch.experiments import run_config

    data = run_config(cfg, str(out), device="cpu", **kw)
    wait_txt = pathlib.Path(out, cfg.tag + "wait.txt").read_text()
    return _with_files(experiment_arrays(data, wait_txt), out)


def _matches(got: dict, want: dict) -> None:
    np.testing.assert_array_equal(got.pop("artifacts"),
                                  want.pop("artifacts"))
    assert_experiment_matches(got, want)


@pytest.mark.parametrize("which", sorted(RUNS))
def test_run_config_matches_jax(which, tmp_path):
    got = port_arrays(port_config(which), tmp_path)
    want = dict(np.load(fixture_path(which)))
    assert len(want["artifacts"]) == 7
    _matches(got, want)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's checkpoint after one segment resumes in the port
    and ends where the JAX package's uninterrupted run ends."""
    ck = tmp_path / "ck"
    shutil.copytree(CKPT_DIR, ck)
    got = port_arrays(port_config("hex", checkpoint_every=CKPT_EVERY),
                      tmp_path / "out", checkpoint_dir=str(ck))
    _matches(got, dict(np.load(fixture_path("hex"))))


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The port's checkpoint after one segment resumes in the JAX package
    and ends where the JAX package's uninterrupted run ends."""
    from flipcomplexityempirical_tpu.experiments import driver as jdrv
    from flipcomplexityempirical_tpu_torch.experiments import driver as pdrv

    ck = str(tmp_path / "ck")
    cfg = port_config("hex", checkpoint_every=CKPT_EVERY)
    g, plan, _ = pdrv.build_graph_and_plan(cfg)
    with pytest.raises(pdrv._SegmentStop):
        pdrv._run_torch(cfg, g, plan, checkpoint_dir=ck,
                        _stop_after_segments=1, device="cpu")
    jcfg = _jax_config("hex", checkpoint_every=CKPT_EVERY)
    jg, jplan, _ = jdrv.build_graph_and_plan(jcfg)
    data = jdrv._run_jax(jcfg, jg, jplan, checkpoint_dir=ck)
    data["partisan"] = jdrv._partisan_summary(jcfg, jg, data)
    want = dict(np.load(fixture_path("hex")))
    want.pop("artifacts")
    got = experiment_arrays(data, str(want["wait_txt"]))
    assert_experiment_matches(got, want)


def test_refusals_name_their_item():
    """What is still refused names its item; the kpair and temper families
    (ROADMAP.md A7b, A8) and the ReCom chain (A9) now have their Specs,
    the JAX driver's."""
    from flipcomplexityempirical_tpu.experiments import driver as jdriver
    from flipcomplexityempirical_tpu.experiments.config import (
        ExperimentConfig as JConfig)
    from flipcomplexityempirical_tpu_torch.experiments import (
        ExperimentConfig, driver)
    from _torch_parity import spec_port
    for kw, item in ((dict(family="dual", n_districts=4,
                           variant="nobacktrack"), "2-district 'bi' walk"),
                     (dict(family="temper"), None),
                     (dict(family="tri", chain="recom"), None),
                     (dict(family="kpair"), None)):
        cfg = ExperimentConfig(alignment=0, base=1.0, pop_tol=0.1, **kw)
        if item is None:
            want = jdriver.spec_for(JConfig(alignment=0, base=1.0,
                                            pop_tol=0.1, **kw))
            assert driver.spec_for(cfg) == spec_port(want), kw
            continue
        with pytest.raises(ValueError, match=item):
            driver.spec_for(cfg)


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
