"""The port's experiment driver on the general path's new families
against the JAX package's, on the CPU: the dual family (K4, the
k-district pair walk on boundary length, a 12 x 12 synthetic precinct
map) and sec11 with the ``nobacktrack`` proposal variant (the dense body
with the interface metrics).

``tests/fixtures/torch/experiment_dual.npz`` and
``experiment_sec11_nobacktrack.npz`` hold what the JAX package's
``run_config`` returns for dual-K4-0B263P25 and sec11 0B263P10 with
``variant='nobacktrack'`` at 401 steps, 2 chains, seed 0 (the keys of
``_parity.experiment_arrays``; the dual one adds the text of its
``compactness.json`` and ``partisan.json``). The card's machine has no
JAX, so ``chip_smoke.py`` holds the card's runs against the same files.
Regenerate with ``python tests/test_torch_general_experiments.py`` (JAX
on the CPU). Tolerance: ``_parity.assert_experiment_matches``, the dual
run's waits (~6e6: n**k - 1 at k = 4) under its ``scaled`` wait rule.
"""

import os
import pathlib
import sys
import tempfile

import numpy as np
import pytest
from _parity import assert_experiment_matches, experiment_arrays

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch"
MU = 2.63815853
RUNS = {
    "dual": dict(family="dual", alignment=0, base=MU, pop_tol=0.25,
                 n_districts=4),
    "sec11_nobacktrack": dict(family="sec11", alignment=0, base=MU,
                              pop_tol=0.1, variant="nobacktrack"),
}
SHAPE = dict(total_steps=401, n_chains=2, seed=0)
JSON = ("compactness.json", "partisan.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fixture_path(which: str) -> pathlib.Path:
    return FIXTURES / f"experiment_{which}.npz"


def _arrays(data, cfg, out) -> dict:
    arrays = experiment_arrays(
        data, pathlib.Path(out, cfg.tag + "wait.txt").read_text())
    if cfg.family == "dual":
        for kind in JSON:
            arrays[kind.replace(".", "_")] = np.asarray(
                pathlib.Path(out, cfg.tag + kind).read_text())
    return arrays


def make_fixture(which: str) -> dict:
    """The JAX package's ``run_config`` of one run, as arrays."""
    from flipcomplexityempirical_tpu.experiments import (ExperimentConfig,
                                                         run_config)
    cfg = ExperimentConfig(**RUNS[which], **SHAPE)
    with tempfile.TemporaryDirectory() as out:
        return _arrays(run_config(cfg, out), cfg, out)


def port_arrays(which: str, out, **kw) -> dict:
    from flipcomplexityempirical_tpu_torch.experiments import (
        ExperimentConfig, run_config)
    cfg = ExperimentConfig(**RUNS[which], **SHAPE)
    return _arrays(run_config(cfg, str(out), device="cpu", **kw), cfg, out)


@pytest.mark.parametrize("which", sorted(RUNS))
def test_run_config_matches_jax(which, tmp_path):
    assert_experiment_matches(port_arrays(which, tmp_path),
                              dict(np.load(fixture_path(which))),
                              waits="scaled" if which == "dual" else "unit")


def test_summary_mode_writes_the_history_artifacts(tmp_path):
    """sec11 ``nobacktrack`` in summary mode (the chunk's rows folded, chain
    0's slope and angle series kept by the fold) writes the history
    mode's 13 artifacts byte for byte."""
    from flipcomplexityempirical_tpu_torch.experiments import (
        ExperimentConfig, run_config)
    files = {}
    for mode in ("history", "summary"):
        cfg = ExperimentConfig(**RUNS["sec11_nobacktrack"], **SHAPE,
                               analytics=mode)
        out = tmp_path / mode
        run_config(cfg, str(out), device="cpu")
        files[mode] = {p.name: p.read_bytes() for p in out.iterdir()}
    assert len(files["history"]) == 13
    assert files["summary"] == files["history"]


@pytest.mark.parametrize("which", sorted(RUNS))
def test_fixture_is_current(which):
    want = dict(np.load(fixture_path(which)))
    got = make_fixture(which)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(FIXTURES.parents[2]))
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for name in RUNS:
        path = fixture_path(name)
        np.savez_compressed(path, **make_fixture(name))
        print(f"wrote {path} ({path.stat().st_size} bytes)")
