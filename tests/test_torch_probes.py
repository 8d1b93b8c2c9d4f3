"""The port's toolchain probes against the JAX package's Mosaic probes.

``tools/mosaic_probes.py`` holds two Pallas kernels, ``kA`` and ``kB``;
here they run through ``pl.pallas_call`` in TPU interpret mode on the
CPU, and the port's plain probes (``kernel/probes.py``) run on CPU
tensors. Tolerance: exact.

- Probe B does not depend on the random bits (``bits | 1`` is never 0),
  so the plain version with Philox bits must equal ``kB`` row for row.
- Probe A does: interpret mode's PRNG gives ``kA`` all-zero bits, which
  sum four row maxima of INT32_MIN to 0 on every row. The plain version
  fed zero host bits must give the same. With Philox bits it is held
  against a numpy computation from the same words.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flipcomplexityempirical_tpu_torch import rng
from flipcomplexityempirical_tpu_torch.kernel import probes

TOOL = (pathlib.Path(__file__).resolve().parent.parent / "tools"
        / "mosaic_probes.py")


@pytest.fixture(scope="module")
def tool():
    # importing runs the tool's own launches, which print FAIL on the CPU
    spec = importlib.util.spec_from_file_location("mosaic_probes", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(kernel, x: np.ndarray) -> np.ndarray:
    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((1, x.shape[0]), jnp.int32),
        interpret=pltpu.InterpretParams())(jnp.asarray(x))
    return np.asarray(out)[0]


def _x(seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    x = r.integers(-3, 4, (probes.ROWS, probes.COLS)).astype(np.int32)
    x[::6] = 0          # rows with no valid entry
    x[1::6] = -1
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_probe_b_matches_pallas_kB(tool, seed):
    x = _x(seed)
    want = _interpret(tool.kB, x)
    got = probes.probe_b(torch.from_numpy(x), probes.STEPS, probes.SEED)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[::6] == 0).all() and (want[2::6] == probes.STEPS).all()


def test_plain_probe_a_zero_bits_matches_pallas_kA(tool):
    x = _x(2)
    want = _interpret(tool.kA, x)
    zero = torch.zeros((probes.STEPS, *x.shape), dtype=torch.int32)
    got = probes.probe_a(torch.from_numpy(x), probes.STEPS, probes.SEED,
                         zero)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,cols,steps", [(128, 128, 4), (5, 37, 3)])
def test_plain_probe_a_matches_numpy(rows, cols, steps):
    x = torch.zeros((rows, cols), dtype=torch.int32)
    words = np.stack([
        rng.philox_plane(9, 0, t, rows, cols, "cpu",
                         stream=rng.STREAM_PROBE).numpy().astype(np.uint32)
        for t in range(steps)])
    signed = (words ^ np.uint32(0x80000000)).view(np.int32)
    want = np.zeros(rows, np.int32)
    with np.errstate(over="ignore"):
        for t in range(steps):
            want = want + signed[t].max(axis=1)   # wrapping int32 adds
    np.testing.assert_array_equal(probes.probe_a(x, steps, 9).numpy(), want)
    host = torch.from_numpy(words.view(np.int32))
    np.testing.assert_array_equal(probes.probe_a(x, steps, 9, host).numpy(),
                                  want)


def test_cpu_calls_count_no_launches_and_inputs_are_checked():
    x = torch.ones((4, 8), dtype=torch.int32)
    before = (probes.probe_a.launches, probes.probe_b.launches)
    probes.probe_a(x, 2, 1)
    probes.probe_b(x, 2, 1)
    assert (probes.probe_a.launches, probes.probe_b.launches) == before
    with pytest.raises(ValueError):
        probes.probe_a(x.to(torch.int64), 2, 1)
    with pytest.raises(ValueError):
        probes.probe_b(x, 2, 1, torch.zeros((3, 4, 8), dtype=torch.int32))


def test_entry_point_runs_on_the_cpu_when_asked(capsys):
    probes.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [probes.NAMES["a"],
                                                  probes.NAMES["b"]]
    assert all(": OK" in ln for ln in lines)
