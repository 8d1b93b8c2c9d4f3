"""Shared comparisons for the tests that hold the PyTorch port against the
JAX package.

Tolerance of every comparison here: integer outputs are bit-equal. Wait
values are bit-equal except where torch's and XLA's f32 ``log`` round the
same input differently, which moves ``floor(log u / log1p(-p))`` across an
integer; such entries are counted, must be at most 1e-3 of all entries,
and each must be off by exactly 1.0. A wait sum may differ by at most the
number of such entries it contains.
"""

import dataclasses

import jax
import numpy as np

from flipcomplexityempirical_tpu_torch.kernel.step import Spec

WAIT_MISMATCH_SHARE = 1e-3


def assert_waits_close(got, want, name="wait"):
    """Per-entry wait comparison under the module's tolerance; returns
    the boolean mask of differing entries."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = got != want
    n_bad = int(bad.sum())
    assert n_bad <= WAIT_MISMATCH_SHARE * got.size, (
        f"{name}: {n_bad} of {got.size} entries differ")
    if n_bad:
        assert (np.abs(got[bad] - want[bad]) == 1.0).all(), (
            name, got[bad], want[bad])
    return bad


def assert_wait_sums_close(got, want, n_bad, name="waits_sum"):
    """Sums of waits: equal where no summed wait differed, else within
    the number of differing waits."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    n_bad = np.broadcast_to(np.asarray(n_bad), got.shape)
    np.testing.assert_array_equal(got[n_bad == 0], want[n_bad == 0],
                                  err_msg=name)
    assert (np.abs(got - want) <= n_bad).all(), name


def uint32_bits(rng, *shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


def jax_host(obj):
    """A JAX pytree as host numpy arrays (what ``convert`` takes)."""
    return jax.tree.map(np.asarray, obj)


def spec_port(spec):
    """The JAX package's Spec as the port's Spec (same fields)."""
    return Spec(**dataclasses.asdict(spec))


def assert_ulps_close(got, want, ulps=4, name="value"):
    """f32 values equal up to ``ulps`` units in the last place, NaN exactly
    where ``want`` is NaN (the interface metrics: torch's and XLA's
    ``acos`` may round the same input differently)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=name)
    g = got[~nan].view(np.int32).astype(np.int64)
    w = want[~nan].view(np.int32).astype(np.int64)
    same = got[~nan] == want[~nan]      # inf == inf, +0 == -0
    assert (same | (np.abs(g - w) <= ulps)).all(), name
