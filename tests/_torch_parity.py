"""Shared helpers for the tests that hold the PyTorch port against the
JAX package: the comparisons of ``_parity`` (numpy only, where their
tolerance is stated) and the JAX-side conversions.
"""

import dataclasses

import jax
import numpy as np
from _parity import (WAIT_MISMATCH_SHARE, assert_ulps_close,  # noqa: F401
                     assert_wait_sums_close, assert_waits_close)

from flipcomplexityempirical_tpu_torch.kernel.step import Spec


def uint32_bits(rng, *shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)


def jax_host(obj):
    """A JAX pytree as host numpy arrays (what ``convert`` takes)."""
    return jax.tree.map(np.asarray, obj)


def spec_port(spec):
    """The JAX package's Spec as the port's Spec (same fields)."""
    return Spec(**dataclasses.asdict(spec))
