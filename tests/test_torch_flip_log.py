"""The port's ``apply_flip_log`` (sort + integer scatters) against the JAX
package's (sort + one-hot matmul histogram), on random logs with -1 rows,
over one chunk and over two composed chunks. Exact: every output
bit-equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flipcomplexityempirical_tpu.kernel import board as kb
from flipcomplexityempirical_tpu_torch.kernel import board as tb


def _random_log(rng, tlen, c, n, p_accept=0.4, p_none=0.2):
    """A log shaped like the chain's: the pointer holds between accepts,
    each accept moves it to a node and flips that node's sign; a chain
    may start with no pointer (f = -1 rows)."""
    log_f = np.full((tlen, c), -1, np.int32)
    log_s = np.ones((tlen, c), np.int32)
    node_sign = {}
    for ci in range(c):
        f = -1 if rng.random() < p_none else int(rng.integers(n))
        if f >= 0:
            node_sign[(ci, f)] = int(rng.choice([-1, 1]))
        for r in range(tlen):
            if rng.random() < p_accept:
                f = int(rng.integers(n))
                node_sign[(ci, f)] = -node_sign.get((ci, f), -1)
            if f >= 0:
                log_f[r, ci] = f
                log_s[r, ci] = node_sign[(ci, f)]
    return log_f, log_s


def _carry(rng, c, n, t0):
    ps = rng.integers(-50, 50, size=(c, n)).astype(np.int32)
    lf = np.minimum(rng.integers(0, 200, size=(c, n)), t0[:, None])
    nf = rng.integers(0, 9, size=(c, n)).astype(np.int32)
    return ps, lf.astype(np.int32), nf


def _jax(carry, log_f, log_s, t0):
    out = kb.apply_flip_log(*(jnp.asarray(x) for x in carry),
                            jnp.asarray(log_f), jnp.asarray(log_s),
                            jnp.asarray(t0))
    return [np.asarray(x) for x in out]


def _port(carry, log_f, log_s, t0):
    out = tb.apply_flip_log(*(torch.from_numpy(x) for x in carry),
                            torch.from_numpy(log_f), torch.from_numpy(log_s),
                            torch.from_numpy(t0))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("tlen,c,n", [(60, 5, 12), (120, 6, 300)])
def test_single_chunk_matches_jax(tlen, c, n):
    rng = np.random.default_rng(tlen + n)
    log_f, log_s = _random_log(rng, tlen, c, n)
    t0 = rng.integers(0, 500, size=c).astype(np.int32)
    carry = _carry(rng, c, n, t0)
    for name, w_arr, g_arr in zip(("part_sum", "last_flipped", "num_flips"),
                                  _jax(carry, log_f, log_s, t0),
                                  _port(carry, log_f, log_s, t0)):
        assert g_arr.dtype == np.int32, name
        np.testing.assert_array_equal(g_arr, w_arr, err_msg=name)


@pytest.mark.parametrize("cut", [1, 17, 49])
def test_two_composed_chunks_match_jax(cut):
    rng = np.random.default_rng(cut)
    tlen, c, n = 50, 4, 10
    log_f, log_s = _random_log(rng, tlen, c, n)
    t0 = np.asarray([0, 3, 7, 100], np.int32)
    carry = _carry(rng, c, n, t0)
    whole = _jax(carry, log_f, log_s, t0)
    first = _port(carry, log_f[:cut], log_s[:cut], t0)
    second = _port(first, log_f[cut:], log_s[cut:], t0 + cut)
    for w_arr, g_arr in zip(whole, second):
        np.testing.assert_array_equal(g_arr, w_arr)
