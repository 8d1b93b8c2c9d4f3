"""Counter-based random bits in torch integer ops.

Two generators live here:

- **threefry2x32**, bit-equal to ``jax.random`` on raw ``uint32[2]`` keys
  with ``jax_threefry_partitionable=True`` (the default of JAX 0.9):
  ``prng_key``, ``split`` and ``uniform`` reproduce ``PRNGKey``,
  ``split`` and the scalar f32 ``uniform``. The board path draws the
  final record's geometric wait through them (``board.record_final``),
  and ``init_board_state`` seeds the per-chain keys with them.
  ``random_bits``, ``uniform_n``, ``permutation`` and ``gumbel`` are
  the array draws of ReCom (``sampling/recom.py``): ``jax.random.bits``,
  ``uniform`` (with ``minval`` / ``maxval``), ``permutation`` of a range
  and ``gumbel`` (low mode) over a shape, bit for bit.
- **Philox4x32-10**, the generator written into the CUDA kernels
  (``csrc/board_chunk.cu``, ``csrc/probes.cu``). ``philox4x32`` is its
  torch twin, so the kernels' plain versions reproduce the device-RNG
  mode bit for bit.

torch's ``uint32`` support is thin, so every word is held in an int64
tensor with values in [0, 2**32) and every operation masks back to 32
bits; 32x32-bit products are split into 16-bit halves so no intermediate
leaves the int64 range.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF

_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85

# the kernels' stream words (the fourth counter word): one stream for the
# board kernel's proposal bit plane, one for its two per-step scalars
# (wait, accept), one for the probe kernels' bit planes
STREAM_PLANE = 0
STREAM_SCALARS = 1
STREAM_PROBE = 2


def _u32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    dev = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.int64, device=dev) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block of JAX's ``threefry2x32_p``:
    key words (k0, k1), counter words (x0, x1), all broadcastable int64
    tensors holding uint32 values. Returns the two output words."""
    k0, k1 = _u32(k0), _u32(k1)
    x0, x1 = _u32(x0), _u32(x1)
    ks = (k0, k1, (k0 ^ k1 ^ _THREEFRY_PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _THREEFRY_ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 (2,) tensor: the high word
    of a 32-bit seed is 0, the low word is the seed's two's complement."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def split(keys: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split`` over a batch of raw keys: (..., 2) ->
    (..., num, 2). Partitionable threefry: key i is the block of counter
    (0, i)."""
    b0, b1 = blocks(keys[..., None, :], range(num))
    return torch.stack([b0, b1], dim=-1)


def _blocks(keys: torch.Tensor, ctr: torch.Tensor) -> tuple:
    keys = _u32(keys)
    ctr = _u32(ctr, keys)
    return threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(ctr),
                        ctr)


def blocks(keys: torch.Tensor, ctr) -> tuple:
    """The two words of each key's threefry block at counter (0, ctr):
    (..., 2) keys against broadcastable counters. ``split`` takes the
    blocks at 0 .. num - 1, ``random_bits32`` the XOR of the block at 0;
    stacking keys and counters draws several of them in one pass."""
    return _blocks(keys, torch.as_tensor(ctr, device=keys.device))


def uniform_of(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform``'s f32 from 32 random bits (int64 values)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0


def random_bits32(keys: torch.Tensor) -> torch.Tensor:
    """One 32-bit word per key, as ``jax.random.bits(key, (), uint32)``:
    the XOR of the two words of the block at counter (0, 0)."""
    b0, b1 = blocks(keys, 0)
    return b0 ^ b1


def uniform(keys: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)`` (f32 scalar in [0, 1)) per key: the top
    23 bits as the mantissa of a float in [1, 2), minus 1 — exact."""
    return uniform_of(random_bits32(keys))


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` per key: (..., 2) keys ->
    (..., n) int64 words, word i the XOR of the two words of the block at
    counter (0, i) (partitionable threefry)."""
    ctr = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = blocks(keys[..., None, :], ctr)
    return b0 ^ b1


F32_TINY = 1.1754943508222875e-38      # numpy.finfo(float32).tiny


def uniform_n(keys: torch.Tensor, n: int, minval: float = 0.0,
              maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=, maxval=)`` per key: (...,
    n) f32, the steps of JAX's ``_uniform`` in f32 (``floats * (maxval -
    minval) + minval``, then the max with ``minval``)."""
    f32 = torch.float32
    lo = torch.tensor(minval, dtype=f32, device=keys.device)
    hi = torch.tensor(maxval, dtype=f32, device=keys.device)
    floats = uniform_of(random_bits(keys, n))
    return torch.maximum(lo, floats * (hi - lo) + lo)


def permutation_rounds(n: int) -> int:
    """The sort rounds of ``jax.random.permutation`` over ``n`` items:
    ceil(3 ln n / ln(2**32 - 1)), one up to 1625 items, two from 1626."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` per (C, 2) key: (C, n) int64.
    Each round splits the key, draws 32 bits a position from the second
    half and stably sorts the items by them (JAX's ``_shuffle``)."""
    x = torch.arange(n, dtype=torch.int64, device=keys.device).expand(
        keys.shape[0], n)
    for _ in range(permutation_rounds(n)):
        ks = split(keys, 2)
        keys = ks[:, 0]
        order = torch.sort(random_bits(ks[:, 1], n), dim=1,
                           stable=True).indices
        x = torch.gather(x, 1, order)
    return x.contiguous()


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` per key in its low mode: -log(-log
    u), u the f32 uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform_n(keys, n, minval=F32_TINY)))


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) words of the 64-bit product of uint32 tensor ``a`` and
    the constant ``m``, without leaving int64."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (mid >> 32)) & MASK32, mid & MASK32


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11), the kernel's generator:
    counter (c0..c3), key (k0, k1), broadcastable int64 tensors holding
    uint32 values. Returns the four output words."""
    like = next((x for x in (c0, c1, c2, c3, k0, k1)
                 if isinstance(x, torch.Tensor)), None)
    c = [_u32(x, like) for x in (c0, c1, c2, c3)]
    k0, k1 = _u32(k0, like), _u32(k1, like)
    shape = torch.broadcast_shapes(*(x.shape for x in (*c, k0, k1)))
    c = [x.expand(shape) for x in c]
    for r in range(10):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c[0], PHILOX_M0)
        hi1, lo1 = _mulhilo(c[2], PHILOX_M1)
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return c


def philox_plane(seed: int, chunk_idx: int, t: int, n_chains: int,
                 n: int, device, stream: int = STREAM_PLANE) -> torch.Tensor:
    """The board kernel's proposal bits at step ``t`` of chunk
    ``chunk_idx``: (C, N) int64 uint32 values. Chain c's key is (seed low
    word, c); cell i takes word i % 4 of the block at counter (i // 4, t,
    chunk, stream). The probe kernels draw rows the same way from
    ``STREAM_PROBE`` with chunk 0."""
    n_words = (n + 3) // 4
    q = torch.arange(n_words, dtype=torch.int64, device=device)[None, :]
    chain = torch.arange(n_chains, dtype=torch.int64, device=device)[:, None]
    words = philox4x32(q, t, chunk_idx, stream, seed & MASK32, chain)
    return torch.stack(words, dim=-1).reshape(n_chains, 4 * n_words)[:, :n]


def philox_scalars(seed: int, chunk_idx: int, t: int, n_chains: int,
                   device) -> torch.Tensor:
    """The kernel's two per-step scalar words (wait, accept) at step ``t``:
    (C, 2) int64, words 0 and 1 of the block at counter (0, t, chunk, 1)."""
    chain = torch.arange(n_chains, dtype=torch.int64, device=device)
    words = philox4x32(0, t, chunk_idx, STREAM_SCALARS, seed & MASK32, chain)
    return torch.stack(words[:2], dim=-1)
