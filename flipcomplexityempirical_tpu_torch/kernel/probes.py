"""The toolchain probes: ``tools/mosaic_probes.py``'s two kernels on CUDA.

The JAX package's tool launches two small Pallas kernels, ``kA`` and
``kB``, to learn whether the TPU compiler accepts a random-bit plane drawn
in a loop with a row-max carry and the board kernel's score / any_valid
loop. Here ``csrc/probes.cu`` computes what they compute, over an int32
input ``x`` (rows, n) for ``t_steps`` steps, one int32 per row:

    probe A: out[r] = sum_t max_j int32(bits[t, r, j] ^ 0x80000000)
    probe B: out[r] = sum_t [max_j int32(score ^ 0x80000000) > INT32_MIN]
             with score = x[r, j] > 0 ? bits[t, r, j] | 1 : 0

(wrapping int32 sums). The bits come from Philox4x32-10 with key (seed,
row) and counter (j // 4, t, 0, ``rng.STREAM_PROBE``), or from host bits
(t_steps, rows, n) as int32 bit patterns. ``probe_a`` and ``probe_b``
launch the kernel on a CUDA tensor and run the plain version,
``probe_reference``, on a CPU tensor; each counts its kernel launches.

Run the probe on the card with

    python -m flipcomplexityempirical_tpu_torch.kernel.probes

which builds the kernel, runs both probes at the tool's shape (x of ones,
128 x 128, 4 steps, seed 3) and prints one ``name: OK`` line per probe.
Unlike the JAX tool it catches nothing: a failure raises and the module
exits nonzero.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from .. import rng
from ..device import resolve_device

ROWS, COLS, STEPS, SEED = 128, 128, 4, 3
NAMES = {"a": "prng-plane-loop-carry", "b": "score-anyvalid-loop"}
_MODE = {"a": 0, "b": 1}
_SIGNATURE = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
              + [ctypes.c_uint, ctypes.c_void_p])


def _plane(t: int, rows: int, n: int, seed: int, bits, device):
    """Step t's (rows, n) uint32 draws, held in int64."""
    if bits is not None:
        return bits[t].to(torch.int64) & rng.MASK32
    return rng.philox_plane(seed, 0, t, rows, n, device,
                            stream=rng.STREAM_PROBE)


def probe_reference(which: str, x: torch.Tensor, t_steps: int, seed: int,
                    bits=None) -> torch.Tensor:
    """The plain version of probe ``which`` ("a" or "b"): (rows,) int32."""
    rows, n = x.shape
    acc = torch.zeros(rows, dtype=torch.int64, device=x.device)
    for t in range(t_steps):
        plane = _plane(t, rows, n, seed, bits, x.device)
        if which == "b":
            plane = torch.where(x > 0, plane | 1, 0)
        # int32(u ^ 0x80000000) == u - 2**31 for every uint32 u
        best = (plane - 2 ** 31).amax(dim=1)
        acc = acc + (best if which == "a" else (best > -2 ** 31).long())
    return ((acc + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _check(x, t_steps, bits) -> None:
    if x.dim() != 2 or x.dtype != torch.int32 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (rows, n) int32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if t_steps < 0:
        raise ValueError(f"t_steps {t_steps} < 0")
    if bits is not None:
        want = (t_steps, *x.shape)
        if (tuple(bits.shape) != want or bits.dtype != torch.int32
                or not bits.is_contiguous()):
            raise ValueError(f"bits must be contiguous int32 {want}, got "
                             f"{bits.dtype} {tuple(bits.shape)}")
        if bits.device != x.device:
            raise ValueError(f"bits on {bits.device}, x on {x.device}")


def _library():
    from . import _build
    lib = _build.load("probes")
    if lib.fce_probe.argtypes is None:
        lib.fce_probe.argtypes = _SIGNATURE
        lib.fce_probe.restype = ctypes.c_int
    return lib


def _run(which: str, x, t_steps: int, seed: int, bits):
    _check(x, t_steps, bits)
    if x.device.type == "cpu":
        return probe_reference(which, x, t_steps, seed, bits)
    if x.device.type != "cuda":
        raise ValueError(f"no probe path for device {x.device}")
    lib = _library()
    rows, n = x.shape
    out = torch.empty(rows, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fce_probe(x.data_ptr(),
                            bits.data_ptr() if bits is not None else None,
                            out.data_ptr(), rows, n, t_steps, _MODE[which],
                            seed & rng.MASK32,
                            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe {which} launch failed: CUDA error {err}")
    _WRAPPER[which].launches += 1
    return out


def probe_a(x: torch.Tensor, t_steps: int = STEPS, seed: int = SEED,
            bits=None) -> torch.Tensor:
    """Probe A (``kA``): per row, the wrapping sum over steps of the row
    max of the sign-flipped bits. ``probe_a.launches`` counts launches."""
    return _run("a", x, t_steps, seed, bits)


def probe_b(x: torch.Tensor, t_steps: int = STEPS, seed: int = SEED,
            bits=None) -> torch.Tensor:
    """Probe B (``kB``): per row, the number of steps whose masked score
    has a valid entry. ``probe_b.launches`` counts launches."""
    return _run("b", x, t_steps, seed, bits)


probe_a.launches = 0
probe_b.launches = 0
_WRAPPER = {"a": probe_a, "b": probe_b}


def run(device="cuda") -> dict:
    """Both probes at the tool's shape on ``device``; returns {name:
    (rows,) int32 result}, synchronised."""
    dev = resolve_device(device)
    x = torch.ones((ROWS, COLS), dtype=torch.int32, device=dev)
    out = {NAMES["a"]: probe_a(x), NAMES["b"]: probe_b(x)}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    for name, out in run(args.device).items():
        print(f"{name}: OK (rows {out.numel()}, first {int(out[0])})")


if __name__ == "__main__":
    main()
