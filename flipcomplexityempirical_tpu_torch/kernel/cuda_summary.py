"""The summary fold on the card: the standalone kernel's wrapper, and
the fused fold that the chunk kernels run on their own records.

``summary_fold(acc, rows)`` folds (T, C) rows that a caller holds into a
``stats.accumulators.SummaryAcc`` in step order: what the JAX package's
``fold_out`` does inside every scan body. The runners call it for their
one-row records (the board runners' final yield, the general runner's
initial one) and for the legacy general body's chunks, which no kernel
makes yet. On CUDA tensors it launches the hand-written kernel of
``csrc/summary_fold.cu`` (built on first use by ``_build``; one thread a
chain), on CPU tensors it runs ``stats.accumulators.fold_block``, the
plain version; it never runs the plain version on the card.

A chunk's own rows are folded inside the chunk kernel
(``cuda_lowered.run_chunk`` and ``cuda_dense.run_general_dense_chunk_cuda``
with ``acc=``): ``fused_fold`` makes that launch's accumulator arguments
and counts it in ``fused_fold.launches``, and ``fold_chunk_rows`` is the
plain version those wrappers run on CPU tensors. Both fold the same
rows: the observable, the wait, the last accepts row and the series
keys, each one of the chunk's record rows (every chunk kernel records a
wait; rows without one are the standalone kernel's case).

    inputs:  rows[acc.observable] (T, C) int32 or float32; rows["wait"]
             (T, C) float32, optional (weight 1 without it);
             rows["accepts"] (T, C) int32, optional (its last row is
             kept); rows[k] (T, C) float32 for each of the accumulator's
             series keys (at most two; chain 0's column is written);
    outputs: the accumulator's mean, m2, wsum, wmean, wm2, waits, accepts,
             buf and series updated in place, and fresh n, kept, stride.

The launch is asynchronous on the current stream (no host sync), so the
board runners' no-sync contract holds with the fold on.
"""

from __future__ import annotations

import ctypes

import torch

from ..stats import accumulators as sacc

# the kernel writes at most two series (the interface's slope and angle)
MAX_SERIES = 2


def _check(acc: sacc.SummaryAcc, rows: dict) -> int:
    """Raise unless ``rows`` and ``acc`` are what the kernel takes; the
    rows' length T."""
    if acc.observable not in rows:
        raise ValueError(f"rows lack the observable {acc.observable!r}")
    x = rows[acc.observable]
    if x.ndim != 2:
        raise ValueError(f"rows must be (T, C), got {tuple(x.shape)}")
    t_len, c = x.shape
    if c != acc.mean.shape[0]:
        raise ValueError(f"rows hold {c} chains, the accumulator "
                         f"{acc.mean.shape[0]}")
    if x.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"observable dtype {x.dtype}: int32 or float32")
    if len(acc.series) > MAX_SERIES:
        raise ValueError(f"the fold kernel writes at most {MAX_SERIES} "
                         "series")
    want = {"wait": torch.float32, "accepts": torch.int32,
            **{k: torch.float32 for k in acc.series}}
    for k, dtype in want.items():
        if k not in rows:
            if k in acc.series:
                raise ValueError(f"rows lack the series {k!r}")
            continue
        v = rows[k]
        if v.shape != x.shape or v.dtype != dtype:
            raise ValueError(f"row {k!r}: {tuple(v.shape)} {v.dtype}, "
                             f"expected {tuple(x.shape)} {dtype}")
    for v in (acc.mean, acc.m2, acc.wsum, acc.wmean, acc.wm2, acc.waits,
              acc.accepts, acc.buf, *acc.series.values()):
        if v.device != x.device or not v.is_contiguous():
            raise ValueError("the accumulator's tensors must be contiguous "
                             "on the rows' device")
    return t_len


def _entry(lib):
    """``lib``'s ``fce_summary_fold`` with its C signature."""
    fn = lib.fce_summary_fold
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, i] + [p] * 18 + [i] * 4 + [p])
        fn.restype = ctypes.c_int
    return fn


def _launch(lib, acc: sacc.SummaryAcc, rows: dict, t_len: int):
    x = rows[acc.observable].contiguous()
    c = x.shape[1]

    def ptr(v):
        return None if v is None else v.data_ptr()

    wait = rows.get("wait")
    wait = None if wait is None else wait.contiguous()
    last = rows["accepts"][-1].contiguous() if "accepts" in rows else None
    keys = list(acc.series)
    srcs = [rows[k].contiguous() for k in keys] + [None] * (
        MAX_SERIES - len(keys))
    dsts = [acc.series[k] for k in keys] + [None] * (MAX_SERIES - len(keys))
    scap = dsts[0].shape[0] if keys else 0
    nks = torch.empty(3, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry(lib)(
            x.data_ptr(), int(x.dtype == torch.float32), ptr(wait),
            ptr(last), ptr(srcs[0]), ptr(srcs[1]), acc.mean.data_ptr(),
            acc.m2.data_ptr(), acc.wsum.data_ptr(), acc.wmean.data_ptr(),
            acc.wm2.data_ptr(), acc.waits.data_ptr(),
            acc.accepts.data_ptr(), acc.buf.data_ptr(), acc.n.data_ptr(),
            acc.kept.data_ptr(), acc.stride.data_ptr(), nks.data_ptr(),
            ptr(dsts[0]), ptr(dsts[1]), scap, t_len, c, acc.buf.shape[1],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"summary_fold launch failed: CUDA error {err}")
    return acc.replace(n=nks[0], kept=nks[1], stride=nks[2])


def fused_sources(acc: sacc.SummaryAcc, row_index: dict) -> tuple:
    """(observable, series source 0, series source 1) as indexes into a
    chunk kernel's record rows (``row_index``: {name: index} of the rows
    the chunk makes; -1 for no series); raises naming a row it lacks."""
    have = sorted(row_index)
    if acc.observable not in row_index:
        raise ValueError(f"the chunk's records lack the observable "
                         f"{acc.observable!r} (they hold {have})")
    if len(acc.series) > MAX_SERIES:
        raise ValueError(f"the fold writes at most {MAX_SERIES} series")
    for k in acc.series:
        if k not in row_index:
            raise ValueError(f"the chunk's records lack the series {k!r} "
                             f"(they hold {have})")
    src = [row_index[k] for k in acc.series]
    src += [-1] * (MAX_SERIES - len(src))
    return row_index[acc.observable], src[0], src[1]


def fold_chunk_rows(acc: sacc.SummaryAcc, rows: dict,
                    row_index: dict) -> sacc.SummaryAcc:
    """The plain version of a fused fold: ``fold_block`` of the chunk's
    ``rows`` that the kernel would fold (``fused_sources`` refuses what
    the kernel refuses)."""
    fused_sources(acc, row_index)
    keep = {acc.observable, "wait", "accepts", *acc.series}
    return sacc.fold_block(acc, {k: v for k, v in rows.items()
                                 if k in keep})


def fused_fold(acc: sacc.SummaryAcc, row_index: dict, n_chains: int,
               launch, keep_rows: bool = True) -> sacc.SummaryAcc:
    """One chunk launch with the fold of its records: ``launch(ptrs,
    ints)`` calls the chunk kernel's C entry with the addresses of the two
    host arrays that ``summary_fold.cuh::fold_args`` reads (the
    accumulator's 14 pointers; cap, series_cap, the row indexes of
    ``fused_sources`` and ``keep_rows``). Returns the accumulator with
    fresh n, kept and stride. Asynchronous, like the chunk launch."""
    obs, src0, src1 = fused_sources(acc, row_index)
    dev = acc.mean.device
    if acc.mean.shape[0] != n_chains:
        raise ValueError(f"the chunk runs {n_chains} chains, the "
                         f"accumulator {acc.mean.shape[0]}")
    for v in (acc.mean, acc.m2, acc.wsum, acc.wmean, acc.wm2, acc.waits,
              acc.accepts, acc.buf, acc.n, acc.kept, acc.stride,
              *acc.series.values()):
        if v.device != dev or not v.is_contiguous():
            raise ValueError("the accumulator's tensors must be contiguous "
                             "on one device")
    keys = list(acc.series)
    dsts = [acc.series[k] for k in keys] + [None] * (MAX_SERIES - len(keys))
    scap = dsts[0].shape[0] if keys else 0
    nks = torch.empty(3, dtype=torch.int32, device=dev)
    ptrs = (ctypes.c_void_p * 14)(*(
        None if v is None else v.data_ptr() for v in (
            acc.mean, acc.m2, acc.wsum, acc.wmean, acc.wm2, acc.waits,
            acc.accepts, acc.buf, acc.n, acc.kept, acc.stride, nks,
            *dsts)))
    ints = (ctypes.c_int * 6)(acc.buf.shape[1], scap, obs, src0, src1,
                              int(keep_rows))
    launch(ctypes.addressof(ptrs), ctypes.addressof(ints))
    fused_fold.launches += 1
    return acc.replace(n=nks[0], kept=nks[1], stride=nks[2])


fused_fold.launches = 0


def summary_fold(acc: sacc.SummaryAcc, rows: dict) -> sacc.SummaryAcc:
    """Fold ``rows`` ({name: (T, C)}) into ``acc`` (module docstring):
    one kernel launch on CUDA tensors, the plain ``fold_block`` on CPU
    tensors. ``summary_fold.launches`` counts kernel launches."""
    t_len = _check(acc, rows)
    dev = acc.mean.device
    if dev.type == "cuda":
        if t_len == 0:
            return acc
        from . import _build
        out = _launch(_build.load("summary_fold"), acc, rows, t_len)
        summary_fold.launches += 1
        return out
    if dev.type == "cpu":
        return sacc.fold_block(acc, rows)
    raise ValueError(f"no summary-fold path for device {dev}")


summary_fold.launches = 0
