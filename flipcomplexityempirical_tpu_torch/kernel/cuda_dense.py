"""The general-dense chunk kernel: its wrapper, its plain version, its
contract.

``run_general_dense_chunk_cuda`` runs ``t_inner`` steps of the JAX
package's ``general_dense`` body (``kernel/dense.py::transition``, then
``kernel/step.py::record``) for every chain of a ``ChainState``. On CUDA
tensors it launches the hand-written kernel of
``csrc/general_dense_chunk.cu`` (built on first use by ``_build``; one
warp per chain, the assignment, boundary and contiguity sets bit-packed in
shared memory with per-group candidate counts, the graph's packed tables
staged into shared memory where they fit); on CPU tensors it runs
``general_dense_chunk_reference``, the step-by-step PyTorch replay of
``kernel/dense.py`` and ``kernel/step.py::record``. Both draw the JAX
package's threefry stream from the state's keys, so they agree with the
JAX package draw for draw.

The kernel's scope (``supports``): the 2-district 'bi' proposal under
re-propose semantics, accept 'cut', no annealing, contiguity 'patch' or
'none' on a graph whose patches fit 32 slots, ``nobacktrack``,
``lazy_uniform``, ``parity_metrics``, ``geom_waits`` and
``record_interface`` on a graph of at most ``MAX_WALL_EDGES`` wall edges
(the k-district pair walk has a kernel of its own, ``cuda_pair``). ``check`` refuses
the rest, naming the ROADMAP.md item that ports it; the runner never
runs the plain version in the kernel's place on the card.

    kernel inputs:  the static tables of ``make_static_inputs`` (the
        graph's tables packed by ``pack_tables``, edges, populations);
        per chain key (2, C), assignment (C, N) int8, cut (C, E) int8,
        cut_deg
        (C, N) int8, dist_pop (2, C), conn_bits (C, W) int32 bit patterns
        (or none: the kernel then fills the plane from the assignment, as
        ``dense.ensure_conn_bits`` does),
        scal (6, C) f32 [log_base, beta, pop_lo, pop_hi, cur_wait,
        waits_sum], ints (8, C) [cut_count, b_count, cur_flip_node,
        t_yield, move_clock, accept_count, tries_sum, exhausted_count],
        part_sum, last_flipped, num_flips (C, N) and cut_times (C, E);
    kernel outputs: the same per-chain fields after the chunk (scal as
        [cur_wait, waits_sum]; cut and cut_deg recounted from the
        assignment), and the (T, C) rows cut_count, b_count, wait, accepts
        and, under ``lazy_uniform``, weight and, under
        ``record_interface``, slope and angle (the interface form, whose
        inputs add each edge's wall rank, the wall edges and their f32
        midpoints, ``interface_inputs``).

With ``acc=`` (a ``stats.accumulators.SummaryAcc``) the chunk also folds
its records into the run's summary accumulator: on the card inside the
same launch (in the wide form a fold warp beside the chain and its
draws warp, in the narrow one a batch fold on each chain's warp every 32
steps; ``csrc/summary_fold.cuh``), on the CPU by the plain chunk and then
``cuda_summary.fold_chunk_rows``. With
``keep_rows=False`` (summary mode, no history) the kernel writes none of
the rows.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import rng
from . import cuda_summary, dense
from . import step as kstep
from .step import Spec, StepParams, geom_denom_finite

# node ids are uint16 in the packed tables
MAX_NODES = 1 << 16
# the interface form's wall bitset is at most 32 words, read a word a lane
MAX_WALL_EDGES = 1024

ROW_NAMES = ("cut_count", "b_count", "wait", "accepts", "weight", "slope",
             "angle")


def fold_row_index(spec: Spec) -> dict:
    """{name: lane} of the record rows a chunk writes and its fold may
    read (the weight under ``lazy_uniform``, slope and angle under
    ``record_interface``)."""
    extra = {"weight": spec.lazy_uniform, "slope": spec.record_interface,
             "angle": spec.record_interface}
    return {k: i for i, k in enumerate(ROW_NAMES) if extra.get(k, True)}


@dataclasses.dataclass
class DenseStatic:
    """The kernel's graph tables on the run's device, made once a run."""

    tables: torch.Tensor       # uint8, ``pack_tables``
    edges: torch.Tensor        # (E, 2) int32
    pop: torch.Tensor          # (N,) int32
    unit_pop: int              # every node's population, or 0 if it varies
    iface: object = None       # ``interface_inputs`` under record_interface


@dataclasses.dataclass
class InterfaceInputs:
    """The interface form's tables: each edge's rank among the wall edges
    (-1 off the walls), the wall edges in edge order and their f32
    midpoints (``step.interface_midpoints``, the plain version's values),
    and the angle's center."""

    wall_rank: torch.Tensor    # (E,) int32
    wall_edges: torch.Tensor   # (n_wall,) int32
    wall_mid: torch.Tensor     # (n_wall, 2) f32
    cx: float
    cy: float


def interface_inputs(dg) -> InterfaceInputs:
    walls = torch.nonzero(dg.wall_id >= 0)[:, 0]
    rank = torch.full((dg.n_edges,), -1, dtype=torch.int32, device=dg.device)
    rank[walls] = torch.arange(walls.numel(), dtype=torch.int32,
                               device=dg.device)
    mid = kstep.interface_midpoints(dg)[walls].contiguous()
    cx, cy = (float(x) for x in dg.center.to(torch.float32).cpu())
    return InterfaceInputs(wall_rank=rank,
                           wall_edges=walls.to(torch.int32).contiguous(),
                           wall_mid=mid, cx=cx, cy=cy)


def _refusal(dg, spec: Spec):
    """Why the kernel does not run (dg, spec), or None."""
    if spec.proposal == "pair":
        return ("proposal 'pair' runs in the pair walk's own kernel "
                "(kernel/cuda_pair.py)")
    if spec.weighted_cut:
        return ("weighted_cut in the 2-district dense kernel waits for "
                "ROADMAP.md B4 (the step tail's accept rules); the pair "
                "kernel serves it")
    if spec.record_interface and int((dg.wall_id >= 0).sum()) > \
            MAX_WALL_EDGES:
        return (f"record_interface: the kernel's wall bitset holds at most "
                f"{MAX_WALL_EDGES} wall edges")
    if spec.accept != "cut" or spec.anneal != "none":
        return (f"accept {spec.accept!r} / anneal {spec.anneal!r} in the "
                "dense kernel waits for ROADMAP.md B4 (the step tail's "
                "accept rules)")
    if spec.record_assignment_bits:
        return ("record_assignment_bits in the dense kernel waits for "
                "ROADMAP.md B9 (the general path's kernels)")
    if not dense.supported(dg, spec) or spec.n_districts != 2:
        return ("kernel.dense.supported rejects this (graph, spec); the "
                "legacy body runs it (kernel_path='general')")
    if dg.max_patch > 32:
        return "patches above 32 slots do not fit the kernel's bitsets"
    if dg.n_nodes > MAX_NODES or dg.max_deg > 32:
        return (f"the kernel holds at most {MAX_NODES} nodes of degree at "
                "most 32")
    if spec.geom_waits and not geom_denom_finite(dg.n_nodes, 2):
        return "geom_waits: n**2 - 1 overflows float32"
    return None


def supports(dg, spec: Spec) -> bool:
    """True iff the kernel reproduces (dg, spec) (module docstring)."""
    return _refusal(dg, spec) is None


def check(dg, spec: Spec, params: StepParams) -> None:
    """Raise unless the kernel reproduces the requested semantics."""
    why = _refusal(dg, spec)
    if why is not None:
        raise ValueError(f"the general-dense kernel does not run {spec}: "
                         f"{why}")
    if params.label_values.numel() != 2:
        raise ValueError("label_values must hold the two district labels")


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> int32 bit patterns, contiguous."""
    x = x.to(torch.int64) & rng.MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(
        torch.int32).contiguous()


def table_layout(n: int, d: int, p: int) -> dict:
    """Byte offsets of the packed tables (``csrc/chain_common.cuh``'s
    ``table_layout``, which both general kernels read): patch adjacency bitsets and patch slots in rows of
    ``pp`` = P rounded up to 8 slots (uint32, then uint16), neighbour edges
    (N, D) as uint32, each node's real patch slots (N,) as a uint32 mask,
    neighbour slots (N, D) as uint16, degrees (N,) as uint8 and, for patch
    slot s of u, the slot of u in that node's patch (N, pp) as uint8;
    ``bytes`` padded to 16."""
    pp = (p + 7) // 8 * 8
    padj = 0
    pn = padj + 4 * n * pp
    nedge = pn + 2 * n * pp
    slots = nedge + 4 * n * d
    nbr = slots + 4 * n
    deg = nbr + 2 * n * d
    rev = deg + n
    return dict(padj=padj, pn=pn, nedge=nedge, slots=slots, nbr=nbr,
                deg=deg, rev=rev, pp=pp, bytes=(rev + n * pp + 15) // 16 * 16)


def _le_bytes(x: torch.Tensor, width: int) -> torch.Tensor:
    """Integers as ``width`` little-endian bytes each, flattened (uint8)."""
    x = x.to(torch.int64).reshape(-1, 1)
    shifts = 8 * torch.arange(width, dtype=torch.int64, device=x.device)
    return ((x >> shifts) & 0xFF).to(torch.uint8).reshape(-1)


def pack_tables(dg) -> torch.Tensor:
    """The graph's tables as one uint8 tensor in ``table_layout``, made on
    the graph's device: the bytes the kernel stages into shared memory or
    reads through L1. Patch rows are padded with the node itself (slots)
    and 0 (adjacency); ``rev`` holds 0 at pads (patch balls are
    symmetric, so every real slot has its reverse)."""
    n, d, p = dg.n_nodes, dg.max_deg, dg.max_patch
    lay = table_layout(n, d, p)
    pp = lay["pp"]
    nodes = torch.arange(n, dtype=torch.int64, device=dg.device)
    pn = torch.cat([dg.patch_nodes.to(torch.int64),
                    nodes[:, None].expand(n, pp - p)], dim=1)
    padj = torch.nn.functional.pad(dg.patch_adj.to(torch.int64),
                                   (0, pp - p))
    real = pn != nodes[:, None]
    slots = (real.to(torch.int64)
             << torch.arange(pp, device=dg.device)).sum(dim=1)
    # the slot of u in the patch of x = pn[u, s]
    back = pn[pn] == nodes[:, None, None]                 # (N, pp, pp)
    rev = torch.where(real, back.to(torch.uint8).argmax(dim=2), 0)
    buf = torch.zeros(lay["bytes"], dtype=torch.uint8, device=dg.device)
    for key, x, width in (("padj", padj, 4), ("pn", pn, 2),
                          ("nedge", dg.nbr_edge, 4), ("slots", slots, 4),
                          ("nbr", dg.nbr, 2), ("deg", dg.deg, 1),
                          ("rev", rev, 1)):
        b = _le_bytes(x, width)
        buf[lay[key]:lay[key] + b.numel()] = b
    return buf


def make_static_inputs(dg, spec: Spec = None) -> DenseStatic:
    """The tables of ``dg`` (with the interface form's under ``spec``'s
    ``record_interface``)."""
    pop = dg.pop
    unit = int(pop[0]) if bool((pop == pop[0]).all()) and int(pop[0]) > 0 \
        else 0
    iface = (interface_inputs(dg) if spec is not None
             and spec.record_interface else None)
    return DenseStatic(tables=pack_tables(dg), edges=_i32(dg.edges),
                       pop=_i32(pop), unit_pop=unit, iface=iface)


def general_dense_chunk_reference(dg, spec: Spec, params: StepParams, state,
                                  t_inner: int):
    """The plain version: the conn planes attached if absent, then
    ``t_inner`` rounds of ``dense.transition`` and ``step.record``.
    Returns (state, rows), rows {name: (T, C)}."""
    state = dense.ensure_conn_bits(dg, spec, state)
    return kstep.run_steps(dense.transition, dg, spec, params, state,
                           t_inner)


def _entry(lib):
    """``lib``'s ``fce_general_dense_chunk`` with its C signature: 32
    pointers, 15 ints, the fold's two host arrays (null in history mode),
    the interface form's five pointers (null without it), its wall edges'
    count and center, the stream."""
    fn = lib.fce_general_dense_chunk
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 32 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int]
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_shape(dg, n_chains: int, fold: bool = False,
                 iface: bool = False) -> dict:
    """How the kernel runs ``n_chains`` chains of ``dg`` on this card (with
    ``fold``, its summary-fold instantiation; with ``iface``, its
    interface form): ``staged`` (the tables in
    shared memory; False: read through L1), ``smem_bytes`` a block,
    ``chains_per_block``, ``producer`` (a draws warp a chain),
    ``blocks_per_sm`` resident, ``threads`` a block."""
    from . import _build
    fn = _build.load("general_dense_chunk").fce_general_dense_shape
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    n_wall = int((dg.wall_id >= 0).sum()) if iface else 0
    err = fn(n_chains, dg.n_nodes, dg.n_edges, dg.max_deg, dg.max_patch,
             int(fold), n_wall, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"general_dense_chunk shape query failed: CUDA "
                           f"error {err}")
    return dict(staged=bool(out[0]), smem_bytes=out[1],
                chains_per_block=out[2], producer=bool(out[3]),
                blocks_per_sm=out[4], threads=out[5])


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous from a 16-byte boundary (the kernel copies these
    fields 16 bytes a lane); a view into a batch may start elsewhere."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def chunk_io(state, params: StepParams, n_edges: int, row_names):
    """The per-chain inputs and output buffers of the general path's chunk
    kernels (this one and ``cuda_pair``'s), in their C entries' order:
    (ins {name: tensor}, outs {name: tensor}, rows {name: (T, C)} of
    ``row_names``' (name, T) pairs, fill: whether the kernel fills the
    conn planes first). The row fields are 16-byte aligned."""
    c, n = state.assignment.shape
    k = state.dist_pop.shape[1]
    dev = state.assignment.device
    i32, f32 = torch.int32, torch.float32
    fill = state.conn_bits is None
    ins = dict(
        key=_i32(state.key).T.contiguous(),
        assignment=state.assignment.contiguous(), cut=_aligned(state.cut),
        cut_deg=state.cut_deg.contiguous(),
        dist_pop=state.dist_pop.to(i32).T.contiguous(),
        conn=(torch.empty((c, 0), dtype=i32, device=dev) if fill
              else _i32(state.conn_bits)),
        scal=torch.stack([x.expand(c) for x in (
            params.log_base, params.beta, params.pop_lo, params.pop_hi,
            state.cur_wait, state.waits_sum)]).to(f32).contiguous(),
        ints=torch.stack([state.cut_count, state.b_count,
                          state.cur_flip_node, state.t_yield,
                          state.move_clock, state.accept_count,
                          state.tries_sum,
                          state.exhausted_count]).to(i32).contiguous(),
        part_sum=_aligned(state.part_sum),
        last_flipped=_aligned(state.last_flipped),
        num_flips=_aligned(state.num_flips),
        cut_times=_aligned(state.cut_times))
    for name in ("assignment", "cut", "cut_deg"):
        if ins[name].dtype != torch.int8:
            raise ValueError(f"{name}: expected torch.int8, got "
                             f"{ins[name].dtype}")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = dict(
        key=empty((2, c), i32), assignment=empty((c, n), torch.int8),
        cut=empty((c, n_edges), torch.int8),
        cut_deg=empty((c, n), torch.int8), dist_pop=empty((k, c), i32),
        conn=empty((c, dense.n_words(n)), i32), scal=empty((2, c), f32),
        ints=empty((8, c), i32), part_sum=empty((c, n), i32),
        last_flipped=empty((c, n), i32), num_flips=empty((c, n), i32),
        cut_times=empty((c, n_edges), i32))
    rows = {nm: empty((t, c), i32 if nm in ("cut_count", "b_count",
                                            "accepts") else f32)
            for nm, t in row_names}
    return ins, outs, rows, fill


def chunk_state(state, outs: dict):
    """The chain state after a chunk, from ``chunk_io``'s outputs."""
    ints_o, scal_o = outs["ints"], outs["scal"]
    return state.replace(
        key=outs["key"].T.to(torch.int64) & rng.MASK32,
        assignment=outs["assignment"], cut=outs["cut"],
        cut_deg=outs["cut_deg"], dist_pop=outs["dist_pop"].T.contiguous(),
        cut_count=ints_o[0], b_count=ints_o[1], cur_wait=scal_o[0],
        cur_flip_node=ints_o[2], t_yield=ints_o[3], move_clock=ints_o[4],
        part_sum=outs["part_sum"], last_flipped=outs["last_flipped"],
        num_flips=outs["num_flips"], cut_times=outs["cut_times"],
        waits_sum=scal_o[1], accept_count=ints_o[5], tries_sum=ints_o[6],
        exhausted_count=ints_o[7],
        conn_bits=outs["conn"].to(torch.int64) & rng.MASK32)


def _launch(lib, dg, static: DenseStatic, spec: Spec, params: StepParams,
            state, t_inner: int, acc=None, keep_rows: bool = True):
    c, n = state.assignment.shape
    e = dg.n_edges
    dev = state.assignment.device
    ins, outs, rows, fill = chunk_io(
        state, params, e,
        [(k, t_inner) for k in fold_row_index(spec)] if keep_rows else [])
    ptrs = [static.tables, static.edges, static.pop, *ins.values(),
            *outs.values(), *(rows.get(k) for k in ROW_NAMES[:5])]
    ptrs = [None if x is None else x.data_ptr() for x in ptrs]
    labels = [int(x) for x in params.label_values.cpu()]
    fi = static.iface if spec.record_interface else None
    if spec.record_interface and fi is None:
        raise ValueError("record_interface needs the interface tables: "
                         "make_static_inputs(dg, spec)")
    iptrs = [None] * 5 if fi is None else [
        x.data_ptr() for x in (fi.wall_rank, fi.wall_edges, fi.wall_mid)] + [
        None if rows.get(k) is None else rows[k].data_ptr()
        for k in ("slope", "angle")]
    n_wall = 0 if fi is None else fi.wall_edges.numel()
    cxy = (0.0, 0.0) if fi is None else (fi.cx, fi.cy)

    def launch(fold_ptrs=None, fold_ints=None):
        with torch.cuda.device(dev):
            err = _entry(lib)(
                *ptrs, c, n, e, dg.max_deg, dg.max_patch, t_inner,
                int(spec.contiguity == "patch"), int(spec.geom_waits),
                int(spec.nobacktrack), int(spec.lazy_uniform),
                int(spec.parity_metrics), int(fill), static.unit_pop,
                labels[0], labels[1], fold_ptrs, fold_ints, *iptrs,
                n_wall, *cxy, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"general_dense_chunk launch failed: CUDA "
                               f"error {err}")

    if acc is None:
        launch()
    else:
        acc = cuda_summary.fused_fold(acc, fold_row_index(spec), c, launch,
                                      keep_rows)
    return chunk_state(state, outs), rows, acc


def run_general_dense_chunk_cuda(dg, static: DenseStatic, spec: Spec,
                                 params: StepParams, state, t_inner: int,
                                 acc=None, keep_rows: bool = True):
    """One chunk for every chain: (state, rows {name: (T, C)}), the state
    carrying its conn planes (filled first where it came without). CUDA
    tensors launch the kernel; CPU tensors run the plain version.
    ``run_general_dense_chunk_cuda.launches`` counts kernel launches.
    With ``acc`` the chunk folds its records into it and returns (state,
    rows, the updated accumulator), on the card in the same launch
    (``cuda_summary.fused_fold.launches`` counts those);
    ``keep_rows=False``, for a run that keeps no history, writes no row
    (rows is empty)."""
    check(dg, spec, params)
    if t_inner < 1:
        raise ValueError(f"t_inner {t_inner} < 1")
    if acc is None and not keep_rows:
        raise ValueError("keep_rows=False drops the rows that only the "
                         "fold reads: pass an accumulator")
    dev = state.assignment.device
    if dev.type == "cuda":
        from . import _build
        new, rows, acc_out = _launch(
            _build.load("general_dense_chunk"), dg, static, spec, params,
            state, t_inner, acc, keep_rows)
        run_general_dense_chunk_cuda.launches += 1
        return (new, rows) if acc is None else (new, rows, acc_out)
    if dev.type == "cpu":
        new, rows = general_dense_chunk_reference(dg, spec, params, state,
                                                  t_inner)
        if acc is None:
            return new, rows
        acc = cuda_summary.fold_chunk_rows(acc, rows, fold_row_index(spec))
        return new, (rows if keep_rows else {}), acc
    raise ValueError(f"no general-dense chunk path for device {dev}")


run_general_dense_chunk_cuda.launches = 0
