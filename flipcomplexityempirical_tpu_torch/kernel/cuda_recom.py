"""The ReCom chunk kernel: its wrapper and its contract.

``run_recom_chunk_cuda`` runs ``t_inner`` moves of the ReCom chain, each
followed by ``kernel/step.py::record``, for every chain of a
``ChainState`` (the JAX package's ``_run_recom_chunk``,
``sampling/recom.py:317``). On CUDA tensors it launches the hand-written
kernel of ``csrc/recom_chunk.cu`` (built on first use by ``_build``; one
512-thread block a chain, the spanning forest, its BFS tree, the subtree
sums and the commit in shared memory); on CPU tensors it runs
``sampling/recom.py::recom_chunk_reference``, the same moves as torch
ops. Both draw the JAX package's threefry stream.

The kernel's scope (``supports``): the 'bi' (k = 2) and 'pair' specs'
ReCom moves at 2 to ``MAX_DISTRICTS`` districts, ``parity_metrics``,
``geom_waits``, ``lazy_uniform``, any ``tree_retries``, ``epsilon`` and
``pop_target`` (None: half the merged pair's population). ``check``
refuses the rest, naming the ROADMAP.md item, and the runner never runs
the plain version in the kernel's place on the card:

- ``record_interface`` / ``record_assignment_bits`` (the sec11 and frank
  families' records): A9b;
- a graph's total population of 2**24 or more (the JAX package's f32
  subtree sums stop being exact, and their order of summation cannot be
  matched), more than 32767 nodes or 65535 edges, or a graph whose
  scratch does not fit a block's shared memory: B11b;
- ``reject_count`` and ``recorder`` (the runner's): A11a.

    kernel inputs:  edges (E, 2), pop (N,), nbr / nbr_edge (N, D) int32,
        nbr_mask (N, D) int8, district labels (K,); per chain key (2, C),
        assignment (C, N) int8, scal (2, C) f32 [cur_wait, waits_sum],
        ints (8, C) [cut_count, b_count, cur_flip_node, t_yield,
        move_clock, accept_count, tries_sum, exhausted_count],
        part_sum, last_flipped, num_flips (C, N) and cut_times (C, E);
    kernel outputs: the same per-chain fields after the chunk with cut
        (C, E), cut_deg (C, N) and dist_pop (K, C) recounted, and the (T,
        C) rows cut_count, b_count, wait, accepts and, under
        ``lazy_uniform``, weight.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import rng
from .cuda_dense import _aligned, _i32
from .step import Spec, StepParams, geom_denom_finite

MAX_DISTRICTS = 32     # a node's neighbouring districts are a uint32 set
MAX_NODES = 32767      # int16 parents, depths and BFS queue
MAX_EDGES = 65535      # uint16 ranks
MAX_POP = 2 ** 24      # exact f32 subtree sums
THREADS = 512
SMEM_LIMIT = 227 * 1024

ROW_NAMES = ("cut_count", "b_count", "wait", "accepts", "weight")


def row_names(spec: Spec) -> tuple:
    """The (T, C) rows a chunk writes (the weight under
    ``lazy_uniform``)."""
    return tuple(k for k in ROW_NAMES if k != "weight" or spec.lazy_uniform)


def smem_bytes(n: int, e: int) -> int:
    """A block's shared memory for a graph of ``n`` nodes and ``e`` edges
    (``csrc/recom_chunk.cu``'s ``layout``, which ``launch_shape`` reports;
    the card tests and ``chip_smoke.py`` hold the two equal)."""
    def r16(x):
        return (x + 15) & ~15
    n4, n2, e4, e2 = r16(4 * n), r16(2 * n), r16(4 * e), r16(2 * e)
    words = r16(4 * ((e + 31) // 32))
    scratch = max(2 * e4, 3 * n4, n4 + 3 * n2 + r16(4 * (n + 2)))
    return (scratch + 2 * e2 + r16(2 * 16 * THREADS) + 2 * r16(n)
            + 2 * words + r16(16 * 4 * 3 + 32 * 4 + 16))


@dataclasses.dataclass
class RecomStatic:
    """The kernel's graph tables on the run's device, made once a run."""

    edges: torch.Tensor       # (E, 2) int32
    pop: torch.Tensor         # (N,) int32
    nbr: torch.Tensor         # (N, D) int32
    nbr_edge: torch.Tensor    # (N, D) int32
    nbr_mask: torch.Tensor    # (N, D) int8


def _refusal(dg, spec: Spec):
    """Why the kernel does not run (dg, spec), or None."""
    k = spec.n_districts
    if spec.proposal not in ("bi", "pair"):
        return f"proposal {spec.proposal!r}"
    if spec.proposal == "bi" and k != 2:
        return "proposal 'bi' requires n_districts == 2"
    if not 2 <= k <= MAX_DISTRICTS:
        return (f"the kernel holds 2 to {MAX_DISTRICTS} districts; k={k} "
                "waits for ROADMAP.md B11b")
    if spec.record_interface or spec.record_assignment_bits:
        return ("record_interface / record_assignment_bits in the ReCom "
                "kernel wait for ROADMAP.md A9b")
    n, e = dg.n_nodes, dg.n_edges
    if n > MAX_NODES or e > MAX_EDGES or e < 1:
        return (f"graphs of 1 to {MAX_EDGES} edges and at most {MAX_NODES} "
                f"nodes ({n} nodes, {e} edges here); others wait for "
                "ROADMAP.md B11b")
    if smem_bytes(n, e) > SMEM_LIMIT:
        return (f"the block's scratch, {smem_bytes(n, e)} bytes, does not "
                "fit its shared memory; larger graphs wait for ROADMAP.md "
                "B11b")
    total = int(dg.pop.to(torch.int64).sum())
    if total >= MAX_POP or int(dg.pop.min()) < 0:
        return (f"a total population of {total}: subtree sums are exact "
                "in f32 below 2**24 only (non-negative populations); "
                "others wait for ROADMAP.md B11b")
    if spec.geom_waits and not geom_denom_finite(n, k):
        return f"geom_waits: n**{k} - 1 overflows float32"
    return None


def supports(dg, spec: Spec) -> bool:
    """True iff the kernel reproduces (dg, spec) (module docstring)."""
    return _refusal(dg, spec) is None


def check(dg, spec: Spec, params: StepParams) -> None:
    """Raise unless the kernel reproduces the requested semantics."""
    why = _refusal(dg, spec)
    if why is not None:
        raise ValueError(f"the ReCom kernel does not run {spec}: {why}")
    if params.label_values.numel() != spec.n_districts:
        raise ValueError("label_values must hold one label a district")


def make_static_inputs(dg) -> RecomStatic:
    return RecomStatic(edges=_i32(dg.edges), pop=_i32(dg.pop),
                       nbr=_i32(dg.nbr), nbr_edge=_i32(dg.nbr_edge),
                       nbr_mask=dg.nbr_mask.to(torch.int8).contiguous())


def _entry(lib):
    """``lib``'s ``fce_recom_chunk`` with its C signature: 30 pointers,
    12 ints, 4 floats, the stream."""
    fn = lib.fce_recom_chunk
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 30 + [ctypes.c_int] * 12
                       + [ctypes.c_float] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_shape(dg, n_chains: int) -> dict:
    """How the kernel runs ``n_chains`` chains of ``dg`` on this card:
    ``smem_bytes`` a block, ``blocks_per_sm`` resident, ``threads`` a
    block, ``registers`` a thread, ``sms`` and ``waves`` (chains over the
    blocks the card holds at once)."""
    from . import _build
    fn = _build.load("recom_chunk").fce_recom_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    err = fn(dg.n_nodes, dg.n_edges, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"recom_chunk shape query failed: CUDA error "
                           f"{err}")
    per_card = max(out[1] * out[4], 1)
    return dict(smem_bytes=out[0], blocks_per_sm=out[1], threads=out[2],
                registers=out[3], sms=out[4],
                waves=-(-n_chains // per_card))


def move_constants(epsilon: float, pop_target, n_nodes: int, k: int):
    """(target, lo_f, hi_f, denom) as f32 values: the f32 target (0.0 when
    None), f32(1 - epsilon), f32(1 + epsilon) and the wait denominator
    n**k - 1, as the JAX package forms them."""
    f32 = np.float32
    target = f32(0.0 if pop_target is None else pop_target)
    return (float(target), float(f32(1 - epsilon)), float(f32(1 + epsilon)),
            float(f32(float(n_nodes) ** k - 1.0)))


def _launch(lib, dg, static: RecomStatic, spec: Spec, params: StepParams,
            state, t_inner: int, epsilon: float, pop_target,
            tree_retries: int):
    c, n = state.assignment.shape
    e, k = dg.n_edges, spec.n_districts
    dev = state.assignment.device
    i32, f32 = torch.int32, torch.float32
    if state.assignment.dtype != torch.int8:
        raise ValueError(f"assignment: expected torch.int8, got "
                         f"{state.assignment.dtype}")
    ins = dict(
        key=_i32(state.key).T.contiguous(),
        assignment=state.assignment.contiguous(),
        scal=torch.stack([state.cur_wait, state.waits_sum]).to(
            f32).contiguous(),
        ints=torch.stack([state.cut_count, state.b_count,
                          state.cur_flip_node, state.t_yield,
                          state.move_clock, state.accept_count,
                          state.tries_sum,
                          state.exhausted_count]).to(i32).contiguous(),
        part_sum=_aligned(state.part_sum),
        last_flipped=_aligned(state.last_flipped),
        num_flips=_aligned(state.num_flips),
        cut_times=_aligned(state.cut_times))

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    outs = dict(
        key=empty((2, c), i32), assignment=empty((c, n), torch.int8),
        cut=empty((c, e), torch.int8), cut_deg=empty((c, n), torch.int8),
        dist_pop=empty((k, c), i32), scal=empty((2, c), f32),
        ints=empty((8, c), i32), part_sum=empty((c, n), i32),
        last_flipped=empty((c, n), i32), num_flips=empty((c, n), i32),
        cut_times=empty((c, e), i32))
    rows = {nm: empty((t_inner, c), f32 if nm in ("wait", "weight") else i32)
            for nm in row_names(spec)}
    labels = params.label_values.to(device=dev, dtype=i32).contiguous()
    ptrs = [static.edges, static.pop, static.nbr, static.nbr_edge,
            static.nbr_mask, labels, *ins.values(), *outs.values(),
            *(rows.get(nm) for nm in ROW_NAMES)]
    ptrs = [None if x is None else x.data_ptr() for x in ptrs]
    target, lo_f, hi_f, denom = move_constants(epsilon, pop_target, n, k)
    with torch.cuda.device(dev):
        err = _entry(lib)(
            *ptrs, c, n, e, dg.max_deg, k, t_inner,
            int(spec.proposal == "pair"), int(spec.parity_metrics),
            int(spec.geom_waits), int(tree_retries),
            rng.permutation_rounds(e), int(pop_target is not None), target,
            lo_f, hi_f, denom, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"recom_chunk launch failed: CUDA error {err}")
    ints_o, scal_o = outs["ints"], outs["scal"]
    state = state.replace(
        key=outs["key"].T.to(torch.int64) & rng.MASK32,
        assignment=outs["assignment"], cut=outs["cut"],
        cut_deg=outs["cut_deg"], dist_pop=outs["dist_pop"].T.contiguous(),
        cut_count=ints_o[0], b_count=ints_o[1], cur_wait=scal_o[0],
        cur_flip_node=ints_o[2], t_yield=ints_o[3], move_clock=ints_o[4],
        part_sum=outs["part_sum"], last_flipped=outs["last_flipped"],
        num_flips=outs["num_flips"], cut_times=outs["cut_times"],
        waits_sum=scal_o[1], accept_count=ints_o[5], tries_sum=ints_o[6],
        exhausted_count=ints_o[7])
    return state, rows


def run_recom_chunk_cuda(dg, static, spec: Spec, params: StepParams, state,
                         t_inner: int, epsilon: float = 0.05,
                         pop_target=None, tree_retries: int = 4):
    """One chunk for every chain: (state, rows {name: (T, C)}). CUDA
    tensors launch the kernel (``static`` its tables; when None, a direct
    call, the request is checked and the tables made here); CPU tensors
    run the plain version, ``sampling/recom.py::recom_chunk_reference``.
    ``run_recom_chunk_cuda.launches`` counts kernel launches."""
    if t_inner < 1:
        raise ValueError(f"t_inner {t_inner} < 1")
    if state.reject_count is not None:
        raise ValueError("reject_count is not ported: the reject taxonomy "
                         "waits for ROADMAP.md A11a")
    dev = state.assignment.device
    if dev.type == "cuda":
        from . import _build
        if static is None:
            check(dg, spec, params)
            static = make_static_inputs(dg)
        out = _launch(_build.load("recom_chunk"), dg, static, spec, params,
                      state, t_inner, epsilon, pop_target, tree_retries)
        run_recom_chunk_cuda.launches += 1
        return out
    if dev.type == "cpu":
        from ..sampling import recom
        return recom.recom_chunk_reference(
            dg, spec, params, state, t_inner, epsilon=epsilon,
            pop_target=pop_target, tree_retries=tree_retries)
    raise ValueError(f"no ReCom chunk path for device {dev}")


run_recom_chunk_cuda.launches = 0
