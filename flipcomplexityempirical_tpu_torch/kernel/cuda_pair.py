"""The k-district pair-walk chunk kernel: its wrapper, its plain version,
its contract.

``run_general_pair_chunk_cuda`` runs ``t_inner`` steps of the JAX
package's ``general_dense`` body under the 'pair' proposal
(``kernel/dense.py::transition``: ``propose_dense``'s node-major (N, K)
selection, the shared ``commit`` with the distinct-pair count and the
boundary-length score, ``refresh_conn_bits``; then
``kernel/step.py::record``) for every chain of a ``ChainState``. On CUDA
tensors it launches the hand-written kernel of
``csrc/general_pair_chunk.cu`` (built on first use by ``_build``; one
warp a chain, a cell a node in shared memory holding its district, its
set of neighbouring districts and its conn bit, and the valid pairs'
counts by word and group of nodes kept up to date at each accepted move);
on CPU tensors it runs ``general_pair_chunk_reference``, the same body as
torch ops. Both draw the JAX package's threefry stream, ``split(key, 4)``
a step.

The kernel's scope (``supports``): the 'pair' proposal with 2 to
``MAX_DISTRICTS`` districts under re-propose semantics, accept 'cut', no
annealing, contiguity 'patch' (patches of at most 32 slots) or 'none',
``weighted_cut`` on or off, a population that varies by node,
``lazy_uniform``, ``parity_metrics``, ``geom_waits``. ``check`` refuses
the rest, naming the ROADMAP.md item; the runner never runs the plain
version in the kernel's place on the card.

    kernel inputs:  the graph's packed tables (``cuda_dense.pack_tables``),
        edges, populations, boundary-length weights and district labels;
        per chain key (2, C), assignment (C, N) int8, cut (C, E) int8,
        dist_pop (K, C), conn_bits (C, W) int32 bit patterns (or none: the
        kernel fills the plane first), scal (6, C) f32 [log_base, beta,
        pop_lo, pop_hi, cur_wait, waits_sum], ints (8, C) [cut_count,
        b_count, cur_flip_node, t_yield, move_clock, accept_count,
        tries_sum, exhausted_count], part_sum, last_flipped, num_flips
        (C, N) and cut_times (C, E);
    kernel outputs: the same per-chain fields after the chunk (cut and
        cut_deg recounted from the assignment), and the (T, C) rows
        cut_count, b_count, wait, accepts and, under ``lazy_uniform``,
        weight.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import cuda_dense, dense
from . import step as kstep
from .cuda_dense import _i32
from .step import Spec, StepParams, geom_denom_finite

# districts are bits of a uint8 set in the kernel
MAX_DISTRICTS = 8

ROW_NAMES = ("cut_count", "b_count", "wait", "accepts", "weight")


def row_names(spec: Spec) -> tuple:
    """The (T, C) rows a chunk writes (the weight under
    ``lazy_uniform``)."""
    return tuple(k for k in ROW_NAMES if k != "weight" or spec.lazy_uniform)


@dataclasses.dataclass
class PairStatic:
    """The kernel's graph tables on the run's device, made once a run."""

    tables: torch.Tensor       # uint8, ``cuda_dense.pack_tables``
    edges: torch.Tensor        # (E, 2) int32
    pop: torch.Tensor          # (N,) int32
    edge_len: torch.Tensor     # (E,) f32
    unit_pop: int              # every node's population, or 0 if it varies


def _refusal(dg, spec: Spec):
    """Why the kernel does not run (dg, spec), or None."""
    k = spec.n_districts
    if spec.proposal != "pair":
        return "the pair kernel runs proposal 'pair' only"
    if not 2 <= k <= MAX_DISTRICTS:
        return (f"the pair kernel holds 2 to {MAX_DISTRICTS} districts "
                f"(each node's neighbouring districts are a uint8 set); "
                f"k={k} is outside its limit")
    if spec.accept != "cut" or spec.anneal != "none":
        return (f"accept {spec.accept!r} / anneal {spec.anneal!r} in the "
                "pair kernel waits for ROADMAP.md B4 (the step tail's "
                "accept rules)")
    if spec.record_interface or spec.record_assignment_bits:
        return ("record_interface / record_assignment_bits in the pair "
                "kernel wait for ROADMAP.md B9 (the general path's kernels)")
    if not dense.supported(dg, spec):
        return ("kernel.dense.supported rejects this (graph, spec); the "
                "legacy body runs it (kernel_path='general')")
    if dg.max_patch > 32:
        return "patches above 32 slots do not fit the kernel's bitsets"
    if dg.n_nodes > cuda_dense.MAX_NODES or dg.max_deg > 32:
        return (f"the kernel holds at most {cuda_dense.MAX_NODES} nodes of "
                "degree at most 32")
    if spec.geom_waits and not geom_denom_finite(dg.n_nodes, k):
        return f"geom_waits: n**{k} - 1 overflows float32"
    return None


def supports(dg, spec: Spec) -> bool:
    """True iff the kernel reproduces (dg, spec) (module docstring)."""
    return _refusal(dg, spec) is None


def check(dg, spec: Spec, params: StepParams) -> None:
    """Raise unless the kernel reproduces the requested semantics."""
    why = _refusal(dg, spec)
    if why is not None:
        raise ValueError(f"the general pair kernel does not run {spec}: "
                         f"{why}")
    if params.label_values.numel() != spec.n_districts:
        raise ValueError("label_values must hold one label a district")


def unit_pop(dg) -> int:
    """Every node's population, or 0 where it varies by node."""
    pop = dg.pop
    return (int(pop[0]) if bool((pop == pop[0]).all()) and int(pop[0]) > 0
            else 0)


def make_static_inputs(dg) -> PairStatic:
    return PairStatic(tables=cuda_dense.pack_tables(dg),
                      edges=_i32(dg.edges), pop=_i32(dg.pop),
                      edge_len=dg.edge_len.to(torch.float32).contiguous(),
                      unit_pop=unit_pop(dg))


def general_pair_chunk_reference(dg, spec: Spec, params: StepParams, state,
                                 t_inner: int):
    """The plain version: the conn planes attached if absent, then
    ``t_inner`` rounds of ``dense.transition`` and ``step.record``.
    Returns (state, rows), rows {name: (T, C)}."""
    state = dense.ensure_conn_bits(dg, spec, state)
    return kstep.run_steps(dense.transition, dg, spec, params, state,
                           t_inner)


def _entry(lib):
    """``lib``'s ``fce_general_pair_chunk`` with its C signature: 34
    pointers (the last the optional recount counts), 14 ints, the wait
    denominator, the stream."""
    fn = lib.fce_general_pair_chunk
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 34 + [ctypes.c_int] * 14
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_shape(dg, n_chains: int, n_districts: int) -> dict:
    """How the kernel runs ``n_chains`` chains of ``dg`` at ``n_districts``
    on this card: ``smem_bytes`` a block, ``chains_per_block``,
    ``blocks_per_sm`` resident, ``threads`` a block, ``chain_bytes`` (a
    chain's shared memory), ``staged`` (the tables in shared memory;
    False: read through L1), ``producer`` (a draws warp a chain)."""
    from . import _build
    fn = _build.load("general_pair_chunk").fce_general_pair_shape
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    err = fn(n_chains, dg.n_nodes, dg.n_edges, dg.max_deg, dg.max_patch,
             n_districts, unit_pop(dg), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"general_pair_chunk shape query failed: CUDA "
                           f"error {err}")
    return dict(smem_bytes=out[0], chains_per_block=out[1],
                blocks_per_sm=out[2], threads=out[3], chain_bytes=out[4],
                staged=bool(out[5]), producer=bool(out[6]))


def _launch(lib, dg, static: PairStatic, spec: Spec, params: StepParams,
            state, t_inner: int, recounts):
    c, n = state.assignment.shape
    k = spec.n_districts
    dev = state.assignment.device
    ins, outs, rows, fill = cuda_dense.chunk_io(
        state, params, dg.n_edges, [(nm, t_inner) for nm in row_names(spec)])
    del ins["cut_deg"]                   # recounted from the assignment
    labels = params.label_values.to(device=dev,
                                    dtype=torch.int32).contiguous()
    ptrs = [static.tables, static.edges, static.pop, static.edge_len, labels,
            *ins.values(), *outs.values(), *(rows.get(nm) for nm in ROW_NAMES),
            recounts]
    ptrs = [None if x is None else x.data_ptr() for x in ptrs]
    # the literal wait denominator, float(n)**k - 1 in double, then f32
    denom = float(torch.tensor(float(n) ** k - 1.0, dtype=torch.float32))
    with torch.cuda.device(dev):
        err = _entry(lib)(
            *ptrs, c, n, dg.n_edges, dg.max_deg, dg.max_patch, k, t_inner,
            int(spec.contiguity == "patch"), int(spec.geom_waits),
            int(spec.lazy_uniform), int(spec.parity_metrics),
            int(spec.weighted_cut), int(fill), static.unit_pop, denom,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"general_pair_chunk launch failed: CUDA error "
                           f"{err}")
    return cuda_dense.chunk_state(state, outs), rows


def run_general_pair_chunk_cuda(dg, static: PairStatic, spec: Spec,
                                params: StepParams, state, t_inner: int, *,
                                recounts=None):
    """One chunk for every chain: (state, rows {name: (T, C)}), the state
    carrying its conn planes (filled first where it came without). CUDA
    tensors launch the kernel; CPU tensors run the plain version.
    ``recounts``, an int32 (C,) CUDA tensor, receives each chain's count
    of full recounts of its valid pairs after accepted moves (the kernel's
    own bookkeeping; the plain version has none).
    ``run_general_pair_chunk_cuda.launches`` counts kernel launches."""
    check(dg, spec, params)
    if t_inner < 1:
        raise ValueError(f"t_inner {t_inner} < 1")
    dev = state.assignment.device
    if recounts is not None and (
            recounts.device != dev or recounts.dtype != torch.int32
            or recounts.shape != (state.assignment.shape[0],)
            or not recounts.is_contiguous()):
        raise ValueError("recounts must be a contiguous int32 (C,) tensor "
                         "on the state's device")
    if dev.type == "cuda":
        from . import _build
        out = _launch(_build.load("general_pair_chunk"), dg, static, spec,
                      params, state, t_inner, recounts)
        run_general_pair_chunk_cuda.launches += 1
        return out
    if dev.type == "cpu":
        if recounts is not None:
            raise ValueError("recounts counts the kernel's bookkeeping; the "
                             "plain version keeps none")
        return general_pair_chunk_reference(dg, spec, params, state, t_inner)
    raise ValueError(f"no general pair chunk path for device {dev}")


run_general_pair_chunk_cuda.launches = 0
