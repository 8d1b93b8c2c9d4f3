"""Board form of the flip chains (the 2-district walk and the k-district
pair walk): types and the plain PyTorch pieces around the chunk kernels.

Port of ``flipcomplexityempirical_tpu/kernel/board.py`` for three bodies:

- the rook body, on a plain H x W rook grid: state is a flat (C, N) int8
  board, N = H*W, flat index x*W + y; its chunk runs in ``cuda_board``
  (the Pallas kernel's twin, on Philox) or, equal to the JAX package's
  rook bodies draw for draw, in ``cuda_lowered`` on the grid's stencil;
- the lowered body (``is_lowered``): a near-grid graph embedded by
  ``lower.stencil_for`` into an H x W canvas (holes carry district -1),
  with masked 8-direction planes, the exact B2-window contiguity, four
  forward cut planes (E, SE, S, SW) and the wall-key interface metrics;
  it serves surgical canvases (sec11, Frankengraph, queen grids) and every
  ``record_interface`` spec, and its chunk runs in ``cuda_lowered``.
- the k-district pair body (``is_pair``; slow_reversible_propose,
  grid_chain_sec11.py:117-130) on a plain rook grid that lowers: the walk
  uniform over distinct (boundary node, adjacent district) pairs in the
  row-major (node, rook direction) order, the ring contiguity of the
  origin district, population gates as per-chain district bitmasks; its
  plain pieces (``planes_pair``, ``transition_pair``, and the bitboard
  selection ``select_flat_pair`` that fixes the JAX package's trajectory)
  live here, its chunk runs in ``cuda_board_pair``.

The chunk of steps itself runs in a hand-written kernel, or its plain
version on the CPU; this module holds what runs around it: the stencil
planes, the cut recount, the flip-log replay of part_sum / last_flipped /
num_flips, the final record, initialisation and the per-edge cut_times
view.

Reference semantics (grid_chain_sec11.py, as the JAX package documents):
uniform boundary proposal with re-propose-until-valid collapsed into one
masked draw, the ring contiguity criterion, the literal ``base**(-dcut)``
accept, memoized geometric waits with the ``n**k - 1`` denominator, the
per-yield re-application of the last flip's bookkeeping, and per-yield
cut_times accumulation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import rng
from ..device import resolve_device
from ..graphs.lattice import LatticeGraph
from ..lower.stencil import stencil_for
from .step import Spec, StepParams, geom_denom_finite, sample_geom_minus1


@dataclasses.dataclass
class BoardGraph:
    """Static per-graph planes. The rook fields serve both bodies; the
    lowered fields (``lower.stencil.StencilSpec``'s planes) are set
    wherever the graph lowers to a stencil, and only the lowered body
    reads them."""

    pop: torch.Tensor      # int32[N] node population weights (0 at holes)
    deg: torch.Tensor      # int32[N] graph degree (<= 8)
    east_ok: torch.Tensor  # bool[N] node has an east (+1 flat) neighbor
    west_ok: torch.Tensor  # bool[N] node has a west (-1 flat) neighbor
    h: int
    w: int
    # --- lowered-stencil planes ---
    adj: Optional[torch.Tensor] = None           # bool[8, N] ring order
    node_mask: Optional[torch.Tensor] = None     # bool[N] real node cells
    cell_of_node: Optional[torch.Tensor] = None  # int64[n_real]
    b2_in: Optional[torch.Tensor] = None         # bool[K, N]
    b2_adj: Optional[torch.Tensor] = None        # int32[K, N]
    nbr_bits: Optional[torch.Tensor] = None      # int32[N]
    iface_key: Optional[torch.Tensor] = None     # int32[4, N]
    uniform_pop: bool = False
    surgical: bool = False
    real_nodes: int = 0
    b2_offsets: tuple = ()
    # (dr, dc) canvas displacement of each B2 offset; None where a flat
    # offset is two displacements (canvas width <= 4)
    b2_disp: Optional[tuple] = None
    b2_iters: int = 0
    patch_exact: bool = False
    iface_ok: bool = False
    iface_decode: tuple = (0, 0, 0, 0)
    center: tuple = (0.0, 0.0)

    @property
    def n(self) -> int:
        return self.h * self.w

    @property
    def n_real(self) -> int:
        """Real node count (canvas minus holes): the geometric-wait
        denominator uses this, never the canvas size."""
        return self.real_nodes or self.h * self.w


@dataclasses.dataclass
class BoardState:
    """Batched chain state, field for field the JAX package's
    ``BoardState``. ``key`` holds the raw uint32 threefry key words in
    int64; ``cut_times_e[c, i]`` counts cut yields of edge (i, i+1),
    ``cut_times_s[c, i]`` of edge (i, i+W); the lowered body adds the
    diagonal planes (None on rook-body states)."""

    key: torch.Tensor            # int64[C, 2]
    board: torch.Tensor          # int8[C, N] district 0..K-1 (0/1 'bi')
    dist_pop: torch.Tensor       # int32[C, K]
    cut_count: torch.Tensor      # int32[C]
    cur_wait: torch.Tensor       # f32[C] memoized geometric wait
    wait_pending: torch.Tensor   # bool[C]
    cur_flip: torch.Tensor       # int32[C] last accepted flip; -1 none
    cur_sign: torch.Tensor       # int32[C] label of cur_flip's district
    t_yield: torch.Tensor        # int32[C]
    move_clock: torch.Tensor     # int32[C]
    part_sum: torch.Tensor       # int32[C, N]
    last_flipped: torch.Tensor   # int32[C, N]
    num_flips: torch.Tensor      # int32[C, N]
    cut_times_e: torch.Tensor    # int32[C, N]
    cut_times_s: torch.Tensor    # int32[C, N]
    waits_sum: torch.Tensor      # f32[C] chunk-local (host drains to f64)
    accept_count: torch.Tensor   # int32[C]
    tries_sum: torch.Tensor      # int32[C]
    exhausted_count: torch.Tensor  # int32[C]
    # the lowered body's diagonal planes: edges (i, i+W+1), (i, i+W-1)
    cut_times_se: Optional[torch.Tensor] = None  # int32[C, N]
    cut_times_sw: Optional[torch.Tensor] = None  # int32[C, N]

    def replace(self, **kw) -> "BoardState":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Grid-shape inference and support predicate
# ---------------------------------------------------------------------------

def board_shape(graph: LatticeGraph):
    """(H, W) if ``graph`` is a plain full rook grid in sorted (x, y) label
    order, else None."""
    labs = graph.labels
    n = graph.n_nodes
    if n == 0 or not all(isinstance(l, tuple) and len(l) == 2 for l in labs):
        return None
    if not all(isinstance(v, (int, np.integer)) for v in labs[0]):
        return None
    xs = [l[0] for l in labs]
    ys = [l[1] for l in labs]
    h, w = max(xs) + 1, max(ys) + 1
    if min(xs) != 0 or min(ys) != 0 or h * w != n:
        return None
    if list(labs) != [(x, y) for x in range(h) for y in range(w)]:
        return None
    if graph.n_edges != h * (w - 1) + (h - 1) * w:
        return None
    lab_arr = np.array(labs, dtype=np.int64)
    d = np.abs(lab_arr[graph.edges[:, 0]] - lab_arr[graph.edges[:, 1]])
    if not (d.sum(axis=1) == 1).all():
        return None
    return h, w


def _shared_ok(spec: Spec) -> bool:
    return (spec.invalid == "repropose"
            and spec.anneal in ("none", "linear")
            and not spec.frame_interface
            and not spec.weighted_cut
            and not spec.record_assignment_bits
            and not spec.nobacktrack
            and not spec.lazy_uniform)


def _pair_ok(graph: LatticeGraph, spec: Spec) -> bool:
    """The k-district pair walk on a plain rook grid's stencil: 2 to 31
    districts, a uniform node population (the population gates are
    per-chain district bitmasks), accept 'cut' or 'always', and a wait
    denominator n**k - 1 that stays finite in f32."""
    st = stencil_for(graph)
    pop = np.asarray(graph.pop)
    k = spec.n_districts
    return (st is not None and not st.surgical
            and 2 <= k <= 31
            and spec.accept in ("cut", "always")
            and pop.size > 0 and bool((pop == pop[0]).all())
            and (not spec.geom_waits
                 or geom_denom_finite(graph.n_nodes, k))
            and spec.contiguity in ("patch", "none")
            and not spec.record_interface)


def supports(graph: LatticeGraph, spec: Spec) -> bool:
    """True iff a body of this module reproduces the reference chain for
    (graph, spec): under the 2-district 'bi' walk the rook body on a
    plain rook grid without ``record_interface``, or the lowered body on
    any graph ``lower.stencil_for`` embeds (surgical canvases, and every
    ``record_interface`` spec whose wall planes encode; lowered 'patch'
    contiguity needs the B2 tables to equal the graph's patch tables);
    under the k-district 'pair' walk the pair body on a plain rook grid
    that lowers (``_pair_ok``). The JAX package's ``supports``, case for
    case."""
    if not _shared_ok(spec):
        return False
    if spec.proposal == "pair":
        return _pair_ok(graph, spec)
    if not (spec.n_districts == 2 and spec.proposal == "bi"
            and spec.accept in ("cut", "corrected", "always")):
        return False
    st = stencil_for(graph)
    if st is None or not (st.surgical or spec.record_interface):
        return (board_shape(graph) is not None
                and spec.contiguity in ("patch", "none")
                and not spec.record_interface)
    return ((spec.contiguity == "none"
             or (spec.contiguity == "patch"
                 and (not st.surgical or st.patch_exact)))
            and (not spec.record_interface or st.iface_ok))


def is_lowered(bg: BoardGraph, spec: Spec) -> bool:
    """True iff chunks of (bg, spec) run on the lowered body."""
    return bg.surgical or spec.record_interface


def is_pair(spec: Spec) -> bool:
    """True iff chunks of ``spec`` run on the k-district pair body."""
    return spec.proposal == "pair"


def body_for(bg: BoardGraph, spec: Spec, bits: Optional[bool] = None) -> str:
    """The JAX package's body (its ``board.body_for``) that a board run of
    (bg, spec) equals draw for draw: under 'pair' 'bitboard' or 'board'
    (``cuda_board_pair.body_for``), else 'lowered_bits', 'lowered',
    'bitboard' or 'board' (``cuda_lowered.body_for``)."""
    from . import cuda_board_pair, cuda_lowered
    kern = cuda_board_pair if is_pair(spec) else cuda_lowered
    return kern.body_for(bg, spec, bits)


def make_board_graph(graph: LatticeGraph, device="cuda") -> BoardGraph:
    """The static planes of ``graph``: from its stencil where it lowers
    (every plain grid of height and width >= 3 included), else the rook
    planes of a plain rook grid."""
    dev = resolve_device(device)
    st = stencil_for(graph)
    if st is None:
        shape = board_shape(graph)
        if shape is None:
            raise ValueError(f"graph {graph.name!r} does not lower to a "
                             "board stencil (see lower.lower_to_stencil)")
        h, w = shape
        y = np.arange(h * w) % w
        return BoardGraph(
            pop=torch.as_tensor(graph.pop, dtype=torch.int32, device=dev),
            deg=torch.as_tensor(graph.deg, dtype=torch.int32, device=dev),
            east_ok=torch.as_tensor(y < w - 1, device=dev),
            west_ok=torch.as_tensor(y > 0, device=dev),
            h=h, w=w, cell_of_node=torch.arange(h * w, device=dev))

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    return BoardGraph(
        pop=t(st.pop, torch.int32), deg=t(st.deg, torch.int32),
        east_ok=t(st.adj[0]), west_ok=t(st.adj[4]), h=st.h, w=st.w,
        adj=t(st.adj), node_mask=t(st.node_mask),
        cell_of_node=t(st.cell_of_node, torch.int64),
        b2_in=t(st.b2_in), b2_adj=t(st.b2_adj, torch.int32),
        nbr_bits=t(st.nbr_bits, torch.int32),
        iface_key=(t(st.iface_key, torch.int32)
                   if st.iface_key is not None else None),
        uniform_pop=st.uniform_pop, surgical=st.surgical,
        real_nodes=st.n_real, b2_offsets=st.b2_offsets,
        b2_disp=st.b2_disp, b2_iters=st.b2_iters, patch_exact=st.patch_exact,
        iface_ok=st.iface_ok, iface_decode=st.iface_decode,
        center=st.center)


def node_view(bg: BoardGraph, arr):
    """Restrict a canvas-indexed (..., N) array to real nodes in node
    order (..., n_real); identity on plain full grids. Host-side."""
    arr = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else arr
    return np.asarray(arr)[..., bg.cell_of_node.cpu().numpy()]


# ---------------------------------------------------------------------------
# Stencil planes
# ---------------------------------------------------------------------------

def _shifted(board: torch.Tensor, w: int, o: int) -> torch.Tensor:
    """value[:, i] = board[:, i + o], -1 off the flat range
    (|o| <= 2w + 2)."""
    n = board.shape[1]
    pad = 2 * w + 2
    p = torch.nn.functional.pad(board, (pad, pad), value=-1)
    return p[:, pad + o: pad + o + n]


def same_planes(bg: BoardGraph, board: torch.Tensor) -> list:
    """same[i][c, n]: ring-offset-i neighbor of n exists and shares n's
    district. Ring order E, SE, S, SW, W, NW, N, NE (rook at even
    indices); row wraps are masked, off-grid pads never match."""
    w = bg.w
    e, wk = bg.east_ok, bg.west_ok

    def sh(o):
        return _shifted(board, w, o) == board

    return [sh(1) & e, sh(w + 1) & e, sh(w), sh(w - 1) & wk,
            sh(-1) & wk, sh(-w - 1) & wk, sh(-w), sh(-w + 1) & e]


def cut_planes(bg: BoardGraph, board: torch.Tensor):
    """(cut_e, cut_s) bool[C, N]: cut indicators of the east (i, i+1) and
    south (i, i+W) edges of each node."""
    n = bg.n
    south_ok = torch.arange(n, device=board.device) < (bg.h - 1) * bg.w
    cut_e = bg.east_ok[None] & (_shifted(board, bg.w, 1) != board)
    cut_s = south_ok[None] & (_shifted(board, bg.w, bg.w) != board)
    return cut_e, cut_s


def recount_cuts(bg: BoardGraph, board: torch.Tensor) -> torch.Tensor:
    """i32[C] cut-edge count recomputed from the board."""
    if bg.surgical:
        same = same_planes_stencil(bg, board)
        # forward planes only: each edge counted once
        return sum((bg.adj[d][None] & ~same[d]).sum(dim=1)
                   for d in range(4)).to(torch.int32)
    cut_e, cut_s = cut_planes(bg, board)
    return (cut_e.sum(dim=1) + cut_s.sum(dim=1)).to(torch.int32)


def ring_contig_ok(same: list) -> torch.Tensor:
    """The ring criterion (== the radius-2 patch check on plain rook
    grids): ok iff <= 1 same-district rook neighbor, or all of them lie in
    one cyclically adjacent block linked through the diagonals."""
    seeds = sum(same[i].to(torch.int32) for i in (0, 2, 4, 6))
    runs = torch.zeros_like(seeds)
    for i in (0, 2, 4, 6):
        linked = same[(i - 1) % 8] & same[(i - 2) % 8]
        runs = runs + (same[i] & ~linked).to(torch.int32)
    return (seeds <= 1) | (runs <= 1)


def _planes(bg: BoardGraph, board: torch.Tensor) -> dict:
    """What a record reads off the current board: the boundary count and
    the cut planes (the JAX package's ``_planes`` also builds the validity
    plane, which only a transition reads)."""
    same = same_planes(bg, board)
    same_deg = sum(same[i].to(torch.int32) for i in (0, 2, 4, 6))
    b_count = (bg.deg[None] - same_deg > 0).sum(dim=1).to(torch.int32)
    south_ok = torch.arange(bg.n, device=board.device) < (bg.h - 1) * bg.w
    return dict(b_count=b_count, cut_e=bg.east_ok[None] & ~same[0],
                cut_s=south_ok[None] & ~same[2])


# ---------------------------------------------------------------------------
# k-district pair body (slow_reversible_propose semantics)
# ---------------------------------------------------------------------------

PAIR_DIRS = 4           # rook directions, fixed order E, S, W, N


def pair_offsets(w: int) -> tuple:
    """Flat offsets of the pair body's directions E, S, W, N."""
    return (1, w, -1, -w)


def _rook_masks(bg: BoardGraph, device) -> tuple:
    """bool (N,) existence masks of the E, S, W, N neighbours."""
    flat = torch.arange(bg.n, device=device)
    return (bg.east_ok, flat < (bg.h - 1) * bg.w, bg.west_ok, flat >= bg.w)


def nbr_value_planes(bg: BoardGraph, board: torch.Tensor) -> list:
    """Rook-neighbour district planes (-1 off the flat range), with their
    existence masks, in E, S, W, N order (the JAX package's
    ``_nbr_value_planes``)."""
    masks = _rook_masks(bg, board.device)
    return [(_shifted(board, bg.w, o), m[None])
            for o, m in zip(pair_offsets(bg.w), masks)]


def pop_gate_bits(bg: BoardGraph, k: int, pop_lo, pop_hi,
                  dist_pop: torch.Tensor):
    """The pair body's population gates as per-chain district bitmasks
    (uniform node population): bit d of ``from_bits[c]`` is "district d may
    lose one unit", ``dp - unit >= pop_lo`` in f32, of ``to_bits[c]`` "may
    gain one", ``dp + unit <= pop_hi``. int64 (C,) each."""
    f32 = torch.float32
    unit = bg.pop[0].to(f32)
    dp = dist_pop.to(f32)
    weights = (torch.ones(k, dtype=torch.int64, device=dp.device)
               << torch.arange(k, device=dp.device))[None]
    zero = torch.zeros_like(weights)
    from_bits = torch.where(dp - unit >= pop_lo[:, None], weights,
                            zero).sum(dim=1)
    to_bits = torch.where(dp + unit <= pop_hi[:, None], weights,
                          zero).sum(dim=1)
    return from_bits, to_bits


def planes_pair(bg: BoardGraph, spec: Spec, pop_lo, pop_hi,
                board: torch.Tensor, dist_pop: torch.Tensor) -> dict:
    """Per-(node, direction) pair validity of the k-district proposal (the
    JAX package's ``_planes_pair``, grid_chain_sec11.py:117-130): uniform
    over DISTINCT (boundary node, adjacent district != own) pairs. A
    direction carries a pair iff its neighbour exists, differs from the
    node's district, and no earlier direction's neighbour holds the same
    district (the reference's pair updater is a set). ``b_count`` is the
    distinct-pair count before the contiguity and population gates; the
    contiguity is the ring criterion of the origin district; ``valid`` is
    (C, N * 4) in the row-major (node, direction) order v * 4 + j, and
    ``valid4`` its four (C, N) direction planes."""
    nbrs = nbr_value_planes(bg, board)
    same = same_planes(bg, board)
    diff = [ex & ~s for (_, ex), s in zip(nbrs, same[0::2])]
    if spec.contiguity == "patch":
        contig = ring_contig_ok(same)
    else:
        contig = torch.ones_like(diff[0])
    from_bits, to_bits = pop_gate_bits(bg, spec.n_districts, pop_lo, pop_hi,
                                       dist_pop)
    ok_from = ((from_bits[:, None] >> board.to(torch.int64)) & 1) == 1
    pairs = []
    b_count = torch.zeros(board.shape[0], dtype=torch.int32,
                          device=board.device)
    for j, (v, ex) in enumerate(nbrs):
        pj = diff[j]
        for vp, exp in nbrs[:j]:            # dedup repeated districts
            pj = pj & ~(exp & (vp == v))
        b_count = b_count + pj.sum(dim=1).to(torch.int32)
        vi = torch.clamp_min(v.to(torch.int64), 0)
        ok_to = ((to_bits[:, None] >> vi) & 1) == 1
        pairs.append(pj & contig & ok_from & ok_to)
    valid = torch.stack(pairs, dim=2).reshape(board.shape[0], -1)
    south_ok = _rook_masks(bg, board.device)[1]
    return dict(valid=valid, valid4=pairs, b_count=b_count,
                cut_e=bg.east_ok[None] & ~same[0],
                cut_s=south_ok[None] & ~same[2])


def supported_pair(bg: BoardGraph, spec: Spec) -> bool:
    """The JAX package's gate of its packed pair body
    (``bitboard.supported_pair``): a uniform-population rook grid whose
    width is a multiple of 32, accept 'cut' / 'always', contiguity 'patch'
    / 'none', 2 to 31 districts and a finite wait denominator. Where it
    fails the JAX package runs its int8 pair body, the same trajectory."""
    return (bool(bg.uniform_pop) and not bg.surgical
            and not spec.record_interface and bg.w % 32 == 0
            and spec.accept in ("cut", "always")
            and spec.contiguity in ("patch", "none")
            and not spec.record_assignment_bits
            and spec.proposal == "pair"
            and 2 <= spec.n_districts <= 31
            and (not spec.geom_waits
                 or geom_denom_finite(bg.n, spec.n_districts)))


def pick_row(rowcnt: torch.Tensor, u: torch.Tensor):
    """The first level of the two-level m-th-valid selection (the JAX
    package's ``bitboard._pick_row``): m = min(int(u * total), total - 1)
    in f32, the row holding the m-th valid slot. Returns (row, m_in_row,
    any_valid)."""
    rowcum = torch.cumsum(rowcnt, dim=1)
    total = rowcum[:, -1]
    m = torch.minimum((u * total.to(torch.float32)).to(torch.int64),
                      torch.clamp_min(total - 1, 0))
    row = (rowcum > m[:, None]).to(torch.int8).argmax(dim=1)
    before = torch.where(
        row > 0, rowcum.gather(1, torch.clamp_min(row - 1, 0)[:, None])[:, 0],
        torch.zeros_like(row))
    return row, m - before, total > 0


def select_flat_pair(bg: BoardGraph, valid4: list, u: torch.Tensor):
    """The (m+1)-th valid (node, direction) slot in the row-major order
    flat4 = v * 4 + j (the JAX package's ``bitboard.select_flat_pair``):
    the row of the grid by ``pick_row``, then the slot within its 4 * w
    interleaved slots. With no valid slot it returns slot 0. Returns
    (flat4 int64 (C,), any_valid)."""
    c = valid4[0].shape[0]
    h, w = bg.h, bg.w
    slots = torch.stack(valid4, dim=2).reshape(c, h, PAIR_DIRS * w)
    row, m_in_row, any_valid = pick_row(
        slots.sum(dim=2, dtype=torch.int64), u)
    in_row = slots[torch.arange(c, device=row.device), row]
    col4 = (torch.cumsum(in_row.to(torch.int64), dim=1)
            > m_in_row[:, None]).to(torch.int8).argmax(dim=1)
    return row * (PAIR_DIRS * w) + col4, any_valid


def value_at(board: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """The district at ``flat[c]`` of each chain, int32 (the JAX
    package's ``bitboard.value_at``)."""
    return board.gather(1, flat.to(torch.int64)[:, None])[:, 0].to(
        torch.int32)


def transition_pair(bg: BoardGraph, spec: Spec, beta, log_base,
                    board: torch.Tensor, dist_pop: torch.Tensor,
                    planes: dict, u_prop: torch.Tensor,
                    u_acc: torch.Tensor) -> dict:
    """The pair transition (the JAX package's ``_transition_pair``):
    select the m-th valid (node, direction) slot, flip the node to that
    direction's neighbour district by the literal ``base**(-dcut)`` bound
    (or always), dcut from the node's rook neighbourhood. Returns the new
    board and dist_pop with the step's flat, d_to, dcut, accept and
    any_valid; the caller commits the counters."""
    f32 = torch.float32
    c, n = board.shape
    flat4, any_valid = select_flat_pair(bg, planes["valid4"], u_prop)
    flat = torch.div(flat4, PAIR_DIRS, rounding_mode="floor")
    j = flat4 % PAIR_DIRS
    offs = torch.tensor(pair_offsets(bg.w), device=board.device)
    d_from = value_at(board, flat)
    d_to = value_at(board, torch.clamp(flat + offs[j], 0, n - 1))
    dcut = torch.zeros(c, dtype=torch.int32, device=board.device)
    for o, m in zip(pair_offsets(bg.w), _rook_masks(bg, board.device)):
        au = value_at(board, torch.clamp(flat + o, 0, n - 1))
        dcut = dcut + torch.where(
            m[flat], (au != d_to).to(torch.int32)
            - (au != d_from).to(torch.int32), 0)
    if spec.accept == "always":
        accept = any_valid
    else:
        tiny = torch.tensor(1e-12, dtype=f32, device=board.device)
        bound = -beta * dcut.to(f32) * log_base
        accept = any_valid & (torch.log(torch.maximum(u_acc, tiny)) < bound)
    ar = torch.arange(c, device=board.device)
    board = board.clone()
    board[ar, flat] = torch.where(accept, d_to, d_from).to(board.dtype)
    popv = (bg.pop[flat] * accept.to(torch.int32))[:, None]
    dist = torch.arange(dist_pop.shape[1], device=board.device)[None]
    dist_pop = (dist_pop + popv * ((dist == d_to[:, None]).to(torch.int32)
                                   - (dist == d_from[:, None]).to(
                                       torch.int32))).to(torch.int32)
    return dict(board=board, dist_pop=dist_pop, flat=flat.to(torch.int32),
                d_to=d_to, dcut=dcut, accept=accept, any_valid=any_valid)


# ---------------------------------------------------------------------------
# Lowered stencil body: masked 8-direction planes (holes + diagonals)
# ---------------------------------------------------------------------------

CUT_KEYS = ("cut_e", "cut_se", "cut_s", "cut_sw")
IFACE_BIG = 2 ** 30


def ring_offsets(w: int) -> tuple:
    """Flat offsets of the ring directions E, SE, S, SW, W, NW, N, NE."""
    return (1, w + 1, w, w - 1, -1, -w - 1, -w, -w + 1)


def same_planes_stencil(bg: BoardGraph, board: torch.Tensor) -> list:
    """same[d][c, i]: the ring-d neighbor EDGE exists in the lowered graph
    and its cell shares i's district. Every direction, diagonals included,
    is masked by its static adjacency plane, so holes and seams are
    exact."""
    return [(_shifted(board, bg.w, o) == board) & bg.adj[d][None]
            for d, o in enumerate(ring_offsets(bg.w))]


def _or_over(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR of an integer tensor over ``dim``, by halving."""
    while x.shape[dim] > 1:
        if x.shape[dim] % 2:
            x = torch.cat([x, torch.zeros_like(x.narrow(dim, 0, 1))], dim=dim)
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) | x.narrow(dim, half, half)
    return x.squeeze(dim)


def stencil_patch_ok(bg: BoardGraph, board: torch.Tensor) -> torch.Tensor:
    """The exact radius-2 ``patch_connected`` check for every cell at
    once, as a bitset propagation over static flat offsets (the JAX
    package's ``_stencil_patch_ok``): member bitset over the K B2-window
    offsets (same district as the center, in its patch), seeds = direct
    neighbors, reach grows from the lowest seed through ``b2_adj`` in
    Jacobi rounds, ok iff every seed is reached. The rounds stop at the
    fixpoint (at most ``b2_iters`` of them, which bound every shortest
    path in a patch), where more rounds would change nothing."""
    c, n = board.shape
    dev = board.device
    i32 = torch.int32
    pad = 2 * bg.w + 2
    offs = torch.tensor(bg.b2_offsets, dtype=torch.int64, device=dev)
    idx = pad + torch.arange(n, device=dev)[None, :] + offs[:, None]
    p = torch.nn.functional.pad(board, (pad, pad), value=-1)
    same = (p[:, idx] == board[:, None, :]) & bg.b2_in[None]   # (C, K, N)
    shifts = torch.arange(len(bg.b2_offsets), dtype=i32,
                          device=dev)[None, :, None]
    # distinct bits: their sum is their OR
    member = (same.to(i32) << shifts).sum(dim=1).to(i32)
    seeds = member & bg.nbr_bits[None]
    reach = seeds & -seeds                     # lowest set bit (0 if none)
    for _ in range(bg.b2_iters):
        hit = ((reach[:, None, :] >> shifts) & 1) == 1
        contrib = _or_over(torch.where(hit, bg.b2_adj[None], 0), dim=1)
        grown = reach | (contrib & member)
        if torch.equal(grown, reach):
            break
        reach = grown
    return (seeds & ~reach) == 0


def planes_stencil(bg: BoardGraph, spec: Spec, pop_lo, pop_hi,
                   board: torch.Tensor, dist_pop: torch.Tensor) -> dict:
    """The lowered body's plane pass (the JAX package's
    ``_planes_stencil``): 8 masked same-planes, the graph degree, the 4
    forward cut planes (E, SE, S, SW), B2 contiguity, the population gate
    and validity."""
    same = same_planes_stencil(bg, board)
    same_deg = sum(x.to(torch.int32) for x in same)
    diff_deg = bg.deg[None] - same_deg
    b_mask = (diff_deg > 0) & bg.node_mask[None]
    b_count = b_mask.sum(dim=1).to(torch.int32)
    cuts = {k: bg.adj[d][None] & ~same[d] for d, k in enumerate(CUT_KEYS)}
    if spec.contiguity == "patch":
        contig = stencil_patch_ok(bg, board)
    else:
        contig = torch.ones_like(b_mask)
    # the exact-f32 threshold form: ceil / floor of the bounds keep every
    # operand an exact f32 integer; hole cells hold -1 (is1 False, pop 0)
    # and are out of b_mask regardless
    f32 = torch.float32
    p0, p1 = dist_pop[:, 0].to(f32), dist_pop[:, 1].to(f32)
    lo, hi = torch.ceil(pop_lo), torch.floor(pop_hi)
    thr0 = torch.minimum(p0 - lo, hi - p1)
    thr1 = torch.minimum(p1 - lo, hi - p0)
    popn = bg.pop[None].to(f32)
    pop_ok = popn <= torch.where(board == 1, thr1[:, None], thr0[:, None])
    return dict(valid=b_mask & contig & pop_ok, b_count=b_count,
                diff_deg=diff_deg, **cuts)


def interface_stencil(bg: BoardGraph, cuts: list):
    """The interface metrics on the lowered cut planes: each wall edge's
    static key packs (canonical edge index << coord bits | doubled
    midpoint coords), so the two smallest keys over the cut planes are
    the two smallest-index wall-cut edges; their midpoints decode
    arithmetically. Returns f32 (slope, angle), NaN where fewer than two
    wall edges are cut."""
    qx_off, qy_off, bx, by = bg.iface_decode
    f32 = torch.float32
    keyed = [torch.where(cuts[d], bg.iface_key[d][None], IFACE_BIG)
             for d in range(4)]
    first = keyed[0].min(dim=1).values
    for kd in keyed[1:]:
        first = torch.minimum(first, kd.min(dim=1).values)
    second = None
    for kd in keyed:
        sk = torch.where(kd > first[:, None], kd, IFACE_BIG).min(dim=1).values
        second = sk if second is None else torch.minimum(second, sk)
    ok = second < IFACE_BIG

    def decode(key):
        qy = (key & ((1 << by) - 1)) + qy_off
        qx = ((key >> by) & ((1 << bx) - 1)) + qx_off
        return qx.to(f32) * 0.5, qy.to(f32) * 0.5

    ax, ay = decode(first)
    ex, ey = decode(second)
    dx, dy = ex - ax, ey - ay
    one = torch.ones_like(dx)
    slope = torch.where(dx != 0, dy / torch.where(dx != 0, dx, one),
                        torch.full_like(dx, float("inf")))
    cx = torch.tensor(bg.center[0], dtype=f32, device=dx.device)
    cy = torch.tensor(bg.center[1], dtype=f32, device=dx.device)
    vax, vay = ax - cx, ay - cy
    vbx, vby = ex - cx, ey - cy
    norm = (torch.sqrt(vax * vax + vay * vay)
            * torch.sqrt(vbx * vbx + vby * vby))
    tiny = torch.tensor(1e-12, dtype=f32, device=dx.device)
    cosang = torch.clamp((vax * vbx + vay * vby) / torch.maximum(norm, tiny),
                         -1.0, 1.0)
    angle = torch.acos(cosang)
    nan = torch.full_like(dx, float("nan"))
    return torch.where(ok, slope, nan), torch.where(ok, angle, nan)


# ---------------------------------------------------------------------------
# Record: wait completion, history row, flip-log row
# ---------------------------------------------------------------------------

def _complete_wait(spec: Spec, state: BoardState, b_count, kwait,
                   n_nodes: int):
    if not spec.geom_waits:
        return state.cur_wait
    w = sample_geom_minus1(kwait, b_count, n_nodes, spec.n_districts)
    return torch.where(state.wait_pending, w, state.cur_wait)


def _record(state: BoardState, planes: dict, cur_wait):
    """The measurement yield: history row, flip-log row, wait bookkeeping,
    yield clock, cut_times planes."""
    out = {"cut_count": state.cut_count, "b_count": planes["b_count"],
           "wait": cur_wait, "accepts": state.accept_count}
    log = {"f": state.cur_flip, "s": state.cur_sign}
    state = state.replace(
        cur_wait=cur_wait,
        wait_pending=torch.zeros_like(state.wait_pending),
        waits_sum=state.waits_sum + cur_wait,
        t_yield=state.t_yield + 1,
        cut_times_e=state.cut_times_e + planes["cut_e"].to(torch.int32),
        cut_times_s=state.cut_times_s + planes["cut_s"].to(torch.int32))
    return state, out, log


# ---------------------------------------------------------------------------
# Deferred flip bookkeeping: log -> (part_sum, last_flipped, num_flips)
# ---------------------------------------------------------------------------

def apply_flip_log(part_sum, last_flipped, num_flips, log_f, log_s, t0):
    """Replay the reference's per-yield flip bookkeeping
    (grid_chain_sec11.py:396-400) from a chunk's (T, C) log; ``t0[c]`` is
    the absolute yield of log row 0. Per yield t with pointer f >= 0 and
    sign s:
        part_sum[f]     += -s * (t - last_flipped[f])
        last_flipped[f]  = t
        num_flips[f]    += 1

    One sort of the key ``f*T + t`` per chain groups the log by pointer
    node with yield order kept inside each group; each entry then weighs
    ``-s * (t - prev)``, where ``prev`` is the group's previous yield or,
    for a group's first entry, the carried ``last_flipped[f]``. Integer
    ``scatter_add_`` sums the weights and the flip counts, and a
    ``scatter_reduce_('amax')`` takes each node's last yield. Rows with
    f = -1 go to a spare column that is dropped. Exact in int64;
    chunks compose through the carried last_flipped."""
    tlen, c = log_f.shape
    n = part_sum.shape[1]
    dev = part_sum.device
    i64 = torch.int64
    f = log_f.T.to(i64)                                   # (C, T)
    s = log_s.T.to(i64)
    t_rel = torch.arange(tlen, dtype=i64, device=dev)[None, :]
    key, order = torch.sort(f * tlen + t_rel, dim=1)
    f_s = torch.div(key, tlen, rounding_mode="floor")    # -1 preserved
    t_abs = t0.to(i64)[:, None] + key - f_s * tlen
    s_s = torch.gather(s, 1, order)
    act = f_s >= 0
    col = torch.where(act, f_s, n)                       # spare column n
    prev_same = torch.zeros_like(act)
    prev_same[:, 1:] = f_s[:, 1:] == f_s[:, :-1]
    prev_t = torch.zeros_like(t_abs)
    prev_t[:, 1:] = t_abs[:, :-1]
    lf_pad = torch.nn.functional.pad(last_flipped.to(i64), (0, 1))
    carried = torch.gather(lf_pad, 1, col)
    prev = torch.where(prev_same, prev_t, carried)
    w_ps = torch.where(act, -s_s * (t_abs - prev), 0)

    ps_d = torch.zeros((c, n + 1), dtype=i64, device=dev)
    ps_d.scatter_add_(1, col, w_ps)
    nf_d = torch.zeros((c, n + 1), dtype=i64, device=dev)
    nf_d.scatter_add_(1, col, act.to(i64))
    lf_d = torch.full((c, n + 1), -1, dtype=i64, device=dev)
    lf_d.scatter_reduce_(1, col, torch.where(act, t_abs, -1), reduce="amax")
    ps_new = (part_sum.to(i64) + ps_d[:, :n]).to(part_sum.dtype)
    nf_new = (num_flips.to(i64) + nf_d[:, :n]).to(num_flips.dtype)
    lf_new = torch.where(nf_d[:, :n] > 0, lf_d[:, :n],
                         last_flipped.to(i64)).to(last_flipped.dtype)
    return ps_new, lf_new, nf_new


# ---------------------------------------------------------------------------
# Epilogue, init, host-side views
# ---------------------------------------------------------------------------

def _split4(keys: torch.Tensor):
    ks = rng.split(keys, 4)
    return ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]


def _record_stencil(bg: BoardGraph, spec: Spec, state: BoardState,
                    planes: dict, cur_wait):
    """The lowered body's measurement yield: ``_record``'s row with the
    four forward cut planes and, under ``record_interface``, the
    interface slope / angle."""
    out = {"cut_count": state.cut_count, "b_count": planes["b_count"],
           "wait": cur_wait, "accepts": state.accept_count}
    if spec.record_interface:
        if not bg.iface_ok:
            raise ValueError("record_interface needs wall planes the "
                             "lowering could not encode (lower.stencil)")
        out["slope"], out["angle"] = interface_stencil(
            bg, [planes[k] for k in CUT_KEYS])
    log = {"f": state.cur_flip, "s": state.cur_sign}
    i32 = torch.int32
    state = state.replace(
        cur_wait=cur_wait,
        wait_pending=torch.zeros_like(state.wait_pending),
        waits_sum=state.waits_sum + cur_wait,
        t_yield=state.t_yield + 1,
        cut_times_e=state.cut_times_e + planes["cut_e"].to(i32),
        cut_times_se=state.cut_times_se + planes["cut_se"].to(i32),
        cut_times_s=state.cut_times_s + planes["cut_s"].to(i32),
        cut_times_sw=state.cut_times_sw + planes["cut_sw"].to(i32))
    return state, out, log


def record_final(bg: BoardGraph, spec: Spec, params: StepParams,
                 state: BoardState):
    """Epilogue: complete any pending wait and record the last yield,
    without a trailing transition (the pair body's record: its
    distinct-pair count and its n**k - 1 wait). Returns (state, history
    row)."""
    t0 = state.t_yield
    key, _, _, kwait = _split4(state.key)
    state = state.replace(key=key)
    if is_lowered(bg, spec):
        planes = planes_stencil(bg, spec, params.pop_lo, params.pop_hi,
                                state.board, state.dist_pop)
        cur_wait = _complete_wait(spec, state, planes["b_count"], kwait,
                                  bg.n_real)
        state, out, log = _record_stencil(bg, spec, state, planes, cur_wait)
    else:
        planes = (planes_pair(bg, spec, params.pop_lo, params.pop_hi,
                              state.board, state.dist_pop)
                  if is_pair(spec) else _planes(bg, state.board))
        cur_wait = _complete_wait(spec, state, planes["b_count"], kwait,
                                  bg.n)
        state, out, log = _record(state, planes, cur_wait)
    if spec.parity_metrics:
        ps, lf, nf = apply_flip_log(state.part_sum, state.last_flipped,
                                    state.num_flips, log["f"][None],
                                    log["s"][None], t0)
        state = state.replace(part_sum=ps, last_flipped=lf, num_flips=nf)
    return state, out


def init_board_state(graph: LatticeGraph, bg: BoardGraph,
                     assignment: np.ndarray, n_chains: int, seed: int,
                     spec: Spec, params: StepParams) -> BoardState:
    """Broadcast a node-order assignment (length n_real) onto the canvas
    (holes carry district -1, pop 0) and seed the per-chain state; keys
    are ``jax.random.split(PRNGKey(seed), C)``."""
    dev = bg.pop.device
    n = bg.n
    lowered = is_lowered(bg, spec)
    a = np.asarray(assignment, np.int8)
    cell = bg.cell_of_node.cpu().numpy()
    a0 = np.full(n, -1, np.int8)
    a0[cell] = a
    pops = np.bincount(a.astype(np.int64), weights=graph.pop,
                       minlength=spec.n_districts).astype(np.int32)
    label_values = params.label_values.cpu().numpy()
    part0 = np.zeros(n, np.int32)
    part0[cell] = label_values[a.astype(np.int64)]
    cut0 = int((a[graph.edges[:, 0]] != a[graph.edges[:, 1]]).sum())

    def full(v, dtype):
        return torch.full((n_chains,), v, dtype=dtype, device=dev)

    def plane(row):
        return (torch.as_tensor(row, device=dev)[None]
                .expand(n_chains, -1).contiguous())

    def zplane():
        return torch.zeros((n_chains, n), dtype=torch.int32, device=dev)

    return BoardState(
        key=rng.split(rng.prng_key(seed, device=dev), n_chains),
        board=plane(a0),
        dist_pop=plane(pops),
        cut_count=full(cut0, torch.int32),
        cur_wait=full(0.0, torch.float32),
        # the initial state's wait is sampled at the first yield
        wait_pending=full(bool(spec.geom_waits), torch.bool),
        cur_flip=full(-1, torch.int32),
        cur_sign=full(0, torch.int32),
        t_yield=full(0, torch.int32),
        move_clock=full(0, torch.int32),
        part_sum=plane(part0),
        last_flipped=zplane(),
        num_flips=zplane(),
        cut_times_e=zplane(),
        cut_times_s=zplane(),
        waits_sum=full(0.0, torch.float32),
        accept_count=full(0, torch.int32),
        tries_sum=full(0, torch.int32),
        exhausted_count=full(0, torch.int32),
        cut_times_se=zplane() if lowered else None,
        cut_times_sw=zplane() if lowered else None)


def edge_cut_times(graph: LatticeGraph, state: BoardState) -> np.ndarray:
    """cut_times as a (C, E) numpy array in LatticeGraph edge order. Each
    edge's plane (E, SE, S, SW) and cell come from the lowering's
    per-edge map, so holes, diagonal and seam edges land in the right
    accumulator; a plain grid too small to lower reads edge (u, u+1) from
    the E plane at u and (u, u+W) from the S plane."""
    st = stencil_for(graph)
    planes = {0: state.cut_times_e.cpu().numpy(),
              2: state.cut_times_s.cpu().numpy()}
    if st is None:
        shape = board_shape(graph)
        if shape is None:
            raise ValueError(f"graph {graph.name!r} is not a plain rook "
                             "grid and does not lower to a stencil")
        u = graph.edges[:, 0].astype(np.int64)
        east = (graph.edges[:, 1] - u == 1) & (shape[1] > 1)
        return np.where(east[None], planes[0][:, u], planes[2][:, u])
    if state.cut_times_se is not None:
        planes[1] = state.cut_times_se.cpu().numpy()
        planes[3] = state.cut_times_sw.cpu().numpy()
    out = np.empty((planes[0].shape[0], graph.n_edges), planes[0].dtype)
    for d in (0, 1, 2, 3):
        sel = np.asarray(st.edge_plane) == d
        if not sel.any():
            continue
        if d not in planes:
            raise ValueError("graph has diagonal edges but state has no "
                             "diagonal cut_times planes (the chunk was "
                             "not run on the lowered body)")
        out[:, sel] = planes[d][:, np.asarray(st.edge_cell)[sel]]
    return out
