"""Board form of the 2-district flip chain on a plain rook grid: types and
the plain PyTorch pieces around the chunk kernel.

Port of the rook-grid subset of ``flipcomplexityempirical_tpu/kernel/
board.py``. State is a flat (C, N) int8 board, N = H*W, flat index
x*W + y. The chunk of steps itself runs in ``cuda_board`` (a hand-written
kernel, or its plain version on the CPU); this module holds what runs
around it: the stencil planes, the cut recount, the flip-log replay of
part_sum / last_flipped / num_flips, the final record, initialisation and
the per-edge cut_times view.

Reference semantics (grid_chain_sec11.py, as the JAX package documents):
uniform boundary proposal with re-propose-until-valid collapsed into one
masked draw, the ring contiguity criterion, the literal ``base**(-dcut)``
accept, memoized geometric waits with the ``n**k - 1`` denominator, the
per-yield re-application of the last flip's bookkeeping, and per-yield
cut_times accumulation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rng
from ..device import resolve_device
from ..graphs.lattice import LatticeGraph
from .step import Spec, StepParams, sample_geom_minus1


@dataclasses.dataclass
class BoardGraph:
    """Static per-graph planes of a plain rook grid."""

    pop: torch.Tensor      # int32[N] node population weights
    deg: torch.Tensor      # int32[N] graph degree (<= 4)
    east_ok: torch.Tensor  # bool[N] node has an east (+1 flat) neighbor
    west_ok: torch.Tensor  # bool[N] node has a west (-1 flat) neighbor
    h: int
    w: int

    @property
    def n(self) -> int:
        return self.h * self.w


@dataclasses.dataclass
class BoardState:
    """Batched chain state, field for field the JAX package's rook-body
    ``BoardState``. ``key`` holds the raw uint32 threefry key words in
    int64; ``cut_times_e[c, i]`` counts cut yields of edge (i, i+1),
    ``cut_times_s[c, i]`` of edge (i, i+W)."""

    key: torch.Tensor            # int64[C, 2]
    board: torch.Tensor          # int8[C, N] district 0/1
    dist_pop: torch.Tensor       # int32[C, 2]
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


def supports(graph: LatticeGraph, spec: Spec) -> bool:
    """True iff this module reproduces the reference chain for (graph,
    spec): a plain rook grid under the 2-district 'bi' walk."""
    return (board_shape(graph) is not None
            and spec.n_districts == 2
            and spec.proposal == "bi"
            and spec.accept in ("cut", "corrected", "always")
            and spec.contiguity in ("patch", "none")
            and spec.invalid == "repropose"
            and spec.anneal in ("none", "linear")
            and not spec.frame_interface
            and not spec.weighted_cut
            and not spec.record_interface
            and not spec.record_assignment_bits
            and not spec.nobacktrack
            and not spec.lazy_uniform)


def make_board_graph(graph: LatticeGraph, device="cuda") -> BoardGraph:
    shape = board_shape(graph)
    if shape is None:
        raise ValueError(f"graph {graph.name!r} is not a plain rook grid")
    dev = resolve_device(device)
    h, w = shape
    y = np.arange(h * w) % w
    return BoardGraph(
        pop=torch.as_tensor(graph.pop, dtype=torch.int32, device=dev),
        deg=torch.as_tensor(graph.deg, dtype=torch.int32, device=dev),
        east_ok=torch.as_tensor(y < w - 1, device=dev),
        west_ok=torch.as_tensor(y > 0, device=dev),
        h=h, w=w)


# ---------------------------------------------------------------------------
# Stencil planes
# ---------------------------------------------------------------------------

def _shifted(board: torch.Tensor, w: int, o: int) -> torch.Tensor:
    """value[:, i] = board[:, i + o], -1 off the flat range."""
    c, n = board.shape
    p = torch.nn.functional.pad(board, (w + 1, w + 1), value=-1)
    return p[:, w + 1 + o: w + 1 + o + n]


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


def record_final(bg: BoardGraph, spec: Spec, params: StepParams,
                 state: BoardState):
    """Epilogue: complete any pending wait and record the last yield,
    without a trailing transition. Returns (state, history row)."""
    t0 = state.t_yield
    key, _, _, kwait = _split4(state.key)
    state = state.replace(key=key)
    planes = _planes(bg, state.board)
    cur_wait = _complete_wait(spec, state, planes["b_count"], kwait, bg.n)
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
    """Broadcast a node-order assignment onto C chains and seed the
    per-chain state; keys are ``jax.random.split(PRNGKey(seed), C)``."""
    dev = bg.pop.device
    n = bg.n
    a = np.asarray(assignment, np.int8)
    pops = np.bincount(a.astype(np.int64), weights=graph.pop,
                       minlength=spec.n_districts).astype(np.int32)
    label_values = params.label_values.cpu().numpy()
    part0 = label_values[a.astype(np.int64)].astype(np.int32)
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
        board=plane(a),
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
        exhausted_count=full(0, torch.int32))


def edge_cut_times(graph: LatticeGraph, state: BoardState) -> np.ndarray:
    """cut_times as a (C, E) numpy array in LatticeGraph edge order: edge
    (u, u+1) reads the E plane at u, edge (u, u+W) the S plane at u."""
    shape = board_shape(graph)
    if shape is None:
        raise ValueError(f"graph {graph.name!r} is not a plain rook grid")
    u = graph.edges[:, 0].astype(np.int64)
    east = (graph.edges[:, 1] - u == 1) & (shape[1] > 1)
    ct_e = state.cut_times_e.cpu().numpy()
    ct_s = state.cut_times_s.cpu().numpy()
    return np.where(east[None], ct_e[:, u], ct_s[:, u])
