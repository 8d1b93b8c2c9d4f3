"""Chain configuration, per-chain parameters, the geometric wait, and the
general path's step: propose, commit, record.

Port of ``flipcomplexityempirical_tpu/kernel/step.py``: ``Spec``,
``StepParams``, ``make_params``, ``sample_geom_minus1``, ``finalize_host``
and the general half, ``propose`` (the re-propose loop, with
``propose_parallel`` candidates a round; the 2-district 'bi' draw and the
k-district 'pair' draw), ``transition`` (the legacy body), ``commit``
(the accept rules 'cut', 'corrected' and 'always', the linear anneal,
boundary-length scores, the pair walk's distinct-pair count) and
``record`` with the wall-interface metrics, batched over chains as (C,
...) tensors. The semantics notes there hold unchanged:
invalid proposals re-propose, the accept is the literal
``base**(-dcut)``, waits are memoized per state with the literal
``n**k - 1`` denominator, and the last flip's bookkeeping is re-applied
on every yield. The re-propose loop runs until every chain has a valid
move or has spent ``max_tries``; a chain that is done keeps its draw, as
the JAX package's vmapped while loop does, so each chain draws exactly
its own stream.

Float sums that the kernels must reproduce run in one fixed order: the
boundary-length score adds v's neighbour slots in slot order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import rng
from ..device import resolve_device
from ..state import chain_state
from . import contiguity


@dataclasses.dataclass(frozen=True)
class Spec:
    """Static chain configuration (the JAX package's field set; the board
    path of this package serves the subset ``cuda_board.check`` allows)."""

    n_districts: int = 2
    proposal: str = "bi"          # 'bi' (2-district sign flip) | 'pair'
    contiguity: str = "patch"     # 'patch' | 'exact' | 'none'
    invalid: str = "repropose"    # 'repropose' | 'selfloop'
    accept: str = "cut"           # 'cut' | 'corrected' | 'always'
    anneal: str = "none"          # 'none' | 'linear'
    frame_interface: bool = False
    weighted_cut: bool = False
    max_tries: int = 256
    propose_parallel: int = 1
    record_interface: bool = False
    parity_metrics: bool = True   # reference-exact accumulator quirks
    geom_waits: bool = True       # sample geometric waiting times
    record_assignment_bits: bool = False
    nobacktrack: bool = False
    lazy_uniform: bool = False


@dataclasses.dataclass
class StepParams:
    """Per-chain runtime parameters: f32 (C,) tensors, plus the i32 (K,)
    district -> reference label map and the linear-anneal constants."""

    log_base: torch.Tensor
    beta: torch.Tensor
    pop_lo: torch.Tensor
    pop_hi: torch.Tensor
    label_values: torch.Tensor
    anneal_t0: float = 100000.0
    anneal_ramp: float = 100000.0
    anneal_beta_max: float = 3.0


def make_params(base, pop_lo, pop_hi, label_values, beta=1.0,
                n_chains=None, device="cuda") -> StepParams:
    """Broadcast scalars to per-chain f32 tensors when n_chains is given.
    ``log_base`` is the f32 log of the f32 base."""
    dev = resolve_device(device)

    def rep(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        if n_chains is not None and x.ndim == 0:
            x = x.expand(n_chains).contiguous()
        return x

    base32 = torch.tensor(base, dtype=torch.float32, device=dev)
    return StepParams(
        log_base=rep(torch.log(base32)), beta=rep(beta),
        pop_lo=rep(pop_lo), pop_hi=rep(pop_hi),
        label_values=torch.as_tensor(label_values, dtype=torch.int32,
                                     device=dev))


def geom_denom_finite(n_nodes: int, k: int) -> bool:
    """True iff the literal wait denominator n**k - 1 survives the f32
    cast (compared in log space)."""
    if n_nodes <= 1:
        return True
    return k * math.log(float(n_nodes)) < math.log(3.4028235e38)


def geom_wait(u: torch.Tensor, b_count: torch.Tensor, n_nodes: int,
              k: int) -> torch.Tensor:
    """Geometric(p) - 1 by inverse CDF, p = b / (n**k - 1), from f32
    uniforms ``u``: ``max(floor(log(max(u, 1e-12)) / log1p(-p)), 0)``,
    every step in f32 as the reference package computes it."""
    if not geom_denom_finite(n_nodes, k):
        raise ValueError(
            f"geom_waits: denominator n**k - 1 = {n_nodes}**{k} - 1 "
            "overflows float32; disable Spec.geom_waits for this config")
    f32 = torch.float32
    denom = torch.tensor(float(n_nodes) ** k - 1.0, dtype=f32,
                         device=u.device)
    tiny = torch.tensor(1e-12, dtype=f32, device=u.device)
    p = b_count.to(f32) / denom
    w = torch.floor(torch.log(torch.maximum(u, tiny)) / torch.log1p(-p))
    return torch.clamp_min(w, 0.0)


def sample_geom_minus1(keys: torch.Tensor, b_count: torch.Tensor,
                       n_nodes: int, k: int) -> torch.Tensor:
    """The reference waiting-time sample per chain, drawn from raw
    threefry keys (C, 2) exactly as the JAX package draws it."""
    return geom_wait(rng.uniform(keys), b_count, n_nodes, k)


# ---------------------------------------------------------------------------
# The general path (batched over chains)
# ---------------------------------------------------------------------------

def check_general(spec: Spec) -> None:
    """Raise for what the general path of this package does not run."""
    if spec.proposal == "bi":
        if spec.n_districts != 2:
            raise ValueError("proposal 'bi' requires n_districts == 2")
    elif spec.proposal == "pair":
        if spec.n_districts < 2:
            raise ValueError("proposal 'pair' requires n_districts >= 2")
        if spec.nobacktrack:
            raise ValueError("nobacktrack requires proposal 'bi' (the pair "
                             "walk has no single excluded reverse move)")
    else:
        raise ValueError(f"proposal {spec.proposal!r}")
    if spec.anneal not in ("none", "linear"):
        raise ValueError(f"anneal mode {spec.anneal!r}")
    if spec.accept not in ("cut", "corrected", "always"):
        raise ValueError(f"accept {spec.accept!r}")
    if spec.invalid not in ("repropose", "selfloop"):
        raise ValueError(f"invalid {spec.invalid!r}")


def effective_beta(spec: Spec, params: StepParams, state):
    """The inverse temperature of the current proposal: constant, or the
    reference's linear schedule on the accepted-move clock
    (grid_chain_sec11.py:88-95), in f32."""
    if spec.anneal == "none":
        return params.beta
    f32 = torch.float32
    dev = params.beta.device
    t = (state.move_clock + 1).to(f32)
    t0 = torch.tensor(params.anneal_t0, dtype=f32, device=dev)
    ramp = torch.tensor(params.anneal_ramp, dtype=f32, device=dev)
    top = torch.tensor(params.anneal_beta_max, dtype=f32, device=dev)
    return torch.minimum(torch.clamp_min((t - t0) / ramp, 0.0), top)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[c, idx[c, ...]] for (C, M) ``x`` and (C, ...) ``idx``."""
    c = x.shape[0]
    return torch.gather(x, 1, idx.reshape(c, -1)).reshape(idx.shape)


def select_nth_true(mask: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Index of the (m+1)-th True of each chain's (C, N) ``mask`` for
    (C, ...) ranks ``m``; 0 where there is none (callers check the
    mask there)."""
    c = mask.shape[0]
    csum = torch.cumsum(mask.to(torch.int64), dim=1).contiguous()
    idx = torch.searchsorted(csum, m.reshape(c, -1).to(torch.int64),
                             right=True)
    idx = torch.where(idx >= mask.shape[1], 0, idx)
    return idx.reshape(m.shape)


def _sample_bi(u: torch.Tensor, state, nobacktrack: bool = False):
    """Uniform over each chain's boundary nodes, flipped to the other
    district (grid_chain_sec11.py:132-145), for (C, R) uniforms ``u``;
    ``nobacktrack`` leaves out the last-flipped node unless it is the
    only boundary node. Returns (v, d_to, sampled_ok), each (C, R)."""
    b_mask = state.cut_deg > 0
    bc = state.b_count
    c = b_mask.shape[0]
    if nobacktrack:
        f = state.cur_flip_node.to(torch.int64)
        fi = torch.clamp_min(f, 0)
        ar = torch.arange(c, device=b_mask.device)
        excl = (f >= 0) & b_mask[ar, fi] & (bc > 1)
        cols = torch.arange(b_mask.shape[1], device=b_mask.device)
        b_mask = b_mask & ~((cols[None, :] == fi[:, None]) & excl[:, None])
        bc = bc - excl.to(bc.dtype)
    bc = bc[:, None]
    m = torch.minimum((u * bc.to(torch.float32)).to(torch.int32),
                      torch.clamp_min(bc - 1, 0))
    v = select_nth_true(b_mask, m)
    d_from = _rows(state.assignment, v).to(torch.int64)
    return v, 1 - d_from, _rows(b_mask, v)


def _sample_pair(u: torch.Tensor, dg, state, k: int):
    """Uniform over each chain's distinct (boundary node, neighbouring
    district) pairs (grid_chain_sec11.py:117-130), for (C, R) uniforms
    ``u``: one prefix-sum selection over the node-major flattened (N, K)
    pair plane. Returns (v, d_to, sampled_ok), each (C, R)."""
    c = u.shape[0]
    pm = chain_state.pair_move_mask(dg, state.assignment, k).reshape(c, -1)
    total = pm.sum(dim=1, dtype=torch.int32)[:, None]
    m = torch.minimum((u * total.to(torch.float32)).to(torch.int32),
                      torch.clamp_min(total - 1, 0))
    idx = select_nth_true(pm, m)
    return idx // k, idx % k, _rows(pm, idx)


def _frame_counts(dg, spec: Spec, state) -> torch.Tensor:
    """(C, K) counts of outer-frame nodes per district."""
    a_f = state.assignment[:, dg.frame_idx].to(torch.int64)
    out = torch.zeros((a_f.shape[0], spec.n_districts), dtype=torch.int32,
                      device=a_f.device)
    return out.scatter_add_(1, a_f, torch.ones_like(a_f, dtype=torch.int32))


def _validate(dg, spec: Spec, params: StepParams, state, v, d_to,
              sampled_ok, frame_counts=None):
    """Validity of tentative flips of (C, R) nodes ``v`` to ``d_to``: the
    draw hit a boundary move, both population bounds hold, contiguity
    (with the frame-interface rule) holds."""
    d_from = _rows(state.assignment, v).to(torch.int64)
    popv = dg.pop[v]
    dp = state.dist_pop
    f32 = torch.float32
    pop_from_new = (_rows(dp, d_from) - popv).to(f32)
    pop_to_new = (_rows(dp, d_to) + popv).to(f32)
    sampled_eff = sampled_ok & (d_to != d_from)
    pop_ok = ((pop_from_new >= params.pop_lo[:, None])
              & (pop_to_new <= params.pop_hi[:, None]))
    conn = contiguity.check(dg, state.assignment, v, d_from, spec.contiguity)
    if spec.frame_interface:
        vf = dg.frame_mask[v].to(torch.int32)
        k = torch.arange(spec.n_districts, device=v.device)
        counts = (frame_counts[:, None, :]
                  - (k == d_from[..., None]) * vf[..., None]
                  + (k == d_to[..., None]) * vf[..., None])
        conn = conn & (counts.amax(dim=-1) < dg.frame_idx.shape[0])
    return sampled_eff & pop_ok & conn


def _draws(*pairs):
    """Threefry blocks of several (C, 2) keys at once: ``pairs`` of (key,
    counter); returns the blocks' words (b0, b1), each (C, len(pairs))."""
    keys = torch.stack([k for k, _ in pairs], dim=1)
    return rng.blocks(keys, [c for _, c in pairs])


def _key(b0, b1, j):
    return torch.stack([b0[:, j], b1[:, j]], dim=-1)


def propose(dg, spec: Spec, params: StepParams, state, keys: torch.Tensor,
            first=None):
    """Draw each chain's proposal under the invalid-move policy from its
    (C, 2) key: (v, d_to, valid, tries), each (C,). ``first``, when
    given, is ``split(keys)`` already drawn (the first re-propose round's
    carry and draw key); every round draws its uniform and the next
    round's split in one pass."""
    check_general(spec)
    c = keys.shape[0]
    dev = keys.device
    ar = torch.arange(c, device=dev)
    frame_counts = (_frame_counts(dg, spec, state) if spec.frame_interface
                    else None)

    def draw(u):                      # u: (C, R) -> each (C, R)
        if spec.proposal == "pair":
            v, d_to, ok = _sample_pair(u, dg, state, spec.n_districts)
        else:
            v, d_to, ok = _sample_bi(u, state, spec.nobacktrack)
        return v, d_to, _validate(dg, spec, params, state, v, d_to, ok,
                                  frame_counts)

    if spec.invalid == "selfloop":
        v, d_to, valid = draw(rng.uniform(keys)[:, None])
        return (v[:, 0], d_to[:, 0], valid[:, 0],
                torch.ones(c, dtype=torch.int32, device=dev))
    kp = spec.propose_parallel
    if not 1 <= kp <= spec.max_tries:
        raise ValueError(f"propose_parallel {kp} must be in "
                         f"[1, max_tries={spec.max_tries}]")
    if first is None:
        b0, b1 = _draws((keys, 0), (keys, 1))
        first = (_key(b0, b1, 0), _key(b0, b1, 1))
    if kp > 1:
        carry, kdraw = first
        vs, d_tos, valids = draw(rng.uniform(rng.split(kdraw, kp)))
        fi = torch.argmax(valids.to(torch.uint8), dim=1)
        valid = valids.any(dim=1)
        tries = torch.where(valid, fi + 1, kp).to(torch.int32)
        v, d_to = vs[ar, fi], d_tos[ar, fi]
        b0, b1 = _draws((carry, 0), (carry, 1))
        nxt = (_key(b0, b1, 0), _key(b0, b1, 1))
    else:
        v = torch.zeros(c, dtype=torch.int64, device=dev)
        d_to = torch.zeros(c, dtype=torch.int64, device=dev)
        valid = torch.zeros(c, dtype=torch.bool, device=dev)
        tries = torch.zeros(c, dtype=torch.int32, device=dev)
        nxt = first
    # round j: its draw key kd and carry key come from the previous
    # round's split; one pass draws kd's uniform and the carry's split
    while True:
        live = ~valid & (tries < spec.max_tries)
        if not bool(live.any()):
            break
        carry, kd = nxt
        b0, b1 = _draws((kd, 0), (carry, 0), (carry, 1))
        nv, nd, nvalid = draw(rng.uniform_of(b0[:, :1] ^ b1[:, :1]))
        v = torch.where(live, nv[:, 0], v)
        d_to = torch.where(live, nd[:, 0], d_to)
        valid = torch.where(live, nvalid[:, 0], valid)
        tries = tries + live.to(torch.int32)
        nxt = (_key(b0, b1, 1), _key(b0, b1, 2))
    return v, d_to, valid, tries


def transition(dg, spec: Spec, params: StepParams, state):
    """One step of every chain on the legacy body: propose (with
    retries), Metropolis accept, commit. The accept and wait uniforms and
    the proposal key's first split are drawn in one pass."""
    ks = rng.split(state.key, 4)
    kprop, kacc, kwait = ks[:, 1], ks[:, 2], ks[:, 3]
    b0, b1 = _draws((kacc, 0), (kwait, 0), (kprop, 0), (kprop, 1))
    u = rng.uniform_of(b0[:, :2] ^ b1[:, :2])
    first = (_key(b0, b1, 2), _key(b0, b1, 3))
    v, d_to, valid, tries = propose(dg, spec, params, state, kprop, first)
    return commit(dg, spec, params, state, ks[:, 0], kacc, kwait, v, d_to,
                  valid, tries, u_acc=u[:, 0], u_wait=u[:, 1])


def commit(dg, spec: Spec, params: StepParams, state, key, kacc, kwait,
           v, d_to, valid, tries, u_acc=None, u_wait=None):
    """Metropolis accept and the masked commit of (C,) proposals (v,
    d_to, valid), the tail both general bodies share. ``key`` is each
    chain's next key, ``kacc`` / ``kwait`` the accept and wait keys
    (``u_acc`` / ``u_wait``: their uniforms, where already drawn)."""
    f32, i32 = torch.float32, torch.int32
    c = v.shape[0]
    dev = v.device
    ar = torch.arange(c, device=dev)
    v = v.to(torch.int64)
    d_to = d_to.to(torch.int64)
    a = state.assignment
    d_from = a[ar, v].to(torch.int64)
    nb, nbm, eids = dg.nbr[v], dg.nbr_mask[v], dg.nbr_edge[v]
    na = torch.gather(a, 1, nb).to(torch.int64)
    old_cut = (na != d_from[:, None]) & nbm
    new_cut = (na != d_to[:, None]) & nbm
    delta = new_cut.to(i32) - old_cut.to(i32)
    dcut = delta.sum(dim=1, dtype=i32)
    if spec.proposal == "pair":
        d_pairs = _pair_delta(dg, spec.n_districts, a, v, d_to, nb, nbm)

    beta = effective_beta(spec, params, state)
    if spec.weighted_cut:
        terms = torch.where(nbm, delta.to(f32) * dg.edge_len[eids], 0.0)
        dscore = terms[:, 0]
        for j in range(1, terms.shape[1]):    # slot order, as the kernels
            dscore = dscore + terms[:, j]
    else:
        dscore = dcut.to(f32)
    log_bound = -beta * dscore * params.log_base
    if spec.accept == "corrected":
        if spec.proposal == "pair":
            b_new = state.b_count + d_pairs
        else:
            cd_new = state.cut_deg.to(i32).scatter_add(
                1, nb, torch.where(nbm, delta, 0))
            cd_new[ar, v] = new_cut.sum(dim=1, dtype=i32)
            b_new = (cd_new > 0).sum(dim=1)
        log_bound = log_bound + (
            torch.log(state.b_count.to(f32))
            - torch.log(torch.clamp_min(b_new, 1).to(f32)))
    if spec.accept == "always":
        accept = valid
    else:
        tiny = torch.tensor(1e-12, dtype=f32, device=dev)
        if u_acc is None:
            u_acc = rng.uniform(kacc)
        logu = torch.log(torch.maximum(u_acc, tiny))
        accept = valid & (logu < log_bound)

    a_new = a.clone()
    a_new[ar, v] = torch.where(accept, d_to, d_from).to(a.dtype)
    upd = torch.where(accept[:, None] & nbm, delta, 0)
    cut = state.cut.to(i32).scatter_add(1, eids, upd).to(state.cut.dtype)
    cut_deg = state.cut_deg.to(i32).scatter_add(1, nb, upd)
    cut_deg[ar, v] = torch.where(accept, new_cut.sum(dim=1, dtype=i32),
                                 state.cut_deg[ar, v].to(i32))
    cut_deg = cut_deg.to(state.cut_deg.dtype)
    popv = dg.pop[v] * accept.to(i32)
    dist_pop = state.dist_pop.clone()
    dist_pop[ar, d_from] -= popv
    dist_pop[ar, d_to] += popv
    cut_count = state.cut_count + torch.where(accept, dcut, 0)
    if spec.proposal == "pair":
        b_count = state.b_count + torch.where(accept, d_pairs, 0).to(i32)
    else:
        b_count = (cut_deg > 0).sum(dim=1).to(i32)
    cur_wait = state.cur_wait
    if spec.geom_waits:
        if u_wait is None:
            u_wait = rng.uniform(kwait)
        wait_new = geom_wait(u_wait, b_count, dg.n_nodes, spec.n_districts)
        cur_wait = torch.where(accept, wait_new, cur_wait)
    acc = accept.to(i32)
    return state.replace(
        key=key, assignment=a_new, cut=cut, cut_deg=cut_deg,
        dist_pop=dist_pop, cut_count=cut_count.to(i32), b_count=b_count,
        cur_wait=cur_wait,
        cur_flip_node=torch.where(accept, v.to(i32), state.cur_flip_node),
        move_clock=state.move_clock + acc,
        accept_count=state.accept_count + acc,
        tries_sum=state.tries_sum + tries.to(i32),
        exhausted_count=state.exhausted_count + (~valid).to(i32))


def _pair_delta(dg, k: int, a: torch.Tensor, v, d_to, nb, nbm):
    """The change of the distinct-pair count if v moves to d_to: only the
    rows of v and of its true neighbours of the (N, K) pair plane change
    (step.py:430-445 of the JAX package), (C,) int32."""
    aff = torch.cat([v[:, None], nb], dim=1)
    live = torch.cat([torch.ones_like(nbm[:, :1]), nbm], dim=1)
    a_tent = a.clone()
    a_tent[torch.arange(a.shape[0], device=a.device), v] = d_to.to(a.dtype)

    def rows(x):
        pm = chain_state.pair_move_mask(dg, x, k, nodes=aff)
        return (pm & live[..., None]).sum(dim=(1, 2), dtype=torch.int32)

    return rows(a_tent) - rows(a)


def interface_midpoints(dg) -> torch.Tensor:
    """(E, 2) f32 midpoints of every edge, ``(p0 + p1) / 2`` of its ends'
    f32 coordinates, as the JAX package's ``interface_metrics`` computes
    them (the dense kernel reads its wall edges' rows of this table)."""
    pts = dg.coords[dg.edges]                            # (E, 2, 2)
    return (pts[:, 0] + pts[:, 1]) / 2.0


def interface_metrics(dg, cut: torch.Tensor, mid=None):
    """f32 (slope, angle) per chain of the (C, E) cut planes: the two
    wall-cut edges of smallest edge index, their midpoints' slope and the
    angle they subtend at the graph's center (kernel/step.py:576 of the
    JAX package, float step for float step); NaN with fewer than two.
    ``mid`` is ``interface_midpoints(dg)`` where already made."""
    f32 = torch.float32
    if mid is None:
        mid = interface_midpoints(dg)
    wc = (cut > 0) & (dg.wall_id >= 0)[None]
    e_ids = torch.arange(wc.shape[1], device=cut.device)
    first = torch.argmax(wc.to(torch.uint8), dim=1)
    wc2 = wc & (e_ids[None] != first[:, None])
    second = torch.argmax(wc2.to(torch.uint8), dim=1)
    ok = wc.any(dim=1) & wc2.any(dim=1)
    ax, ay = mid[first, 0], mid[first, 1]
    ex, ey = mid[second, 0], mid[second, 1]
    dx, dy = ex - ax, ey - ay
    one = torch.ones_like(dx)
    slope = torch.where(dx != 0, dy / torch.where(dx != 0, dx, one),
                        torch.full_like(dx, float("inf")))
    cx, cy = dg.center[0].to(f32), dg.center[1].to(f32)
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


def record(dg, spec: Spec, params: StepParams, state):
    """One yield of the measurement loop (grid_chain_sec11.py:366-402):
    (state with its accumulators advanced, {name: (C,) outputs})."""
    i32 = torch.int32
    t = state.t_yield
    out = {"cut_count": state.cut_count, "b_count": state.b_count,
           "wait": state.cur_wait, "accepts": state.accept_count}
    if spec.lazy_uniform:
        out["weight"] = 1.0 + state.cur_wait
    cut_times = state.cut_times + state.cut.to(i32)
    waits_sum = state.waits_sum + state.cur_wait
    part_sum, last_flipped, num_flips = (
        state.part_sum, state.last_flipped, state.num_flips)
    if spec.parity_metrics:
        ar = torch.arange(t.shape[0], device=t.device)
        f = state.cur_flip_node.to(torch.int64)
        has = f >= 0
        fi = torch.clamp_min(f, 0)
        sign = params.label_values[state.assignment[ar, fi].to(torch.int64)]
        lf = last_flipped[ar, fi]
        part_sum = part_sum.clone()
        last_flipped = last_flipped.clone()
        num_flips = num_flips.clone()
        part_sum[ar, fi] += torch.where(has, -sign * (t - lf), 0).to(i32)
        last_flipped[ar, fi] = torch.where(has, t, lf)
        num_flips[ar, fi] += has.to(i32)
    if spec.record_interface:
        out["slope"], out["angle"] = interface_metrics(dg, state.cut)
    if spec.record_assignment_bits:
        bits = max(1, (spec.n_districts - 1).bit_length())
        if dg.n_nodes * bits > 32:
            raise ValueError("record_assignment_bits needs n_nodes * "
                             "ceil(log2(k)) <= 32")
        shifts = torch.arange(dg.n_nodes, device=t.device) * bits
        out["abits"] = (state.assignment.to(torch.int64) << shifts).sum(
            dim=1) & rng.MASK32
    return state.replace(cut_times=cut_times, waits_sum=waits_sum,
                         part_sum=part_sum, last_flipped=last_flipped,
                         num_flips=num_flips, t_yield=t + 1), out


def run_steps(transition_fn, dg, spec: Spec, params: StepParams, state,
              t_inner: int):
    """``t_inner`` rounds of ``transition_fn`` and ``record``: (state,
    {name: (T, C) rows})."""
    rows: dict = {}
    for _ in range(t_inner):
        state = transition_fn(dg, spec, params, state)
        state, out = record(dg, spec, params, state)
        for k, v in out.items():
            rows.setdefault(k, []).append(v)
    return state, {k: torch.stack(v) for k, v in rows.items()}


def finalize_host(state_np, label_values, t_final, assignment=None):
    """The reference's post-run finalisation (grid_chain_sec11.py:416-419)
    on host arrays: never-flipped nodes get part_sum = t * final_sign;
    lognum_flips = log(num_flips + 1). The reference does not add the
    tail segment for flipped nodes, and neither does this.

    ``assignment`` overrides ``state_np.assignment`` for state flavors
    that carry it under another name (the board path's ``.board``)."""
    if assignment is None:
        assignment = state_np.assignment
    sign = np.asarray(label_values)[np.asarray(assignment,
                                               dtype=np.int64)]
    part_sum = np.array(state_np.part_sum)
    never = np.array(state_np.last_flipped) == 0
    part_sum[never] = t_final * sign[never]
    lognum = np.log(np.array(state_np.num_flips) + 1.0)
    return part_sum, lognum
