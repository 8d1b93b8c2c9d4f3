"""The rejection-free dense body over bit-packed node sets: the plain
version of ``csrc/general_dense_chunk.cu``.

Port of ``flipcomplexityempirical_tpu/kernel/dense.py``, batched over
chains; its 'pair' branch (the k-district walk over the node-major (N, K)
plane) is the plain version of ``csrc/general_pair_chunk.cu``. Each step
builds the packed validity plane once,
``pack(boundary & population-feasible) & conn_bits``, and selects the
m-th valid node directly, with one uniform: conditioned on the state,
"uniform over the move set, re-propose until valid" is "uniform over the
valid subset", so a step matches the legacy body in distribution
whenever a valid move exists; a step with none self-loops
(``exhausted_count`` advances). ``conn_bits`` carries "flipping node i
keeps its district connected" for the current assignment; a committed
flip at v changes it only inside {v} | patch(v) (patch balls are
symmetric), so ``refresh_conn_bits`` recomputes at most 1 + P bits a
step. Accept and bookkeeping are ``kernel/step.py::commit``, shared with
the legacy body.

Packed planes are (..., ceil(M / 32)) uint32 words held in int64 (the
convention of ``rng.py``): bit j of word w is element 32 * w + j, pad
bits zero.
"""

from __future__ import annotations

import torch

from .. import rng
from ..state import chain_state
from . import contiguity
from . import step as kstep
from .step import Spec, StepParams


def supported(graph, spec: Spec) -> bool:
    """True iff ``general_dense`` runs this (graph, spec): the 'bi' or
    'pair' walk under re-propose semantics, no frame interface, contiguity
    'patch' (on a graph whose patches fit 32 slots) or 'none'. The JAX
    package's rule."""
    if spec.proposal not in ("bi", "pair"):
        return False
    if spec.proposal == "bi" and spec.n_districts != 2:
        return False
    if spec.nobacktrack and spec.proposal != "bi":
        return False
    if spec.invalid != "repropose":
        return False
    if spec.frame_interface:
        return False
    if spec.contiguity not in ("patch", "none"):
        return False
    if spec.contiguity == "patch" and not getattr(graph, "patch_ok", True):
        return False
    return True


def n_words(n: int) -> int:
    """uint32 words of an n-bit set."""
    return (n + 31) // 32


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool (..., M) -> (..., ceil(M / 32)) uint32 words in int64."""
    m = mask.shape[-1]
    w = n_words(m)
    p = torch.nn.functional.pad(mask.to(torch.int64), (0, 32 * w - m))
    p = p.reshape(*mask.shape[:-1], w, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return (p << shifts).sum(dim=-1)


def unpack_mask(words: torch.Tensor, n: int) -> torch.Tensor:
    """(..., W) words -> bool (..., n), pad bits dropped."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :n].bool()


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 word (held in int64), as int64."""
    x = words.to(torch.int64) & rng.MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & rng.MASK32) >> 24


def select_nth_set(words: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Index of the (m+1)-th set bit of each (..., W) packed set for
    (...) ranks ``m``: the word by a popcount cumsum, the bit by an
    in-word prefix popcount. 0 where the set is empty."""
    pc = popcount(words)
    c = torch.cumsum(pc, dim=-1)
    m = m.to(torch.int64)
    wi = torch.argmax((c > m[..., None]).to(torch.uint8), dim=-1)
    c_wi = torch.gather(c, -1, wi[..., None])[..., 0]
    pc_wi = torch.gather(pc, -1, wi[..., None])[..., 0]
    r = m - (c_wi - pc_wi)
    word = torch.gather(words.to(torch.int64), -1, wi[..., None])
    lanes = torch.arange(32, dtype=torch.int64, device=words.device)
    prefix = popcount(word & ((2 << lanes) - 1))
    bit = torch.argmax((prefix > r[..., None]).to(torch.uint8), dim=-1)
    return wi * 32 + bit


def conn_plane(dg, spec: Spec, assignment: torch.Tensor) -> torch.Tensor:
    """bool (C, N): flipping node i out of its district keeps that
    district connected. The full recompute (entry and oracle)."""
    c, n = assignment.shape
    if spec.contiguity == "none":
        return torch.ones((c, n), dtype=torch.bool,
                          device=assignment.device)
    nodes = torch.arange(n, device=assignment.device)[None, :]
    return contiguity.patch_connected(dg, assignment, nodes, assignment)


def init_conn_bits(dg, spec: Spec, assignment: torch.Tensor):
    """(C, ceil(N / 32)) packed conn planes."""
    return pack_mask(conn_plane(dg, spec, assignment))


def refresh_conn_bits(dg, spec: Spec, assignment: torch.Tensor,
                      conn_bits: torch.Tensor, v: torch.Tensor):
    """After the commit, the conn bits of {v} | patch(v) recomputed
    against the committed assignment and spliced in. Unchanged on a
    rejected step; patch pad slots (pn == v) are left out, so every
    touched bit is distinct."""
    if spec.contiguity == "none":
        return conn_bits
    c = v.shape[0]
    v = v.to(torch.int64)
    pn = dg.patch_nodes[v]                               # (C, P)
    aff = torch.cat([v[:, None], pn], dim=1)             # (C, 1 + P)
    live = torch.cat([torch.ones_like(v[:, None], dtype=torch.bool),
                      pn != v[:, None]], dim=1)
    a = assignment.to(torch.int64)
    new = contiguity.patch_connected(dg, assignment, aff,
                                     torch.gather(a, 1, aff))
    bit = torch.ones_like(aff) << (aff % 32)
    w = conn_bits.shape[1]
    clear = torch.zeros((c, w), dtype=torch.int64, device=v.device)
    clear.scatter_add_(1, aff // 32, torch.where(live, bit, 0))
    sets = torch.zeros_like(clear)
    sets.scatter_add_(1, aff // 32, torch.where(live & new, bit, 0))
    return (conn_bits & ~clear & rng.MASK32) | sets


def _pop_plane_bi(dg, params: StepParams, a: torch.Tensor,
                  dist_pop: torch.Tensor) -> torch.Tensor:
    """bool (C, N): both population bounds of flipping each node to the
    other district, in f32 (``dist_pop`` already f32)."""
    popv = dg.pop.to(torch.float32)
    return (((torch.gather(dist_pop, 1, a) - popv)
             >= params.pop_lo[:, None])
            & ((torch.gather(dist_pop, 1, 1 - a) + popv)
               <= params.pop_hi[:, None]))


def _pop_planes(dg, params: StepParams, a: torch.Tensor,
                dist_pop: torch.Tensor):
    """The pair walk's population gates in f32: ``from_ok`` bool (C, N)
    (the donor district stays >= pop_lo without node i) and ``to_ok``
    bool (C, N, K) (district d stays <= pop_hi with node i)."""
    popv = dg.pop.to(torch.float32)
    from_ok = (torch.gather(dist_pop, 1, a) - popv) >= params.pop_lo[:, None]
    to_ok = ((dist_pop[:, None, :] + popv[None, :, None])
             <= params.pop_hi[:, None, None])
    return from_ok, to_ok


def propose_dense(dg, spec: Spec, params: StepParams, state,
                  keys: torch.Tensor, u=None):
    """Rejection-free proposal from each chain's (C, 2) key (``u``: its
    uniform, where already drawn): one uniform and one packed selection
    over the valid-move set. Returns (v, d_to, valid, tries), tries
    always 1; a chain with no valid move gets valid False."""
    kstep.check_general(spec)
    c, n = state.assignment.shape
    k = spec.n_districts
    a = state.assignment.to(torch.int64)
    dist_pop = state.dist_pop.to(torch.float32)
    if spec.proposal == "pair":
        from_ok, to_ok = _pop_planes(dg, params, a, dist_pop)
        pm = chain_state.pair_move_mask(dg, a, k)            # (C, N, K)
        conn = unpack_mask(state.conn_bits, n)
        plane = pm & from_ok[..., None] & to_ok & conn[..., None]
        words = pack_mask(plane.reshape(c, n * k))
    else:
        cand = state.cut_deg > 0
        if spec.nobacktrack:
            ar = torch.arange(c, device=a.device)
            f = state.cur_flip_node.to(torch.int64)
            fi = torch.clamp_min(f, 0)
            excl = (f >= 0) & cand[ar, fi] & (state.b_count > 1)
            cols = torch.arange(n, device=a.device)
            cand = cand & ~((cols[None, :] == fi[:, None]) & excl[:, None])
        pop_ok = _pop_plane_bi(dg, params, a, dist_pop)
        words = pack_mask(cand & pop_ok) & state.conn_bits
    total = popcount(words).sum(dim=1)
    if u is None:
        u = rng.uniform(keys)
    m = torch.minimum((u * total.to(torch.float32)).to(torch.int64),
                      torch.clamp_min(total - 1, 0))
    idx = select_nth_set(words, m)
    if spec.proposal == "pair":
        v = torch.clamp_max(idx // k, n - 1)
        d_to = idx % k
    else:
        v = torch.clamp_max(idx, n - 1)
        d_to = 1 - torch.gather(a, 1, v[:, None])[:, 0]
    valid = total > 0
    return v, d_to, valid, torch.ones(c, dtype=torch.int32, device=a.device)


def transition(dg, spec: Spec, params: StepParams, state):
    """One general_dense step of every chain: rejection-free propose, the
    shared accept / commit tail, then the O(P) conn-plane refresh.
    Needs ``state.conn_bits`` (``ensure_conn_bits``)."""
    if state.conn_bits is None:
        raise ValueError("general_dense transition needs state.conn_bits; "
                         "attach it with kernel.dense.ensure_conn_bits")
    ks = rng.split(state.key, 4)
    u = rng.uniform(ks[:, 1:])            # proposal, accept, wait
    v, d_to, valid, tries = propose_dense(dg, spec, params, state, ks[:, 1],
                                          u[:, 0])
    new = kstep.commit(dg, spec, params, state, ks[:, 0], ks[:, 2],
                       ks[:, 3], v, d_to, valid, tries, u_acc=u[:, 1],
                       u_wait=u[:, 2])
    return new.replace(conn_bits=refresh_conn_bits(
        dg, spec, new.assignment, state.conn_bits, v))


def ensure_conn_bits(dg, spec: Spec, states):
    """Attach the packed conn planes to a batch of states if absent."""
    if states.conn_bits is not None:
        return states
    return states.replace(conn_bits=init_conn_bits(dg, spec,
                                                   states.assignment))


def strip_conn_bits(states):
    """Drop the carried conn planes (a state leaving the runner)."""
    if states.conn_bits is None:
        return states
    return states.replace(conn_bits=None)
