"""ChainState: the whole state of a batch of flip walks on a general graph.

Port of ``flipcomplexityempirical_tpu/state/chain_state.py``. The JAX
package keeps one chain a pytree and vmaps over chains; here every field
carries the chains axis first, (C, ...) tensors on one device. The
derived fields (cut mask, per-node incident-cut counts, district tallies,
the boundary count) are pure functions of ``assignment``; ``derive``
recomputes them, and the kernels keep them up to date incrementally.
The accumulators mirror the reference's metric store
(grid_chain_sec11.py:383-400): cut_times per edge, num_flips /
last_flipped / part_sum per node, and the waits.

Keys are raw threefry words held in int64 (C, 2) (``rng.py``).
``reject_count`` stays None: the reject taxonomy belongs to the obs
recorder, which this package has not ported (ROADMAP.md A11).
``conn_bits`` is the packed contiguity plane of the ``general_dense``
body (``kernel/dense.py``): (C, ceil(N / 32)) uint32 words in int64, bit
i set where flipping node i keeps its district connected; None outside
that body, and stripped before a state leaves the runner.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import rng


@dataclasses.dataclass
class ChainState:
    key: torch.Tensor             # int64 (C, 2) threefry key words
    assignment: torch.Tensor      # int8 (C, N) district 0..K-1
    cut: torch.Tensor             # int8 (C, E) 0/1 cut-edge indicator
    cut_deg: torch.Tensor         # int8 (C, N) incident cut edges
    dist_pop: torch.Tensor        # int32 (C, K)
    cut_count: torch.Tensor       # int32 (C,)
    b_count: torch.Tensor         # int32 (C,) |b_nodes|
    cur_wait: torch.Tensor        # float32 (C,) memoised geometric wait
    cur_flip_node: torch.Tensor   # int32 (C,), -1 until a first acceptance
    t_yield: torch.Tensor         # int32 (C,) yields recorded
    move_clock: torch.Tensor      # int32 (C,) accepted moves since init
    part_sum: torch.Tensor        # int32 (C, N)
    last_flipped: torch.Tensor    # int32 (C, N)
    num_flips: torch.Tensor       # int32 (C, N)
    cut_times: torch.Tensor       # int32 (C, E)
    waits_sum: torch.Tensor       # float32 (C,) (chunk-local; host f64)
    accept_count: torch.Tensor    # int32 (C,)
    tries_sum: torch.Tensor       # int32 (C,) proposals drawn
    exhausted_count: torch.Tensor  # int32 (C,) steps with no valid move
    reject_count: Optional[torch.Tensor] = None
    conn_bits: Optional[torch.Tensor] = None

    @property
    def n_districts(self) -> int:
        return int(self.dist_pop.shape[-1])

    @property
    def n_chains(self) -> int:
        return int(self.assignment.shape[0])

    def replace(self, **kw) -> "ChainState":
        return dataclasses.replace(self, **kw)


def pair_move_mask(dg, assignment: torch.Tensor, k: int, nodes=None):
    """bool (C, N, K) (or (C, R, K) for the (C, R) rows ``nodes``): the
    k-district pair move set, district d present among node v's
    neighbours and not v's own (the reference's b_nodes pair updater,
    grid_chain_sec11.py:151-153: a set of distinct (node, district)
    pairs)."""
    a = assignment.to(torch.int64)
    c, n = a.shape
    if nodes is None:
        nodes = torch.arange(n, device=a.device).expand(c, n)
    nodes = nodes.to(torch.int64)
    r = nodes.shape[1]
    nbr = dg.nbr[nodes]                                  # (C, R, D)
    nbm = dg.nbr_mask[nodes]
    own = torch.gather(a, 1, nodes)                      # (C, R)
    nbr_a = torch.gather(a, 1, nbr.reshape(c, -1)).reshape(nbr.shape)
    ks = torch.arange(k, device=a.device)
    has = ((nbr_a[..., None] == ks) & nbm[..., None]).any(dim=2)
    return has & (ks != own[..., None]).reshape(c, r, k)


def b_nodes_count(dg, assignment: torch.Tensor, cut_deg: torch.Tensor,
                  k: int, proposal: str = "bi"):
    """|b_nodes| per chain as the reference wires it for each walk:
    boundary nodes for the 2-district 'bi' walk, distinct (node,
    district) pairs for the k-district pair walk (the count geom_wait's
    p = |b_nodes| / (n**k - 1) takes)."""
    if proposal == "pair":
        return pair_move_mask(dg, assignment, k).sum(
            dim=(1, 2)).to(torch.int32)
    return (cut_deg > 0).sum(dim=-1).to(torch.int32)


def derive(dg, assignment: torch.Tensor, k: int, proposal: str = "bi"):
    """Recompute the derived fields from a (C, N) assignment: (cut,
    cut_deg, dist_pop, cut_count, b_count)."""
    a = assignment.to(torch.int64)
    cut = (a[:, dg.edges[:, 0]] != a[:, dg.edges[:, 1]]).to(torch.int32)
    cut_deg = torch.zeros(a.shape, dtype=torch.int32, device=a.device)
    cut_deg.index_add_(1, dg.edges[:, 0], cut)
    cut_deg.index_add_(1, dg.edges[:, 1], cut)
    dist_pop = torch.zeros((a.shape[0], k), dtype=torch.int32,
                           device=a.device)
    dist_pop.scatter_add_(1, a, dg.pop.expand_as(a).to(torch.int32))
    cut_count = cut.sum(dim=1).to(torch.int32)
    b_count = b_nodes_count(dg, a, cut_deg, k, proposal)
    return (cut.to(torch.int8), cut_deg.to(torch.int8), dist_pop, cut_count,
            b_count)


def init_state(dg, assignment: torch.Tensor, k: int, keys: torch.Tensor,
               label_values: torch.Tensor, sample_initial_wait=None,
               proposal: str = "bi") -> ChainState:
    """The initial state of every chain. ``keys`` (C, 2): each chain's
    key, split once as the JAX package does (the first half stays the
    chain's key, the second seeds the initial wait). ``assignment`` is
    (N,) (one plan for every chain) or (C, N). ``label_values[district]``
    is the reference's +1/-1 label, which seeds part_sum
    (grid_chain_sec11.py:219). ``sample_initial_wait(keys, b_count)``
    draws the memoised wait of the initial state; None leaves it 0."""
    c = keys.shape[0]
    dev = keys.device
    a = assignment.to(torch.int8)
    if a.dim() == 1:
        a = a.expand(c, -1)
    a = a.contiguous()
    cut, cut_deg, dist_pop, cut_count, b_count = derive(dg, a, k, proposal)
    ks = rng.split(keys, 2)
    key, kw = ks[:, 0], ks[:, 1]
    if sample_initial_wait is not None:
        wait = sample_initial_wait(kw, b_count).to(torch.float32)
    else:
        wait = torch.zeros(c, dtype=torch.float32, device=dev)
    n, e = dg.n_nodes, dg.n_edges
    i32 = torch.int32

    def zeros(*shape):
        return torch.zeros(shape, dtype=i32, device=dev)

    return ChainState(
        key=key.contiguous(), assignment=a, cut=cut, cut_deg=cut_deg,
        dist_pop=dist_pop, cut_count=cut_count, b_count=b_count,
        cur_wait=wait, cur_flip_node=torch.full((c,), -1, dtype=i32,
                                                device=dev),
        t_yield=zeros(c), move_clock=zeros(c),
        part_sum=label_values.to(dev)[a.to(torch.int64)].to(i32),
        last_flipped=zeros(c, n), num_flips=zeros(c, n),
        cut_times=zeros(c, e),
        waits_sum=torch.zeros(c, dtype=torch.float32, device=dev),
        accept_count=zeros(c), tries_sum=zeros(c), exhausted_count=zeros(c))
