"""ReCom: the spanning-tree recombination chain, the JAX package's second
chain family.

Port of ``flipcomplexityempirical_tpu/sampling/recom.py``. The plain
versions here are the JAX package's bodies as torch ops, with the chains
axis written out in place of ``vmap`` (every argument and result carries
it first) and each ``while_loop`` a Python loop that runs until no chain
has work left (a chain that is done keeps its values, as under ``vmap``):

- ``spanning_forest``: the random minimum spanning forest of the merged
  pair, Boruvka rounds over the ranks of ``jax.random.permutation``
  (``rng.permutation``, bit for bit). The ranks are distinct, so the
  forest is unique and any exact MST algorithm gives the same edges;
- ``tree_structure``: BFS parents and depths from the root;
- ``subtree_populations``: f32 sums rolled up level by level (exact while
  every partial sum stays below 2**24);
- ``mark_subtree``: the subtree under the cut child;
- ``recom_move``: the move (cut edge, merge, up to ``tree_retries`` tree
  attempts with the balanced child edge picked by Gumbel-argmax, commit,
  ``derive``, the parity settlement, the wait);
- ``recom_chunk_reference``: T moves, each followed by
  ``kernel/step.py::record`` (JAX ``_run_recom_chunk``).

``run_recom`` is the chunked runner, with ``run_chains``' contract
(``sampling/runner.py``). On CUDA tensors each chunk is one launch of the
hand-written kernel of ``csrc/recom_chunk.cu`` (``kernel/cuda_recom.py``);
on CPU tensors the chunk runs ``recom_chunk_reference``. The plain chunk
never runs in the kernel's place on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng
from ..kernel import cuda_recom
from ..kernel import step as kstep
from ..state.chain_state import derive
from .runner import (RunResult, assemble_history, maybe_host, pick_chunk,
                     snap_chunk_to, thin_outs)


def _ceil_log2(n: int) -> int:
    b = 1
    while (1 << b) < n:
        b += 1
    return b


def spanning_forest(dg, member: torch.Tensor, keys: torch.Tensor):
    """bool (C, E): the random minimum spanning forest of the subgraph
    each chain's ``member`` (bool (C, N)) induces, Boruvka with the ranks
    ``rng.permutation(keys, E)`` as weights; non-members stay singletons."""
    n, e = dg.n_nodes, dg.n_edges
    c = member.shape[0]
    dev = member.device
    eu, ev = dg.edges[:, 0], dg.edges[:, 1]
    internal = member[:, eu] & member[:, ev]
    w = rng.permutation(keys, e)
    big = e
    ar = torch.arange(n, device=dev).expand(c, n)
    comp = ar.clone()
    in_tree = torch.zeros((c, e), dtype=torch.bool, device=dev)
    jumps = _ceil_log2(max(n, 2))
    while True:
        cu, cv = comp[:, eu], comp[:, ev]
        alive = internal & (cu != cv)
        if not bool(alive.any()):
            return in_tree
        we = torch.where(alive, w, big)
        best = torch.full((c, n), big, dtype=torch.int64, device=dev)
        best = best.scatter_reduce(1, cu, we, "amin")
        best = best.scatter_reduce(1, cv, we, "amin")
        sel = alive & ((we <= torch.gather(best, 1, cu))
                       | (we <= torch.gather(best, 1, cv)))
        lo, hi = torch.minimum(cu, cv), torch.maximum(cu, cv)
        parent = ar.clone().scatter_reduce(
            1, torch.where(sel, hi, 0), torch.where(sel, lo, n), "amin")
        parent = torch.minimum(parent, ar)
        for _ in range(jumps):
            parent = torch.gather(parent, 1, parent)
        comp = torch.gather(parent, 1, comp)
        in_tree = in_tree | sel


def tree_structure(dg, in_tree: torch.Tensor, member: torch.Tensor,
                   root: torch.Tensor):
    """(parent, depth), int64 (C, N): BFS over the forest's edges from each
    chain's ``root``; parent[root] = root, nodes off the root's tree keep
    parent = self and depth = -1."""
    c = member.shape[0]
    n = dg.n_nodes
    dev = member.device
    cr = torch.arange(c, device=dev)
    tree_nbr = in_tree[:, dg.nbr_edge] & dg.nbr_mask          # (C, N, D)
    parent = torch.arange(n, device=dev).expand(c, n).clone()
    depth = torch.full((c, n), -1, dtype=torch.int64, device=dev)
    depth[cr, root] = 0
    frontier = torch.zeros((c, n), dtype=torch.bool, device=dev)
    frontier[cr, root] = True
    nbr = dg.nbr.expand(c, -1, -1)
    lvl = 0
    while bool(frontier.any()):
        nbr_is_par = frontier[:, dg.nbr] & tree_nbr
        new = nbr_is_par.any(dim=2) & (depth < 0) & member
        first = torch.argmax(nbr_is_par.to(torch.uint8), dim=2)
        cand = torch.gather(nbr, 2, first[..., None])[..., 0]
        parent = torch.where(new, cand, parent)
        depth = torch.where(new, lvl + 1, depth)
        frontier = new
        lvl += 1
    return parent, depth


def subtree_populations(dg, parent: torch.Tensor, depth: torch.Tensor):
    """f32 (C, N) subtree population sums, rolled up from the deepest BFS
    level to the root."""
    acc = torch.where(depth >= 0, dg.pop.to(torch.float32), 0.0)
    for lvl in range(int(depth.max()), 0, -1):
        at = depth == lvl
        acc = acc.scatter_add(1, torch.where(at, parent, 0),
                              torch.where(at, acc, 0.0))
    return acc


def mark_subtree(dg, parent: torch.Tensor, depth: torch.Tensor,
                 cut_child: torch.Tensor):
    """bool (C, N): the nodes whose root path passes through each chain's
    ``cut_child``, by a top-down sweep of the levels below it."""
    c, n = parent.shape
    dev = parent.device
    cr = torch.arange(c, device=dev)
    mark = torch.zeros((c, n), dtype=torch.bool, device=dev)
    mark[cr, cut_child] = True
    start = depth[cr, cut_child] + 1
    maxd = depth.max(dim=1).values
    not_cc = torch.arange(n, device=dev)[None, :] != cut_child[:, None]
    for lvl in range(int(start.min()), int(maxd.max()) + 1):
        live = ((lvl >= start) & (lvl <= maxd))[:, None]
        at = (depth == lvl) & not_cc & live
        mark = mark | (at & torch.gather(mark, 1, parent))
    return mark


def _attempt(dg, member, root, keys, pop_target, lo_f, hi_f):
    """One tree attempt for each chain of the batch: (parent, depth,
    cut_child, found), the balanced child edges' Gumbel-argmax."""
    n = dg.n_nodes
    cr = torch.arange(member.shape[0], device=member.device)
    ks = rng.split(keys, 2)
    in_tree = spanning_forest(dg, member, ks[:, 0])
    parent, depth = tree_structure(dg, in_tree, member, root)
    sub = subtree_populations(dg, parent, depth)
    total = sub[cr, root]
    target = total / 2.0 if pop_target is None else pop_target.expand_as(
        total)
    lo, hi = (target * lo_f)[:, None], (target * hi_f)[:, None]
    rest = total[:, None] - sub
    ok = ((depth > 0) & (sub >= lo) & (sub <= hi) & (rest >= lo)
          & (rest <= hi))
    g = rng.gumbel(ks[:, 1], n)
    cut_child = torch.argmax(torch.where(ok, g, -torch.inf), dim=1)
    return parent, depth, cut_child, ok.any(dim=1)


def recom_move(dg, spec, state, epsilon: float = 0.05, pop_target=None,
               label_values=None, tree_retries: int = 4):
    """One ReCom move for every chain of the batch: merge the two
    districts across a random cut edge, draw spanning trees of the merged
    pair (up to ``tree_retries`` attempts in all), and commit the split at
    a balanced tree edge if one exists. The JAX package's ``recom_move``,
    argument for argument: ``pop_target`` the ideal district population
    (None: half the merged pair's), ``label_values`` the district labels
    of the parity settlement (None skips it)."""
    if state.reject_count is not None:
        raise ValueError("reject_count is not ported: the reject taxonomy "
                         "waits for ROADMAP.md A11a")
    n = dg.n_nodes
    dev = state.assignment.device
    c = state.assignment.shape[0]
    cr = torch.arange(c, device=dev)
    i32, f32 = torch.int32, torch.float32
    ks = rng.split(state.key, 4)
    key, k_edge, k_draw, k_wait = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
    a = state.assignment.to(torch.int64)

    cut_mask = state.cut > 0
    u = rng.uniform_n(k_edge, dg.n_edges)
    e_star = torch.argmax(torch.where(cut_mask, u, -1.0), dim=1)
    any_cut = cut_mask.any(dim=1)
    root = dg.edges[e_star, 0]
    d1 = a[cr, root]
    d2 = a[cr, dg.edges[e_star, 1]]
    member = (a == d1[:, None]) | (a == d2[:, None])

    target = (None if pop_target is None
              else torch.tensor(pop_target, dtype=f32, device=dev))
    lo_f = torch.tensor(1 - epsilon, dtype=f32, device=dev)
    hi_f = torch.tensor(1 + epsilon, dtype=f32, device=dev)
    kk = rng.split(k_draw, 2)
    k_next = kk[:, 0]
    parent, depth, cut_child, found_tree = _attempt(
        dg, member, root, kk[:, 1], target, lo_f, hi_f)
    tries = 1
    while True:
        live = ~found_tree & (tries < tree_retries)
        if not bool(live.any()):
            break
        idx = live.nonzero()[:, 0]
        kk = rng.split(k_next[idx], 2)
        k_next = k_next.clone()
        k_next[idx] = kk[:, 0]
        p2, d2_, cc2, ok2 = _attempt(dg, member[idx], root[idx], kk[:, 1],
                                     target, lo_f, hi_f)
        parent, depth = parent.clone(), depth.clone()
        cut_child, found_tree = cut_child.clone(), found_tree.clone()
        parent[idx], depth[idx], cut_child[idx], found_tree[idx] = (
            p2, d2_, cc2, ok2)
        tries += 1
    found = found_tree & any_cut

    side = mark_subtree(dg, parent, depth, cut_child)
    a_new = torch.where(member, torch.where(side, d1[:, None], d2[:, None]),
                        a)
    a_new = torch.where(found[:, None], a_new, a)
    cut, cut_deg, dist_pop, cut_count, b_count = derive(
        dg, a_new, spec.n_districts, spec.proposal)

    part_sum, last_flipped, num_flips = (
        state.part_sum, state.last_flipped, state.num_flips)
    if spec.parity_metrics and label_values is not None:
        lv = torch.as_tensor(label_values, dtype=i32, device=dev)
        changed = a_new != a
        t_now = state.t_yield[:, None]
        part_sum = part_sum + torch.where(
            changed, lv[a] * (t_now - last_flipped), 0).to(i32)
        last_flipped = torch.where(changed, t_now, last_flipped)
        num_flips = num_flips + changed.to(i32)

    cur_wait = state.cur_wait
    if spec.geom_waits:
        wait_new = kstep.sample_geom_minus1(k_wait, b_count, n,
                                            spec.n_districts)
        cur_wait = torch.where(found, wait_new, cur_wait)
    fi = found.to(i32)
    return state.replace(
        key=key.contiguous(), assignment=a_new.to(state.assignment.dtype),
        cut=cut.to(state.cut.dtype), cut_deg=cut_deg.to(state.cut_deg.dtype),
        dist_pop=dist_pop, cut_count=cut_count, b_count=b_count,
        cur_wait=cur_wait,
        cur_flip_node=torch.where(found, -1, state.cur_flip_node).to(i32),
        part_sum=part_sum, last_flipped=last_flipped, num_flips=num_flips,
        move_clock=state.move_clock + fi,
        accept_count=state.accept_count + fi,
        tries_sum=state.tries_sum + 1,
        exhausted_count=state.exhausted_count + (1 - fi))


def recom_chunk_reference(dg, spec, params, state, t_inner: int,
                          epsilon: float = 0.05, pop_target=None,
                          tree_retries: int = 4):
    """The plain chunk (JAX ``_run_recom_chunk``): ``t_inner`` rounds of
    ``recom_move`` (the parity settlement with ``params.label_values``)
    and ``kernel/step.py::record``. Returns (state, {name: (T, C)})."""
    def move(dg, spec, params, state):
        return recom_move(dg, spec, state, epsilon=epsilon,
                          pop_target=pop_target,
                          label_values=params.label_values,
                          tree_retries=tree_retries)
    return kstep.run_steps(move, dg, spec, params, state, t_inner)


def run_recom(dg, spec, params, states, n_steps: int,
              epsilon: float = 0.05, pop_target=None, tree_retries: int = 4,
              record_history: bool = True, chunk=None,
              record_initial: bool = True, record_every: int = 1,
              history_device: bool = False, recorder=None) -> RunResult:
    """The ReCom chain family's chunked runner, with ``run_chains``'
    contract: ``n_steps`` yields, the first the initial record unless
    ``record_initial=False`` continues an earlier run; ``record_every=k``
    keeps yields 0, k, 2k, ... of the history; ``history_device`` keeps it
    as tensors on the run's device; the wait sums are drained into a host
    float64 total once a chunk. The default chunk is ``pick_chunk(n,
    256)``. On the card each chunk is one launch of the ReCom kernel
    (``kernel/cuda_recom.py``), which refuses by name what it does not
    run; on the CPU the plain chunk runs. ``recorder`` (obs events) waits
    for ROADMAP.md A11a."""
    if recorder is not None:
        raise ValueError("run_recom(recorder=...): obs events wait for "
                         "ROADMAP.md A11a")
    if states.reject_count is not None:
        raise ValueError("reject_count is not ported: the reject taxonomy "
                         "waits for ROADMAP.md A11a")
    if record_every < 1:
        raise ValueError(f"record_every must be >= 1, got {record_every}")
    if chunk is None:
        chunk = pick_chunk(n_steps + (0 if record_initial else 1), 256)
    if record_every > 1:
        chunk = snap_chunk_to(chunk, record_every)
    if pop_target is not None:
        pop_target = float(pop_target)
    static = None
    if states.assignment.device.type == "cuda":
        cuda_recom.check(dg, spec, params)
        static = cuda_recom.make_static_inputs(dg)
    states = states.replace(conn_bits=None)

    hist_parts = {} if record_history else None
    done = 0
    if record_initial:
        states, out0 = kstep.record(dg, spec, params, states)
        if record_history:
            out0 = maybe_host(out0, history_device)
            hist_parts = {k: [v[:, None]] for k, v in out0.items()}
        done = 1
    waits_total = states.waits_sum.cpu().numpy().astype(np.float64)
    states = states.replace(waits_sum=torch.zeros_like(states.waits_sum))
    while done < n_steps:
        this = min(chunk, n_steps - done)
        states, outs = cuda_recom.run_recom_chunk_cuda(
            dg, static, spec, params, states, this, epsilon=epsilon,
            pop_target=pop_target, tree_retries=tree_retries)
        if record_history:
            outs = maybe_host(thin_outs(outs, record_every), history_device)
            for k, v in outs.items():
                hist_parts.setdefault(k, []).append(v.T)
        waits_total += states.waits_sum.cpu().numpy().astype(np.float64)
        states = states.replace(waits_sum=torch.zeros_like(states.waits_sum))
        done += this
    history = assemble_history(hist_parts, record_history, history_device)
    return RunResult(state=states, history=history, waits_total=waits_total,
                     n_yields=n_steps)
