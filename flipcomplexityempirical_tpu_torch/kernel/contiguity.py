"""Single-flip contiguity checks, batched over chains.

Port of ``flipcomplexityempirical_tpu/kernel/contiguity.py``:

- ``patch_connected``: label propagation inside the flipped node's
  radius-r patch (P <= 32 slots). Sufficient always; exact when the
  origin district is simply connected.
- ``exact_connected``: a masked frontier expansion over the whole graph
  (gerrychain's ``single_flip_contiguous``), the oracle.

Both take a (C, N) assignment and node / origin-district tensors whose
first axis is the chain, and return bool of the origin tensor's shape.
Both are True when the flipped node has at most one same-district
neighbour. Propagation runs to its fixpoint, which is what the JAX
package's fixed P rounds (``patch_connected``) and its while loop
(``exact_connected``) both reach.
"""

from __future__ import annotations

import torch

# (chain, node, slot, slot) elements one block of patch checks holds at
# once
_BLOCK = 1 << 24


def _patch_rows(dg, a: torch.Tensor, v: torch.Tensor,
                d_origin: torch.Tensor) -> torch.Tensor:
    """patch_connected for (1 or C, R) nodes ``v`` against (C, N) ``a``:
    label propagation from the lowest seed slot over the slot adjacency
    (``patch_adj``'s bitsets unpacked), to its fixpoint."""
    c = a.shape[0]
    p = dg.max_patch
    pn = dg.patch_nodes[v]                              # (Cv, R, P)
    if v.shape[0] == 1:
        ap = a[:, pn[0]]
    else:
        ap = torch.gather(a, 1, pn.reshape(c, -1)).reshape(pn.shape)
    member = (ap == d_origin[..., None]) & (pn != v[..., None])
    slots = torch.arange(p, device=a.device)
    # [.., s, t]: slot t is adjacent to slot s
    adj = ((dg.patch_adj[v][..., None] >> slots) & 1).bool()
    seeds = member & (slots < dg.deg[v][..., None])     # slots < deg: nbrs
    start = torch.argmax(seeds.to(torch.uint8), dim=-1)
    reach = (slots == start[..., None]) & seeds.any(dim=-1, keepdim=True)
    while True:
        grown = reach | ((reach[..., :, None] & adj).any(dim=-2) & member)
        if torch.equal(grown, reach):
            break
        reach = grown
    return (seeds.sum(dim=-1) <= 1) | ~(seeds & ~reach).any(dim=-1)


def patch_connected(dg, assignment: torch.Tensor, v: torch.Tensor,
                    d_origin: torch.Tensor) -> torch.Tensor:
    """True where v's d_origin neighbours stay connected to each other
    inside v's patch once v is removed: nodes ``v`` of shape (C, ...) or
    (1, ...) (the same nodes on every chain) of the chains' (C, N)
    ``assignment``, districts ``d_origin`` of shape (C, ...)."""
    c = assignment.shape[0]
    vf = v.reshape(v.shape[0], -1).to(torch.int64)
    df = d_origin.reshape(c, -1).to(assignment.dtype)
    per = max(1, _BLOCK // (c * max(dg.max_patch, 1) ** 2))
    out = [_patch_rows(dg, assignment, vf[:, i:i + per], df[:, i:i + per])
           for i in range(0, vf.shape[1], per)]
    return torch.cat(out, dim=1).reshape(d_origin.shape)


def exact_connected(dg, assignment: torch.Tensor, v: torch.Tensor,
                    d_origin: torch.Tensor) -> torch.Tensor:
    """gerrychain-exact check: expand from one of v's origin-district
    neighbours within the district minus v until every such neighbour
    is reached or the frontier dies."""
    c = assignment.shape[0]
    n = dg.n_nodes
    dev = assignment.device
    vf = v.reshape(c, -1).to(torch.int64)
    df = d_origin.reshape(c, -1).to(torch.int64)
    r = vf.shape[1]
    a = assignment.to(torch.int64)
    nb = dg.nbr[vf]                                     # (C, R, D)
    seed = ((torch.gather(a, 1, nb.reshape(c, -1)).reshape(nb.shape)
             == df[..., None]) & dg.nbr_mask[vf])
    n_seeds = seed.sum(dim=-1).reshape(-1)
    rows = a.repeat_interleave(r, dim=0)                # (C * R, N)
    vv, dd = vf.reshape(-1), df.reshape(-1)
    nbf, seedf = nb.reshape(c * r, -1), seed.reshape(c * r, -1)
    ar = torch.arange(c * r, device=dev)
    targets = torch.zeros((c * r, n), dtype=torch.int32, device=dev)
    targets.scatter_add_(1, nbf, seedf.to(torch.int32))
    targets = targets > 0
    targets[ar, vv] = False
    district = (rows == dd[:, None]) & (
        torch.arange(n, device=dev) != vv[:, None])
    start = nbf[ar, torch.argmax(seedf.to(torch.uint8), dim=1)]
    visited = torch.zeros((c * r, n), dtype=torch.bool, device=dev)
    visited[ar, start] = True
    while bool((targets & ~visited).any()):
        hit = (visited[:, dg.nbr] & dg.nbr_mask).any(dim=-1)
        grown = visited | (hit & district)
        if torch.equal(grown, visited):
            break
        visited = grown
    reached = ~(targets & ~visited).any(dim=1)
    return ((n_seeds <= 1) | reached).reshape(v.shape)


def check(dg, assignment: torch.Tensor, v: torch.Tensor,
          d_origin: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "patch":
        return patch_connected(dg, assignment, v, d_origin)
    if mode == "exact":
        return exact_connected(dg, assignment, v, d_origin)
    if mode == "none":
        return torch.ones(v.shape, dtype=torch.bool, device=v.device)
    raise ValueError(f"contiguity mode {mode!r}")
