"""Chain configuration, per-chain parameters and the geometric wait.

Port of ``Spec``, ``StepParams``, ``make_params``, ``sample_geom_minus1``
and ``finalize_host`` from ``flipcomplexityempirical_tpu/kernel/step.py``.
The semantics notes there hold unchanged: invalid proposals re-propose,
the accept is the literal ``base**(-dcut)``, waits are memoized per state
with the literal ``n**k - 1`` denominator, and the last flip's bookkeeping
is re-applied on every yield.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import rng
from ..device import resolve_device


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
