"""Replica exchange over a beta (inverse-temperature) ladder, as torch ops.

Port of ``flipcomplexityempirical_tpu/sampling/tempering.py``. The ladder
lives along the chain axis: chain c is rung ``c % n_rungs`` of ladder
``c // n_rungs``. Swaps exchange TEMPERATURES (the beta entries of
StepParams), not states, so a swap round is a permutation and a select
over C values; the chunk kernels read each chain's beta at every launch.

Acceptance: with per-rung target pi_r(x) ∝ exp(-beta_r * log(base) *
|cut(x)|), the swap of rungs (i, j) accepts with probability
min(1, exp((beta_i - beta_j) * (E_i - E_j))), E = log(base) * cut, drawn
from one uniform per pair (the JAX package's
``jax.random.uniform(key, (C,))`` at the pair's lower index, the same
threefry blocks here: ``rng.blocks(key, arange(C))``). The decision is
``log(max(u, 1e-12)) < log_a`` in f32, as the JAX package computes it.

Incompatible with ``Spec.anneal != 'none'``: the annealed chain derives
its inverse temperature from the step counter and ignores
``StepParams.beta``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..kernel.step import StepParams


def make_ladder_params(params: StepParams, betas,
                       n_ladders: int) -> StepParams:
    """Tile a base StepParams into (n_ladders * n_rungs) chains whose beta
    varies along the rung axis (rung fastest)."""
    f32 = torch.float32
    dev = params.log_base.device
    betas = torch.as_tensor(betas, dtype=f32, device=dev)
    c = n_ladders * betas.shape[0]

    def tile(x):
        x = torch.as_tensor(x, dtype=f32, device=dev)
        return (x if x.ndim == 0 else x[:1]).expand(c).contiguous()

    return dataclasses.replace(
        params, log_base=tile(params.log_base),
        beta=betas.repeat(n_ladders).contiguous(),
        pop_lo=tile(params.pop_lo), pop_hi=tile(params.pop_hi))


def chain_rungs(beta: torch.Tensor, n_rungs: int):
    """Per-chain rung = rank of the chain's CURRENT beta within its ladder,
    rank 0 = largest beta (coldest), ties in position order (a stable
    argsort of -beta). Returns (rung (C,), pos_of_rank (L, R))."""
    b_lr = beta.reshape(-1, n_rungs)
    pos_of_rank = torch.argsort(-b_lr, dim=1, stable=True)
    rank_of_pos = torch.argsort(pos_of_rank, dim=1, stable=True)
    return rank_of_pos.reshape(-1), pos_of_rank


def pair_uniforms(key: torch.Tensor, c: int) -> torch.Tensor:
    """``jax.random.uniform(key, (c,))`` for one raw key (2,): entry i is
    the f32 uniform of the XOR of the key's threefry block at counter
    (0, i)."""
    b0, b1 = rng.blocks(key, torch.arange(c, device=key.device))
    return rng.uniform_of(b0 ^ b1)


def swap_within_batch(key: torch.Tensor, states, params: StepParams,
                      n_rungs: int, parity: int, spec=None):
    """One even-odd swap round inside a batch laid out (ladders, rungs):
    ``parity`` 0 pairs rungs (0, 1), (2, 3), ...; parity 1 pairs (1, 2),
    ... (rung = rank of each chain's current beta, coldest first).
    Returns (params with exchanged betas, swap-accept mask (C,) bool);
    states are untouched. ``states`` may be a ChainState or a BoardState:
    only ``cut_count`` (the energy) is read. Pass the chains' ``Spec`` so
    that annealing is refused here."""
    if spec is not None and spec.anneal != "none":
        raise ValueError("replica exchange is incompatible with Spec.anneal "
                         "!= 'none': the annealed kernel ignores "
                         "StepParams.beta, so swapped betas have no effect")
    c = states.cut_count.shape[0]
    dev = states.cut_count.device
    beta = params.beta
    rung, pos_of_rank = chain_rungs(beta, n_rungs)
    idx = torch.arange(c, device=dev)
    ladder = torch.div(idx, n_rungs, rounding_mode="floor")
    lo = (rung % 2) == (parity % 2)
    partner_rank = torch.clamp(torch.where(lo, rung + 1, rung - 1), 0,
                               n_rungs - 1)
    partner = ladder * n_rungs + torch.gather(
        pos_of_rank, 1, partner_rank.reshape(-1, n_rungs)).reshape(-1)
    valid_pair = torch.where(
        lo, rung + 1 < n_rungs,
        (rung >= 1) & (rung % 2 == (1 - parity % 2)))
    # per-chain energy log_base * cut: partner-symmetric even where
    # log_base differs by chain
    energy = params.log_base * states.cut_count.to(torch.float32)
    log_a = (beta - beta[partner]) * (energy - energy[partner])
    # one shared uniform per unordered pair: drawn at the lower index
    u = pair_uniforms(key.to(dev), c)[torch.minimum(idx, partner)]
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    accept = valid_pair & (torch.log(torch.maximum(u, tiny)) < log_a)
    new_beta = torch.where(accept, beta[partner], beta)
    return dataclasses.replace(params, beta=new_beta), accept
