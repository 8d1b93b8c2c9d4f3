"""Carry the JAX package's board-path objects into this package's types.

The JAX package's ``BoardGraph``, ``BoardState`` and ``StepParams``,
handed over as host arrays (``jax.tree.map(np.asarray, obj)``), become
``kernel.board.BoardGraph`` / ``BoardState`` and ``kernel.step.StepParams``
on a chosen device, field by field and dtype by dtype. Only attributes
are read, so this module imports nothing of the JAX package; it is how a
test hands both packages the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .kernel.board import BoardGraph, BoardState
from .kernel.step import StepParams

_STATE_DTYPES = {
    "key": torch.int64, "board": torch.int8, "dist_pop": torch.int32,
    "cut_count": torch.int32, "cur_wait": torch.float32,
    "wait_pending": torch.bool, "cur_flip": torch.int32,
    "cur_sign": torch.int32, "t_yield": torch.int32,
    "move_clock": torch.int32, "part_sum": torch.int32,
    "last_flipped": torch.int32, "num_flips": torch.int32,
    "cut_times_e": torch.int32, "cut_times_s": torch.int32,
    "waits_sum": torch.float32, "accept_count": torch.int32,
    "tries_sum": torch.int32, "exhausted_count": torch.int32,
}


def _tensor(x, dtype, dev) -> torch.Tensor:
    arr = np.array(x, order="C")
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.as_tensor(arr, device=dev).to(dtype)


def board_graph(bg, device="cuda") -> BoardGraph:
    """A rook-grid BoardGraph (the JAX package's, as host arrays)."""
    dev = resolve_device(device)
    if getattr(bg, "surgical", False):
        raise ValueError("surgical (lowered) board graphs are not ported")
    return BoardGraph(pop=_tensor(bg.pop, torch.int32, dev),
                      deg=_tensor(bg.deg, torch.int32, dev),
                      east_ok=_tensor(bg.east_ok, torch.bool, dev),
                      west_ok=_tensor(bg.west_ok, torch.bool, dev),
                      h=int(bg.h), w=int(bg.w))


def board_state(state, device="cuda") -> BoardState:
    """A rook-body BoardState (the JAX package's, as host arrays)."""
    dev = resolve_device(device)
    for extra in ("cut_times_se", "cut_times_sw", "reject_count"):
        if getattr(state, extra, None) is not None:
            raise ValueError(f"BoardState.{extra} is not ported")
    return BoardState(**{name: _tensor(getattr(state, name), dtype, dev)
                         for name, dtype in _STATE_DTYPES.items()})


def step_params(params, device="cuda") -> StepParams:
    """Per-chain StepParams (the JAX package's, as host arrays)."""
    dev = resolve_device(device)
    f32 = torch.float32
    return StepParams(
        log_base=_tensor(params.log_base, f32, dev),
        beta=_tensor(params.beta, f32, dev),
        pop_lo=_tensor(params.pop_lo, f32, dev),
        pop_hi=_tensor(params.pop_hi, f32, dev),
        label_values=_tensor(params.label_values, torch.int32, dev),
        anneal_t0=float(params.anneal_t0),
        anneal_ramp=float(params.anneal_ramp),
        anneal_beta_max=float(params.anneal_beta_max))


def to_numpy(obj) -> dict:
    """A port dataclass of tensors as {field: numpy array or value}."""
    return {f.name: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(obj)
            for v in (getattr(obj, f.name),)}
