"""Carry the JAX package's objects into this package's types.

The JAX package's ``BoardGraph``, ``BoardState``, ``DeviceGraph``,
``ChainState`` and ``StepParams``, handed over as host arrays
(``jax.tree.map(np.asarray, obj)``), become ``kernel.board.BoardGraph`` /
``BoardState``, ``graphs.DeviceGraph``, ``state.ChainState`` and
``kernel.step.StepParams`` on a chosen device, field by field and dtype
by dtype: the rook, pair and lowered board bodies (a k-district state's
(C, K) dist_pop and its K labels), and the general path (the legacy and
dense bodies, the conn planes included). Only attributes are
read, so this module imports nothing of the JAX package; it is how a test
hands both packages the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .graphs.lattice import DeviceGraph
from .kernel.board import BoardGraph, BoardState
from .kernel.step import StepParams
from .state.chain_state import ChainState

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
    "cut_times_se": torch.int32, "cut_times_sw": torch.int32,
}
_GRAPH_PLANES = {
    "pop": torch.int32, "deg": torch.int32, "east_ok": torch.bool,
    "west_ok": torch.bool, "adj": torch.bool, "node_mask": torch.bool,
    "cell_of_node": torch.int64, "b2_in": torch.bool, "b2_adj": torch.int32,
    "nbr_bits": torch.int32, "iface_key": torch.int32,
}
_GRAPH_STATICS = ("h", "w", "uniform_pop", "surgical", "real_nodes",
                  "b2_offsets", "b2_disp", "b2_iters", "patch_exact",
                  "iface_ok", "iface_decode", "center")


_DEVICE_GRAPH = {
    "edges": torch.int64, "nbr": torch.int64, "nbr_mask": torch.bool,
    "nbr_edge": torch.int64, "deg": torch.int64, "pop": torch.int32,
    "coords": torch.float32, "frame_mask": torch.bool,
    "frame_idx": torch.int64, "wall_id": torch.int8,
    "edge_len": torch.float32, "patch_nodes": torch.int64,
    "patch_adj": torch.int64, "patch_size": torch.int64,
    "center": torch.float32,
}
_CHAIN_STATE = {
    "key": torch.int64, "assignment": torch.int8, "cut": torch.int8,
    "cut_deg": torch.int8, "dist_pop": torch.int32,
    "cut_count": torch.int32, "b_count": torch.int32,
    "cur_wait": torch.float32, "cur_flip_node": torch.int32,
    "t_yield": torch.int32, "move_clock": torch.int32,
    "part_sum": torch.int32, "last_flipped": torch.int32,
    "num_flips": torch.int32, "cut_times": torch.int32,
    "waits_sum": torch.float32, "accept_count": torch.int32,
    "tries_sum": torch.int32, "exhausted_count": torch.int32,
    "conn_bits": torch.int64,
}


def _tensor(x, dtype, dev) -> torch.Tensor:
    arr = np.array(x, order="C")
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.as_tensor(arr, device=dev).to(dtype)


def board_graph(bg, device="cuda") -> BoardGraph:
    """A BoardGraph (the JAX package's, as host arrays): the rook planes
    and, where set, the lowered-stencil planes and statics."""
    dev = resolve_device(device)
    planes = {name: _tensor(getattr(bg, name), dtype, dev)
              for name, dtype in _GRAPH_PLANES.items()
              if getattr(bg, name, None) is not None}
    statics = {name: getattr(bg, name) for name in _GRAPH_STATICS}
    statics["b2_offsets"] = tuple(int(o) for o in statics["b2_offsets"])
    if statics["b2_disp"] is not None:
        statics["b2_disp"] = tuple((int(r), int(c))
                                   for r, c in statics["b2_disp"])
    return BoardGraph(**planes, **statics)


def board_state(state, device="cuda") -> BoardState:
    """A BoardState (the JAX package's, as host arrays), with the diagonal
    cut_times planes where the lowered body made them."""
    dev = resolve_device(device)
    if getattr(state, "reject_count", None) is not None:
        raise ValueError("BoardState.reject_count is not ported")
    return BoardState(**{name: _tensor(getattr(state, name), dtype, dev)
                         for name, dtype in _STATE_DTYPES.items()
                         if getattr(state, name, None) is not None})


def device_graph(dg, device="cuda", patch_ok: bool = True) -> DeviceGraph:
    """A DeviceGraph (the JAX package's, as host arrays). The JAX view
    carries no ``patch_ok``: pass the LatticeGraph's."""
    dev = resolve_device(device)
    return DeviceGraph(**{name: _tensor(getattr(dg, name), dtype, dev)
                          for name, dtype in _DEVICE_GRAPH.items()},
                       patch_ok=bool(patch_ok))


def chain_state(state, device="cuda") -> ChainState:
    """A batched ChainState (the JAX package's, as host arrays), with the
    conn planes where the state carries them."""
    dev = resolve_device(device)
    if getattr(state, "reject_count", None) is not None:
        raise ValueError("ChainState.reject_count is not ported: the reject "
                         "taxonomy waits for ROADMAP.md A11")
    return ChainState(**{name: _tensor(getattr(state, name), dtype, dev)
                         for name, dtype in _CHAIN_STATE.items()
                         if getattr(state, name, None) is not None})


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
    """A port dataclass of tensors as {field: numpy array or value}; fields
    that are None (a rook state's diagonal planes) are left out."""
    return {f.name: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(obj)
            for v in (getattr(obj, f.name),) if v is not None}
