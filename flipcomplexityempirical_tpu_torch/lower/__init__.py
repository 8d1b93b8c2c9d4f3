"""The lowering pass: near-grid graphs onto the board path's canvas."""

from .stencil import StencilSpec, lower_to_stencil, stencil_for

__all__ = ["StencilSpec", "lower_to_stencil", "stencil_for"]
