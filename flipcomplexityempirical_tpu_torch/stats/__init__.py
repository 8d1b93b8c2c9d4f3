"""Statistics over a run's results (numpy only)."""

from . import partisan

__all__ = ["partisan"]
