from .lattice import LatticeGraph, build_lattice
from .builders import (PARITY_LABELS, frank_plan, frankengraph, grid_sec11,
                       sec11_plan, square_grid, stripes_plan)

__all__ = ["LatticeGraph", "build_lattice", "square_grid", "stripes_plan",
           "grid_sec11", "frankengraph", "sec11_plan", "frank_plan",
           "PARITY_LABELS"]
