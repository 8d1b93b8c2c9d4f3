from .lattice import LatticeGraph, build_lattice
from .builders import square_grid, stripes_plan

__all__ = ["LatticeGraph", "build_lattice", "square_grid", "stripes_plan"]
