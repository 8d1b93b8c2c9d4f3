from .dualgraph import (GeoAttributes, from_geojson, from_shapefile,
                        synthetic_precincts, voronoi_precincts)
from .lattice import DeviceGraph, LatticeGraph, build_lattice
from .builders import (PARITY_LABELS, frank_plan, frankengraph, grid_sec11,
                       hex_lattice, sec11_plan, square_grid, stripes_plan,
                       triangular_lattice)

__all__ = ["DeviceGraph", "LatticeGraph", "build_lattice", "square_grid",
           "stripes_plan", "grid_sec11", "frankengraph",
           "triangular_lattice", "hex_lattice", "sec11_plan", "frank_plan",
           "PARITY_LABELS", "GeoAttributes", "from_geojson",
           "from_shapefile", "synthetic_precincts", "voronoi_precincts"]
