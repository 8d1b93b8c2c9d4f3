"""The port's dual-graph modules (``graphs/dualgraph.py``,
``graphs/shapefile.py``, the committed precinct fixture) against the JAX
package's, numpy only: the same features give the same LatticeGraph
tables, geometry attributes and boundary-length weights, bit for bit;
the shapefile writer writes the JAX package's bytes, and the dual graph
read back from them equals the JAX package's reading, and its GeoJSON's
up to the float sums' order (the writer reverses ring orientation:
relative 1e-12, as ``tests/test_dualgraph.py`` holds it)."""

import dataclasses

import numpy as np
import pytest

from flipcomplexityempirical_tpu.graphs import dualgraph as jdual
from flipcomplexityempirical_tpu.graphs import shapefile as jshp
from flipcomplexityempirical_tpu.workloads import data as jdata

from flipcomplexityempirical_tpu_torch.graphs import dualgraph as pdual
from flipcomplexityempirical_tpu_torch.graphs import shapefile as pshp
from flipcomplexityempirical_tpu_torch.workloads import data as pdata

TABLES = ("edges", "nbr", "nbr_mask", "nbr_edge", "deg", "pop", "coords",
          "frame_mask", "wall_id", "edge_len", "patch_nodes", "patch_adj",
          "patch_size")


def assert_same_dual(got, want):
    (pg, pgeo), (jg, jgeo) = got, want
    assert pg.labels == jg.labels
    for k in TABLES:
        np.testing.assert_array_equal(getattr(pg, k), getattr(jg, k),
                                      err_msg=k)
    assert pg.patch_ok == jg.patch_ok
    assert pg.center == jg.center
    for f in dataclasses.fields(jgeo):
        np.testing.assert_array_equal(getattr(pgeo, f.name),
                                      getattr(jgeo, f.name), err_msg=f.name)


def test_fixture_is_the_jax_package_fixture():
    with open(pdata.fixture_path(), "rb") as a, \
            open(jdata.fixture_path(), "rb") as b:
        assert a.read() == b.read()
    assert pdata.load_fixture() == jdata.load_fixture()


@pytest.mark.parametrize("adjacency", ["rook", "queen"])
def test_from_geojson_fixture_matches_jax(adjacency):
    fc = pdata.load_fixture()
    kw = dict(pop_property="POP", adjacency=adjacency)
    assert_same_dual(pdual.from_geojson(fc, **kw),
                     jdual.from_geojson(fc, **kw))


@pytest.mark.parametrize("nx,ny,seed", [(12, 12, 0), (12, 12, 1), (5, 7, 3),
                                        (10, 8, 20260806)])
def test_synthetic_precincts_match_jax(nx, ny, seed):
    fc = pdual.synthetic_precincts(nx, ny, seed=seed)
    assert fc == jdual.synthetic_precincts(nx, ny, seed=seed)
    assert_same_dual(pdual.from_geojson(fc, pop_property="POP"),
                     jdual.from_geojson(fc, pop_property="POP"))


@pytest.mark.parametrize("n,seed", [(144, 0), (60, 5)])
def test_voronoi_precincts_match_jax(n, seed):
    pytest.importorskip("scipy")
    fc = pdual.voronoi_precincts(n, seed=seed)
    assert fc == jdual.voronoi_precincts(n, seed=seed)
    assert_same_dual(pdual.from_geojson(fc, pop_property="POP",
                                        name_property="NAME"),
                     jdual.from_geojson(fc, pop_property="POP",
                                        name_property="NAME"))


def test_shapefile_round_trip_matches_jax(tmp_path):
    """The port's writer and reader against the JAX package's, byte for
    byte, and the dual graph of the file read back equal to the
    GeoJSON's."""
    fc = pdual.synthetic_precincts(6, 5, seed=2)
    pshp.write_shapefile(str(tmp_path / "p"), fc)
    jshp.write_shapefile(str(tmp_path / "j"), fc)
    for ext in (".shp", ".shx", ".dbf"):
        p, j = tmp_path / f"p{ext}", tmp_path / f"j{ext}"
        if j.exists():
            assert p.read_bytes() == j.read_bytes(), ext
    kw = dict(pop_property="POP", name_property="NAME")
    got = pdual.from_shapefile(str(tmp_path / "p.shp"), **kw)
    assert_same_dual(got, jdual.from_shapefile(str(tmp_path / "j.shp"), **kw))
    (g, geo), (g0, geo0) = got, jdual.from_geojson(fc, **kw)
    for k in TABLES:
        np.testing.assert_allclose(getattr(g, k), getattr(g0, k),
                                   rtol=1e-12, err_msg=k)
    for f in dataclasses.fields(geo0):
        np.testing.assert_allclose(getattr(geo, f.name),
                                   getattr(geo0, f.name), rtol=1e-12,
                                   atol=1e-12, err_msg=f.name)
