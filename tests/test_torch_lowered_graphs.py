"""The port's lowered-family graphs against the JAX package's, numpy only.

``grid_sec11``, ``frankengraph`` (the JAX package builds it with networkx;
the port draws the triangular lattice by hand), surgical and queen grids,
the starting plans and every ``StencilSpec`` field must be equal, so the
two packages run the same chain on the same canvas. Tolerance: exact.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.lower import stencil as jstencil
from flipcomplexityempirical_tpu_torch import graphs as tgraphs
from flipcomplexityempirical_tpu_torch.lower import stencil as tstencil

PORT = pathlib.Path(__file__).resolve().parent.parent / \
    "flipcomplexityempirical_tpu_torch"
SURGERY = dict(remove_nodes=[(0, 0), (2, 3)],
               extra_edges=[((0, 1), (1, 0)), ((3, 4), (4, 5))])
GRAPH_FIELDS = ("edges", "deg", "pop", "coords", "frame_mask", "wall_id",
                "patch_nodes", "patch_adj", "patch_size")

GRAPHS = {
    "sec11": (fce.graphs.grid_sec11, tgraphs.grid_sec11),
    "frankengraph": (fce.graphs.frankengraph, tgraphs.frankengraph),
    "frankengraph7": (lambda: fce.graphs.frankengraph(7),
                      lambda: tgraphs.frankengraph(7)),
    "surgical": (lambda: fce.graphs.square_grid(5, 7, **SURGERY),
                 lambda: tgraphs.square_grid(5, 7, **SURGERY)),
    "queen": (lambda: fce.graphs.square_grid(6, queen=True),
              lambda: tgraphs.square_grid(6, queen=True)),
}


@pytest.fixture(scope="module")
def pairs():
    return {name: (jf(), tf()) for name, (jf, tf) in GRAPHS.items()}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_equals_jax(pairs, name):
    want, got = pairs[name]
    assert got.name == want.name and got.labels == want.labels
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == getattr(want, f).dtype, f
    assert got.patch_ok == want.patch_ok
    assert tuple(got.center) == tuple(want.center)


def test_paper_graph_sizes(pairs):
    assert (pairs["sec11"][1].n_nodes, pairs["sec11"][1].n_edges) == \
        (1596, 3116)
    assert (pairs["frankengraph"][1].n_nodes,
            pairs["frankengraph"][1].n_edges) == (800, 1920)


@pytest.mark.parametrize("alignment", [0, 1, 2])
def test_plans_equal_jax(pairs, alignment):
    want, got = pairs["sec11"]
    np.testing.assert_array_equal(tgraphs.sec11_plan(got, alignment),
                                  fce.graphs.sec11_plan(want, alignment))
    want, got = pairs["frankengraph"]
    np.testing.assert_array_equal(tgraphs.frank_plan(got, alignment),
                                  fce.graphs.frank_plan(want, alignment))
    np.testing.assert_array_equal(tgraphs.PARITY_LABELS,
                                  fce.graphs.PARITY_LABELS)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_stencil_equals_jax(pairs, name):
    want_g, got_g = pairs[name]
    want = jstencil.lower_to_stencil(want_g)
    got = tstencil.lower_to_stencil(got_g)
    assert got is not None and want is not None
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        else:
            assert a == b, f.name
    assert got.surgical == want.surgical


def test_port_needs_no_networkx():
    """The card's machine has no networkx: no module of the port imports
    it."""
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        roots = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split(".")[0])
        assert "networkx" not in roots, path
