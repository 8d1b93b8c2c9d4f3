"""Committed workload fixtures: the port's copy of
``flipcomplexityempirical_tpu/workloads/data``.

``precincts_10x8.geojson`` is a deterministic precinct-style
FeatureCollection (``graphs.dualgraph.synthetic_precincts(10, 8,
seed=20260806)``, 80 jittered quads with POP / NAME properties,
populations in [80, 120]), the same bytes as the JAX package's, so the
dual family's ``dual_source='fixture'`` ingests the same map through
``from_geojson`` in both packages.
"""

from __future__ import annotations

import json
import os

_FIXTURE = "precincts_10x8.geojson"


def fixture_path() -> str:
    return os.path.join(os.path.dirname(__file__), _FIXTURE)


def load_fixture() -> dict:
    """The parsed FeatureCollection, ready for ``from_geojson``."""
    with open(fixture_path()) as f:
        return json.load(f)
