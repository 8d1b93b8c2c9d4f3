"""The port's general runner on the dense body against a run of the JAX
package's, kept as a fixture the card's machine can read.

``tests/fixtures/torch/general_dense_hex.npz`` holds, for hex_lattice(14,
28) (the hex family's default lattice) from a stripes plan, 8 chains (the
experiments' count), seed 0, base 1/0.3, pop_tol 0.1: the initial batched
ChainState (``init_*``), and what the JAX package's
``run_chains(kernel_path='general_dense', n_steps=1001, chunk=500)``
returns: the final state (``state_*``), the
history (``hist_*``) and the f64 wait totals. ``chip_smoke.py`` holds the
card's kernel to it; here the plain version is held to it.

Regenerate with ``python tests/test_torch_general_fixture.py`` (JAX on the
CPU). Tolerance: ``_parity.assert_chain_run_matches``.
"""

import os
import pathlib
import sys

import numpy as np
import pytest
from _parity import assert_chain_run_matches, general_fixture_inputs

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures" / "torch"
           / "general_dense_hex.npz")
GRAPH, PLAN_K, CHAINS, SEED = (14, 28), 2, 8, 0
BASE, POP_TOL = 1 / 0.3, 0.1
STEPS, CHUNK = 1001, 500


def make_fixture() -> dict:
    import jax

    import flipcomplexityempirical_tpu as fce
    g = fce.graphs.hex_lattice(*GRAPH)
    spec = fce.Spec()
    dg, st, par = fce.init_batch(g, fce.graphs.stripes_plan(g, PLAN_K),
                                 n_chains=CHAINS, seed=SEED, spec=spec,
                                 base=BASE, pop_tol=POP_TOL)
    res = fce.run_chains(dg, spec, par, st, n_steps=STEPS, chunk=CHUNK,
                         kernel_path="general_dense")
    out = {"base": np.float64(BASE), "pop_lo": np.asarray(par.pop_lo),
           "pop_hi": np.asarray(par.pop_hi),
           "graph": np.asarray(GRAPH), "steps": np.int64(STEPS),
           "chunk": np.int64(CHUNK), "waits_total": res.waits_total}
    for prefix, state in (("init", st), ("state", res.state)):
        s = jax.tree.map(np.asarray, state)
        out.update({f"{prefix}_{f}": getattr(s, f)
                    for f in s.__dataclass_fields__
                    if getattr(s, f) is not None})
    out.update({f"hist_{k}": np.asarray(v) for k, v in res.history.items()})
    return out


def test_plain_dense_run_matches_jax_fixture():
    import torch

    import flipcomplexityempirical_tpu_torch as port
    from flipcomplexityempirical_tpu_torch import convert, sampling
    want = dict(np.load(FIXTURE))
    g = port.graphs.hex_lattice(*want["graph"])
    dg, state, params = general_fixture_inputs(port, convert, g, want,
                                               "cpu")
    torch.set_num_threads(1)
    res = sampling.run_chains(dg, port.Spec(), params, state,
                              n_steps=int(want["steps"]),
                              chunk=int(want["chunk"]),
                              kernel_path="general_dense")
    assert_chain_run_matches(
        convert.to_numpy(res.state), res.history, res.waits_total,
        {k[6:]: v for k, v in want.items() if k.startswith("state_")},
        {k[5:]: v for k, v in want.items() if k.startswith("hist_")},
        want["waits_total"])


@pytest.mark.slow
def test_fixture_is_current():
    want = dict(np.load(FIXTURE))
    got = make_fixture()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(FIXTURE.parents[3]))
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
