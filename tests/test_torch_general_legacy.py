"""The port's legacy re-propose body (``kernel/step.py::transition``, torch
ops) against the JAX package's ``run_chains(kernel_path='general')``, on
the CPU: the re-propose loop with one and with ``propose_parallel``
candidates a round, the patch and the exact contiguity checks, the
self-loop policy and the corrected accept.

Tolerance (``_parity.assert_chain_run_matches``): every state field and
history key equal; waits equal except counted log ties.
"""

import jax
import numpy as np
import pytest
import torch
from _parity import assert_chain_run_matches

import flipcomplexityempirical_tpu as fce

import flipcomplexityempirical_tpu_torch as port
from flipcomplexityempirical_tpu_torch import convert, sampling

C = 5
CASES = {
    "patch": ("hex_lattice", 3, 4, {}),
    "exact-parallel4": ("hex_lattice", 3, 4,
                        dict(contiguity="exact", propose_parallel=4)),
    "tri-selfloop-corrected": ("triangular_lattice", 4, 6,
                               dict(invalid="selfloop", accept="corrected")),
    "square-frame-anneal": ("square_grid", 5, 6,
                            dict(frame_interface=True, anneal="linear")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_run_matches_jax(case):
    name, m, n, spec_kw = CASES[case]
    jg = getattr(fce.graphs, name)(m, n)
    pg = getattr(port.graphs, name)(m, n)
    plan = fce.graphs.stripes_plan(jg, 2)
    jspec, pspec = fce.Spec(**spec_kw), port.Spec(**spec_kw)
    jdg, jst, jpar = fce.init_batch(jg, plan, n_chains=C, seed=2,
                                    spec=jspec, base=1.2, pop_tol=0.15)
    pdg, pst, ppar = sampling.init_batch(pg, plan, n_chains=C, seed=2,
                                         spec=pspec, base=1.2, pop_tol=0.15,
                                         device="cpu")
    jr = fce.run_chains(jdg, jspec, jpar, jst, n_steps=70, chunk=30,
                        kernel_path="general")
    pr = sampling.run_chains(pdg, pspec, ppar, pst, n_steps=70, chunk=30,
                             kernel_path="general")
    assert_chain_run_matches(
        convert.to_numpy(pr.state), pr.history, pr.waits_total,
        jax.tree.map(np.asarray, jr.state),
        {k: np.asarray(v) for k, v in jr.history.items()}, jr.waits_total)
    s = convert.to_numpy(pr.state)
    assert s["accept_count"].sum() > 0
    if spec_kw.get("invalid") == "selfloop":
        assert (s["tries_sum"] == 69).all()
    else:
        assert s["tries_sum"].sum() > s["accept_count"].sum()
