"""The port's k-district pair walk against the JAX package's on a small
rook grid with random populations and boundary lengths, on the CPU.

The pair plane (``state.chain_state.pair_move_mask``, the distinct-pair
``b_nodes_count``) on random plans, and the general runner's pair walk
at k = 3 and 4 with ``weighted_cut`` on and off, through the dense body
(``kernel_path='general_dense'``: the plain version of
``csrc/general_pair_chunk.cu``) and the legacy body ('general'), against
``run_chains`` from the same seed. Tolerance (``_parity``): every field
and history key equal, waits equal except counted log ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pair_cases import grid_pair, run_both

from flipcomplexityempirical_tpu.state import chain_state as jcs

from flipcomplexityempirical_tpu_torch.state import chain_state as pcs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k", [2, 3, 5, 8])
def test_pair_plane_matches_jax(k):
    jg, pg = grid_pair()
    jdg, pdg = jg.device(), pg.device("cpu")
    a = np.random.default_rng(k).integers(0, k, (6, jg.n_nodes))
    got = pcs.pair_move_mask(pdg, torch.as_tensor(a), k).numpy()
    want = np.stack([np.asarray(jcs.pair_move_mask(jdg, jnp.asarray(r), k))
                     for r in a])
    np.testing.assert_array_equal(got, want)
    cut, cut_deg, _, _, b = pcs.derive(pdg, torch.as_tensor(a), k, "pair")
    for i, r in enumerate(a):
        _, jcd, _, _, jb = jcs.derive(jdg, jnp.asarray(r, jnp.int8), k,
                                      "pair")
        assert int(b[i]) == int(jb)
        np.testing.assert_array_equal(cut_deg[i].numpy(), np.asarray(jcd))


CASES = [(3, False, "general_dense"), (3, True, "general_dense"),
         (4, False, "general_dense"), (4, True, "general_dense"),
         (3, True, "general"), (4, False, "general")]


@pytest.mark.parametrize("k,weighted,path", CASES)
def test_pair_walk_matches_jax(k, weighted, path):
    run_both(*grid_pair(), k, weighted, path)
