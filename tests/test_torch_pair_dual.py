"""The port's k-district pair walk against the JAX package's on a 6 x 6
synthetic precinct dual graph (populations that vary by node, the shared
boundary lengths as ``edge_len``), on the CPU: k = 3 and 4, with
``weighted_cut`` on and off, through the dense body (the plain version of
``csrc/general_pair_chunk.cu``), and one case of each k through the
legacy body. Tolerance (``_parity``): every field and history key equal,
waits equal except counted log ties; at k = 4 under the k-district walks'
``scaled`` wait rule.

At 36 nodes and k = 4 the wait's denominator n**k - 1 makes a wait
~1e4-1e5, where a one-ulp difference between torch's and XLA's f32 ``log``
moves floor(log u / log1p(-p)) across an integer more often than the
unscaled rule's share (1e-3) allows; the scaled rule still holds each
differing wait to exactly 1.0 off. At k = 3 the unscaled rule holds.
"""

import pytest
import torch
from _torch_pair_cases import dual_pair, run_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIDE = 6
CASES = [(3, False, "general_dense"), (3, True, "general_dense"),
         (4, False, "general_dense"), (4, True, "general_dense"),
         (3, True, "general"), (4, False, "general")]


@pytest.mark.parametrize("k,weighted,path", CASES)
def test_dual_pair_walk_matches_jax(k, weighted, path):
    run_both(*dual_pair(SIDE), k, weighted, path, steps=150,
             scaled=k >= 4)
