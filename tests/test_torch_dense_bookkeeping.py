"""The deferred records of ``csrc/general_dense_chunk.cu``, on the CPU.

The kernel does not replay ``kernel/step.py::record`` yield by yield. It
keeps cut_times and the parity fields (part_sum, last_flipped, num_flips
of cur_flip_node, ``step.py:538-551``) with closed forms that touch memory
only at accepted moves and at the chunk's end, and it writes cut and
cut_deg from the assignment at the end. ``deferred_records`` below is a
numpy model of exactly that arithmetic, from a chunk's input state and the
accepted (node, step) moves of the plain version
(``cuda_dense.general_dense_chunk_reference``); the test holds it to the
plain version's outputs with exact equality. The kernel itself is held to
the plain version on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import flipcomplexityempirical_tpu_torch as port
from flipcomplexityempirical_tpu_torch import convert, sampling
from flipcomplexityempirical_tpu_torch.kernel import cuda_dense, dense
from flipcomplexityempirical_tpu_torch.kernel import step as kstep

C = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def deferred_records(graph, state: dict, moves, t_len: int, labels,
                     parity: bool) -> dict:
    """The kernel's arithmetic for one chain and one chunk: ``state`` the
    chunk's input fields (numpy, one chain), ``moves`` the accepted
    (node, step) pairs in step order. Returns the fields it writes."""
    a = state["assignment"].astype(np.int64).copy()
    a_in = a.copy()
    nbr, deg, nbr_edge = graph.nbr, graph.deg, graph.nbr_edge
    # cut_times: the chunk starts from cut * T; a flip at step t changes
    # each of v's edges by +-1, seen by the T - t yields t..T-1
    cut_times = (state["cut_times"].astype(np.int64)
                 + state["cut"].astype(np.int64) * t_len)
    part_sum = state["part_sum"].astype(np.int64).copy()
    last_flipped = state["last_flipped"].astype(np.int64).copy()
    num_flips = state["num_flips"].astype(np.int64).copy()
    t_yield, flip_in = int(state["t_yield"]), int(state["cur_flip_node"])
    cur_flip, run_start, first_accept = flip_in, 0, t_len
    closed = set()

    def close_run(x, b, t_end):
        # a run at x in district b over yields ..e: (label[1-b] - s) * e
        e = t_yield + t_end - 1
        part_sum[x] += (labels[1 - b] - labels[b]) * e
        num_flips[x] += t_end - run_start
        last_flipped[x] = e
        closed.add(x)

    for v, t in moves:
        for s in range(deg[v]):
            delta = 1 if a[nbr[v, s]] == a[v] else -1
            cut_times[nbr_edge[v, s]] += delta * (t_len - t)
        if parity and cur_flip >= 0 and t > run_start:
            close_run(cur_flip, a[cur_flip], t)
        a[v] ^= 1
        cur_flip, run_start = v, t
        first_accept = min(first_accept, t)
    if parity:
        if cur_flip >= 0:
            close_run(cur_flip, a[cur_flip], t_len)
        for x in closed:
            b1 = (a_in[x] if x == flip_in and first_accept > 0
                  else 1 - a_in[x])
            part_sum[x] += (labels[b1] * state["last_flipped"][x]
                            - labels[1 - a[x]] * last_flipped[x])
    ends = graph.edges
    cut = (a[ends[:, 0]] != a[ends[:, 1]]).astype(np.int64)
    cut_deg = np.array([(a[nbr[i, :deg[i]]] != a[i]).sum()
                        for i in range(a.shape[0])])
    return dict(assignment=a, cut=cut, cut_deg=cut_deg, cut_times=cut_times,
                part_sum=part_sum, last_flipped=last_flipped,
                num_flips=num_flips)


def _plain_chunk(dg, spec, params, st, t_len):
    """The plain version's chunk, and each chain's accepted (node, step)
    moves, read off its steps one at a time."""
    want, _ = cuda_dense.general_dense_chunk_reference(dg, spec, params, st,
                                                       t_len)
    cur = dense.ensure_conn_bits(dg, spec, st)
    moves = [[] for _ in range(st.assignment.shape[0])]
    for t in range(t_len):
        before = cur.accept_count.clone()
        cur, _ = kstep.run_steps(dense.transition, dg, spec, params, cur, 1)
        for c in torch.nonzero(cur.accept_count != before)[:, 0].tolist():
            moves[c].append((int(cur.cur_flip_node[c]), t))
    for k in ("part_sum", "last_flipped", "num_flips", "cut_times"):
        assert torch.equal(getattr(cur, k), getattr(want, k))
    return want, moves


def _model_chunk(graph, st_np, moves, t_len, labels, parity):
    out = {}
    for c in range(len(moves)):
        one = {k: (v[c] if np.ndim(v) else v) for k, v in st_np.items()}
        for k, v in deferred_records(graph, one, moves[c], t_len, labels,
                                     parity).items():
            out.setdefault(k, []).append(v)
    return {k: np.stack(v) for k, v in out.items()}


def _assert_fields(model, want_np, label):
    for k, v in model.items():
        np.testing.assert_array_equal(
            v, want_np[k].astype(np.int64), err_msg=f"{label}: {k}")


def _setup(builder, spec_kw, tol, labels=None, seed=2):
    g = getattr(port.graphs, builder)(3, 4)
    spec = port.Spec(**spec_kw)
    dg, st, params = sampling.init_batch(
        g, port.graphs.stripes_plan(g, 2), n_chains=C, seed=seed, spec=spec,
        base=0.8, pop_tol=tol, label_values=labels, device="cpu")
    return g, spec, dg, st, params


CASES = {
    "hex": ("hex_lattice", {}, 0.3, None),
    "tri": ("triangular_lattice", {}, 0.3, None),
    "hex-labels-3-7": ("hex_lattice", {}, 0.3, (3, 7)),
    "tri-nobacktrack": ("triangular_lattice", {"nobacktrack": True}, 0.3,
                        None),
    "hex-lazy-uniform": ("hex_lattice", {"lazy_uniform": True}, 0.3, None),
    "tri-parity-off": ("triangular_lattice", {"parity_metrics": False}, 0.3,
                       None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deferred_records_match_the_plain_version(case):
    """From a fresh state (cur_flip_node -1 on entry), then from that
    chunk's end (a run already open at cur_flip_node); one chunk of T
    equals two of T / 2, the second starting mid-run with t_yield
    offset."""
    builder, spec_kw, tol, labels = CASES[case]
    g, spec, dg, st, params = _setup(builder, spec_kw, tol, labels)
    lab = [int(x) for x in params.label_values]
    parity = spec.parity_metrics
    assert bool((st.cur_flip_node == -1).all())
    t_len = 24
    for _ in range(2):
        want, moves = _plain_chunk(dg, spec, params, st, t_len)
        assert sum(map(len, moves)) > 0
        model = _model_chunk(g, convert.to_numpy(st), moves, t_len, lab,
                             parity)
        _assert_fields(model, convert.to_numpy(want), case)
        # the same chunk as two halves
        half, half_moves = _plain_chunk(dg, spec, params, st, t_len // 2)
        first = _model_chunk(g, convert.to_numpy(st), half_moves,
                             t_len // 2, lab, parity)
        _assert_fields(first, convert.to_numpy(half), f"{case} first half")
        mid = convert.to_numpy(half)
        rest = [[(v, t - t_len // 2) for v, t in ms if t >= t_len // 2]
                for ms in moves]
        second = _model_chunk(g, mid, rest, t_len - t_len // 2, lab, parity)
        _assert_fields(second, convert.to_numpy(want), f"{case} two halves")
        st = want
    if not parity:
        assert int(st.num_flips.sum()) == 0


def test_no_accepted_move_keeps_the_open_run():
    """After moves, a lower population bound above the whole graph's: no
    move is valid, every step self-loops, and the run open at
    cur_flip_node on entry spans the whole chunk."""
    g, spec, dg, st, params = _setup("hex_lattice", {}, 0.3)
    st, _ = cuda_dense.general_dense_chunk_reference(dg, spec, params, st, 15)
    assert bool((st.cur_flip_node >= 0).all())
    params.pop_lo = torch.full((C,), float(g.pop.sum()) + 1)
    want, moves = _plain_chunk(dg, spec, params, st, 10)
    assert not any(moves)
    assert bool((want.exhausted_count == st.exhausted_count + 10).all())
    model = _model_chunk(g, convert.to_numpy(st), moves, 10,
                         [int(x) for x in params.label_values], True)
    _assert_fields(model, convert.to_numpy(want), "no accepted move")


@pytest.mark.parametrize("builder", ["hex_lattice", "triangular_lattice"])
def test_packed_tables_hold_the_graph(builder):
    """``pack_tables``' bytes decode, at ``table_layout``'s offsets, to the
    graph's neighbour, edge, degree and patch tables, patch rows padded to
    a multiple of 8 slots with the node itself and no adjacency, and to
    the real-slot masks and reverse slots the kernel's member masks use."""
    g = getattr(port.graphs, builder)(3, 4)
    dg = g.device("cpu")
    n, d, p = dg.n_nodes, dg.max_deg, dg.max_patch
    lay = cuda_dense.table_layout(n, d, p)
    pp = lay["pp"]
    buf = cuda_dense.pack_tables(dg).numpy()
    assert buf.size == lay["bytes"] and buf.size % 16 == 0
    assert pp % 8 == 0 and p <= pp < p + 8
    assert lay["padj"] % 16 == 0 and lay["pn"] % 16 == 0

    def at(key, dtype, shape):
        size = int(np.prod(shape)) * np.dtype(dtype).itemsize
        return buf[lay[key]:lay[key] + size].view(dtype).reshape(shape)

    padj, pn = at("padj", np.uint32, (n, pp)), at("pn", np.uint16, (n, pp))
    np.testing.assert_array_equal(padj[:, :p], g.patch_adj)
    np.testing.assert_array_equal(pn[:, :p], g.patch_nodes)
    assert not padj[:, p:].any()
    np.testing.assert_array_equal(pn[:, p:], np.arange(n)[:, None]
                                  + np.zeros((1, pp - p), np.int64))
    np.testing.assert_array_equal(at("nedge", np.uint32, (n, d)),
                                  g.nbr_edge)
    np.testing.assert_array_equal(at("nbr", np.uint16, (n, d)), g.nbr)
    np.testing.assert_array_equal(at("deg", np.uint8, (n,)), g.deg)
    # each node's real slots, and the slot of u in the patch of its slot s
    slots, rev = at("slots", np.uint32, (n,)), at("rev", np.uint8, (n, pp))
    for u in range(n):
        real = [s for s in range(pp) if pn[u, s] != u]
        assert int(slots[u]) == sum(1 << s for s in real)
        for s in real:
            assert pn[pn[u, s], rev[u, s]] == u
