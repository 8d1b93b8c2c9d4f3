"""The valid-pair bookkeeping of ``csrc/general_pair_chunk.cu``, on the
CPU.

The kernel does not rebuild every node's valid (node, district) pairs at
each step. It keeps, per chain, a cell a node (its district A, its set of
neighbouring districts NB, its conn bit, kept only where the node has
another district among its neighbours and else marked stale until the
chunk's end) and the count of valid pairs of
each word of 32 nodes and of each group of 32 words, changes them at the
nodes an accepted move touches (v and its patch, or its neighbours
without contiguity), recounts every node only when a population gate
changes (a uniform population's district masks) or after every move (a
population that varies by node), and selects the m-th valid pair in
three warp rounds: the group, the word, the node, then the district.
``PairCounts`` below is a numpy model of exactly that arithmetic. The
test drives it along the accepted moves of the plain version
(``cuda_pair.general_pair_chunk_reference``) and holds it, at every step,
to a full recount of the plain version's valid plane
(``chain_state.pair_move_mask`` & the f32 gates & conn) and to
``kernel/dense.py::select_nth_set`` for every m < total. The kernel
itself is held to the plain version on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from flipcomplexityempirical_tpu_torch import Spec, graphs, sampling
from flipcomplexityempirical_tpu_torch.kernel import cuda_pair, dense
from flipcomplexityempirical_tpu_torch.state import chain_state

GROUP_SHIFT = 10          # the kernel's kGroupShift: 1024 nodes a group
F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


POPC8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def popc(x):
    """Set bits of each value below 256 (a valid or neighbour set)."""
    return POPC8[np.asarray(x, dtype=np.int64)]


def below(cnt):
    """The exclusive warp prefix of (..., 32) lanes' counts as the kernel
    takes it: one ballot a bit of the counts (8 bits), popc of the lanes
    below."""
    out = np.zeros_like(cnt)
    for b in range(8):
        ballot = (cnt >> b) & 1
        out += (np.cumsum(ballot, axis=-1) - ballot) << b
    return out


def nth_bit(x, r):
    """Position of the r-th set bit of x, elementwise (chain_common.cuh's
    halvings)."""
    x, r = x.copy(), r.copy()
    pos = np.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        low = popc(x & ((1 << s) - 1))
        up = r >= low
        r = np.where(up, r - low, r)
        x = np.where(up, x >> s, x)
        pos = np.where(up, pos + s, pos)
    return pos


class PairCounts:
    """One chain's cells, word and group counts and masks, as the kernel
    keeps them."""

    def __init__(self, dg, k: int, patch: bool, a, dp, params, c):
        self.nbr = dg.nbr.numpy()
        self.nbm = dg.nbr_mask.numpy()
        self.deg = dg.deg.numpy()
        self.pn = dg.patch_nodes.numpy()
        self.padj = dg.patch_adj.numpy() & 0xFFFFFFFF
        self.pop = dg.pop.numpy()
        self.n, self.d, self.p = dg.n_nodes, dg.max_deg, dg.max_patch
        self.k, self.patch = k, patch
        self.nw = (self.n + 31) // 32
        self.ng = (self.nw + 31) // 32
        pop = self.pop
        self.unit = int(pop[0]) if (pop == pop[0]).all() and pop[0] > 0 \
            else 0
        self.lo = F32(params.pop_lo[c])
        self.hi = F32(params.pop_hi[c])
        self.a = np.asarray(a, np.int64).copy()
        self.dp = np.zeros(8, dtype=np.int64)    # the 8 tallies a lane keeps
        self.dp[:k] = dp
        self.nb = np.bitwise_or.reduce(
            np.where(self.nbm, 1 << self.a[self.nbr], 0), axis=1)
        # a run's first chunk: the conn bits of the nodes on a boundary,
        # the others stale (every conn bit without contiguity)
        self.stale = patch & (self.row() == 0)
        self.conn = np.array([not patch or (not self.stale[i] and
                                            self.patch_connected(i, -1, 0))
                              for i in range(self.n)])
        self.fm, self.tm = self.masks()
        self.recounts = self.remasks = 0
        self.stale_seen = int(self.stale.sum())
        self.recount()

    def row(self):
        """Each node's other districts among its neighbours."""
        return self.nb & ~(1 << self.a)

    def refresh_stale(self):
        """The chunk's end: the stale nodes' conn bits checked."""
        for i in np.flatnonzero(self.stale):
            self.conn[i] = self.patch_connected(i, -1, 0)
        self.stale[:] = False

    def nbr_set(self, x: int, v: int, d_to: int) -> int:
        s = 0
        for r in range(self.deg[x]):
            y = self.nbr[x, r]
            s |= 1 << (d_to if y == v else int(self.a[y]))
        return s

    def masks(self):
        fm = tm = 0
        if self.unit:
            u = F32(self.unit)
            for d in range(self.k):
                pd = F32(self.dp[d])
                fm |= int(pd - u >= self.lo) << d
                tm |= int(pd + u <= self.hi) << d
        return fm, tm

    def vsets(self, a, nb, conn, nodes, fm, tm):
        """The valid districts of ``nodes`` with cells (a, nb, conn)."""
        cand = np.where(conn, nb & ~(1 << a), 0)
        if self.unit:
            return np.where((fm >> a) & 1, cand & tm, 0)
        pf = self.pop[nodes].astype(F32)
        dpf = self.dp.astype(F32)
        to = sum(((dpf[d] + pf) <= self.hi).astype(np.int64) << d
                 for d in range(8))
        return np.where(cand != 0,
                        np.where(dpf[a] - pf >= self.lo, cand & to, 0), 0)

    def node_vsets(self):
        return self.vsets(self.a, self.nb, self.conn, np.arange(self.n),
                          self.fm, self.tm)

    def recount(self):
        vs = np.zeros(32 * self.nw, dtype=np.int64)
        vs[:self.n] = self.node_vsets()
        self.wc = popc(vs).reshape(self.nw, 32).sum(axis=1)
        wc = np.zeros(32 * self.ng, dtype=np.int64)
        wc[:self.nw] = self.wc
        self.g = wc.reshape(self.ng, 32).sum(axis=1)

    def patch_connected(self, u: int, v: int, d_to: int) -> bool:
        au = d_to if u == v else int(self.a[u])
        member = 0
        for s in range(self.p):
            x = self.pn[u, s]
            ax = d_to if x == v else int(self.a[x])
            member |= int(ax == au and x != u) << s
        seeds = member & ((1 << int(self.deg[u])) - 1)
        if seeds & (seeds - 1) == 0:
            return True
        reach = seeds & -seeds
        frontier = reach
        while frontier:
            s = (frontier & -frontier).bit_length() - 1
            frontier &= frontier - 1
            nb = int(self.padj[u, s]) & member & ~reach
            reach |= nb
            frontier |= nb
            if seeds & ~reach == 0:
                return True
        return False

    def commit(self, v: int, d_to: int) -> int:
        """The accepted move of v to d_to; returns the change of the
        distinct-pair count."""
        kt = self.p if self.patch else self.d
        dv = self.deg[v]
        xs, new, stale = [], [], []   # the touched nodes, their new cells
        for i in range(kt + 1):
            x = v if i == 0 else int(self.pn[v, i - 1] if self.patch
                                     else self.nbr[v, i - 1])
            if i > 0 and x == v:
                continue
            nb = self.nbr_set(x, v, d_to) if 1 <= i <= dv else self.nb[x]
            ax = d_to if x == v else self.a[x]
            # the conn bit checked on a boundary, else left stale
            check = self.patch and (nb & ~(1 << ax)) != 0
            cx = self.patch_connected(x, v, d_to) if check else self.conn[x]
            xs.append(x)
            new.append((ax, nb, cx))
            stale.append(self.patch and not check)
        xs = np.array(xs)
        old = (self.a[xs], self.nb[xs], self.conn[xs])
        new = tuple(np.array(col) for col in zip(*new))
        # the rows of the (N, K) pair plane, before and after
        rows = int((popc(new[1] & ~(1 << new[0]))
                    - popc(old[1] & ~(1 << old[0]))).sum())
        popv = self.unit or int(self.pop[v])
        self.dp[self.a[v]] -= popv
        self.dp[d_to] += popv
        fm, tm = self.masks()
        remask = bool(self.unit) and (fm, tm) != (self.fm, self.tm)
        dc = None
        if self.unit and not remask:
            dc = (popc(self.vsets(*new, xs, fm, tm))
                  - popc(self.vsets(*old, xs, self.fm, self.tm)))
        self.fm, self.tm = fm, tm
        self.a[xs], self.nb[xs], self.conn[xs] = new
        self.stale[xs] = stale
        self.stale_seen = max(self.stale_seen, int(self.stale.sum()))
        if dc is not None:
            for x, d in zip(xs, dc):
                # the word counts are bytes added as 32-bit words
                q = 4 * ((x >> 5) >> 2)
                w4 = np.zeros(4, dtype=np.int64)
                w4[:len(self.wc[q:q + 4])] = self.wc[q:q + 4]
                packed = int((w4 << (8 * np.arange(4))).sum())
                packed += (int(d) & 0xFFFFFFFF) << (8 * ((x >> 5) & 3))
                packed &= 0xFFFFFFFF
                w4 = (packed >> (8 * np.arange(4))) & 0xFF
                self.wc[q:q + 4] = w4[:len(self.wc[q:q + 4])]
                self.g[x >> GROUP_SHIFT] += d
        else:
            self.recount()
            self.recounts += 1
            self.remasks += remask
        return rows

    def select(self, m):
        """The m-th valid pairs (m an array) in three warp rounds: (v,
        d_to) arrays."""
        g = np.zeros_like(m)
        r = m.copy()
        if self.ng > 1:  # lane j holds groups j and 32 + j
            gl = np.zeros(64, dtype=np.int64)
            gl[:self.ng] = self.g
            incl = np.concatenate([np.cumsum(gl[:32]),
                                   np.cumsum(gl[32:]) + gl[:32].sum()])
            g = np.argmax(incl[None, :] > m[:, None], axis=1)
            r = m - (incl[g] - gl[g])
        wcnt = np.zeros(32 * self.ng, dtype=np.int64)
        wcnt[:self.nw] = self.wc
        wcnt = wcnt.reshape(self.ng, 32)[g]          # the group's words
        wbelow = below(wcnt)
        ws = np.argmax(wbelow + wcnt > r[:, None], axis=1)
        r = r - wbelow[np.arange(len(m)), ws]
        w = (g << 5) + ws
        vs = np.zeros(32 * self.nw, dtype=np.int64)
        vs[:self.n] = self.node_vsets()
        vs = vs.reshape(self.nw, 32)[w]               # the word's nodes
        vcnt = popc(vs)
        vbelow = below(vcnt)
        src = np.argmax(vbelow + vcnt > r[:, None], axis=1)
        at = np.arange(len(m))
        return ((w << 5) + src,
                nth_bit(vs[at, src], r - vbelow[at, src]))


def plain_plane(dg, params, state, k):
    """bool (C, N, K): the plain version's valid pairs."""
    a = state.assignment.to(torch.int64)
    from_ok, to_ok = dense._pop_planes(dg, params, a,
                                       state.dist_pop.to(torch.float32))
    pm = chain_state.pair_move_mask(dg, a, k)
    conn = dense.unpack_mask(state.conn_bits, dg.n_nodes)
    return pm & from_ok[..., None] & to_ok & conn[..., None]


def drive(graph, plan, k, spec, base, pop_tol, chains, steps, seed):
    dg, st, params = sampling.init_batch(graph, plan, n_chains=chains,
                                         seed=seed, spec=spec, base=base,
                                         pop_tol=pop_tol, device="cpu")
    st = dense.ensure_conn_bits(dg, spec, st)
    n = dg.n_nodes
    models = [PairCounts(dg, k, spec.contiguity == "patch",
                         st.assignment[c].numpy(), st.dist_pop[c].numpy(),
                         params, c)
              for c in range(chains)]
    moves = 0
    for _ in range(steps):
        new, _ = cuda_pair.general_pair_chunk_reference(dg, spec, params, st,
                                                        1)
        for c, mdl in enumerate(models):
            changed = np.flatnonzero(
                (new.assignment[c] != st.assignment[c]).numpy())
            if changed.size:
                v = int(changed[0])
                db = mdl.commit(v, int(new.assignment[c, v]))
                assert db == int(new.b_count[c] - st.b_count[c])
                moves += 1
        st = new
        plane = plain_plane(dg, params, st, k)
        conn = dense.unpack_mask(st.conn_bits, n).numpy()
        words = dense.pack_mask(plane.reshape(chains, n * k))
        for c, mdl in enumerate(models):
            np.testing.assert_array_equal(mdl.a, st.assignment[c].numpy())
            # conn kept off the stale nodes, which have no other district
            np.testing.assert_array_equal(mdl.conn[~mdl.stale],
                                          conn[c][~mdl.stale])
            assert (mdl.row()[mdl.stale] == 0).all()
            np.testing.assert_array_equal(mdl.dp[:k], st.dist_pop[c].numpy())
            # the counts against a full recount of the plain plane
            per_node = np.zeros(32 * mdl.nw, dtype=np.int64)
            per_node[:n] = plane[c].sum(dim=1).numpy()
            wc = per_node.reshape(mdl.nw, 32).sum(axis=1)
            np.testing.assert_array_equal(mdl.wc, wc)
            gc = np.zeros(32 * mdl.ng, dtype=np.int64)
            gc[:mdl.nw] = wc
            np.testing.assert_array_equal(mdl.g,
                                          gc.reshape(mdl.ng, 32).sum(axis=1))
            total = int(mdl.g.sum())
            if total == 0:
                continue
            ms = torch.arange(total)
            idx = dense.select_nth_set(words[c].expand(total, -1), ms)
            v, d_to = mdl.select(ms.numpy())
            np.testing.assert_array_equal(v, (idx // k).numpy())
            np.testing.assert_array_equal(d_to, (idx % k).numpy())
    assert int(st.b_count.sum()) == int(chain_state.b_nodes_count(
        dg, st.assignment, st.cut_deg, k, "pair").sum())
    conn = dense.unpack_mask(st.conn_bits, n).numpy()
    for c, mdl in enumerate(models):
        mdl.refresh_stale()
        np.testing.assert_array_equal(mdl.conn, conn[c])
    return models, moves


def test_pair_counts_uniform_population_masks_change():
    """A 33 x 33 rook grid (1089 nodes, two count groups), one population
    per node, k = 4, a tolerance tight enough that the district masks
    change, every move accepted (base 1)."""
    g = graphs.square_grid(33, 33)
    spec = Spec(n_districts=4, proposal="pair")
    models, moves = drive(g, graphs.stripes_plan(g, 4), 4, spec, base=1.0,
                          pop_tol=0.03, chains=2, steps=60, seed=5)
    assert moves > 0
    assert models[0].ng == 2
    assert sum(m.remasks for m in models) > 0
    assert min(m.stale_seen for m in models) > 0
    # a move that changes no mask updates the counts in place
    assert sum(m.recounts for m in models) < moves


@pytest.mark.parametrize("k", [4, 8])
def test_pair_counts_varying_population(k):
    """A synthetic 10 x 10 precinct map (populations that vary by node,
    boundary lengths) under weighted_cut: every accepted move recounts."""
    g, _ = graphs.from_geojson(graphs.synthetic_precincts(10, 10, seed=1),
                               pop_property="POP")
    spec = Spec(n_districts=k, proposal="pair", weighted_cut=True)
    models, moves = drive(g, graphs.stripes_plan(g, k), k, spec, base=2.0,
                          pop_tol=0.3, chains=3, steps=60, seed=7)
    assert moves > 0
    assert sum(m.recounts for m in models) == moves


def test_recounts_are_the_kernels_alone():
    """The wrapper's ``recounts=`` counts the kernel's own recounts: the
    plain version, which keeps none, refuses it."""
    g = graphs.square_grid(4, 4)
    spec = Spec(n_districts=3, proposal="pair")
    dg, st, params = sampling.init_batch(g, graphs.stripes_plan(g, 3),
                                         n_chains=2, seed=1, spec=spec,
                                         base=1.0, pop_tol=0.5, device="cpu")
    static = cuda_pair.make_static_inputs(dg)
    with pytest.raises(ValueError, match="plain version keeps none"):
        cuda_pair.run_general_pair_chunk_cuda(
            dg, static, spec, params, st, 4,
            recounts=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous int32"):
        cuda_pair.run_general_pair_chunk_cuda(
            dg, static, spec, params, st, 4,
            recounts=torch.zeros(3, dtype=torch.int32))
