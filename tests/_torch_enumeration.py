"""The exact stationary distribution of the 2-district flip chain on a
small rook grid, in numpy alone, for the checks that hold the port's
chains to it: ``chip_smoke.py`` (on a machine without JAX) and the CPU
tests.

A copy of ``tests/test_enumeration.py``'s enumeration (whose module
imports the JAX package): every 2-labelling of the 3 x 4 grid with both
districts connected and populations within the bounds, the exact
transition matrix of the re-propose chain with the literal
``base**(-dcut)`` accept, its stationary distribution by power
iteration (``stationary``, as there, and ``stationary_lazy``, which also
converges where the chain is periodic), and the bar an empirical
occupancy must clear (total variation below 0.06, E|cut| within 2 %).
A state is the bitmask of the district-1 nodes, node i at bit i. The
grid comes from the port's ``graphs.square_grid``.

That bar is ``test_enumeration.py``'s, for one run of a few chains; it
passes a sampler whose base is off by 10 %. Pooled over many independent
chains, ``group_t`` holds E|cut| and every node's district-1 share to
the sampling noise measured across groups of chains, and ``simulate``
draws the exact chain itself, so that the CPU tests and
``python tests/_torch_enumeration.py`` show what that check passes and
what it catches. ``build_pair_transition`` and ``pair_pool_check`` do the
same for the k-district pair walk (states as tuples of districts), with
or without the boundary-length score; ``joint_tempered_stationary`` and
``cut_law_check`` for the rungs of a 2-rung tempered ladder.
"""

import numpy as np

from flipcomplexityempirical_tpu_torch import graphs

NX, NY = 3, 4          # 12 nodes -> 4096 assignments, exhaustive
EPS = 0.5              # pops within [3, 9]
N = NX * NY
TV_TOL, CUT_TOL = 0.06, 0.02
# chip_smoke.py's pooled sample: chains, steps read after the burn-in, and
# the independent groups of chains that group_t compares
CHAINS, SAMPLES, GROUPS = 4096, 200, 32
T_TOL = 6.0            # |t| bar of group_t (Student t, GROUPS - 1 dof)
TV_POOL_TOL = 0.03     # TV bar of such a pool (the exact chain's: 0.009-0.015)


def build_masks(nx=NX, ny=NY):
    """(graph, per-node neighbour bitmasks) of the nx x ny rook grid."""
    g = graphs.square_grid(nx, ny)
    n = nx * ny
    nbrmask = [0] * n  # python ints: arbitrary-precision bit ops
    for a, b in g.edges.tolist():
        nbrmask[a] |= 1 << b
        nbrmask[b] |= 1 << a
    return g, nbrmask


def connected_bitmask(mask, nbrmask):
    if mask == 0:
        return False
    start = mask & (-mask)
    reach = start
    while True:
        grow = reach
        m = reach
        while m:
            b = m & (-m)
            grow |= nbrmask[b.bit_length() - 1]
            m ^= b
        grow &= mask
        if grow == reach:
            return reach == mask
        reach = grow


def enumerate_states(nbrmask):
    """All 2-labelings (district-1 bitmask) with both districts connected
    and pops within bounds."""
    full = (1 << N) - 1
    ideal = N / 2
    lo, hi = (1 - EPS) * ideal, (1 + EPS) * ideal
    states = []
    for m in range(1, full):
        p1 = bin(m).count("1")
        if not (lo <= p1 <= hi and lo <= N - p1 <= hi):
            continue
        if connected_bitmask(m, nbrmask) and \
                connected_bitmask(full ^ m, nbrmask):
            states.append(m)
    return states


def cut_count_of(m, edges):
    a = np.array([(m >> i) & 1 for i in range(N)])
    return int((a[edges[:, 0]] != a[edges[:, 1]]).sum())


def build_transition(states, g, base):
    """Row-stochastic matrix of the re-propose chain with literal accept."""
    index = {m: i for i, m in enumerate(states)}
    edges = g.edges
    cuts = np.array([cut_count_of(m, edges) for m in states])
    n = len(states)
    P = np.zeros((n, n))
    for i, m in enumerate(states):
        a = np.array([(m >> v) & 1 for v in range(N)])
        cut = a[edges[:, 0]] != a[edges[:, 1]]
        bnodes = np.unique(edges[cut].ravel())
        # valid moves: flips landing in the enumerated state set
        moves = []
        for v in bnodes:
            m2 = m ^ (1 << int(v))
            j = index.get(m2)
            if j is not None:
                moves.append(j)
        V = len(moves)
        if V == 0:
            raise ValueError(f"state {m:#x} has no valid move")
        stay = 0.0
        for j in moves:
            acc = min(1.0, base ** (cuts[i] - cuts[j]))
            P[i, j] += acc / V
            stay += (1 - acc) / V
        P[i, i] += stay
    if not np.allclose(P.sum(axis=1), 1.0):
        raise ValueError("transition rows do not sum to 1")
    return P, cuts


def stationary(P):
    pi = np.full(P.shape[0], 1.0 / P.shape[0])
    for _ in range(20000):
        nxt = pi @ P
        if np.abs(nxt - pi).max() < 1e-13:
            break
        pi = nxt
    return pi / pi.sum()


def stationary_lazy(P):
    """The stationary distribution of ``P`` by power iteration of its lazy
    chain ``(I + P) / 2``, which has the same stationary distribution and
    is aperiodic. ``stationary``'s iteration of ``P`` itself does not
    converge where ``P`` is periodic: at base 1.0 on this grid every valid
    move is accepted and changes the parity of the district-1 count, so
    ``P`` has no self-loop and eigenvalue -1, and the vector it returns
    after its 20000 steps is off the stationary distribution by a total
    variation of 0.047 (11/234)."""
    return stationary(0.5 * (np.eye(P.shape[0]) + P))


def board_bits(boards) -> np.ndarray:
    """(S, N) district boards (0/1, node order) -> (S,) state bitmasks."""
    b = np.asarray(boards).astype(np.int64)
    return (b << np.arange(b.shape[1], dtype=np.int64)).sum(axis=1)


def occupancy_error(abits, states, pi, cuts):
    """(TV distance, relative E|cut| error) of the empirical occupancy of
    the state bitmasks ``abits`` against the exact ``pi``. A bitmask
    outside the state set raises KeyError (the chain visited an invalid
    state)."""
    index = {m: i for i, m in enumerate(states)}
    idx = np.array([index[int(m)] for m in abits])
    emp = np.bincount(idx, minlength=len(states)).astype(float)
    emp /= emp.sum()
    tv = 0.5 * np.abs(emp - pi).sum()
    e_cut_exact = float((pi * cuts).sum())
    e_cut_emp = float((emp * cuts).sum())
    return tv, abs(e_cut_emp - e_cut_exact) / e_cut_exact


def assert_matches_stationary(abits, states, pi, cuts, tv_tol=TV_TOL,
                              cut_tol=CUT_TOL):
    """``test_enumeration.py``'s bar: TV below ``tv_tol`` and the E|cut|
    error below ``cut_tol``."""
    tv, cut_err = occupancy_error(abits, states, pi, cuts)
    assert tv < tv_tol, f"TV distance {tv:.4f} (|S|={len(states)})"
    assert cut_err < cut_tol, f"E|cut| relative error {cut_err:.4f}"


def node_bits(states, n=N) -> np.ndarray:
    """(K, n) float: node i's district (0/1) in each state."""
    m = np.asarray(states, np.int64)[:, None]
    return ((m >> np.arange(n)) & 1).astype(float)


def group_t(abits, chain, states, pi, cuts, groups=GROUPS,
            n=N) -> np.ndarray:
    """Student t statistics of the pooled occupancy's E|cut| (entry 0)
    and of each node's district-1 share (entries 1..n) against their
    exact values under ``pi``. ``chain`` holds each board's chain (each
    chain contributes as many boards). The chains are independent, so the
    occupancies of ``groups`` disjoint sets of chains are independent
    draws, whatever the correlation along a chain: each t is the mean of
    the groups' means less the exact value, over their standard error,
    and on the exact chain it follows Student's t with ``groups - 1``
    degrees of freedom. A bitmask outside the state set raises
    KeyError."""
    index = {m: i for i, m in enumerate(states)}
    idx = np.array([index[int(m)] for m in abits])
    chain = np.asarray(chain)
    grp = chain * groups // (int(chain.max()) + 1)
    counts = np.zeros((groups, len(states)))
    np.add.at(counts, (grp, idx), 1.0)
    emp = counts / counts.sum(axis=1, keepdims=True)
    obs = np.concatenate([np.asarray(cuts, float)[:, None],
                          node_bits(states, n)], axis=1)
    means = emp @ obs
    se = means.std(axis=0, ddof=1) / np.sqrt(groups)
    return (means.mean(axis=0) - pi @ obs) / se


def patch_ok(graph, a, u) -> bool:
    """The radius-r patch check of flipping node u of plan ``a`` (numpy,
    from the graph's patch tables): u's same-district neighbours stay
    connected inside u's patch without u."""
    pn = graph.patch_nodes[u][:graph.patch_size[u]]
    member = {s for s, x in enumerate(pn) if a[x] == a[u]}
    seeds = [s for s in member if s < graph.deg[u]]
    if len(seeds) <= 1:
        return True
    reach, todo = {seeds[0]}, [seeds[0]]
    while todo:
        s = todo.pop()
        for t in member:
            if (int(graph.patch_adj[u][s]) >> t) & 1 and t not in reach:
                reach.add(t)
                todo.append(t)
    return all(s in reach for s in seeds)


def build_dense_transition(graph, a0, base, pop_lo, pop_hi):
    """The states reachable from plan ``a0`` and the exact transition
    matrix of the rejection-free dense chain on ``graph`` (uniform over
    the valid moves: boundary nodes whose flip keeps both population
    bounds and passes the patch check; then the literal ``base**(-dcut)``
    accept), as ``tests/test_dense.py``'s enumeration builds it. Returns
    (states as bitmasks of the district-1 nodes, P, cut counts)."""
    n = graph.n_nodes
    edges = np.asarray(graph.edges)
    pop = np.asarray(graph.pop, np.float64)

    def arr(m):
        return np.array([(m >> v) & 1 for v in range(n)], np.int64)

    def valid(a):
        dp = np.array([pop[a == 0].sum(), pop[a == 1].sum()])
        out = []
        for v in range(n):
            nb = graph.nbr[v][graph.nbr_mask[v]]
            if not (a[nb] != a[v]).any():
                continue
            if dp[a[v]] - pop[v] < pop_lo or dp[1 - a[v]] + pop[v] > pop_hi:
                continue
            if patch_ok(graph, a, v):
                out.append(v)
        return out

    m0 = int((np.asarray(a0, np.int64) << np.arange(n)).sum())
    index, order, moves, todo = {m0: 0}, [m0], {}, [m0]
    while todo:
        m = todo.pop()
        moves[m] = valid(arr(m))
        for v in moves[m]:
            m2 = m ^ (1 << v)
            if m2 not in index:
                index[m2] = len(order)
                order.append(m2)
                todo.append(m2)
    cuts = np.array([int((arr(m)[edges[:, 0]] != arr(m)[edges[:, 1]]).sum())
                     for m in order])
    P = np.zeros((len(order), len(order)))
    for i, m in enumerate(order):
        vs = moves[m]
        if not vs:
            raise ValueError("an absorbing state in the closure")
        for v in vs:
            j = index[m ^ (1 << v)]
            acc = min(1.0, base ** float(cuts[i] - cuts[j]))
            P[i, j] += acc / len(vs)
            P[i, i] += (1.0 - acc) / len(vs)
    if not np.allclose(P.sum(axis=1), 1.0):
        raise ValueError("transition rows do not sum to 1")
    return order, P, cuts


def build_pair_transition(graph, a0, k, base, pop_lo, pop_hi,
                          weighted=False):
    """The states reachable from plan ``a0`` and the exact transition
    matrix of the rejection-free k-district pair chain on ``graph``
    (``kernel/dense.py``'s pair branch: uniform over the valid (node,
    district) pairs, a district among the node's neighbours' and not its
    own, both population bounds kept and the node's patch check passed;
    then the literal accept ``base**(-score)``, the score the cut change
    or, with ``weighted``, the change of the cut edges' ``edge_len``
    sum). Returns (states as tuples of districts, P, cut counts)."""
    n = graph.n_nodes
    edges = np.asarray(graph.edges)
    pop = np.asarray(graph.pop, np.float64)
    elen = np.asarray(graph.edge_len, np.float64)

    def score(a):
        cut = a[edges[:, 0]] != a[edges[:, 1]]
        return float(elen[cut].sum()) if weighted else float(cut.sum())

    def valid(a):
        dp = np.bincount(a, weights=pop, minlength=k)
        out = []
        for v in range(n):
            nb = graph.nbr[v][graph.nbr_mask[v]]
            if dp[a[v]] - pop[v] < pop_lo or not patch_ok(graph, a, v):
                continue
            for d in sorted(set(a[nb].tolist()) - {int(a[v])}):
                if dp[d] + pop[v] <= pop_hi:
                    out.append((v, d))
        return out

    s0 = tuple(int(x) for x in a0)
    index, order, moves, todo = {s0: 0}, [s0], {}, [s0]
    while todo:
        m = todo.pop()
        moves[m] = valid(np.array(m))
        for v, d in moves[m]:
            m2 = m[:v] + (d,) + m[v + 1:]
            if m2 not in index:
                index[m2] = len(order)
                order.append(m2)
                todo.append(m2)
    arrs = [np.array(m) for m in order]
    scores = np.array([score(a) for a in arrs])
    cuts = np.array([int((a[edges[:, 0]] != a[edges[:, 1]]).sum())
                     for a in arrs])
    P = np.zeros((len(order), len(order)))
    for i, m in enumerate(order):
        mv = moves[m]
        if not mv:
            raise ValueError("an absorbing state in the closure")
        for v, d in mv:
            j = index[m[:v] + (d,) + m[v + 1:]]
            acc = min(1.0, base ** float(scores[i] - scores[j]))
            P[i, j] += acc / len(mv)
            P[i, i] += (1.0 - acc) / len(mv)
    if not np.allclose(P.sum(axis=1), 1.0):
        raise ValueError("transition rows do not sum to 1")
    return order, P, cuts


def pair_pool_check(assignments, chain, states, pi, cuts, groups=GROUPS):
    """(TV, relative E|cut| error, t statistics) of pooled k-district
    assignments ((S, N) integer rows; ``chain`` each row's chain) against
    the exact ``pi`` over ``states`` (tuples): the t of E|cut| (entry 0)
    and of each node's mean district index, over ``groups`` disjoint sets
    of chains, as ``group_t`` computes them. A row outside the state set
    raises KeyError."""
    index = {m: i for i, m in enumerate(states)}
    idx = np.array([index[tuple(int(x) for x in r)] for r in assignments])
    emp = np.bincount(idx, minlength=len(states)).astype(float)
    emp /= emp.sum()
    tv = 0.5 * np.abs(emp - pi).sum()
    e_cut = float((pi * cuts).sum())
    cut_err = abs(float((emp * cuts).sum()) - e_cut) / e_cut
    chain = np.asarray(chain)
    grp = chain * groups // (int(chain.max()) + 1)
    counts = np.zeros((groups, len(states)))
    np.add.at(counts, (grp, idx), 1.0)
    gemp = counts / counts.sum(axis=1, keepdims=True)
    obs = np.concatenate([np.asarray(cuts, float)[:, None],
                          np.array(states, float)], axis=1)
    means = gemp @ obs
    se = means.std(axis=0, ddof=1) / np.sqrt(groups)
    return tv, cut_err, (means.mean(axis=0) - pi @ obs) / se


def joint_tempered_stationary(P1, P2, cuts, lb, b1, b2):
    """The exact time-averaged law of the 2-rung tempered chain with a
    swap round after every transition and alternating parity (a copy of
    ``tests/test_tempered.py``'s ``_joint_tempered_stationary``): the
    recorded-yield distribution obeys v_{t+1} = S_{t%2}(P(v_t)) over the
    joint (cold state, hot state) space, where S_0 swaps the two states
    with probability min(1, exp(lb * (b1 - b2) * (cut_i - cut_j))) and
    S_1 is the identity (a parity-1 round has no pair at 2 rungs).
    Returns the (K, K) joint law; its row and column sums are the cold
    and hot rungs' marginals."""
    n = P1.shape[0]
    d = cuts[:, None] - cuts[None, :]
    a_ij = np.minimum(1.0, np.exp(lb * (b1 - b2) * d))

    def step_p(v):
        return P1.T @ v @ P2

    def swap(v):
        return v * (1 - a_ij) + v.T * a_ij.T

    v = np.full((n, n), 1.0 / (n * n))
    for _ in range(4000):
        nxt = step_p(swap(step_p(v)))
        if np.abs(nxt - v).max() < 1e-13:
            break
        v = nxt
    v /= v.sum()
    avg = (v + swap(step_p(v))) / 2
    return avg / avg.sum()


def cut_law_check(cut_rows, pi, cuts, groups=GROUPS):
    """(TV, relative E|cut| error, t of E|cut|) of pooled cut counts
    against the cut-count law of ``pi`` over states with ``cuts``:
    ``cut_rows`` (L, T) holds each of L independent chains' (or ladders')
    recorded cut counts; the t is the mean of ``groups`` disjoint sets of
    rows less the exact E|cut|, over their standard error."""
    cut_rows = np.asarray(cut_rows, np.int64)
    vals = np.unique(np.asarray(cuts, np.int64))
    exact = np.array([pi[cuts == v].sum() for v in vals])
    pos = np.searchsorted(vals, cut_rows.ravel())
    if (pos >= len(vals)).any() or (vals[np.minimum(pos, len(vals) - 1)]
                                    != cut_rows.ravel()).any():
        raise KeyError("a cut count outside the exact law's support")
    emp = np.bincount(pos, minlength=len(vals)) / cut_rows.size
    tv = 0.5 * np.abs(emp - exact).sum()
    e_cut = float(exact @ vals)
    grp = np.arange(cut_rows.shape[0]) * groups // cut_rows.shape[0]
    means = np.array([cut_rows[grp == g].mean() for g in range(groups)])
    t = (means.mean() - e_cut) / (means.std(ddof=1) / np.sqrt(groups))
    return tv, abs(float(emp @ vals) - e_cut) / e_cut, float(t)


def simulate(P, start, chains=CHAINS, steps=SAMPLES, seed=0):
    """(steps, chains) state indices of ``chains`` independent runs of the
    chain ``P`` from states drawn from ``start``, after each step."""
    rng = np.random.default_rng(seed)
    cdf = P.cumsum(axis=1)
    cdf[:, -1] = 1.0
    cur = rng.choice(P.shape[0], size=chains, p=start)
    out = np.empty((steps, chains), np.int64)
    for t in range(steps):
        cur = (cdf[cur] < rng.random(chains)[:, None]).sum(axis=1)
        out[t] = cur
    return out


def pool_check(idx, states, pi, cuts, n=N):
    """(TV, relative E|cut| error, t statistics) of a (steps, chains) pool
    of state indices, as ``chip_smoke.py`` reads the card's boards (of n
    nodes)."""
    abits = np.asarray(states, np.int64)[idx.ravel()]
    chain = np.tile(np.arange(idx.shape[1]), idx.shape[0])
    tv, cut_err = occupancy_error(abits, states, pi, cuts)
    return tv, cut_err, group_t(abits, chain, states, pi, cuts, n=n)


if __name__ == "__main__":
    # What the pooled check passes (the exact chain) and what it catches
    # (the exact chain of a base off by 1, 2, 5 and 10 %), at chip_smoke.py's
    # sample size: python tests/_torch_enumeration.py
    g, nbrmask = build_masks()
    states = enumerate_states(nbrmask)
    for base in (0.5, 1.0, 2.0):
        P, cuts = build_transition(states, g, base)
        pi = stationary_lazy(P)
        rows = [pool_check(simulate(P, pi, seed=r), states, pi, cuts)
                for r in range(8)]
        print(f"base {base}: exact chain, 8 pools: TV "
              f"{min(r[0] for r in rows):.4f}-{max(r[0] for r in rows):.4f},"
              f" max |t| {max(np.abs(r[2]).max() for r in rows):.2f}")
        for off in (1.01, 1.02, 1.05, 1.1):
            Pw, _ = build_transition(states, g, base * off)
            piw = stationary_lazy(Pw)
            tv, cut_err, t = pool_check(simulate(Pw, piw, seed=99), states,
                                        pi, cuts)
            print(f"  base x {off}: TV(pi_off, pi) "
                  f"{0.5 * np.abs(piw - pi).sum():.4f}; pooled TV {tv:.4f},"
                  f" E|cut| error {cut_err:.4f}, |t| of E|cut| "
                  f"{abs(t[0]):.2f}, max |t| {np.abs(t).max():.2f}")
