"""The summary fold inside the chunk kernels, on the CPU.

``cuda_lowered.run_chunk`` and ``cuda_dense.run_general_dense_chunk_cuda``
take the run's summary accumulator (``acc=``) and fold their own records
into it: on the card inside the chunk's launch, on a fold warp fed through
shared memory (``csrc/summary_fold.cuh``), on the CPU by the plain chunk
and then ``fold_block``. The summary-mode runs of
``test_torch_analytics_runners.py`` hold that fold on the CPU to
``fold_block`` and to the JAX package's in-scan ``fold_out``; the card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` hold the
kernels to their history-mode launches and the standalone fold. Here:

- the dense kernel's fused entry, which the general runner does not
  reach on the CPU (it runs the dense body as torch ops there), equals
  the plain chunk followed by ``fold_block`` over chunks that halve the
  buffer inside them and end in the middle of a stride, with two series
  keys;
- without a history the fused entry leaves out only the rows that the
  fold alone reads (the lowered kernel's flip-log pair stays), and it
  refuses an accumulator whose observable or series the chunk does not
  record;
- ``ring_fold`` below, a numpy model of the kernels' hand-off (a chain
  warp keeps step t's packet in lane t mod 32 and, at the batch's end,
  writes the batch into slot t // 32 mod K of a ring on full / empty
  barriers with parity waits; a fold warp with one lane a chain folds the
  batches in order and halves the buffer across its lanes), equals
  ``fold_block`` bit for bit under random interleavings.
"""

import numpy as np
import pytest
import torch

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu_torch import graphs as tgraphs
from flipcomplexityempirical_tpu_torch import sampling
from flipcomplexityempirical_tpu_torch.kernel import cuda_dense as cd
from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl
from flipcomplexityempirical_tpu_torch.stats import accumulators as tacc

from _torch_parity import spec_port
from test_torch_analytics_runners import assert_acc_equal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits_equal(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# The fused entry on CPU tensors
# ---------------------------------------------------------------------------

def lowered_case(chains=3):
    g = tgraphs.frankengraph()
    spec = spec_port(fce.Spec(contiguity="patch", record_interface=True))
    bg, st, params = sampling.init_board(
        g, tgraphs.frank_plan(g, 0), n_chains=chains, seed=5, spec=spec,
        base=0.3, pop_tol=0.1, device="cpu")
    return spec, bg, st, params


def test_lowered_fused_entry_keeps_the_flip_log():
    """Without a history the flip-log pair is still made: the low-level
    outputs keep it and leave only the fold's rows out."""
    spec, bg, st, params = lowered_case()
    static = cl.make_static_inputs(bg, spec, params)
    ins = (st.board, *cl.pack_state(st, params))
    plain = cl.run_lowered_chunk_cuda(bg, static, spec, 11, *ins)
    got, _ = cl.run_lowered_chunk_cuda(bg, static, spec, 11, *ins,
                                       acc=tacc.init_summary(3),
                                       keep_rows=False)
    for i, (a, b) in enumerate(zip(got, plain)):
        if i in cl.FOLD_ONLY_OUTS:
            assert a is None
        else:
            assert bits_equal(a, b), cl.OUT_NAMES[i]


def dense_case(chains=4, **spec_kw):
    g = tgraphs.hex_lattice(6, 10)
    spec = spec_port(fce.Spec(**spec_kw))
    dg, st, params = sampling.init_batch(g, tgraphs.stripes_plan(g, 2),
                                         n_chains=chains, seed=4, spec=spec,
                                         base=1 / 0.3, pop_tol=0.2,
                                         device="cpu")
    return spec, dg, st, params


def test_dense_fused_entry_is_chunk_then_fold_block():
    """The general runner runs the dense body as torch ops on the CPU, so
    the dense kernel's fused entry is held here: chunks of 7, 13 and 9
    steps at cap 8 (the buffer halves inside them, the first two end in
    the middle of a stride), two series keys, no history."""
    spec, dg, st, params = dense_case(lazy_uniform=True)
    keys = ("wait", "weight")
    acc = tacc.init_summary(4, cap=8, series_keys=keys, series_cap=29)
    want, plain = acc.clone(), st
    for t_len in (7, 13, 9):
        plain, rows = cd.run_general_dense_chunk_cuda(dg, None, spec, params,
                                                      plain, t_len)
        st, got_rows, acc = cd.run_general_dense_chunk_cuda(
            dg, None, spec, params, st, t_len, acc=acc, keep_rows=False)
        assert got_rows == {}
        for f in ("assignment", "key", "part_sum", "cut_times",
                  "waits_sum"):
            assert bits_equal(getattr(st, f), getattr(plain, f)), f
        want = tacc.fold_block(want, rows)
        assert_acc_equal(acc, want)
    assert (int(acc.n), int(acc.stride)) == (29, 4)


def test_fused_entry_refuses_what_its_rows_lack():
    spec, bg, st, params = lowered_case()
    with pytest.raises(ValueError, match="observable 'slope2'"):
        cl.run_chunk(bg, spec, params, st, 3,
                     acc=tacc.init_summary(3, observable="slope2"))
    dspec, dg, dst, dpar = dense_case()
    with pytest.raises(ValueError, match="series 'weight'"):
        cd.run_general_dense_chunk_cuda(
            dg, None, dspec, dpar, dst, 3,
            acc=tacc.init_summary(4, series_keys=("weight",),
                                  series_cap=3))
    with pytest.raises(ValueError, match="pass an accumulator"):
        cl.run_chunk(bg, spec, params, st, 3, keep_rows=False)


# ---------------------------------------------------------------------------
# A numpy model of the hand-off to the fold warp
# ---------------------------------------------------------------------------

class Barrier:
    """An mbarrier: ``count`` arrivals complete a phase; a wait on parity
    p returns once the phase of that parity has completed (a fresh
    barrier's phase of parity 1 counts as completed)."""

    def __init__(self, count):
        self.count, self.arrived, self.phase = count, 0, 0

    def arrive(self):
        self.arrived += 1
        if self.arrived == self.count:
            self.arrived, self.phase = 0, self.phase + 1

    def done(self, parity):
        return self.phase % 2 != parity


def fold_lanes(m, sched, packets, buf, cap, series, scap):
    """One batch on the fold warp: ``packets`` (steps, lanes, 4) float32,
    lane i = chain i of the block; the moments in float32 in fold_out's
    order (every chunk kernel records a wait), the schedule shared, a
    halving spread over 32 lanes a round."""
    f32 = np.float32
    for p in packets:
        x, v = p[:, 0], p[:, 1]
        n = sched["n"]
        n1 = f32(n + 1)
        delta = x - m["mean"]
        m["mean"] = m["mean"] + delta / n1
        m["m2"] = m["m2"] + delta * (x - m["mean"])
        w = f32(1) + v
        m["wsum"] = m["wsum"] + w
        wd = x - m["wmean"]
        m["wmean"] = m["wmean"] + wd * (w / m["wsum"])
        m["wm2"] = m["wm2"] + (w * wd) * (x - m["wmean"])
        m["waits"] = m["waits"] + v
        halve, slot = False, -1
        if sched["phase"] == 0:
            if sched["kept"] >= cap:
                sched["kept"], sched["stride"] = cap // 2, 2 * sched["stride"]
                halve = True
            slot = sched["kept"]
            sched["kept"] += 1
        sched["n"] += 1
        if halve:
            sched["phase"] = sched["n"] % sched["stride"]
        else:
            sched["phase"] = (sched["phase"] + 1) % sched["stride"]
        if halve:
            for row in buf:       # the warp halves each lane's row in turn
                for j0 in range(0, cap // 2, 32):
                    j = np.arange(j0, min(j0 + 32, cap // 2))
                    got = row[2 * j].copy()    # every lane reads, then
                    row[j] = got               # every lane writes
                row[cap // 2:] = 0
        if slot >= 0:
            buf[:, slot] = x
        if series is not None:
            at = min(n, scap - 1)
            for k, s in enumerate(series):
                s[at] = p[0, 2 + k]


def ring_fold(acc, rows, block, ring, rng):
    """The fold of ``rows`` ({name: (T, C)}) as the kernels hand it over:
    chains in blocks of ``block``, each block's chain warps (producers)
    and its fold warp (consumer) stepped in a random order that the
    barriers allow; a chain warp keeps step t's packet in lane t mod 32
    and writes its batch into slot t // 32 mod ``ring`` at the batch's
    end. Returns the accumulator's fields as numpy arrays."""
    x_all = rows[acc.observable].numpy().astype(np.float32)
    t_len, c = x_all.shape
    wait = rows["wait"].numpy().astype(np.float32)
    keys = list(acc.series)
    src = [rows[k].numpy().astype(np.float32) for k in keys]
    cap = acc.buf.shape[1]
    out = {k: getattr(acc, k).numpy().copy() for k in (
        "mean", "m2", "wsum", "wmean", "wm2", "waits", "buf", "accepts")}
    series = [acc.series[k].numpy().copy() for k in keys]
    scap = series[0].shape[0] if keys else 0
    nks = None
    n_batches = -(-t_len // 32)
    for c0 in range(0, c, block):
        live = min(block, c - c0)
        lanes = slice(c0, c0 + live)
        full = [Barrier(32 * live) for _ in range(ring)]
        empty = [Barrier(32) for _ in range(ring)]
        slots = np.full((ring, 32, live, 4), np.nan, np.float32)
        tags = np.full((ring, 32, live), -1)      # the step a packet holds
        lanes_pk = np.zeros((live, 32, 4), np.float32)  # packets in lanes
        made = [0] * live                         # steps each chain made
        folded = 0                                # batches folded
        m = {k: out[k][lanes].copy() for k in (
            "mean", "m2", "wsum", "wmean", "wm2", "waits")}
        sched = dict(n=int(acc.n), kept=int(acc.kept),
                     stride=int(acc.stride))
        sched["phase"] = sched["n"] % sched["stride"]
        buf = out["buf"][lanes]
        while folded < n_batches:
            ready = []
            for i in range(live):
                t = made[i]
                last = t % 32 == 31 or t == t_len - 1
                if t < t_len and (not last or empty[(t // 32) % ring].done(
                        ((t // 32 // ring) & 1) ^ 1)):
                    ready.append(i)
            q = folded
            if full[q % ring].done((q // ring) & 1):
                ready.append(-1)
            assert ready, "the hand-off deadlocked"
            who = ready[rng.integers(len(ready))]
            if who >= 0:                          # chain warp: one step
                t, cc = made[who], c0 + who
                s, j = (t // 32) % ring, t % 32
                lanes_pk[who, j] = (x_all[t, cc], wait[t, cc],
                                    *(v[t, cc] for v in src),
                                    *([0.0] * (2 - len(src))))
                made[who] += 1
                if j == 31 or t == t_len - 1:     # the batch to its slot
                    slots[s, :j + 1, who] = lanes_pk[who, :j + 1]
                    tags[s, :j + 1, who] = t - j + np.arange(j + 1)
                    for _ in range(32):
                        full[s].arrive()
            else:                                 # fold warp: one batch
                s, steps = q % ring, min(32, t_len - 32 * q)
                want = 32 * q + np.arange(steps)
                assert (tags[s, :steps] == want[:, None]).all(), \
                    "the fold read a slot its batch had not filled"
                fold_lanes(m, sched, slots[s, :steps], buf, cap,
                           series if c0 == 0 else None, scap)
                for _ in range(32):
                    empty[s].arrive()
                folded += 1
        for k, v in m.items():
            out[k][lanes] = v
        out["buf"][lanes] = buf
        if "accepts" in rows:
            out["accepts"][lanes] = rows["accepts"][-1, lanes].numpy()
        if c0 == 0:
            nks = (sched["n"], sched["kept"], sched["stride"])
    return out, nks, series


@pytest.mark.parametrize("chains,t_len,cap,block,ring", [
    (8, 369, 4096, 8, 2),      # the lowered kernel's fold warp, C=8
    (8, 369, 8, 8, 2),         # halvings inside the chunk
    (12, 100, 8, 8, 2),        # a partial block
    (3, 2439, 16, 1, 2),       # the dense wide form: 1 chain a block
    (19, 150, 16, 8, 2),       # the dense narrow form: 8, 8 and 3 chains
    (5, 77, 8, 1, 1),          # one slot: every batch waits
])
def test_ring_model_matches_fold_block(chains, t_len, cap, block, ring):
    rng = np.random.default_rng(t_len * chains + cap)
    rows = {"cut_count": torch.as_tensor(
                rng.integers(5, 600, (t_len, chains)), dtype=torch.int32),
            "accepts": torch.as_tensor(np.cumsum(
                rng.integers(0, 2, (t_len, chains)), axis=0),
                dtype=torch.int32)}
    rows["wait"] = torch.as_tensor(
        rng.geometric(0.3, (t_len, chains)) - 1, dtype=torch.float32)
    for k in ("slope", "angle"):
        v = rng.normal(size=(t_len, chains)).astype(np.float32)
        v[rng.random(t_len) < 0.2] = np.nan
        rows[k] = torch.as_tensor(v)
    acc = tacc.init_summary(chains, cap=cap, series_keys=("slope", "angle"),
                            series_cap=t_len + 3)
    # start mid-schedule: fold a first block plainly
    acc = tacc.fold_block(acc, {k: v[:45] for k, v in rows.items()})
    got, nks, series = ring_fold(acc, rows, block, ring, rng)
    want = tacc.fold_block(acc.clone(), rows)
    assert nks == (int(want.n), int(want.kept), int(want.stride))
    for k, v in got.items():
        np.testing.assert_array_equal(v.view(np.int32),
                                      getattr(want, k).numpy().view(
                                          np.int32), err_msg=k)
    for k, s in zip(("slope", "angle"), series):
        np.testing.assert_array_equal(s.view(np.int32),
                                      want.series[k].numpy().view(np.int32))
