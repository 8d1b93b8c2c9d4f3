"""The port's bench entry point (``python -m flipcomplexityempirical_tpu_torch.
bench``) on the CPU at a tiny size, its refusals, and the numpy-only copy
of the exact enumeration that ``chip_smoke.py`` holds the card's chains
to.

The bench runs in-process through ``bench.main``, as ``python -m`` runs
it: a ``--cpu`` run prints one headline on stdout that
``tools/bench_compare.py::extract_metrics`` reads under ``bench.py``'s
metric name; without a card and without ``--cpu`` it exits 1; every flag
of ``bench.py`` it does not port exits 2 naming the ROADMAP.md item
(``--block-chains``, the TPU kernel's block size, is left to argparse);
``--ess`` (with ``--ess-host``, ``--record-every``) adds the
``cut_ess_per_sec`` record on stderr.
The enumeration copy must give ``tests/test_enumeration.py``'s states,
cut counts and stationary distribution exactly (float64, same order of
operations); its lazy iteration must give the stationary distribution
at every base, which the plain iteration misses at base 1.0 (a periodic
chain). The pooled check of ``chip_smoke.py`` phase 9 (``group_t`` and the
pool's TV bar) must pass the exact chain, drawn in numpy at the phase's
sample size, and catch that chain with its base off by 5 %, which
``test_enumeration.py``'s bar lets through.
"""

import json

import numpy as np
import pytest
import torch

import test_enumeration as ref
from _torch_enumeration import (CUT_TOL, T_TOL, TV_POOL_TOL, TV_TOL,
                                assert_matches_stationary, board_bits,
                                build_masks, build_transition,
                                enumerate_states, group_t, occupancy_error,
                                pool_check, simulate, stationary,
                                stationary_lazy)
from flipcomplexityempirical_tpu_torch import bench
from tools.bench_compare import extract_metrics

TINY = ["--cpu", "--chains", "4", "--steps", "41", "--warmup", "11",
        "--chunk", "10"]


def _run(capsys, argv):
    try:
        code = bench.main(argv)
    except SystemExit as exc:        # argparse's own refusals
        code = exc.code
    out, err = capsys.readouterr()
    return code, out, err


@pytest.mark.parametrize("argv,metric,kernel_path,kernel", [
    (["--grid", "6"], "flips_per_sec_per_chip_64x64", "board",
     "lowered_chunk"),
    (["--grid", "6", "--pallas"], "flips_per_sec_per_chip_64x64", "pallas",
     "board_chunk"),
    (["--grid", "3", "--graph", "hex"], "flips_per_sec_per_chip_hex",
     ("general_dense", "general"), ("general_dense_chunk", None)),
    (["--grid", "6", "--general"], "flips_per_sec_per_chip_64x64",
     "general", None),
    (["--grid", "4", "--graph", "hex", "--k", "4"],
     "flips_per_sec_per_chip_hex", ("general_dense", "general"),
     ("general_pair_chunk", None)),
    (["--grid", "8", "--general", "--k", "4"],
     "flips_per_sec_per_chip_64x64_pair_k4", "general", None),
], ids=["board", "pallas", "hex", "general", "hex-k4", "general-k4"])
def test_bench_cpu_headline(capsys, argv, metric, kernel_path, kernel):
    code, out, err = _run(capsys, TINY + argv)
    assert code == 0, err
    lines = out.strip().splitlines()
    assert len(lines) == 1
    head = json.loads(lines[0])
    assert extract_metrics(head) == {metric: head["value"]}
    assert head["value"] > 0 and head["unit"] == "flips/s"
    assert head["device"] == "cpu"
    if isinstance(kernel_path, tuple):     # the general path's race
        assert head["kernel_path"] in kernel_path
        assert head["kernel"] == kernel[kernel_path.index(
            head["kernel_path"])]
    else:
        assert head["kernel_path"] == kernel_path
        assert head["kernel"] == kernel
    assert head["repeats"] == 2 and head["repeat_policy"] == "best"
    assert "vs_baseline" not in head
    meta = json.loads(err.strip().splitlines()[-1])
    assert meta["chains"] == 4 and meta["steps"] == 41
    assert meta["launches"] == 0          # the plain versions ran
    assert 0.0 < meta["accept_rate"] <= 1.0
    if meta["path"] == "general":
        # the legacy body re-proposes; bench.py reads the last timed run
        assert meta["mean_tries_per_step"] >= 1.0
    else:
        assert meta["mean_tries_per_step"] == 1.0
    if isinstance(kernel_path, tuple):
        assert sorted(meta["seconds_by_body"]) == sorted(kernel_path)


def test_bench_without_a_card_exits_nonzero(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out, err = _run(capsys, ["--grid", "6"])
    assert code == 1
    assert out == "" and "--cpu" in err


def test_bench_refuses_a_grid_above_the_lowered_kernel(capsys):
    code, out, err = _run(capsys, ["--cpu", "--grid", "65", "--chains", "2",
                                   "--steps", "3", "--warmup", "3",
                                   "--chunk", "2"])
    assert code == 2 and out == "" and "B2" in err


@pytest.mark.parametrize("extra", [["--k", "3"], ["--k=3"]],
                         ids=["extra0-A7b", "extra13-A7b"])
def test_bench_runs_the_board_pair_walk(capsys, extra):
    """``--k`` on square (refused while ROADMAP.md A7b waited) runs the
    board pair kernel's path at ``bench.py``'s metric name."""
    code, out, err = _run(capsys, ["--cpu", "--grid", "6", "--chains", "4",
                                   "--steps", "21", "--warmup", "11",
                                   "--chunk", "10"] + extra)
    assert code == 0
    head = json.loads(out.strip())
    assert head["metric"] == "flips_per_sec_per_chip_64x64_pair_k3"
    assert head["kernel"] == "board_pair_chunk"
    assert head["kernel_path"] == "board" and head["path"] == "board"


@pytest.mark.parametrize("extra,item", [
    (["--devstats"], "A11"), (["--mesh", "4"], "A10"),
    (["--service", "--events", "-"], "A11"), (["--adaptive"], "A11"),
    (["--workload-matrix"], "A11"), (["--workloads", "frank"], "A11"),
    (["--fleet"], "A11"), (["--events", "-"], "A11"),
    (["--profile", "p"], "A11"),
    (["--service", "--tenants", "8", "--profile", "p"], "A11"),
    (["--target-ess", "9"], "A11"), (["--target-rhat", "1.1"], "A11"),
    (["--body", "int8"], "B7"),
    (["--block-chains", "64"], "unrecognized arguments"),
])
def test_bench_refuses_unported_flags(capsys, extra, item):
    code, out, err = _run(capsys, ["--cpu"] + extra)
    assert code == 2 and out == ""
    assert item in err


@pytest.mark.parametrize("extra", [
    ["--ess"], ["--ess", "--ess-host"], ["--ess", "--record-every", "2"],
    ["--ess", "--graph", "hex", "--grid", "4"]],
    ids=["ess", "ess-host", "record-every", "hex"])
def test_bench_runs_the_ess_flags(capsys, extra):
    """The flags that waited for the device analytics now run: the
    headline as before, and before the meta line on stderr the
    cut_ess_per_sec record of the host estimators (``--cpu``)."""
    code, out, err = _run(capsys, ["--cpu", "--grid", "6", "--chains", "4",
                                   "--steps", "41", "--warmup", "11",
                                   "--chunk", "10"] + extra)
    assert code == 0
    assert json.loads(out.strip())["metric"].startswith(
        "flips_per_sec_per_chip_")
    records = [json.loads(ln) for ln in err.splitlines()
               if ln.startswith("{")]
    assert [r.get("metric") for r in records] == ["cut_ess_per_sec", None]
    rec = records[0]
    assert rec["ess_on_device"] is False and "ess_host_check" not in rec
    assert rec["ess_total"] > 0 and rec["value"] > 0
    assert rec["bottleneck_phi"] > 0 and rec["bottleneck_r"] > 0
    assert rec.get("record_every", 1) == (2 if "--record-every" in extra
                                          else 1)


def test_bench_refuses_record_every_off_the_chunk(capsys):
    code, out, err = _run(capsys, ["--cpu", "--chunk", "10",
                                   "--record-every", "3", "--ess"])
    assert code == 2 and out == "" and "--record-every 3 must divide" in err


def test_bench_refuses_what_bench_py_refuses(capsys):
    for argv in (["--graph", "sec11", "--pallas"], ["--chunk", "7"],
                 ["--pallas", "--body", "bits"], ["--general", "--pallas"],
                 ["--general", "--body", "bits"]):
        code, out, _ = _run(capsys, ["--cpu"] + argv)
        assert code == 2 and out == "", argv


def test_bench_takes_bench_py_defaults_it_ports():
    """``--k 2``, ``--body bits``, ``--graph hex`` and ``--general`` are
    bench.py values this program runs: no refusal before parsing."""
    for argv in (["--k", "2"], ["--k=2"], ["--body", "bits"],
                 ["--graph", "hex"], ["--graph=hex"], ["--general"]):
        assert bench._not_ported(argv) is None, argv
        bench._parser().parse_args(argv)


def test_bench_metric_names_follow_bench_py():
    assert bench._metric("square") == "flips_per_sec_per_chip_64x64"
    assert bench._metric("sec11") == "flips_per_sec_per_chip_sec11"
    assert bench._metric("frank") == "flips_per_sec_per_chip_frank"
    assert bench._metric("hex") == "flips_per_sec_per_chip_hex"


@pytest.mark.parametrize("base", [0.5, 1.0, 2.0])
def test_enumeration_copy_equals_test_enumeration(base):
    g, nbrmask = build_masks()
    rg, rmask = ref.build_masks()
    assert nbrmask == rmask
    np.testing.assert_array_equal(g.edges, rg.edges)
    states = enumerate_states(nbrmask)
    assert states == ref.enumerate_states(rmask)
    P, cuts = build_transition(states, g, base)
    rP, rcuts = ref.build_transition(states, rg, base)
    np.testing.assert_array_equal(P, rP)
    np.testing.assert_array_equal(cuts, rcuts)
    pi = stationary(P)
    np.testing.assert_array_equal(pi, ref.stationary(rP))
    # an occupancy drawn from pi itself clears the bar, a skewed one not
    draws = np.random.default_rng(0).choice(len(states), 200_000, p=pi)
    abits = np.asarray(states)[draws]
    assert_matches_stationary(abits, states, pi, cuts)
    ref.assert_matches_stationary(abits, states, pi, cuts)
    tv, _ = occupancy_error(np.asarray(states)[:1].repeat(100), states, pi,
                            cuts)
    assert tv > 0.5


@pytest.mark.parametrize("base", [0.5, 1.0, 2.0])
def test_stationary_lazy_is_stationary(base):
    """The lazy chain's fixed point is P's stationary distribution at
    every base; the plain iteration's is too where P is aperiodic, and is
    not at base 1.0, where P has period 2."""
    g, nbrmask = build_masks()
    states = enumerate_states(nbrmask)
    P, _ = build_transition(states, g, base)
    pi = stationary_lazy(P)
    assert np.abs(pi @ P - pi).max() < 1e-12
    plain = stationary(P)
    if base == 1.0:
        assert np.diag(P).max() == 0.0
        assert 0.5 * np.abs(plain - pi).sum() > 0.04
    else:
        np.testing.assert_allclose(plain, pi, rtol=0, atol=1e-10)


def test_board_bits_is_the_district_one_bitmask():
    boards = np.array([[1, 0, 0, 1], [0, 1, 1, 0]], np.int8)
    np.testing.assert_array_equal(board_bits(boards), [0b1001, 0b0110])


@pytest.mark.parametrize("base", [0.5, 1.0, 2.0])
def test_pooled_check_passes_the_exact_chain_and_catches_a_biased_one(base):
    g, nbrmask = build_masks()
    states = enumerate_states(nbrmask)
    P, cuts = build_transition(states, g, base)
    pi = stationary_lazy(P)
    tv, cut_err, t = pool_check(simulate(P, pi, seed=1), states, pi, cuts)
    assert tv < TV_POOL_TOL and cut_err < CUT_TOL
    assert np.abs(t).max() < T_TOL, t
    off, _ = build_transition(states, g, 1.05 * base)
    pi_off = stationary_lazy(off)
    tv, cut_err, t = pool_check(simulate(off, pi_off, seed=2), states, pi,
                                cuts)
    assert tv < TV_TOL and cut_err < CUT_TOL     # the reference's bar passes
    assert abs(t[0]) > T_TOL, t                  # the pooled check does not


def test_group_t_reads_groups_of_chains():
    """group_t groups boards by chain, not by their order in the pool:
    boards step by step of 8 chains, chains 0-3 always in one state and
    4-7 in the other, make two groups of means 1 and 2 (E|cut|)."""
    states = [0b0011, 0b0101]
    cuts = np.array([1, 2])
    chain = np.tile(np.arange(8), 10)
    abits = np.where(chain < 4, states[0], states[1])
    t = group_t(abits, chain, states, np.array([0.5, 0.5]), cuts, groups=2)
    assert t[0] == 0.0
    # mean 1.5 against 1.25, standard error 0.5
    t = group_t(abits, chain, states, np.array([0.75, 0.25]), cuts, groups=2)
    np.testing.assert_allclose(t[0], 0.5)
