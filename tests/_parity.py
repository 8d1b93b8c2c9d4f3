"""The tolerance rules of the tests that hold the PyTorch port against the
JAX package, in numpy alone: ``chip_smoke.py`` holds the card's runs to the
same rules on a machine without JAX.

Tolerance of every comparison here: integer outputs are bit-equal. Wait
values are bit-equal except where torch's and XLA's f32 ``log`` round the
same input differently, which moves ``floor(log u / log1p(-p))`` across an
integer; such entries are counted, must be at most 1e-3 of all entries,
and each must be off by exactly 1.0. A wait sum may differ by at most the
number of such entries it contains. Interface metrics (slope, angle) are
within 4 ulp, NaN exactly where the JAX value is NaN.

The k-district walks' waits (``scaled``): the denominator n**k - 1 makes
a wait large (~6e6 on the 144-node dual map at k = 4), and there four
ulps of ``log``'s relative error move floor(log u / log1p(-p)) by
|w| * 2**-21 or more, so a differing log crosses an integer on a share of
the draws far above 1e-3, and the memoised wait repeats it on every
yield until the next accept. There a differing entry must still be off
by exactly 1.0, but entries whose reference wait is at least
``WAIT_SCALED_FROM`` (2**21 * 1e-3) do not count toward the 1e-3 share;
smaller ones do, as above.
"""

import numpy as np

WAIT_MISMATCH_SHARE = 1e-3
WAIT_SCALED_FROM = 2 ** 21 * WAIT_MISMATCH_SHARE
FLOAT_STATE = ("state_cur_wait", "state_waits_sum")
# the ReCom runs' waits (the "relative" rule): up to n**k / 2 at k = 4 (~1e9 on
# the 32 x 32 grid), where a log tie moves floor(log u / log1p(-p)) by a few
# units in the last place of the f32 wait: each differing wait within
# WAIT_REL * |wait| + 1 (8 units of 2**-23), each float state field within
# that much per differing wait of its chain, the wait totals as
# ``assert_relative_wait_totals`` says
WAIT_REL = 2.0 ** -20


def assert_waits_close(got, want, name="wait", scaled=False):
    """Per-entry wait comparison under the module's tolerance (``scaled``:
    the k-district walks' rule); returns the boolean mask of differing
    entries."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bad = got != want
    counted = bad & (np.abs(want) < WAIT_SCALED_FROM) if scaled else bad
    n_bad = int(counted.sum())
    assert n_bad <= WAIT_MISMATCH_SHARE * got.size, (
        f"{name}: {n_bad} of {got.size} entries differ")
    if n_bad:
        assert (np.abs(got[bad] - want[bad]) == 1.0).all(), (
            name, got[bad], want[bad])
    return bad


def assert_wait_sums_close(got, want, n_bad, name="waits_sum",
                           sum_ulps=False):
    """Sums of waits: equal where no summed wait differed, else within
    the number of differing waits (``sum_ulps``: within that many units in
    the last place of the f32 sum, at least 1 each, for the k-district
    walks' per-chunk f32 sums of waits ~1e7, where a wait off by 1.0
    moves the rounded sum by a unit of its last place)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    n_bad = np.broadcast_to(np.asarray(n_bad), got.shape)
    np.testing.assert_array_equal(got[n_bad == 0], want[n_bad == 0],
                                  err_msg=name)
    unit = (np.maximum(np.spacing(np.abs(want).astype(np.float32)), 1.0)
            if sum_ulps else 1.0)
    assert (np.abs(got - want) <= n_bad * unit).all(), name


def assert_ulps_close(got, want, ulps=4, name="value"):
    """f32 values equal up to ``ulps`` units in the last place, NaN exactly
    where ``want`` is NaN (the interface metrics: torch's and XLA's
    ``acos`` may round the same input differently)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=name)
    g = got[~nan].view(np.int32).astype(np.int64)
    w = want[~nan].view(np.int32).astype(np.int64)
    same = got[~nan] == want[~nan]      # inf == inf, +0 == -0
    assert (same | (np.abs(g - w) <= ulps)).all(), name


def experiment_arrays(data: dict, wait_txt: str) -> dict:
    """A ``run_config`` data dict (either package's) as the fixture's
    arrays; the state's key words as uint32, the JAX package's dtype.
    Keys a family does not make (slopes and angles without interface
    metrics, the partisan scores at k > 2 outside the dual family) are
    left out; the temper family adds its per-rung cut trajectories and
    swap counts."""
    out = {k: np.asarray(data[k]) for k in
           ("end_signed", "cut_times", "part_sum", "num_flips", "slopes",
            "angles", "waits_all", "assignments") if data[k] is not None}
    out["end_signed"] = out["end_signed"].astype(np.int8)
    out["assignments"] = out["assignments"].astype(np.int8)
    out.update({f"hist_{k}": np.asarray(v)
                for k, v in data["history"].items()})
    out.update({f"partisan_{k}": np.asarray(v)
                for k, v in data.get("partisan", {}).items()})
    if "rung_cut" in data:                 # the temper family's diagnostics
        out["rung_cut"] = np.asarray(data["rung_cut"])
        for k in ("attempts", "accepts"):
            out[f"swap_{k}"] = np.asarray(data["swapstats"][k], np.int64)
    state = data["state"]
    fields = (state.items() if isinstance(state, dict) else
              ((f, getattr(state, f)) for f in state.__dataclass_fields__))
    out.update({f"state_{f}": np.asarray(v) for f, v in fields
                if v is not None})
    out["state_key"] = out["state_key"].astype(np.uint32)
    out["wait_txt"] = np.array(wait_txt)
    return out


def assert_relative_waits(got, want, n_bad, name="wait") -> None:
    """The "relative" rule's bound: each entry within ``n_bad`` (per chain, or 1
    an entry) times WAIT_REL * |want| + 1."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    n_bad = np.broadcast_to(np.asarray(n_bad), got.shape[:1])
    n_bad = n_bad.reshape(n_bad.shape + (1,) * (got.ndim - 1))
    assert (np.abs(got - want)
            <= n_bad * (WAIT_REL * np.abs(want) + 1.0)).all(), name


def assert_relative_wait_totals(got, want, got_hist, want_hist,
                                name="waits_all") -> None:
    """The "relative" rule's bound on each chain's wait total (f32 sums a chunk,
    drained to f64): equal where no recorded wait differed, else within
    the waits' summed differences plus a unit in the last place of the
    f32 total for every yield from the first differing wait on (each later
    f32 addition may round the other way)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    gh = np.asarray(got_hist, np.float64)
    wh = np.asarray(want_hist, np.float64)
    bad = gh != wh
    n_bad = bad.sum(axis=1)
    np.testing.assert_array_equal(got[n_bad == 0], want[n_bad == 0],
                                  err_msg=name)
    first = np.where(bad.any(axis=1), np.argmax(bad, axis=1), gh.shape[1])
    unit = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    slack = np.abs(gh - wh).sum(axis=1) + (gh.shape[1] - first) * unit
    assert (np.abs(got - want) <= slack).all(), name


# assert_experiment_matches' wait rules, each a complete rule:
# "unit": the module's rule (each differing wait off by exactly 1.0, at
#     most 1e-3 of entries; totals within a unit per differing wait);
# "scaled": the k-district walks' per-entry rule, totals as "unit";
# "scaled_ulps": "scaled" with the wait totals within that many units in
#     the last place of their f32 sum (``sum_ulps``);
# "relative": the ReCom runs' rule, "scaled" per entry and each differing
#     wait within WAIT_REL (``assert_relative_waits``), the totals as
#     ``assert_relative_wait_totals`` says, the float state fields equal
#     where no wait differed and within WAIT_REL per differing wait.
WAIT_RULES = ("unit", "scaled", "scaled_ulps", "relative")


def assert_experiment_matches(got: dict, want: dict,
                              waits: str = "unit") -> int:
    """Hold a run's arrays (``experiment_arrays``) against a fixture's:
    the waits, their totals and the float state fields under the rule
    ``waits`` (``WAIT_RULES``), the interface metrics within 4 ulp,
    ``wait.txt`` equal unless a tie was counted in chain 0, everything
    else bit-equal. Returns the differing waits."""
    if waits not in WAIT_RULES:
        raise ValueError(f"waits={waits!r}: one of {WAIT_RULES}")
    scaled = waits != "unit"
    relative = waits == "relative"
    assert sorted(got) == sorted(want)
    bad = assert_waits_close(got["hist_wait"], want["hist_wait"],
                             scaled=scaled)
    n_bad = bad.sum(axis=1)
    if relative:
        assert_relative_waits(got["hist_wait"], want["hist_wait"], 1)
    if "hist_weight" in want:                  # 1 + wait, lazy_uniform
        np.testing.assert_array_equal(assert_waits_close(
            got["hist_weight"], want["hist_weight"], "weight",
            scaled=scaled), bad)
    if relative:
        assert_relative_wait_totals(got["waits_all"], want["waits_all"],
                                    got["hist_wait"], want["hist_wait"])
    else:
        assert_wait_sums_close(got["waits_all"], want["waits_all"], n_bad,
                               sum_ulps=waits == "scaled_ulps")
    for k in ("slopes", "angles", "hist_slope", "hist_angle"):
        if k in want:
            assert_ulps_close(got[k], want[k], name=k)
    for k in FLOAT_STATE:
        if relative:
            np.testing.assert_array_equal(got[k][n_bad == 0],
                                          want[k][n_bad == 0], err_msg=k)
            assert_relative_waits(got[k], want[k], n_bad, name=k)
        else:
            assert_wait_sums_close(got[k], want[k], n_bad, name=k)
    if n_bad[0] == 0:
        assert str(got["wait_txt"]) == str(want["wait_txt"])
    skip = {"hist_wait", "hist_weight", "waits_all", "slopes", "angles",
            "hist_slope", "hist_angle", "wait_txt", *FLOAT_STATE}
    for k in sorted(set(want) - skip):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if k.startswith("partisan_"):
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
    return int(n_bad.sum())


def state_dict(state) -> dict:
    """A chain state's fields (either package's, or a dict) as numpy
    arrays, None fields left out."""
    if isinstance(state, dict):
        items = state.items()
    else:
        items = ((f, getattr(state, f)) for f in state.__dataclass_fields__)
    return {k: np.asarray(v) for k, v in items if v is not None}


def assert_chain_run_matches(got_state, got_hist: dict, got_waits,
                             want_state, want_hist: dict, want_waits,
                             scaled: bool = False) -> int:
    """Hold a general-path run (final state, (C, T) history, f64 wait
    totals) against another under the module's rules: the waits (and the
    lazy weights, 1 + wait) per the log-tie rule (``scaled``: the
    k-district walks' rule), the wait totals and the
    float state fields within the number of differing waits of their
    chain, the interface metrics (slope, angle) within 4 ulp with NaN
    where the reference has NaN, every other field and history key equal
    in value. Returns the differing waits."""
    got_state, want_state = state_dict(got_state), state_dict(want_state)
    assert sorted(got_hist) == sorted(want_hist)
    assert sorted(got_state) == sorted(want_state)
    n_bad = np.zeros(np.asarray(got_waits).shape[0], np.int64)
    if "wait" in want_hist:
        bad = assert_waits_close(got_hist["wait"], want_hist["wait"],
                                 scaled=scaled)
        n_bad = bad.sum(axis=1)
        if "weight" in want_hist:
            wbad = assert_waits_close(got_hist["weight"],
                                      want_hist["weight"], "weight",
                                      scaled=scaled)
            np.testing.assert_array_equal(wbad, bad)
    assert_wait_sums_close(got_waits, want_waits, n_bad)
    for k in ("cur_wait", "waits_sum"):
        assert_wait_sums_close(got_state[k], want_state[k], n_bad, name=k)
    for k in sorted(set(want_hist) & {"slope", "angle"}):
        assert_ulps_close(got_hist[k], want_hist[k], name=k)
    for k in sorted(set(want_hist) - {"wait", "weight", "slope", "angle"}):
        np.testing.assert_array_equal(np.asarray(got_hist[k]),
                                      np.asarray(want_hist[k]), err_msg=k)
    for k in sorted(set(want_state) - {"cur_wait", "waits_sum"}):
        g, w = got_state[k], want_state[k]
        assert g.shape == w.shape, k
        np.testing.assert_array_equal(g.astype(np.int64),
                                      w.astype(np.int64), err_msg=k)
    return int(n_bad.sum())


def general_fixture_inputs(port, convert, graph, fx: dict, device):
    """(DeviceGraph, ChainState, StepParams) on ``device`` from a general
    fixture's ``init_*`` arrays and bounds (``test_torch_general_
    fixture.py``), through the port's own converters."""
    from types import SimpleNamespace
    from flipcomplexityempirical_tpu_torch.kernel.step import make_params
    state = convert.chain_state(SimpleNamespace(**{
        k[5:]: v for k, v in fx.items() if k.startswith("init_")}),
        device=device)
    params = make_params(float(fx["base"]), fx["pop_lo"], fx["pop_hi"],
                         [1, -1], n_chains=len(fx["pop_lo"]), device=device)
    return graph.device(device), state, params
