"""Replica exchange in the port (``sampling/tempering.py``,
``sampling/tempered.py``) against the JAX package's.

- The pair uniforms: ``jax.random.uniform(key, (c,))`` is the f32 uniform
  of the XOR of the key's threefry block at counter (0, i); bit-equal.
- ``swap_within_batch``: the new betas and the accept mask at both
  parities, for random cut counts and ladders permuted by earlier swaps.
  The decision is ``log(max(u, 1e-12)) < log_a`` in f32, where torch's
  and XLA's ``log`` may round one input differently (a few of these
  draws' uniforms do: counted); a decision may differ only where the two
  logs differ, and none does in these draws.
- ``run_tempered`` on the board path (the Frankengraph on the lowered
  body) and on the general path (a small hexagonal lattice on the legacy
  body, which the JAX package's tempered general path runs): states,
  ``beta_hist``, the swap attempts and accepts, every history row and
  ``per_rung_history`` bit-equal, the waits by ``_parity``'s rule.
- A single rung equals the plain runner (the port's copy of
  ``tests/test_tempered.py``'s first test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.sampling import tempered as jtd
from flipcomplexityempirical_tpu.sampling import tempering as jt
from flipcomplexityempirical_tpu_torch import graphs as tgraphs
from flipcomplexityempirical_tpu_torch import rng
from flipcomplexityempirical_tpu_torch.kernel.step import Spec, make_params
from flipcomplexityempirical_tpu_torch.sampling import (init_batch,
                                                        init_board,
                                                        run_board,
                                                        run_chains)
from flipcomplexityempirical_tpu_torch.sampling import tempered as ttd
from flipcomplexityempirical_tpu_torch.sampling import tempering as tt
from flipcomplexityempirical_tpu_torch.sampling.runner import RunResult

from _torch_parity import (assert_wait_sums_close, assert_waits_close,
                           spec_port)


@pytest.mark.parametrize("c", [1, 2, 7, 80, 81])
def test_pair_uniforms_match_jax(c):
    for seed in (0, 5, 2 ** 31 + 3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.uniform(key, (c,)))
        got = tt.pair_uniforms(rng.prng_key(seed), c).numpy()
        np.testing.assert_array_equal(got, want)


class _Cuts:
    """A state with only the field a swap reads."""

    def __init__(self, cut):
        self.cut_count = cut


def _jax_params(log_base, beta):
    return fce.kernel.step.StepParams(
        log_base=jnp.asarray(log_base), beta=jnp.asarray(beta),
        pop_lo=jnp.zeros_like(jnp.asarray(beta)),
        pop_hi=jnp.zeros_like(jnp.asarray(beta)),
        label_values=jnp.asarray([1, -1], jnp.int32))


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("n_rungs,base", [(4, 3.0), (5, 0.5), (2, 1.7)])
def test_swap_within_batch_matches_jax(parity, n_rungs, base):
    r = np.random.default_rng(10 * n_rungs + parity)
    n_ladders = 6
    c = n_ladders * n_rungs
    ladder = np.linspace(1.0, 0.4, n_rungs).astype(np.float32)
    flips = ties = 0
    for trial in range(8):
        beta = np.concatenate([r.permutation(ladder)
                               for _ in range(n_ladders)])
        cut = r.integers(10, 60, size=c).astype(np.int32)
        log_base = np.full(c, np.log(np.float32(base)), np.float32)
        key = jax.random.PRNGKey(trial)
        want_p, want_acc = jt.swap_within_batch(
            key, _Cuts(jnp.asarray(cut)), _jax_params(log_base, beta),
            n_rungs, parity)
        params = make_params(base, 0.0, 0.0, [1, -1], n_chains=c,
                             device="cpu")
        params.beta = torch.as_tensor(beta)
        assert torch.equal(params.log_base, torch.as_tensor(log_base))
        got_p, got_acc = tt.swap_within_batch(
            rng.prng_key(trial), _Cuts(torch.as_tensor(cut)), params,
            n_rungs, parity)
        # the logs of the pair uniforms in both packages: a decision may
        # differ only where they do
        u = tt.pair_uniforms(rng.prng_key(trial), c)
        tiny = torch.tensor(1e-12)
        log_t = torch.log(torch.maximum(u, tiny)).numpy()
        log_j = np.asarray(jnp.log(jnp.maximum(jnp.asarray(u.numpy()),
                                               1e-12)))
        tie = log_t != log_j
        ties += int(tie.sum())
        differ = got_acc.numpy() != np.asarray(want_acc)
        flips += int(differ.sum())
        assert not (differ & ~tie).any(), trial
        if not differ.any():
            np.testing.assert_array_equal(got_p.beta.numpy(),
                                          np.asarray(want_p.beta))
    # the logs differ on a few uniforms (ties, counted), and no decision
    # flipped on them in these draws
    assert flips == 0, (flips, ties)


def test_chain_rungs_match_jax():
    """``chain_rungs`` and the host mirror ``_host_rungs`` against the JAX
    package's, on ladders with duplicate betas."""
    r = np.random.default_rng(3)
    for ladder in ([2.0, 1.0, 1.0, 0.5], [1.0, 1.0, 1.0],
                   [4.0, 2.0, 1.0, 0.5, 0.25]):
        n = len(ladder)
        for _ in range(10):
            beta = np.concatenate([r.permutation(ladder)
                                   for _ in range(6)]).astype(np.float32)
            want, want_pos = jt.chain_rungs(jnp.asarray(beta), n)
            got, got_pos = tt.chain_rungs(torch.as_tensor(beta), n)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(got_pos.numpy(),
                                          np.asarray(want_pos))
            np.testing.assert_array_equal(ttd._host_rungs(beta, n),
                                          np.asarray(want))


BETAS = (1.0, 0.9, 0.8)


def _temper_pair(path, n_steps=41, swap_every=10, record_every=1):
    """The JAX package's and the port's run_tempered from their own
    init_tempered, two ladders of ``BETAS``."""
    if path == "board":
        g, tg = fce.graphs.frankengraph(), tgraphs.frankengraph()
        plan, tplan = fce.graphs.frank_plan(g, 0), tgraphs.frank_plan(tg, 0)
    else:
        g, tg = fce.graphs.hex_lattice(3, 4), tgraphs.hex_lattice(3, 4)
        plan = fce.graphs.stripes_plan(g, 2)
        tplan = tgraphs.stripes_plan(tg, 2)
    spec = fce.Spec(contiguity="patch", record_interface=False)
    kw = dict(betas=BETAS, n_ladders=2, seed=3, base=1 / 0.3, pop_tol=0.1)
    h, st, par = jtd.init_tempered(g, plan, spec=spec, **kw)
    th, tst, tpar = ttd.init_tempered(tg, tplan, spec=spec_port(spec),
                                      device="cpu", **kw)
    run = dict(n_steps=n_steps, betas=BETAS, n_ladders=2,
               swap_every=swap_every, swap_seed=7, record_every=record_every)
    want = jtd.run_tempered(h, spec, par, st,
                            bits=False if path == "board" else None, **run)
    got = ttd.run_tempered(th, spec_port(spec), tpar, tst, **run)
    return got, want


def assert_temper_equal(got, want):
    assert type(got.state).__name__ == type(want.state).__name__
    np.testing.assert_array_equal(got.beta_hist, want.beta_hist)
    np.testing.assert_array_equal(got.swap_attempts, want.swap_attempts)
    np.testing.assert_array_equal(got.swap_accepts, want.swap_accepts)
    np.testing.assert_array_equal(got.params.beta.numpy(),
                                  np.asarray(want.params.beta))
    assert got.end_parity == want.end_parity
    np.testing.assert_array_equal(got.end_swap_key.numpy(),
                                  np.asarray(want.end_swap_key))
    assert sorted(got.history) == sorted(want.history)
    bad = assert_waits_close(got.history["wait"], want.history["wait"])
    n_bad = bad.sum(axis=1)
    for k in sorted(set(want.history) - {"wait"}):
        np.testing.assert_array_equal(got.history[k],
                                      np.asarray(want.history[k]), err_msg=k)
        np.testing.assert_array_equal(ttd.per_rung_history(got, k),
                                      jtd.per_rung_history(want, k),
                                      err_msg=k)
    assert_wait_sums_close(got.waits_total, want.waits_total, n_bad)
    gs = got.host_state()
    for f, v in gs.items():
        w = np.asarray(getattr(want.state, f))
        if f == "cur_wait":
            assert_waits_close(v, w, f)
        elif f == "waits_sum":
            assert_wait_sums_close(v, w, n_bad, f)
        else:
            np.testing.assert_array_equal(v, w.astype(v.dtype), err_msg=f)


@pytest.mark.parametrize("path", ["board", "general"])
def test_run_tempered_matches_jax(path):
    got, want = _temper_pair(path)
    assert_temper_equal(got, want)
    assert got.swap_accepts.sum() > 0
    assert got.beta_hist.shape == (4, 6)


def test_run_tempered_thinned_matches_jax():
    """``record_every`` on the board path: the thinned grid survives the
    round boundaries and the rung reconstruction."""
    got, want = _temper_pair("board", n_steps=41, swap_every=10,
                             record_every=5)
    assert_temper_equal(got, want)
    assert got.history["cut_count"].shape == (6, 9)


@pytest.mark.parametrize("path", ["general", "board"])
def test_single_rung_matches_plain_runner(path):
    """A 1-rung ladder is the plain runner: nothing to swap, and the
    orchestration adds nothing (the port's copy of
    ``tests/test_tempered.py``'s first test; the general path's plain
    runner on the legacy body, the one the tempered general path runs)."""
    g = tgraphs.square_grid(6, 6)
    plan = tgraphs.stripes_plan(g, 2)
    kw = dict(n_chains=6, seed=3, base=1.3, pop_tol=0.3, device="cpu")
    if path == "board":
        spec = Spec(contiguity="patch")
        h, st, params = init_board(g, plan, spec=spec, **kw)
        plain = run_board(h, spec, params, st, n_steps=161, chunk=40,
                          device="cpu")
    else:
        spec = Spec(contiguity="patch", record_interface=True)
        h, st, params = init_batch(g, plan, spec=spec, **kw)
        plain = run_chains(h, spec, params, st, n_steps=161, chunk=40,
                           kernel_path="general")
    assert isinstance(plain, RunResult)
    h2, st2, params2 = ttd.init_tempered(
        g, plan, betas=[1.0], n_ladders=6, seed=3, spec=spec, base=1.3,
        pop_tol=0.3, device="cpu")
    res = ttd.run_tempered(h2, spec, params2, st2, n_steps=161,
                           betas=[1.0], n_ladders=6, swap_every=40)
    assert set(res.history) == set(plain.history)
    for k in plain.history:
        np.testing.assert_array_equal(res.history[k], plain.history[k],
                                      err_msg=k)
    sp, sr = plain.host_state(), res.host_state()
    assert sorted(sp) == sorted(sr)
    for f in sp:
        np.testing.assert_array_equal(sp[f], sr[f], err_msg=f)
    np.testing.assert_allclose(res.waits_total, plain.waits_total)
    assert res.swap_attempts.sum() == 0


def test_refusals():
    tg = tgraphs.square_grid(5, 5)
    spec = Spec(contiguity="patch")
    h, st, params = ttd.init_tempered(
        tg, tgraphs.stripes_plan(tg, 2), betas=[1.0, 0.5], n_ladders=2,
        seed=0, spec=spec, base=1.0, pop_tol=0.5, device="cpu")
    run = dict(betas=[1.0, 0.5], n_ladders=2, swap_every=4)
    with pytest.raises(ValueError, match="A11"):
        ttd.run_tempered(h, spec, params, st, 9, recorder=object(), **run)
    with pytest.raises(ValueError, match="batch size"):
        ttd.run_tempered(h, spec, params, st, 9, betas=[1.0, 0.5, 0.2],
                         n_ladders=2, swap_every=4)
    with pytest.raises(ValueError, match="anneal"):
        tt.swap_within_batch(rng.prng_key(0), st, params, 2, 0,
                             spec=Spec(anneal="linear"))
