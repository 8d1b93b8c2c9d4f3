"""The port's experiment configs and sweep loop against the JAX package's.

Tolerance: tags, node sizes and checkpoint identities are byte-equal for
every config of every sweep; everything else here is exact behaviour
(refusals, skips, exit codes). No chain runs in this file.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest
import torch

from flipcomplexityempirical_tpu.experiments import config as jconfig
from flipcomplexityempirical_tpu.experiments import driver as jdriver
from flipcomplexityempirical_tpu_torch.experiments import artifacts as tart
from flipcomplexityempirical_tpu_torch.experiments import config as tconfig
from flipcomplexityempirical_tpu_torch.experiments import driver as tdriver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(total_steps=41, n_chains=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The runs here are small: one intra-op thread is as fast alone and
    keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("family", sorted(jconfig.SWEEPS))
def test_tags_sizes_identities_match_jax(family):
    jax_cfgs = list(jconfig.SWEEPS[family]())
    port_cfgs = list(tconfig.SWEEPS[family]())
    assert len(port_cfgs) == len(jax_cfgs)
    for jc, tc in zip(jax_cfgs, port_cfgs):
        fields = {f.name: getattr(jc, f.name)
                  for f in dataclasses.fields(jc) if f.name != "backend"}
        assert fields == {k: getattr(tc, k) for k in fields}
        assert tc.backend == "torch"
        assert tc.tag == jc.tag
        assert tc.plot_node_size == jc.plot_node_size
        assert tdriver._ckpt_identity(tc) == jdriver._ckpt_identity(jc)


def test_sweep_sizes_and_constants():
    assert len(list(tconfig.sec11_sweep())) == 150
    assert len(list(tconfig.frank_sweep())) == 24
    for name in ("MU", "SEC11_BASES", "SEC11_POPS", "FRANK_BASES",
                 "FRANK_POPS", "TEMPER_BETAS"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert tart.ARTIFACT_KINDS == jdriver.artifact_kinds("sec11")
    for fam in jconfig.SWEEPS:
        assert tart.artifact_kinds(fam) == jdriver.artifact_kinds(fam)


@pytest.mark.parametrize("kw", [
    dict(family="kpair", n_districts=4),
    dict(family="kpair", n_districts=3),
    dict(family="temper", betas=(1.0, 0.9), swap_every=10),
], ids=["family=kpair-n_districts=4-A7b", "family=kpair-n_districts=3-A7b",
        "family=temper-betas=(1.0, 0.9)-swap_every=10-A8"])
def test_kpair_and_temper_configs_run(kw, tmp_path):
    """The kpair and temper configs that were refused while ROADMAP.md A7b
    and A8 waited now run (kpair on an 8 x 8 grid here) and leave every
    artifact of their family."""
    kw = dict(dict(alignment=0, base=0.3, pop_tol=0.5), **SMALL, **kw)
    if kw["family"] == "kpair":
        kw["grid"] = 8
    cfg = tconfig.ExperimentConfig(**kw)
    [(_, data)] = tdriver.run_sweep([cfg], str(tmp_path), device="cpu",
                                    verbose=False)
    assert tdriver.is_done(cfg, str(tmp_path))
    assert data["history"]["cut_count"].shape[1] == SMALL["total_steps"]
    if cfg.family == "temper":
        assert data["rung_cut"].shape == (2, SMALL["total_steps"])
        # 3 swap rounds of parity 0, 1, 0: pair (0, 1) tried twice a ladder
        assert data["swapstats"]["attempts"] == [2 * SMALL["n_chains"]]


@pytest.mark.parametrize("kw, missing", [
    (dict(family="tri", chain="recom", analytics="summary"),
     "the recom chain stays on the history"),
    (dict(family="dual", n_districts=4, variant="nobacktrack"),
     "2-district 'bi' walk"),
    (dict(family="frank", accept="corrected"), "B4"),
    (dict(family="sec11", chain="gibbs"), "chain 'gibbs'"),
    (dict(family="sec11", accept="corrected"), "B4"),
    (dict(family="dual", n_districts=8, chain="recom", backend="python"),
     "runs 'torch' only"),
], ids=lambda x: x if isinstance(x, str) else "-".join(
    f"{k}={v}" for k, v in x.items()))
def test_unported_configs_are_refused(kw, missing, tmp_path):
    kw = dict(dict(alignment=0, base=0.3, pop_tol=0.5), **SMALL, **kw)
    cfg = tconfig.ExperimentConfig(**kw)
    with pytest.raises(ValueError, match=missing):
        tdriver.run_sweep([cfg], str(tmp_path), device="cpu",
                          verbose=False)
    assert not os.listdir(tmp_path)        # nothing written, nothing run


@pytest.mark.parametrize("kw", [dict(family="hex", analytics="summary"),
                                dict(family="sec11", analytics="summary")],
                         ids=["family=hex-analytics=summary",
                              "family=sec11-analytics=summary"])
def test_summary_configs_run(kw, tmp_path):
    """The configs that were refused while summary mode waited for the
    device analytics now run, with their summary in the data."""
    cfg = tconfig.ExperimentConfig(
        **dict(dict(alignment=0, base=0.3, pop_tol=0.5), **SMALL, **kw))
    [(_, data)] = tdriver.run_sweep([cfg], str(tmp_path), device="cpu",
                                    verbose=False)
    assert tdriver.is_done(cfg, str(tmp_path))
    assert int(data["summary"]["n"]) == SMALL["total_steps"]


def test_run_sweep_skips_finished_config(tmp_path, capsys):
    cfg = tconfig.ExperimentConfig(family="frank", alignment=2, base=0.3,
                                   pop_tol=0.1, **SMALL)
    for kind in tart.ARTIFACT_KINDS:
        (tmp_path / (cfg.tag + kind)).write_text("")
    assert tdriver.is_done(cfg, str(tmp_path))
    assert tdriver.count_artifacts(cfg, str(tmp_path)) == 13
    assert tdriver.run_sweep([cfg], str(tmp_path), device="cpu") == []
    assert f"[skip] frank {cfg.tag}" in capsys.readouterr().out
    os.remove(tmp_path / (cfg.tag + "wait.txt"))
    assert not tdriver.is_done(cfg, str(tmp_path))
    assert tdriver.count_artifacts(cfg, str(tmp_path)) == 12


def test_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = tconfig.ExperimentConfig(family="frank", alignment=0, base=0.3,
                                   pop_tol=0.5, **SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdriver.run_config(cfg, str(tmp_path))
    assert not os.listdir(tmp_path)


def test_cli_without_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    out = subprocess.run(
        [sys.executable, "-m", "flipcomplexityempirical_tpu_torch.experiments",
         "--family", "frank", "--only", "0B30P10", "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not os.listdir(tmp_path)


def test_cli_refuses_unknown_tag(tmp_path):
    from flipcomplexityempirical_tpu_torch.experiments.__main__ import main
    with pytest.raises(SystemExit) as exc:
        main(["--family", "sec11", "--only", "9B9P9", "--out",
              str(tmp_path), "--device", "cpu"])
    assert "no sec11 config" in str(exc.value.code)


def test_cli_contiguity_is_patch_only(tmp_path, capsys):
    """'exact' contiguity runs on the general path's legacy body, the
    Frankengraph's with its interface metrics: the CLI runs a config of
    it and writes its 13 artifacts; any other contiguity is refused by
    the parser."""
    from flipcomplexityempirical_tpu_torch.experiments.__main__ import main
    main(["--family", "frank", "--contiguity", "exact", "--only",
          "0B30P50", "--steps", "30", "--chains", "1", "--out",
          str(tmp_path), "--device", "cpu"])
    assert len(os.listdir(tmp_path)) == 13
    shutil.rmtree(tmp_path)
    tmp_path.mkdir()
    with pytest.raises(SystemExit) as exc:
        main(["--family", "frank", "--contiguity", "ring", "--out",
              str(tmp_path), "--device", "cpu"])
    assert exc.value.code == 2
    assert "invalid choice: 'ring'" in capsys.readouterr().err
