"""The port's sweep service on the CPU: fingerprints, grouping, refusals
and the entry points.

- ``ExperimentConfig.fingerprint()`` of the port equals the JAX package's
  (pure python, no JAX computation) for every config of the sec11, frank,
  tri and hex sweeps, and under overrides of the run shape, the lattice,
  the contiguity, the variant and the other conditional payload keys;
  each sweep is one fingerprint group.
- ``SweepService._form_groups`` gives the JAX package's submission-ordered
  greedy partition (written out below), with and without
  ``max_batch_chains``, and a job with a checkpoint on disk stays solo.
- What the port leaves out is refused by its ROADMAP.md item: the
  unported families and chains at submission (a summary-mode config is
  accepted), the service's
  host layers (journal, recorder, retries, ...), the CLI's other flags
  and subcommands, and ``--service`` beside a kernel-path flag of the
  bench.
- The CLI, ``run_simulation`` and ``bench --cpu --service`` each run once
  at a tiny size on the kernels' plain versions.
"""

import dataclasses
import json

import pytest

from flipcomplexityempirical_tpu.experiments import config as jax_config
from flipcomplexityempirical_tpu_torch import bench
from flipcomplexityempirical_tpu_torch.experiments import config
from flipcomplexityempirical_tpu_torch.service import SweepService
from flipcomplexityempirical_tpu_torch.service import __main__ as cli

SWEEPS = ("sec11", "frank", "tri", "hex")
# (name, sweep, overrides) beyond each sweep's defaults: the paper's run
# shape, other run shapes and thinning, the lattice, the contiguity, the
# variants and the conditional payload keys (chain, analytics, the dual
# family's seed)
OVERRIDES = (
    ("paper shape", "sec11", dict(total_steps=100_000, n_chains=8)),
    ("steps 401", "frank", dict(total_steps=401, n_chains=2)),
    ("record_every 4", "frank", dict(record_every=4)),
    ("lattice 6x10", "hex", dict(lattice_m=6, lattice_n=10)),
    ("lattice 4x6 tri", "tri", dict(lattice_m=4, lattice_n=6)),
    ("contiguity exact", "hex", dict(contiguity="exact")),
    ("variant nobacktrack", "hex", dict(variant="nobacktrack")),
    ("variant lazy", "tri", dict(variant="lazy")),
    ("accept corrected", "frank", dict(accept="corrected")),
    ("propose_parallel 4", "sec11", dict(propose_parallel=4)),
    ("chain recom", "frank", dict(chain="recom")),
    ("analytics summary", "frank", dict(analytics="summary")),
    ("checkpoint_every 50", "frank", dict(checkpoint_every=50)),
    ("dual seed 5", "dual", dict(seed=5)),
    ("temper", "temper", {}),
    ("kpair", "kpair", {}),
)
CASES = ([pytest.param(c, id=f"{name}-{c.tag}")
          for name in SWEEPS for c in config.SWEEPS[name]()]
         + [pytest.param(c, id=f"{label}-{c.tag}")
            for label, name, kw in OVERRIDES
            for c in list(config.SWEEPS[name](**kw))[:2]])


@pytest.mark.parametrize("cfg", CASES)
def test_fingerprint_equals_jax(cfg):
    want = jax_config.ExperimentConfig(**dataclasses.asdict(cfg))
    assert want.backend == "torch"
    assert cfg.fingerprint() == want.fingerprint()


def test_each_sweep_is_one_fingerprint_group():
    """Every config of a sweep shares one fingerprint (so the service runs
    the sweep as one batch), and the four sweeps' differ."""
    fps = {name: {c.fingerprint() for c in config.SWEEPS[name]()}
           for name in SWEEPS}
    assert all(len(v) == 1 for v in fps.values()), fps
    assert len(set().union(*fps.values())) == len(SWEEPS)


def _jobs(svc, *specs):
    """Submit configs (family, alignment, base, chains) at 41 steps."""
    return [svc.submit(config.ExperimentConfig(
        family=fam, alignment=al, base=base, pop_tol=0.1, total_steps=41,
        n_chains=chains, lattice_m=4, lattice_n=6))
        for fam, al, base, chains in specs]


SPECS = (("frank", 0, 0.3, 2), ("frank", 1, 0.3, 2), ("hex", 0, 0.3, 2),
         ("frank", 2, 0.3, 2), ("hex", 1, 0.3, 2), ("sec11", 0, 0.3, 2))


@pytest.mark.parametrize("max_chains,solo,want", [
    (None, None, [[0, 1, 3], [2, 4], [5]]),
    (4, None, [[0, 1], [2, 4], [3], [5]]),
    (None, 1, [[0, 3], [1], [2, 4], [5]]),
], ids=["unbounded", "max_batch_chains 4", "checkpointed job solo"])
def test_form_groups_is_the_jax_rule(tmp_path, max_chains, solo, want):
    ck = tmp_path / "ck"
    svc = SweepService(str(tmp_path / "out"), checkpoint_dir=str(ck),
                       max_batch_chains=max_chains, device="cpu")
    jobs = _jobs(svc, *SPECS)
    if solo is not None:
        ck.mkdir()
        (ck / f"{jobs[solo].tag}.npz").write_bytes(b"")
    groups = svc._form_groups(svc.queue.runnable())
    assert [[jobs.index(j) for j in grp] for grp in groups] == want


@pytest.mark.parametrize("kw", [
    dict(family="temper", betas=(1.0, 0.9), swap_every=5),
    dict(family="kpair", n_districts=4, grid=8),
], ids=["temper", "kpair"])
def test_submit_runs_kpair_and_temper(tmp_path, kw):
    """The families that waited for ROADMAP.md A7b and A8 are queued and
    run: two kpair configs coalesce into one batch on the board pair
    kernel's path, temper jobs run solo (their swap state is the run's),
    each through the driver's own run."""
    svc = SweepService(str(tmp_path), device="cpu")
    jobs = [svc.submit(config.ExperimentConfig(
        alignment=al, base=0.3, pop_tol=0.5, total_steps=21, n_chains=2,
        **kw)) for al in (0, 1)]
    svc.run_until_idle()
    assert svc.exit_code == 0
    assert all(j.status == "done" for j in jobs)
    if kw["family"] == "kpair":
        [batch] = svc.batch_stats
        assert len(batch.jobs) == 2 and batch.kernel_path == "board"
    else:
        assert [len(b.jobs) for b in svc.batch_stats] == [1, 1]
        assert all(b.chains == 4 for b in svc.batch_stats)
        for j in jobs:
            assert j.result["rung_cut"].shape == (2, 21)


@pytest.mark.parametrize("kw,item", [
    (dict(family="dual", n_districts=4, chain="gibbs"), "chain 'gibbs'"),
    (dict(family="frank", chain="recom", backend="python"),
     "runs 'torch' only"),
    (dict(family="frank", variant="nobacktrack", analytics="fold"),
     "analytics 'fold'"),
], ids=["dual unknown chain", "recom backend", "frank variant analytics"])
def test_submit_refuses_unported(tmp_path, kw, item):
    svc = SweepService(str(tmp_path), device="cpu")
    cfg = config.ExperimentConfig(alignment=0, base=0.3, pop_tol=0.1, **kw)
    with pytest.raises(ValueError, match=item):
        svc.submit(cfg)
    assert len(svc.queue) == 0


@pytest.mark.parametrize("kw", [
    dict(family="dual", n_districts=4, chain="recom"),
    dict(family="frank", chain="recom"),
    dict(family="frank", variant="nobacktrack", chain="recom"),
], ids=["dual", "recom", "frank variant"])
def test_submit_queues_recom_solo(tmp_path, kw):
    """ReCom configs, refused while A9 was open, are queued and run solo
    (never coalesced), as the JAX service runs them."""
    svc = SweepService(str(tmp_path), device="cpu")
    cfg = config.ExperimentConfig(alignment=0, base=0.3, pop_tol=0.1, **kw)
    job = svc.submit(cfg)
    assert len(svc.queue) == 1 and svc._solo_only(job)


def test_submit_accepts_summary(tmp_path):
    """A summary-mode config is queued, as the JAX service queues it (its
    batch then runs in history mode)."""
    svc = SweepService(str(tmp_path), device="cpu")
    cfg = config.ExperimentConfig(family="frank", alignment=0, base=0.3,
                                  pop_tol=0.1, analytics="summary")
    job = svc.submit(cfg)
    assert len(svc.queue) == 1 and job.config.analytics == "summary"


@pytest.mark.parametrize("kw", [
    {"recorder": object()}, {"heartbeat": "hb.json"},
    {"compile_cache": object()}, {"policy": object()},
    {"journal": "journal.jsonl"}, {"dispatch_timeout": 5.0},
    {"control": object()}], ids=lambda kw: next(iter(kw)))
def test_service_host_layers_refused(tmp_path, kw):
    with pytest.raises(ValueError, match="A11"):
        SweepService(str(tmp_path), device="cpu", **kw)


def test_recover_refused(tmp_path):
    with pytest.raises(ValueError, match="A11"):
        SweepService.recover(str(tmp_path), device="cpu")


@pytest.mark.parametrize("argv", [
    ["serve", "root"], ["worker", "root"], ["submit", "http://x"],
    ["status", "http://x"], ["--events", "e.jsonl"], ["--heartbeat=h"],
    ["--compile-cache", "c"], ["--faults", "segment.step:once"],
    ["--retries", "1"], ["--quarantine-after", "1"], ["--deadline", "9"],
    ["--dispatch-timeout", "9"], ["--recover"]],
    ids=lambda a: a[0].split("=")[0])
def test_cli_refuses_unported(tmp_path, capsys, argv):
    assert cli.main(["--cpu", "--out", str(tmp_path)] + argv
                    if argv[0].startswith("--") else argv) == 2
    assert "A11" in capsys.readouterr().err


def test_cli_runs_the_temper_family(tmp_path, capsys):
    """``--family temper`` (refused while ROADMAP.md A8 waited) runs a
    config solo through the driver's temper run."""
    assert cli.main(["--cpu", "--family", "temper", "--out",
                     str(tmp_path), "--chains", "1", "--steps", "11",
                     "--only", "temper-0B333P10R10S50"]) == 0
    out = capsys.readouterr().out
    assert "[done] j0000 temper-0B333P10R10S50" in out and "1 jobs 10 chains" in out


def test_cli_without_card_fails(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(cli.torch.cuda, "is_available", lambda: False)
    assert cli.main(["--family", "frank", "--out", str(tmp_path)]) == 1
    assert "--cpu" in capsys.readouterr().err


def test_cli_runs_one_batch(tmp_path, capsys):
    tags = ["0B30P10", "2B333P90"]
    code = cli.main(["--cpu", "--family", "frank", "--out", str(tmp_path),
                     "--steps", "41", "--chains", "1", "--seed", "0",
                     "--only", *tags])
    out = capsys.readouterr().out.splitlines()
    assert code == 0, out
    done = [line for line in out if line.startswith("[done]")]
    assert [line.split()[2] for line in done] == [
        c.tag for c in config.frank_sweep() if c.tag in tags]
    batch = [line for line in out if line.startswith("[batch]")]
    assert len(batch) == 1 and " 2 jobs 2 chains 41 steps lowered_bits" \
        in batch[0] and batch[0].endswith("launches 0")


def test_run_simulation_record(tmp_path):
    rec = cli.run_simulation(tenants=3, chains=1, steps=21, device="cpu",
                             outdir=str(tmp_path))
    assert rec["metric"] == "tenant_efficiency" and rec["unit"] == "ratio"
    assert rec["value"] > 0 and rec["tenants"] == 3
    assert rec["kernel_path"] == "lowered_bits" and rec["device"] == "cpu"
    assert rec["serial_service_s"] == pytest.approx(
        3 * rec["solo_turnaround_s"], abs=2e-3)


def test_bench_cpu_service(capsys):
    code = bench.main(["--cpu", "--service", "--tenants", "2", "--chains",
                       "1", "--steps", "21"])
    out, err = capsys.readouterr()
    assert code == 0, err
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["metric"] == "tenant_efficiency" and rec["cpu_fallback"]
    assert rec["family"] == "frank" and rec["steps"] == 21
    meta = json.loads(err.strip().splitlines()[-1])
    assert meta["mode"] == "service" and meta["device"] == "cpu"


@pytest.mark.parametrize("flag", ["--pallas", "--general", "--body"])
def test_bench_service_refuses_kernel_flags(capsys, flag):
    argv = ["--cpu", "--service", flag] + (["bits"] if flag == "--body"
                                          else [])
    assert bench.main(argv) == 2
    assert "incompatible with --service" in capsys.readouterr().err

