"""Experiment configuration: the reference's sweep grids as data.

The reference encodes configuration in module constants + nested loops +
output filenames (SURVEY.md section 5 'Config / flag system';
grid_chain_sec11.py:33-36,182-184). Here a config is a dataclass; the
filename tag is byte-compatible: ``{alignment}B{int(100*base)}P{int(100*pop)}``
(grid_chain_sec11.py:323) — note int() truncation, e.g. 1/0.3 -> "333",
mu -> "263".

The port's copy of ``flipcomplexityempirical_tpu/experiments/config.py``:
the same fields, tags, node sizes and sweeps, so a tag names the same
config in both packages. ``backend`` has one value, ``"torch"``.
``fingerprint`` hashes the JAX package's payload, so a config's
fingerprint here equals the JAX package's for the same fields; the sweep
service (``service/scheduler.py``) coalesces the configs that share one.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Iterator

MU = 2.63815853  # Z^2 SAW connective constant (grid_chain_sec11.py:33)

SEC11_BASES = [.1, 1 / MU ** 2, .2, 1 / MU, .8, 1, MU, 4, MU ** 2, 10]
SEC11_POPS = [.01, .05, .1, .5, .9]
FRANK_BASES = [.3, 1 / .3]
FRANK_POPS = [.05, .1, .5, .9]


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    family: str               # 'sec11' | 'frank' | 'kpair' | 'tri' |
                              # 'hex' | 'temper' | 'dual'
    alignment: int            # 0 | 1 | 2 (sec11/frank/temper); stripe
                              # axis 0 | 1 (kpair/tri/hex/dual)
    base: float
    pop_tol: float
    total_steps: int = 100_000
    n_chains: int = 8         # reference runs 1; chain 0 renders artifacts
    seed: int = 0
    backend: str = "torch"    # this package's only backend
    contiguity: str = "patch"  # 'patch' | 'exact'
    accept: str = "cut"       # 'cut' | 'corrected'
    checkpoint_every: int = 0  # steps between mid-config checkpoints
                               # (0 = only at completion); resume picks up
                               # from the last saved segment
    propose_parallel: int = 1  # kernel/step.py Spec.propose_parallel:
                               # candidates per re-propose round (batch
                               # accelerators benefit from >1)
    # --- widened families (BASELINE.json configs 2-5) ---
    n_districts: int = 2      # kpair/dual: k districts via the pair walk
    grid: int = 64            # kpair: board side (n x n rook grid)
    lattice_m: int = 14       # tri/hex: generator rows
    lattice_n: int = 28       # tri/hex: generator cols
    betas: tuple = ()         # temper: the beta ladder, rung 0 first
    swap_every: int = 0       # temper: transitions between swap rounds
    dual_nx: int = 12         # dual: synthetic-precinct state is nx x ny
    dual_ny: int = 12
    dual_source: str = "quads"  # dual: 'quads' (jittered lattice) |
                                # 'voronoi' (irregular-degree cells)
    record_every: int = 1     # history thinning through the runners
    chain: str = "flip"       # 'flip' (single-node flip walk) | 'recom'
                              # (spanning-tree ReCom, sampling/recom.py)
    variant: str = "none"     # proposal variant: 'none' | 'nobacktrack'
                              # (arxiv 1204.4140) | 'lazy' (lazy-uniform
                              # reweighting riding the geometric waits)
    analytics: str = "history"  # telemetry plane: 'history' (oracle
                                # path; full per-step histories read
                                # back per chunk) | 'summary'
                                # (device-resident accumulators; one
                                # small summary pytree per chunk)

    @property
    def tag(self) -> str:
        core = (f"{self.alignment}B{int(100 * self.base)}"
                f"P{int(100 * self.pop_tol)}")
        if self.family in ("sec11", "frank"):
            # reference families keep the reference's exact filename tag
            # (grid_chain_sec11.py:323)
            t = core
        # widened families prefix the family (artifact filenames and
        # checkpoint keys must not collide when sweeps share an output
        # or checkpoint directory) and their sweep-varying parameters
        elif self.family == "dual" and self.dual_source != "quads":
            t = (f"{self.family}-{self.dual_source[:3].upper()}-"
                 f"K{self.n_districts}-{core}")
        elif self.family in ("kpair", "dual"):
            t = f"{self.family}-K{self.n_districts}-{core}"
        elif self.family == "temper":
            t = (f"{self.family}-{core}"
                 f"R{len(self.betas)}S{self.swap_every}")
        else:
            t = f"{self.family}-{core}"
        # non-default chain/variant wrap the tag so artifacts and
        # checkpoint keys never collide with the flip walk's
        if self.chain != "flip":
            t = f"{self.chain}-{t}"
        if self.variant != "none":
            t = f"{t}-{self.variant[:4].upper()}"
        return t

    def fingerprint(self) -> str:
        """Content hash over the KERNEL-RELEVANT statics: two configs
        with equal fingerprints build the same graph, the same Spec, and
        the same run shape (steps, thinning), so the service scheduler
        may coalesce them into one batch of chains.

        Deliberately EXCLUDED — everything that varies per tenant
        without changing the kernel's inputs beyond per-chain rows:
        ``alignment`` (initial plan only), ``base``/``pop_tol``
        (per-chain StepParams leaves), ``seed`` (per-chain PRNG state;
        except the dual family, whose geometry generation consumes it),
        ``n_chains`` (the batch axis being coalesced),
        ``checkpoint_every`` (host-side segmenting). Hashed as sorted
        canonical JSON — independent of field ordering; the payload and
        its conditional keys are the JAX package's, so equal fields
        give equal fingerprints in both packages."""
        payload = {
            "family": self.family,
            "backend": self.backend,
            "contiguity": self.contiguity,
            "accept": self.accept,
            "propose_parallel": self.propose_parallel,
            "n_districts": self.n_districts,
            "grid": self.grid,
            "lattice": [self.lattice_m, self.lattice_n],
            "betas": [float(b) for b in self.betas],
            "swap_every": self.swap_every,
            "dual": [self.dual_nx, self.dual_ny, self.dual_source],
            "total_steps": self.total_steps,
            "record_every": self.record_every,
        }
        if self.family == "dual":
            payload["seed"] = self.seed
        # appended conditionally, as in the JAX package, so configs that
        # leave these at their defaults keep the same hash there and here
        if self.chain != "flip":
            payload["chain"] = self.chain
        if self.variant != "none":
            payload["variant"] = self.variant
        if self.analytics != "history":
            payload["analytics"] = self.analytics
        blob = json.dumps(payload, sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]

    @property
    def plot_node_size(self) -> int:
        # grid_chain_sec11.py:188 ns=120; Frankenstein_chain.py:37 ns=500
        if self.family in ("frank", "temper"):
            return 500
        if self.family in ("tri", "hex", "dual"):
            return 60
        return 120 if self.family == "sec11" else 10


def sec11_sweep(**overrides) -> Iterator[ExperimentConfig]:
    """The 150-config sec11 grid (grid_chain_sec11.py:182-184; alignment
    iterates [2,1,0])."""
    for pop, base, al in itertools.product(SEC11_POPS, SEC11_BASES,
                                           [2, 1, 0]):
        yield ExperimentConfig(family="sec11", alignment=al, base=base,
                               pop_tol=pop, **overrides)


def frank_sweep(**overrides) -> Iterator[ExperimentConfig]:
    """The 24-config Frankengraph grid (Frankenstein_chain.py:182-184)."""
    for pop, base, al in itertools.product(FRANK_POPS, FRANK_BASES,
                                           [2, 1, 0]):
        yield ExperimentConfig(family="frank", alignment=al, base=base,
                               pop_tol=pop, **overrides)


def kpair_sweep(**overrides) -> Iterator[ExperimentConfig]:
    """BASELINE config 2: k-district (k=4, 8) pair walks on the 64x64
    grid (slow_reversible_propose semantics, grid_chain_sec11.py:117-130),
    routed through the board pair fast path."""
    for k, base, al in itertools.product([4, 8], [0.8, MU], [0, 1]):
        yield ExperimentConfig(family="kpair", alignment=al, base=base,
                               pop_tol=0.5, n_districts=k, **overrides)


def tri_sweep(**overrides) -> Iterator[ExperimentConfig]:
    """BASELINE config 3a: 2-district flip walk on a triangular lattice
    (non-grid planar adjacency)."""
    for base, al in itertools.product(FRANK_BASES, [0, 1]):
        yield ExperimentConfig(family="tri", alignment=al, base=base,
                               pop_tol=0.1, **overrides)


def hex_sweep(**overrides) -> Iterator[ExperimentConfig]:
    """BASELINE config 3b: 2-district flip walk on a hexagonal lattice."""
    for base, al in itertools.product(FRANK_BASES, [0, 1]):
        yield ExperimentConfig(family="hex", alignment=al, base=base,
                               pop_tol=0.1, **overrides)


# The default FRANK B333 ladder spans [1.0, 0.63]: the order-disorder
# transition sits near beta ~ 0.65 (REPLICATION.md "Tempering the B333
# bimodal regime"), so the hottest rungs melt the interface and refreeze
# it into a fresh mode, while 0.03-0.05 spacing keeps every adjacent
# swap rate above ~0.4. A naive wide ladder (1.0 .. 0.25, spacing 0.15)
# measured swap rates ~0.005 past the transition — betas beyond the melt
# point buy nothing and starve the ladder.
TEMPER_BETAS = (1.0, .95, .9, .85, .8, .76, .72, .69, .66, .63)


def temper_sweep(**overrides) -> Iterator[ExperimentConfig]:
    """BASELINE config 4: beta-tempered Frankengraph chains with replica
    exchange, centred on the slow-mixing bimodal B333 regime
    (REPLICATION.md). The cold rung (beta=1) is the physical chain."""
    overrides.setdefault("betas", TEMPER_BETAS)
    overrides.setdefault("swap_every", 50)
    for al in [0, 1, 2]:
        yield ExperimentConfig(family="temper", alignment=al,
                               base=1 / .3, pop_tol=0.1, **overrides)


def dual_sweep(**overrides) -> Iterator[ExperimentConfig]:
    """BASELINE config 5: k districts on a precinct dual graph (synthetic
    jittered-quad state; from_geojson also ingests real shapefiles), with
    boundary-length Metropolis and Polsby-Popper compactness scores."""
    for k, al in itertools.product([4, 8], [0, 1]):
        yield ExperimentConfig(family="dual", alignment=al, base=MU,
                               pop_tol=0.25, n_districts=k, **overrides)


SWEEPS = {
    "sec11": sec11_sweep,
    "frank": frank_sweep,
    "kpair": kpair_sweep,
    "tri": tri_sweep,
    "hex": hex_sweep,
    "temper": temper_sweep,
    "dual": dual_sweep,
}
