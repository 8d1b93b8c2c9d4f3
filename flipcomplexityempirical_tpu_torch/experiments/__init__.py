"""The paper's experiment driver on the card: the sec11, Frankengraph,
kpair, triangular, hexagonal, temper and dual sweeps, segmented runs with
checkpoint resume, each family's artifacts, and the CLI (``python -m
flipcomplexityempirical_tpu_torch.experiments``). The port of
``flipcomplexityempirical_tpu/experiments``, the ReCom chain
(``chain='recom'``) included; the supervisor, telemetry and the python
oracle backend are not ported."""

from .config import (
    ExperimentConfig, sec11_sweep, frank_sweep, kpair_sweep, tri_sweep,
    hex_sweep, temper_sweep, MU, SEC11_BASES, SEC11_POPS, FRANK_BASES,
    FRANK_POPS, TEMPER_BETAS, SWEEPS,
)
from .driver import (
    run_config, run_sweep, is_done, build_graph_and_plan,
    save_checkpoint, load_checkpoint, CheckpointIdentityError,
)
from .artifacts import ARTIFACT_KINDS

__all__ = [
    "ExperimentConfig", "sec11_sweep", "frank_sweep", "kpair_sweep",
    "tri_sweep", "hex_sweep", "temper_sweep", "MU",
    "SEC11_BASES", "SEC11_POPS", "FRANK_BASES", "FRANK_POPS",
    "TEMPER_BETAS", "SWEEPS",
    "run_config", "run_sweep", "is_done", "build_graph_and_plan",
    "save_checkpoint", "load_checkpoint", "CheckpointIdentityError",
    "ARTIFACT_KINDS",
]
