"""The paper's experiment driver on the card: the sec11 and Frankengraph
sweeps, segmented runs with checkpoint resume, the 13 artifacts per
config, and the CLI (``python -m flipcomplexityempirical_tpu_torch.
experiments``). The port of ``flipcomplexityempirical_tpu/experiments``
for those two families; the supervisor, telemetry and the other families
are not ported."""

from .config import (
    ExperimentConfig, sec11_sweep, frank_sweep, MU,
    SEC11_BASES, SEC11_POPS, FRANK_BASES, FRANK_POPS, SWEEPS,
)
from .driver import (
    run_config, run_sweep, is_done, build_graph_and_plan,
    save_checkpoint, load_checkpoint, CheckpointIdentityError,
)
from .artifacts import ARTIFACT_KINDS

__all__ = [
    "ExperimentConfig", "sec11_sweep", "frank_sweep", "MU",
    "SEC11_BASES", "SEC11_POPS", "FRANK_BASES", "FRANK_POPS", "SWEEPS",
    "run_config", "run_sweep", "is_done", "build_graph_and_plan",
    "save_checkpoint", "load_checkpoint", "CheckpointIdentityError",
    "ARTIFACT_KINDS",
]
