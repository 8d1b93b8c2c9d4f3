"""The sweep service's coalescing core on the card: fingerprint-equal
configs of a sweep run as one batch of chains, each config's rows sliced
back out bit-identical to its solo run, and the one-shot CLI
(``python -m flipcomplexityempirical_tpu_torch.service``) with its
tenant-efficiency mode. The port of the core of
``flipcomplexityempirical_tpu/service``; its journal, retries, fleet and
server wait for ROADMAP.md A11."""

from .queue import DONE, FAILED, QUEUED, RUNNING, Job, JobQueue
from .scheduler import (BatchStats, SweepService, concat_params,
                        concat_states)

__all__ = [
    "DONE", "FAILED", "QUEUED", "RUNNING", "Job", "JobQueue",
    "BatchStats", "SweepService", "concat_params", "concat_states",
]
