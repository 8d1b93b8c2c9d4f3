"""Job queue for the sweep service: config submissions as host records.

Port of ``flipcomplexityempirical_tpu/service/queue.py`` without what
serves the host layers of ROADMAP.md A11: the obs recorder (the
``job_submitted`` event), the submission clock, and the retry and
quarantine bookkeeping (``attempts``, ``det_failures``, ``solo``, the
``quarantined`` status). A list of ``Job`` dataclasses with
submission-order iteration; which jobs coalesce lives in
``scheduler.SweepService``. The queue only owns identity (monotonic job
ids) and lifecycle status. No threads: the service is a single host loop
driving batched launches.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..experiments.config import ExperimentConfig

# Job lifecycle: queued -> running -> done | failed (a job that raises
# is not retried)
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"


@dataclasses.dataclass
class Job:
    """One submitted config and its service-side lifecycle."""

    job_id: str
    config: ExperimentConfig
    status: str = QUEUED
    batch: Optional[str] = None       # the batch this job ran in
    error: Optional[str] = None       # last failure message
    result: Optional[dict] = None     # per-tenant data dict when DONE

    @property
    def tag(self) -> str:
        return self.config.tag

    @property
    def fingerprint(self) -> str:
        return self.config.fingerprint()


class JobQueue:
    """Submission-ordered job store. ``submit`` assigns ``j<K>`` ids;
    ``runnable`` yields queued jobs in submission order."""

    def __init__(self):
        self._jobs: list[Job] = []

    def submit(self, config: ExperimentConfig) -> Job:
        job = Job(job_id=f"j{len(self._jobs):04d}", config=config)
        self._jobs.append(job)
        return job

    def jobs(self) -> list[Job]:
        return list(self._jobs)

    def runnable(self) -> list[Job]:
        return [j for j in self._jobs if j.status == QUEUED]

    def __len__(self) -> int:
        return len(self._jobs)
