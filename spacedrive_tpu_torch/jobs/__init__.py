"""Stateful jobs: init, steps and finalize, with pause, resume, cancel,
lanes and a checkpoint that survives the process.

Counterpart of ``spacedrive_tpu/jobs/`` (job.py, worker.py, manager.py,
report.py, error.py): one worker thread per running job
(:mod:`.worker`), dispatched by :class:`.manager.Jobs` one at a time per
library and lane; each job keeps its report row in the library's ``job``
table, with its serialized state, so a paused job resumes at its last
committed step and a killed process resumes at boot
(:meth:`Jobs.cold_resume`). :class:`JobContext` is the name the port's jobs
have always taken their context by; it is the worker's context.
"""

from .error import EarlyFinish, JobAlreadyRunning, JobCanceled, JobError, JobPaused
from .job import JOB_REGISTRY, DynJob, JobState, StatefulJob, StepResult, merge_metadata
from .manager import MAX_WORKERS, Jobs
from .report import JobReport, JobStatus
from .worker import Worker, WorkerCommand, WorkerContext

JobContext = WorkerContext

__all__ = [
    "EarlyFinish", "JobAlreadyRunning", "JobCanceled", "JobContext", "JobError", "JobPaused",
    "JOB_REGISTRY", "DynJob", "JobState", "StatefulJob", "StepResult", "merge_metadata",
    "MAX_WORKERS", "Jobs", "JobReport", "JobStatus", "Worker", "WorkerCommand",
    "WorkerContext", "register_builtin_jobs",
]


def register_builtin_jobs() -> None:
    """Import every module that defines a job, so that :data:`JOB_REGISTRY`
    holds every job type before a cold resume looks one up by name."""
    from ..locations import indexer_job  # noqa: F401
    from ..objects import crypto_jobs, dedup, file_identifier, fs, validator  # noqa: F401
    from ..objects.media import processor  # noqa: F401
