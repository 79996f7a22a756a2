"""Job errors (counterpart of ``spacedrive_tpu/jobs/error.py``)."""

from __future__ import annotations


class JobError(Exception):
    """Fatal job failure → status Failed."""


class JobPaused(Exception):
    """Unwinds the run loop at a checkpoint: the pause and shutdown
    commands, a transient pipeline stage failure, a full disk mid-commit.
    Carries the serialized :class:`.job.JobState` of the committed work."""

    def __init__(self, state_blob: bytes, from_shutdown: bool = False,
                 errors: list[str] | None = None) -> None:
        super().__init__("job paused")
        self.state_blob = state_blob
        self.from_shutdown = from_shutdown
        # the soft step errors so far, persisted so a resumed run still ends
        # CompletedWithErrors. The list itself, not a copy (no ``or []`` for
        # an empty one): the pipeline's drain appends a leaked stage's error
        # while this exception is in flight, and the worker must see it
        self.errors = errors if errors is not None else []


class JobCanceled(Exception):
    """The cancel command → status Canceled."""


class EarlyFinish(Exception):
    """Clean no-op completion."""

    def __init__(self, reason: str = "nothing to do") -> None:
        super().__init__(reason)


class JobAlreadyRunning(JobError):
    """Dedup rejection: a job of the same hash is running or queued."""
