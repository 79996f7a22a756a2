"""Job reports: the ``job`` row of every job run.

Counterpart of ``spacedrive_tpu/jobs/report.py``: the row holds the
serialized checkpoint (:class:`.job.JobState`) in ``data`` and the chain's
head in ``parent_id``. ``message`` is the live progress message and is not
persisted.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import uuid
from typing import Any

from ..models import Database, JobRow, utc_now


class JobStatus:
    QUEUED = 0
    RUNNING = 1
    COMPLETED = 2
    CANCELED = 3
    FAILED = 4
    PAUSED = 5
    COMPLETED_WITH_ERRORS = 6

    FINISHED = (COMPLETED, CANCELED, FAILED, COMPLETED_WITH_ERRORS)

    NAMES = {0: "Queued", 1: "Running", 2: "Completed", 3: "Canceled",
             4: "Failed", 5: "Paused", 6: "CompletedWithErrors"}


@dataclasses.dataclass
class JobReport:
    id: str
    name: str
    status: int = JobStatus.QUEUED
    action: str | None = None
    errors_text: str | None = None
    data: bytes | None = None  # the serialized JobState checkpoint
    metadata: dict[str, Any] | None = None
    parent_id: str | None = None
    task_count: int = 0
    completed_task_count: int = 0
    date_estimated_completion: dt.datetime | None = None
    date_created: dt.datetime | None = None
    date_started: dt.datetime | None = None
    date_completed: dt.datetime | None = None
    message: str = ""  # live progress message (not persisted)

    @classmethod
    def new(cls, name: str, action: str | None = None,
            parent_id: str | None = None) -> "JobReport":
        return cls(id=str(uuid.uuid4()), name=name, action=action,
                   parent_id=parent_id, date_created=utc_now())

    def _row(self) -> dict[str, Any]:
        row = dataclasses.asdict(self)
        row.pop("message")
        return row

    def create(self, db: Database) -> None:
        db.insert(JobRow, self._row())

    def upsert(self, db: Database) -> None:
        """Write the row. Two threads may write one report at once (a job
        queued by one thread and dispatched by another), so a lost insert
        race is ignored and updates the row the other thread made."""
        row = self._row()
        job_id = row.pop("id")
        if not db.update(JobRow, {"id": job_id}, row):
            db.insert(JobRow, {"id": job_id, **row}, or_ignore=True)
            db.update(JobRow, {"id": job_id}, row)

    @classmethod
    def from_row(cls, row: dict[str, Any]) -> "JobReport":
        fields = {f.name for f in dataclasses.fields(cls)} - {"message"}
        return cls(**{k: v for k, v in row.items() if k in fields})

    def progress_payload(self) -> dict[str, Any]:
        """The ``job_progress`` event's payload."""
        return {
            "id": self.id,
            "name": self.name,
            "status": self.status,
            "task_count": self.task_count,
            "completed_task_count": self.completed_task_count,
            "message": self.message,
            "estimated_completion": (self.date_estimated_completion.isoformat()
                                     if self.date_estimated_completion else None),
        }
