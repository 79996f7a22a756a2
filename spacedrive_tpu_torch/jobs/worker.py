"""Worker: one thread per running job.

Counterpart of ``spacedrive_tpu/jobs/worker.py``: it owns the job's bounded
command queue, persists the report's transitions, computes the ETA from the
step cadence and emits a throttled ``job_progress`` event on the node's bus,
and a ``db.commit`` at the job's exit. Telemetry traces, the queue-wait
histogram and the completion counter are not ported.
"""

from __future__ import annotations

import datetime as dt
import logging
import queue
import threading
import time
from typing import TYPE_CHECKING

from ..models import utc_now
from .error import JobCanceled, JobPaused
from .job import DynJob
from .report import JobStatus

if TYPE_CHECKING:
    from ..library import Library
    from .manager import Jobs

logger = logging.getLogger(__name__)

PROGRESS_THROTTLE_S = 0.05


class WorkerCommand:
    PAUSE = "pause"
    CANCEL = "cancel"
    SHUTDOWN = "shutdown"


class WorkerContext:
    """What job code sees: the library, the node, progress reporting and
    the command poll."""

    def __init__(self, worker: "Worker") -> None:
        self._worker = worker
        self.library = worker.library
        self.node = worker.library.node if worker.library else None

    def progress(self, completed_task_count: int | None = None,
                 task_count: int | None = None, message: str | None = None) -> None:
        self._worker.update_progress(completed_task_count, task_count, message)

    def check_commands(self, dyn_job: DynJob) -> None:
        """The poll between steps: raises JobPaused or JobCanceled."""
        cmd = self._worker.poll_command()
        if cmd is None:
            return
        if cmd == WorkerCommand.CANCEL:
            raise JobCanceled()
        raise JobPaused(dyn_job.serialize_state(), from_shutdown=cmd == WorkerCommand.SHUTDOWN,
                        errors=dyn_job._soft_errors)


class Worker:
    def __init__(self, manager: "Jobs", library: "Library", dyn_job: DynJob) -> None:
        self.manager = manager
        self.library = library
        self.dyn_job = dyn_job
        self.report = dyn_job.report
        # bounded: three idempotent commands; 32 pending ones mean the job
        # loop is wedged, and more buffering would not unwedge it
        self._commands: queue.Queue[str] = queue.Queue(maxsize=32)
        self._thread: threading.Thread | None = None
        self._started_at = 0.0
        self._last_progress_emit = 0.0

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._do_work, name=f"job-{self.report.name}-{self.report.id[:8]}",
            daemon=True)
        self._thread.start()

    def send_command(self, command: str) -> None:
        while True:
            try:
                self._commands.put_nowait(command)
                return
            except queue.Full:
                # displace the oldest pending command (each is idempotent
                # and the newest is the current intent), but never a cancel:
                # displacing one sheds the incoming command and re-queues
                # the cancel in its place
                try:
                    dropped = self._commands.get_nowait()
                except queue.Empty:
                    continue
                if dropped == WorkerCommand.CANCEL and command != WorkerCommand.CANCEL:
                    dropped, command = command, dropped
                logger.warning("job %s command queue full; displaced %s",
                               self.report.id[:8], dropped)

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def poll_command(self) -> str | None:
        try:
            return self._commands.get_nowait()
        except queue.Empty:
            return None

    def update_progress(self, completed: int | None, total: int | None,
                        message: str | None) -> None:
        r = self.report
        if completed is not None:
            r.completed_task_count = completed
        if total is not None:
            r.task_count = total
        if message is not None:
            r.message = message
        if r.completed_task_count and r.task_count:
            elapsed = time.monotonic() - self._started_at
            remaining = elapsed / r.completed_task_count * (r.task_count
                                                            - r.completed_task_count)
            r.date_estimated_completion = utc_now() + dt.timedelta(seconds=remaining)
        now = time.monotonic()
        if now - self._last_progress_emit >= PROGRESS_THROTTLE_S:
            self._last_progress_emit = now
            self._emit_progress()

    def _emit_progress(self) -> None:
        self.library.emit("job_progress", self.report.progress_payload())

    def _do_work(self) -> None:
        r = self.report
        r.status = JobStatus.RUNNING
        r.date_started = utc_now()
        r.upsert(self.library.db)
        self._started_at = time.monotonic()
        ctx = WorkerContext(self)
        next_job: DynJob | None = None
        try:
            metadata, errors = self.dyn_job.run(ctx)
            r.metadata = metadata
            if errors:
                r.status = JobStatus.COMPLETED_WITH_ERRORS
                r.errors_text = "\n\n".join(errors)
            else:
                r.status = JobStatus.COMPLETED
            r.date_completed = utc_now()
            if self.dyn_job.next_jobs:
                next_job = self.dyn_job.next_jobs.pop(0)
                next_job.next_jobs = self.dyn_job.next_jobs
        except JobPaused as p:
            # the committed steps stay; the chain after it is paused too
            logger.warning("job %s paused%s: %s", r.name,
                           " for shutdown" if p.from_shutdown else "", p.errors[-1:])
            r.status = JobStatus.PAUSED
            r.data = p.state_blob
            if p.errors:
                r.errors_text = "\n\n".join(p.errors)
            self._pause_children()
        except JobCanceled:
            r.status = JobStatus.CANCELED
            r.date_completed = utc_now()
            self._cancel_children()
        except Exception as e:
            logger.exception("job %s failed", r.name)
            r.status = JobStatus.FAILED
            r.errors_text = repr(e)
            r.date_completed = utc_now()
            self._cancel_children()
        finally:
            try:
                r.upsert(self.library.db)
                self._emit_progress()
                # the job's writes are committed here, so this bump never
                # precedes them; a throttled progress event may have been
                # the last step's only signal
                self.library.emit("db.commit", {"source": "job.exit", "job": r.name})
                logger.info("job %s -> %s", r.name, JobStatus.NAMES[r.status])
            except Exception:
                logger.exception("job %s: exit bookkeeping failed", r.name)
            finally:
                self.manager.complete(self.library, self, next_job)

    def _pause_children(self) -> None:
        for child in self.dyn_job.next_jobs:
            child.report.status = JobStatus.PAUSED
            child.report.upsert(self.library.db)

    def _cancel_children(self) -> None:
        for child in self.dyn_job.next_jobs:
            child.report.status = JobStatus.CANCELED
            child.report.upsert(self.library.db)
