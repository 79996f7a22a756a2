"""Worker: one thread per running job.

Counterpart of ``spacedrive_tpu/jobs/worker.py``: it owns the job's bounded
command queue, persists the report's transitions, computes the ETA from the
step cadence and emits a throttled ``job_progress`` event on the node's bus,
and a ``db.commit`` at the job's exit. Each run is one telemetry trace
(``trace_id`` = the report id, so ``telemetry.jobTrace(job_id)`` resolves
it; a paused trace stays open in the ring and the resumed run continues
it); a finished run exports its JSONL under ``<data_dir>/logs/traces/``
and adds the span totals to the report's metadata as ``trace``. The
worker records ``sd_job_queue_wait_seconds{lane}``,
``sd_jobs_completed_total{job,status}`` and a ``job.status`` event at
each start and exit.
"""

from __future__ import annotations

import datetime as dt
import logging
import queue
import threading
import time
from typing import TYPE_CHECKING

from .. import telemetry
from ..models import utc_now
from .error import JobCanceled, JobPaused
from .job import DynJob
from .report import JobStatus

if TYPE_CHECKING:
    from ..library import Library
    from .manager import Jobs

logger = logging.getLogger(__name__)

PROGRESS_THROTTLE_S = 0.05

_QUEUE_WAIT = telemetry.histogram(
    "sd_job_queue_wait_seconds", "dispatch-queue wait per job",
    labels=("lane",))
_COMPLETED = telemetry.counter(
    "sd_jobs_completed_total", "finished jobs by name and status",
    labels=("job", "status"))


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
        #: the job's telemetry trace (None with SD_TELEMETRY=off); job code
        #: opens child spans with ``telemetry.span(ctx.trace, ...)``
        self.trace = worker.trace

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
        self.trace = None  # opened at _do_work's start

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
        telemetry.event("job.status", job=r.name, id=r.id,
                        status=JobStatus.NAMES[JobStatus.RUNNING])
        self._started_at = time.monotonic()
        queued_at = getattr(self.dyn_job, "_queued_at_monotonic", None)
        if queued_at is not None:
            _QUEUE_WAIT.observe(max(0.0, self._started_at - queued_at),
                                lane=self.dyn_job.job.LANE)
        self.trace = telemetry.start_trace(
            f"job.{r.name}", trace_id=r.id, resume=True,
            job=r.name, job_id=r.id, lane=self.dyn_job.job.LANE,
            library_id=self.library.id if self.library else None)
        self.dyn_job.trace = self.trace
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
                telemetry.event("job.status", job=r.name, id=r.id,
                                status=JobStatus.NAMES.get(r.status, str(r.status)))
                self._finish_telemetry()
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

    def _finish_telemetry(self) -> None:
        """Count a finished run, then close its trace, export the JSONL and
        add the span totals to the report's metadata. A paused run's trace
        stays open in the ring for the resumed run."""
        r = self.report
        if r.status not in JobStatus.FINISHED:
            return
        _COMPLETED.inc(job=r.name, status=JobStatus.NAMES.get(r.status, str(r.status)))
        if self.trace is None:
            return
        try:
            node = self.library.node if self.library else None
            summary = telemetry.finish_trace(
                self.trace, export_dir=node.data_dir if node else None)
            if summary:
                r.metadata = {**(r.metadata or {}), "trace": summary}
        except Exception:
            logger.exception("trace finalization failed for job %s", r.id)

    def _pause_children(self) -> None:
        for child in self.dyn_job.next_jobs:
            child.report.status = JobStatus.PAUSED
            child.report.upsert(self.library.db)

    def _cancel_children(self) -> None:
        for child in self.dyn_job.next_jobs:
            child.report.status = JobStatus.CANCELED
            child.report.upsert(self.library.db)
