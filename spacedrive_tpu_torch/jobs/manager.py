"""Jobs manager: ingest and dispatch with one writer per library and lane.

Counterpart of ``spacedrive_tpu/jobs/manager.py``. ``MAX_WORKERS`` is 1 per
lane and library: a library's database has one writer, and the parallel
work (the kernels) happens inside a step. Lanes (``StatefulJob.LANE``) are
the one overlap allowed: a media-lane job (thumbnails: file I/O, host
codecs and the card's resize) runs beside the default lane's scan chain,
so media processing of identified prefixes starts while identify still
hashes; database writes still serialize on the connection lock. Capacity
is keyed by ``(library.id, LANE)``, so one library's scan never holds back
another library's jobs.

Jobs are deduplicated by hash; the overflow queue is persisted as Queued
rows; a finished job dispatches the job chained after it; pause, resume
and cancel act on one job; :meth:`Jobs.shutdown` checkpoints every running
job instead of letting it finish, and :meth:`Jobs.cold_resume` revives the
checkpoints at boot.

A checkpoint that cannot be revived is marked Failed and pushes a
library notification (``job_cold_resume_failed``), as in the reference; the
jobs a dead process left Running are counted by
:func:`..recovery.note_cold_resumed` and each emits a ``job.cold_resume``
event. ``sd_jobs_running{lane}`` and ``sd_jobs_queued`` follow every
dispatch, queueing, completion and cancel; the worker reads the queue-wait
stamp :meth:`Jobs.ingest` sets.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import TYPE_CHECKING

from .. import telemetry
from ..models import JobRow
from .error import JobAlreadyRunning
from .job import DynJob, StatefulJob
from .report import JobReport, JobStatus
from .worker import Worker, WorkerCommand

if TYPE_CHECKING:
    from ..library import Library

logger = logging.getLogger(__name__)

MAX_WORKERS = 1

_RUNNING = telemetry.gauge("sd_jobs_running", "running workers per lane",
                           labels=("lane",))
_QUEUED = telemetry.gauge("sd_jobs_queued",
                          "jobs waiting for lane capacity")

#: statuses cold resume revives
_UNFINISHED = (JobStatus.PAUSED, JobStatus.RUNNING, JobStatus.QUEUED)


class Jobs:
    """The lock guards the running set and the queue only: no method writes
    the database while it holds the lock. The identify job's committer
    spawns warm-start media jobs from inside its group transaction, which
    holds the database's writer lock, so a report written under this lock
    could deadlock the two."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._running: dict[str, Worker] = {}  # job id -> worker
        # unbounded in memory, bounded in practice by hash dedup (one entry
        # a distinct job), and persisted as Queued rows: a bounded queue
        # would drop jobs
        self._queue: deque[tuple["Library", DynJob]] = deque()
        self._shutting_down = False
        self._idle = threading.Event()
        self._idle.set()

    def spawn(self, library: "Library", jobs: list[StatefulJob],
              action: str | None = None) -> str:
        """Chain ``jobs`` (each runs after the previous one succeeds) and
        ingest the head; returns the head's report id. Every job's state is
        persisted up front, so a cold resume can rebuild a child that never
        ran."""
        if not jobs:
            raise ValueError("spawn requires at least one job")
        dyn_jobs: list[DynJob] = []
        parent_id = None
        for i, job in enumerate(jobs):
            report = JobReport.new(job.NAME, action=f"{action}-{i}" if action and i else action,
                                   parent_id=parent_id)
            dyn = DynJob(job, report)
            report.data = dyn.serialize_state()
            dyn_jobs.append(dyn)
            if i == 0:
                parent_id = report.id
        head = dyn_jobs[0]
        head.next_jobs = dyn_jobs[1:]
        for dyn in dyn_jobs[1:]:
            dyn.report.upsert(library.db)
        self.ingest(library, head)
        return head.id

    def _lane_load(self, library_id: str, lane: str) -> int:
        """Running workers of ``library_id``'s ``lane`` (callers hold the
        lock)."""
        return sum(1 for w in self._running.values()
                   if w.library.id == library_id and w.dyn_job.job.LANE == lane)

    def _update_occupancy(self, lane: str) -> None:
        """The lane-occupancy and queue-depth gauges (callers hold the lock);
        a lane sums across libraries, so labels stay the lane vocabulary."""
        _RUNNING.set(sum(1 for w in self._running.values()
                         if w.dyn_job.job.LANE == lane), lane=lane)
        _QUEUED.set(len(self._queue))

    def _pop_dispatchable(self) -> tuple["Library", DynJob] | None:
        """The first queued job whose (library, lane) has capacity (callers
        hold the lock)."""
        for i, (lib, queued) in enumerate(self._queue):
            if self._lane_load(lib.id, queued.job.LANE) < MAX_WORKERS:
                del self._queue[i]
                return lib, queued
        return None

    def ingest(self, library: "Library", dyn_job: DynJob) -> None:
        """Dispatch the job, or queue it (its row Queued) while its
        (library, lane) is busy; raises JobAlreadyRunning for a duplicate."""
        # the worker observes the queue wait from this stamp
        dyn_job._queued_at_monotonic = time.monotonic()
        with self._lock:
            if self._shutting_down:
                raise JobAlreadyRunning("job system is shutting down")
            new_hash = dyn_job.hash()
            for worker in self._running.values():
                if worker.dyn_job.hash() == new_hash:
                    raise JobAlreadyRunning(
                        f"job {dyn_job.job.NAME} already running (hash {new_hash[:8]})")
            for _, queued in self._queue:
                if queued.hash() == new_hash:
                    raise JobAlreadyRunning(
                        f"job {dyn_job.job.NAME} already queued (hash {new_hash[:8]})")
            if self._lane_load(library.id, dyn_job.job.LANE) < MAX_WORKERS:
                self._dispatch(library, dyn_job)
                return
            dyn_job.report.status = JobStatus.QUEUED
            self._queue.append((library, dyn_job))
            self._update_occupancy(dyn_job.job.LANE)
            logger.debug("job %s queued (%d in queue)", dyn_job.job.NAME, len(self._queue))
        dyn_job.report.upsert(library.db)

    def complete(self, library: "Library", worker: Worker, next_job: DynJob | None) -> None:
        """Called by a worker's thread as it exits: dispatches the chained
        job, then whatever queued job has capacity. The idle event stays
        clear until then."""
        with self._lock:
            self._running.pop(worker.report.id, None)
            self._update_occupancy(worker.dyn_job.job.LANE)
            shutting_down = self._shutting_down
        if next_job is not None and not shutting_down:
            try:
                self.ingest(library, next_job)
            except JobAlreadyRunning as e:
                logger.warning("chained job dropped: %s", e)
        with self._lock:
            if not self._shutting_down:
                while (entry := self._pop_dispatchable()) is not None:
                    self._dispatch(*entry)
            if not self._running and not self._queue:
                self._idle.set()

    def _dispatch(self, library: "Library", dyn_job: DynJob) -> None:
        worker = Worker(self, library, dyn_job)
        self._running[dyn_job.id] = worker
        self._idle.clear()
        self._update_occupancy(dyn_job.job.LANE)
        logger.info("dispatching job %s (%s)", dyn_job.job.NAME, dyn_job.id[:8])
        worker.start()

    # -- control -------------------------------------------------------------
    def pause(self, job_id: str) -> bool:
        with self._lock:
            worker = self._running.get(job_id)
        if worker is None:
            return False
        worker.send_command(WorkerCommand.PAUSE)
        return True

    def cancel(self, job_id: str) -> bool:
        """Cancel a running job, or take a queued one off the queue."""
        with self._lock:
            worker = self._running.get(job_id)
            queued = next(((i, lib, q) for i, (lib, q) in enumerate(self._queue)
                           if q.id == job_id), None) if worker is None else None
            if queued is not None:
                del self._queue[queued[0]]
                self._update_occupancy(queued[2].job.LANE)
                if not self._running and not self._queue:
                    self._idle.set()
        if worker is not None:
            worker.send_command(WorkerCommand.CANCEL)
            return True
        if queued is None:
            return False
        _i, lib, dyn_job = queued
        for job in (dyn_job, *dyn_job.next_jobs):
            job.report.status = JobStatus.CANCELED
            job.report.upsert(lib.db)
        return True

    def resume(self, library: "Library", job_id: str) -> bool:
        """Revive a Paused job from its checkpoint, with its paused chain."""
        row = library.db.find_one(JobRow, {"id": job_id})
        if row is None or row["status"] != JobStatus.PAUSED:
            return False
        dyn_job = DynJob.new_from_report(JobReport.from_row(row))
        dyn_job.next_jobs = self._load_chain(library, row)
        self.ingest(library, dyn_job)
        return True

    def is_active(self) -> bool:
        with self._lock:
            return bool(self._running or self._queue)

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until no job is running or queued; False on timeout."""
        while True:
            if not self._idle.wait(timeout):
                return False
            with self._lock:
                if not self._running and not self._queue:
                    return True
                entry = self._pop_dispatchable()
                if entry is not None:
                    self._dispatch(*entry)

    def shutdown(self, timeout: float = 30.0) -> None:
        """Checkpoint every running job (the shutdown command pauses it at
        its last committed step or group) and keep queued jobs Queued."""
        with self._lock:
            self._shutting_down = True
            workers = list(self._running.values())
            queued, self._queue = list(self._queue), deque()
        for lib, dyn_job in queued:
            dyn_job.report.status = JobStatus.QUEUED
            dyn_job.report.upsert(lib.db)
        for worker in workers:
            worker.send_command(WorkerCommand.SHUTDOWN)
        for worker in workers:
            worker.join(timeout)

    # -- cold resume ----------------------------------------------------------
    def cold_resume(self, library: "Library") -> int:
        """At boot: revive every chain's first unfinished job (Paused,
        Running after a kill, or Queued) from its checkpoint, with the rest
        of its chain; returns how many were revived. Besides a chain's
        head, as the reference does, this revives a chained job whose head
        finished before the process died (a scan killed in identify). A
        checkpoint that cannot be revived is marked Failed, its error
        appended to the errors it carried; it is not re-queued."""
        revived = 0
        crash_survivors = 0
        rows = library.db.query(
            "SELECT * FROM job WHERE status IN (?, ?, ?) ORDER BY date_created, rowid",
            list(_UNFINISHED))
        chains = library.db.query(
            "SELECT id, parent_id, status FROM job ORDER BY date_created, rowid")
        # the members before each job in its chain, in chain order
        before: dict[str, list[int]] = {}
        seen: dict[str, list[int]] = {}
        for r in chains:
            head = r["parent_id"] or r["id"]
            before[r["id"]] = list(seen.get(head, []))
            seen.setdefault(head, []).append(r["status"])
        for raw in rows:
            row = JobRow.decode_row(raw)
            if row["parent_id"] is not None and any(
                    s in _UNFINISHED for s in before.get(row["id"], [])):
                continue  # revived with its chain's first unfinished job
            if row["parent_id"] is not None and any(
                    s not in (JobStatus.COMPLETED, JobStatus.COMPLETED_WITH_ERRORS)
                    for s in before.get(row["id"], [])):
                continue  # an earlier job of its chain failed or was canceled
            report = JobReport.from_row(row)
            try:
                dyn_job = DynJob.new_from_report(report)
                dyn_job.next_jobs = self._load_chain(library, row)
                self.ingest(library, dyn_job)
                revived += 1
                if row["status"] == JobStatus.RUNNING:
                    crash_survivors += 1
                    telemetry.event("job.cold_resume", job=report.name, id=report.id)
                    logger.info("cold-resuming %s (%s) from its checkpoint after a crash",
                                report.name, report.id[:8])
            except Exception as e:
                # lost scan progress the user must see, not a silent
                # Canceled; the blob would fail the same way forever
                logger.warning("cold resume failed for %s (%s): %s; marking Failed",
                               report.name, report.id[:8], e)
                report.status = JobStatus.FAILED
                failure = f"cold resume failed: {e!r}"
                report.errors_text = (f"{report.errors_text}\n\n{failure}"
                                      if report.errors_text else failure)
                report.upsert(library.db)
                try:
                    from ..notifications import emit_library_notification

                    emit_library_notification(library, {
                        "kind": "job_cold_resume_failed", "job_name": report.name,
                        "job_id": report.id, "error": str(e)})
                except Exception:
                    logger.exception("cold-resume failure notification could not be emitted")
        if crash_survivors:
            from ..recovery import note_cold_resumed

            note_cold_resumed(crash_survivors)
        return revived

    def _load_chain(self, library: "Library", row: dict) -> list[DynJob]:
        """The Paused or Queued jobs chained after ``row``, in chain order."""
        head = row["parent_id"] or row["id"]
        members = library.db.query(
            "SELECT * FROM job WHERE parent_id = ? ORDER BY date_created, rowid", [head])
        ids = [m["id"] for m in members]
        after = ids[ids.index(row["id"]) + 1:] if row["id"] in ids else ids
        children = []
        for raw in members:
            if raw["id"] not in after:
                continue
            report = JobReport.from_row(JobRow.decode_row(raw))
            if report.status in (JobStatus.PAUSED, JobStatus.QUEUED):
                try:
                    children.append(DynJob.new_from_report(report))
                except Exception as e:
                    logger.warning("dropping unresumable child %s: %s", report.id[:8], e)
        return children
