"""Stateful jobs and a one-worker chain runner (condensed).

Counterpart of ``spacedrive_tpu/jobs/`` (job.py:46-262, worker.py,
manager.py spawn :67 / wait_idle :213, report.py, error.py): a job is
``init()`` → a list of JSON-serializable steps → ``execute_step()`` per step
→ ``finalize()``; steps may append steps; per-step soft errors accumulate
into CompletedWithErrors; :class:`EarlyFinish` is a clean skip; an exception
fails the job and cancels the rest of its chain. A job whose
``pipeline_spec()`` returns a spec runs its steps through
:class:`.pipeline.PipelineExecutor` (unless ``SD_PIPELINE=0``), then the
sequential loop runs whatever steps remain, as job.py:229-262 does; both
advance one :class:`JobState`. A transient stage failure or a full disk
ends a pipelined job Paused (:class:`JobPaused`) at its last committed
group, and the jobs after it in the chain stay Queued. Every job keeps a
report row in the library's ``job`` table. Every committed step (or group
transaction, when pipelined) and every job exit emits a post-commit
``db.commit`` on the node's bus, which moves the search index's watermark.

One worker thread per node runs the spawned chains one at a time (the
library database has one writer). Resume, cold resume (the checkpoint
persist) and the pause/cancel commands are not ported.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import json
import logging
import queue
import threading
import uuid
from typing import TYPE_CHECKING, Any, ClassVar

from .models import JobRow, utc_now

if TYPE_CHECKING:
    from .library import Library

logger = logging.getLogger(__name__)


class JobError(Exception):
    """Fatal job failure → status Failed."""


class EarlyFinish(Exception):
    """Clean no-op completion."""


class JobPaused(Exception):
    """The job stopped at its last committed step and may be run again
    later: a transient pipeline stage failure, or a full disk mid-commit.
    Carries the soft errors so far (the list itself, so errors appended
    while the pipeline drains still land)."""

    def __init__(self, errors: list[str]) -> None:
        super().__init__("job paused")
        self.errors = errors


class JobStatus:
    QUEUED = 0
    RUNNING = 1
    COMPLETED = 2
    CANCELED = 3
    FAILED = 4
    PAUSED = 5
    COMPLETED_WITH_ERRORS = 6

    NAMES = {0: "Queued", 1: "Running", 2: "Completed", 3: "Canceled",
             4: "Failed", 5: "Paused", 6: "CompletedWithErrors"}


class StepResult:
    """What one execute_step returns."""

    __slots__ = ("more_steps", "metadata", "errors")

    def __init__(self, more_steps: list[Any] | None = None,
                 metadata: dict[str, Any] | None = None,
                 errors: list[str] | None = None) -> None:
        self.more_steps = more_steps or []
        self.metadata = metadata or {}
        self.errors = errors or []


class StatefulJob:
    """Subclass with NAME, init() and execute_step()."""

    NAME: ClassVar[str] = ""

    def __init__(self, init_args: dict[str, Any]) -> None:
        self.init_args = init_args

    def init(self, ctx: "JobContext") -> tuple[dict[str, Any], list[Any], dict[str, Any]]:
        """Returns (data, steps, initial run metadata); raise EarlyFinish to
        complete with nothing to do."""
        raise NotImplementedError

    def execute_step(self, ctx: "JobContext", data: dict[str, Any], step: Any,
                     step_number: int) -> StepResult:
        raise NotImplementedError

    def finalize(self, ctx: "JobContext", data: dict[str, Any],
                 run_metadata: dict[str, Any]) -> dict[str, Any] | None:
        return run_metadata or None

    def pipeline_spec(self):
        """A batched job returns a :class:`.pipeline.PipelineSpec` to run
        its steps on the streaming executor; None keeps the step loop."""
        return None


@dataclasses.dataclass
class JobState:
    """What the sequential loop and the pipeline executor both advance."""

    data: dict[str, Any]
    steps: list[Any]
    step_number: int = 0
    run_metadata: dict[str, Any] = dataclasses.field(default_factory=dict)


def merge_metadata(acc: dict[str, Any], update: dict[str, Any]) -> None:
    """Numeric values accumulate, lists extend, everything else overwrites."""
    for key, value in update.items():
        old = acc.get(key)
        if (isinstance(old, (int, float)) and isinstance(value, (int, float))
                and not isinstance(old, bool)):
            acc[key] = old + value
        elif isinstance(old, list) and isinstance(value, list):
            acc[key] = old + value
        else:
            acc[key] = value


@dataclasses.dataclass
class JobReport:
    """The ``job`` row of one job run."""

    id: str
    name: str
    status: int = JobStatus.QUEUED
    action: str | None = None
    errors_text: str | None = None
    data: bytes | None = None  # the job's init args, JSON
    metadata: dict[str, Any] | None = None
    parent_id: str | None = None
    task_count: int = 0
    completed_task_count: int = 0
    date_estimated_completion: dt.datetime | None = None
    date_created: dt.datetime | None = None
    date_started: dt.datetime | None = None
    date_completed: dt.datetime | None = None

    def upsert(self, db) -> None:
        row = dataclasses.asdict(self)
        if db.find_one(JobRow, {"id": self.id}) is None:
            db.insert(JobRow, row)
        else:
            row.pop("id")
            db.update(JobRow, {"id": self.id}, row)


class JobContext:
    """What job code sees: the library, the node, and progress reporting."""

    def __init__(self, library: "Library", report: JobReport) -> None:
        self.library = library
        self.node = library.node
        self._report = report

    def progress(self, completed_task_count: int | None = None,
                 task_count: int | None = None) -> None:
        if completed_task_count is not None:
            self._report.completed_task_count = completed_task_count
        if task_count is not None:
            self._report.task_count = task_count


def _run(job: StatefulJob, ctx: JobContext, state: JobState,
         errors: list[str]) -> dict[str, Any] | None:
    """init → steps (pipelined, then sequential) → finalize; returns the
    metadata. ``state`` and the soft ``errors`` fill in place, so a caller
    that catches :class:`JobPaused` still sees what was committed."""
    try:
        data, steps, meta = job.init(ctx)
    except EarlyFinish as e:
        logger.info("job %s early finish: %s", job.NAME, e)
        return job.finalize(ctx, {}, {})
    _emit_commit(ctx.library, "job.init", job.NAME)
    state.data, state.steps, state.run_metadata = data, list(steps), dict(meta)
    ctx.progress(task_count=len(state.steps))
    spec = job.pipeline_spec()
    if spec is not None:
        from .pipeline import PipelineExecutor, pipeline_enabled

        if pipeline_enabled():
            # the streaming path: the same stages, overlapped; commits stay
            # in page order, so the state it leaves is the sequential one
            PipelineExecutor(spec, ctx, job, state, errors).run()
    while state.step_number < len(state.steps):
        try:
            result = job.execute_step(ctx, state.data, state.steps[state.step_number],
                                      state.step_number)
        except EarlyFinish:
            break
        _emit_commit(ctx.library, "job.step", job.NAME)
        if result.more_steps:
            state.steps.extend(result.more_steps)
            ctx.progress(task_count=len(state.steps))
        merge_metadata(state.run_metadata, result.metadata)
        errors.extend(result.errors)
        state.step_number += 1
        ctx.progress(completed_task_count=state.step_number)
    return job.finalize(ctx, state.data, state.run_metadata)


def _emit_commit(library: "Library", source: str, job_name: str) -> None:
    """A post-commit ``db.commit`` after a job's init, after each of its
    steps and at its exit (the JAX worker's ``job_progress`` and job-exit
    ``db.commit``, jobs/worker.py:145-150, :225). The database runs in
    autocommit mode with explicit transactions, so the writes are committed
    by now: the search index's watermark moves past them and a query falls
    back to SQL until the index has refreshed."""
    library.emit("db.commit", {"source": source, "job": job_name})


class Jobs:
    """Spawns job chains and runs them one at a time on one worker thread."""

    def __init__(self) -> None:
        self._queue: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._pending = 0
        self._idle = threading.Condition(self._lock)
        self._worker: threading.Thread | None = None

    def spawn(self, library: "Library", jobs: list[StatefulJob],
              action: str | None = None) -> str:
        """Queue a chain (each job runs after the previous one succeeds);
        returns the head job's report id."""
        if not jobs:
            raise ValueError("spawn requires at least one job")
        chain = []
        parent_id = None
        for i, job in enumerate(jobs):
            report = JobReport(id=str(uuid.uuid4()), name=job.NAME,
                               action=f"{action}-{i}" if action and i else action,
                               parent_id=parent_id, date_created=utc_now(),
                               data=json.dumps(job.init_args).encode())
            report.upsert(library.db)
            chain.append((job, report))
            parent_id = parent_id or report.id
        with self._lock:
            self._pending += 1
            if self._worker is None:
                self._worker = threading.Thread(target=self._work, name="jobs-worker",
                                                daemon=True)
                self._worker.start()
        self._queue.put((library, chain))
        return chain[0][1].id

    def _work(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            library, chain = item
            try:
                self._run_chain(library, chain)
            except Exception:  # a report write failed; keep serving chains
                logger.exception("job chain bookkeeping failed")
            finally:
                with self._lock:
                    self._pending -= 1
                    self._idle.notify_all()

    def _run_chain(self, library: "Library", chain) -> None:
        for i, (job, report) in enumerate(chain):
            report.status = JobStatus.RUNNING
            report.date_started = utc_now()
            report.upsert(library.db)
            state = JobState({}, [])
            errors: list[str] = []
            try:
                metadata = _run(job, JobContext(library, report), state, errors)
            except JobPaused as p:
                # the committed steps stay; the jobs after it stay Queued
                logger.warning("job %s paused: %s", report.name, p.errors[-1:])
                report.status = JobStatus.PAUSED
                report.metadata = state.run_metadata or None
                report.errors_text = "\n\n".join(p.errors) or None
                report.upsert(library.db)
                _emit_commit(library, "job.exit", report.name)
                return
            except Exception as e:
                logger.exception("job %s failed", report.name)
                report.status = JobStatus.FAILED
                report.errors_text = repr(e)
                report.date_completed = utc_now()
                report.upsert(library.db)
                for _job, child in chain[i + 1:]:
                    child.status = JobStatus.CANCELED
                    child.upsert(library.db)
                _emit_commit(library, "job.exit", report.name)
                return
            report.metadata = metadata
            report.status = (JobStatus.COMPLETED_WITH_ERRORS if errors
                             else JobStatus.COMPLETED)
            report.errors_text = "\n\n".join(errors) or None
            report.date_completed = utc_now()
            report.upsert(library.db)
            logger.info("job %s -> %s", report.name, JobStatus.NAMES[report.status])
            _emit_commit(library, "job.exit", report.name)

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until every spawned chain has finished; False on timeout."""
        with self._lock:
            return self._idle.wait_for(lambda: self._pending == 0, timeout)

    def shutdown(self, timeout: float = 30.0) -> None:
        """Let queued chains finish, then stop the worker."""
        with self._lock:
            worker = self._worker
            self._worker = None
        if worker is not None:
            self._queue.put(None)
            worker.join(timeout)
