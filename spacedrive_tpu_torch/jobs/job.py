"""The StatefulJob protocol and its type-erased runner.

Counterpart of ``spacedrive_tpu/jobs/job.py`` (:46-275). A job is
``init()`` → a list of JSON-serializable steps → ``execute_step()`` per step
→ ``finalize()``; steps may append steps; per-step soft errors accumulate
into CompletedWithErrors; :class:`.error.EarlyFinish` is a clean skip; an
exception fails the job and cancels the rest of its chain. A job whose
``pipeline_spec()`` returns a spec runs its steps through
:class:`..pipeline.PipelineExecutor` (unless ``SD_PIPELINE=0``), then the
sequential loop runs whatever steps remain; both advance one
:class:`JobState`.

Between steps (and, pipelined, between group commits) the runner polls its
worker's commands: pause and shutdown serialize the whole
``JobState{init_args, data, steps, step_number, run_metadata}`` into the
report, so :meth:`DynJob.new_from_report` resumes at the exact step; cancel
unwinds. State is JSON, so every job's ``init_args``, ``data`` and steps are
plain JSON values.

Every committed sequential step, and the job's init, emits a post-commit
``db.commit`` on the node's bus (the pipeline emits one per group
transaction, the worker one at the job's exit), which moves the search
index's watermark. Init runs in a ``job.init`` span and each sequential
step in a ``job.step`` span of the job's trace (``ctx.trace``), observed
into ``sd_job_step_seconds{job}``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import time
from typing import TYPE_CHECKING, Any, ClassVar

from .. import telemetry
from .error import EarlyFinish, JobError
from .report import JobReport

if TYPE_CHECKING:
    from .worker import WorkerContext

logger = logging.getLogger(__name__)

_STEP_SECONDS = telemetry.histogram(
    "sd_job_step_seconds", "sequential step latency per job",
    labels=("job",))

JOB_REGISTRY: dict[str, type["StatefulJob"]] = {}


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
    """Subclass with NAME, init() and execute_step(); a subclass with a NAME
    registers itself for cold resume."""

    NAME: ClassVar[str] = ""
    #: dispatch lane (:mod:`.manager`): each (library, lane) runs at most
    #: one job at a time, so a media-lane job overlaps the default lane's
    #: scan; writes still serialize on the database's connection lock
    LANE: ClassVar[str] = "default"
    #: init_args keys left out of every persisted checkpoint
    SECRET_INIT_KEYS: ClassVar[tuple[str, ...]] = ()

    def __init__(self, init_args: dict[str, Any]) -> None:
        self.init_args = init_args

    def hash(self) -> str:
        """Dedup identity: the name and the canonical init args."""
        blob = json.dumps({"name": self.NAME, "args": self.init_args}, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:32]

    def init(self, ctx: "WorkerContext") -> tuple[dict[str, Any], list[Any], dict[str, Any]]:
        """Returns (data, steps, initial run metadata); raise EarlyFinish to
        complete with nothing to do."""
        raise NotImplementedError

    def execute_step(self, ctx: "WorkerContext", data: dict[str, Any], step: Any,
                     step_number: int) -> StepResult:
        raise NotImplementedError

    def finalize(self, ctx: "WorkerContext", data: dict[str, Any],
                 run_metadata: dict[str, Any]) -> dict[str, Any] | None:
        return run_metadata or None

    def pipeline_spec(self):
        """A batched job returns a :class:`..pipeline.PipelineSpec` to run
        its steps on the streaming executor; None keeps the step loop."""
        return None

    def __init_subclass__(cls, **kw: Any) -> None:
        super().__init_subclass__(**kw)
        if cls.NAME:
            JOB_REGISTRY[cls.NAME] = cls


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


class JobState:
    """The checkpointable whole of a running job; ``data`` is None until
    ``init`` has run."""

    def __init__(self, init_args: dict[str, Any], data: dict[str, Any] | None,
                 steps: list[Any], step_number: int, run_metadata: dict[str, Any]) -> None:
        self.init_args = init_args
        self.data = data
        self.steps = steps
        self.step_number = step_number
        self.run_metadata = run_metadata

    def serialize(self, secret_keys: tuple[str, ...] = ()) -> bytes:
        init_args = {k: v for k, v in self.init_args.items() if k not in secret_keys}
        return json.dumps({"init_args": init_args, "data": self.data, "steps": self.steps,
                           "step_number": self.step_number,
                           "run_metadata": self.run_metadata}).encode()

    @classmethod
    def deserialize(cls, blob: bytes) -> "JobState":
        d = json.loads(blob.decode() if isinstance(blob, (bytes, bytearray)) else blob)
        return cls(d["init_args"], d["data"], d["steps"], d["step_number"], d["run_metadata"])


def _emit_commit(library, source: str, job_name: str) -> None:
    """A post-commit ``db.commit`` on the node's bus. The database runs in
    autocommit mode with explicit transactions, so the writes are committed
    by now: the search index's watermark moves past them and a query falls
    back to SQL until the index has refreshed."""
    library.emit("db.commit", {"source": source, "job": job_name})


class DynJob:
    """One job, its report, its state and the chain queued after it."""

    def __init__(self, job: StatefulJob, report: JobReport, state: JobState | None = None,
                 next_jobs: list["DynJob"] | None = None) -> None:
        self.job = job
        self.report = report
        self.state = state or JobState(job.init_args, None, [], 0, {})
        self.next_jobs = next_jobs or []
        #: True when this run continues a checkpoint (pause or cold resume)
        self.was_resumed = False
        self._soft_errors: list[str] = []

    @property
    def id(self) -> str:
        return self.report.id

    def hash(self) -> str:
        return self.job.hash()

    @classmethod
    def new_from_report(cls, report: JobReport) -> "DynJob":
        """Revive a job from its persisted report and checkpoint."""
        job_type = JOB_REGISTRY.get(report.name)
        if job_type is None:
            raise JobError(f"unknown job name for resume: {report.name!r}")
        state = JobState.deserialize(report.data) if report.data else None
        return cls(job_type(state.init_args if state else {}), report, state)

    def run(self, ctx: "WorkerContext") -> tuple[dict[str, Any] | None, list[str]]:
        """init → steps (pipelined, then sequential) → finalize, checking
        the worker's commands after init and between steps. Returns
        (metadata, soft errors); raises JobPaused, JobCanceled, or the
        error that fails the job."""
        state = self.state
        t0 = time.perf_counter()
        self.was_resumed = state.data is not None
        # a resumed run re-reads the soft errors its checkpoint persisted
        errors = [e for e in (self.report.errors_text or "").split("\n\n") if e]
        self._soft_errors = errors  # what a pause must carry
        trace = getattr(self, "trace", None)
        if state.data is None:
            try:
                with telemetry.span(trace, "job.init"):
                    data, steps, meta = self.job.init(ctx)
            except EarlyFinish as e:
                logger.info("job %s early finish: %s", self.job.NAME, e)
                return self.job.finalize(ctx, {}, {}), errors
            _emit_commit(ctx.library, "job.init", self.job.NAME)
            state.data, state.steps, state.run_metadata = data, list(steps), dict(meta)
            state.step_number = 0
            ctx.progress(task_count=len(state.steps),
                         message=f"{self.job.NAME}: {len(state.steps)} steps")
            ctx.check_commands(self)  # a pause during init checkpoints cleanly
        spec = self.job.pipeline_spec()
        if spec is not None:
            from ..pipeline import PipelineExecutor, pipeline_enabled

            if pipeline_enabled():
                # the streaming path: the same stages, overlapped; commits
                # stay in page order, so the state it leaves is the
                # sequential one
                PipelineExecutor(spec, ctx, self, errors).run()
        while state.step_number < len(state.steps):
            ctx.check_commands(self)
            try:
                with telemetry.span(trace, "job.step", step=state.step_number) as step_sp:
                    result = self.job.execute_step(ctx, state.data,
                                                   state.steps[state.step_number],
                                                   state.step_number)
                _STEP_SECONDS.observe(step_sp.duration_s, job=self.job.NAME)
            except EarlyFinish:
                break
            _emit_commit(ctx.library, "job.step", self.job.NAME)
            if result.more_steps:
                state.steps.extend(result.more_steps)
                ctx.progress(task_count=len(state.steps))
            merge_metadata(state.run_metadata, result.metadata)
            errors.extend(result.errors)
            state.step_number += 1
            ctx.progress(completed_task_count=state.step_number)
        metadata = self.job.finalize(ctx, state.data or {}, state.run_metadata)
        logger.info("job %s ran %.3f s (%d steps)", self.job.NAME, time.perf_counter() - t0,
                    state.step_number)
        return metadata, errors

    def serialize_state(self) -> bytes:
        return self.state.serialize(self.job.SECRET_INIT_KEYS)
