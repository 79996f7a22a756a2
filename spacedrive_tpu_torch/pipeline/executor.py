"""Bounded-queue streaming executor for batched jobs.

Counterpart of ``spacedrive_tpu/pipeline/executor.py`` (:186-757). Thread
layout, one executor per pipelined job run::

    prefetch ──pages──▶ dispatch ──results──▶ committer (job thread)

or, with sharded prefetch (``SD_SCAN_SHARDS`` > 1)::

    split ──tickets──▶ merge ──pages──▶ dispatch ──results──▶ committer
      └──slices──▶ gather-0..n-1 ──┘ (fill the tickets)

Every queue is bounded (``SD_PIPELINE_DEPTH``), so a slow committer holds
back the dispatcher and a slow dispatcher the prefetcher: memory stays
O((depth + group) × batch) however far the stages drift apart.

Group commit (``SD_COMMIT_GROUP``): up to N processed pages share one
durable transaction. Each page's ``spec.commit`` runs in order and its own
``db.transaction()`` joins the outer one; a failed attempt rolls every page
of the group back and restores ``data``, and ``COMMIT_RETRY`` retries it
while the error is transient. A full disk ends the job Paused at the last
committed group.

Checkpoints and commands: the committer is the job's worker thread. After
each committed group it persists the job's serialized state into its report
row (outside the group transaction: a kill between the two resumes one
group early, and re-running a committed group is idempotent, its rows being
no longer orphans), so a killed process cold-resumes there. It polls the
worker's commands before every wait for a result and between the backoff
quanta of a group's retry, so pause, shutdown and cancel land on a
committed-group boundary: the pages processed but not committed are
dropped, and the drain joins the stage threads before the worker writes
the row's new status, so no stage launches a kernel after it.

Stage supervision: a failure on a stage thread reaches the committer in
page order, after the pages before it. Those are committed first; then a
transient failure (``retry.is_transient``) ends the job Paused at the last
committed group, and any other failure re-raises and fails the job. A stage
forwards its failure with the same bounded put as a page. The reference
(``_put_nowait_or_drop``, :256-267) instead drops the oldest queued item to
make room when the queue is full: the dropped page is never committed, the
page after it is, and the cursor moves past the dropped page's rows. The
port does not copy that.

What the port leaves out, on purpose:

- No fallback. The dispatch stage launches the CUDA kernels; a CUDA error
  there is not transient and fails the job, exactly as the sequential step
  loop does. The reference's CPU re-dispatch of a failed hash batch
  (``spacedrive_tpu/objects/file_identifier.py:378-397``) and its
  ``is_device_wedge`` pause (``utils/retry.py:96``) are not ported: both
  hide the device.

Telemetry, as in the reference (:298-574): the run is a ``pipeline.run``
span of the job's trace, and every stage call a span pinned under it —
``pipeline.page`` (on the sharded path a detached span opened by the split
thread and closed by the merger, with ``pipeline.split``,
``pipeline.gather`` and ``pipeline.merge`` under it), ``pipeline.hash`` and
``pipeline.commit``. The report's ``pipeline_*_s`` are the sums of those
spans' durations, which measure with telemetry off too. The gather threads
publish the page they work for (:func:`page_span`), so the identifier's
``identifier.gather`` nests inside its page; the reference's opens under
the slice's ``pipeline.gather`` instead (ROADMAP Queue 3). Families:
``sd_pipeline_stage_{busy,blocked,idle}_seconds{stage}``,
``sd_commit_txns_total``, ``sd_commit_txn_pages_total``,
``sd_gather_shards``, ``sd_gather_inflight`` and
``sd_gather_shard_tasks_total{shard}``. An out-of-work probe (the page call
that returns nothing, only on an adaptive run) is a ``pipeline.page`` span
marked ``empty``.
"""

from __future__ import annotations

import logging
import os
import queue
import sqlite3
import threading
import time
from typing import TYPE_CHECKING, Any

from .. import telemetry
from ..jobs import JobError, JobPaused, merge_metadata
from ..retry import RetryPolicy, is_disk_full, is_transient, note_disk_full, retry_call

if TYPE_CHECKING:
    from ..jobs import DynJob, WorkerContext
    from .spec import PipelineSpec

logger = logging.getLogger(__name__)

#: per-stage accounting: busy = executing the stage callable, blocked =
#: waiting on a full downstream queue, idle = waiting on an empty upstream
#: queue; busy is read off the stage spans
_BUSY = telemetry.counter(
    "sd_pipeline_stage_busy_seconds",
    "time each pipeline stage spent executing its callable",
    labels=("stage",))
_BLOCKED = telemetry.counter(
    "sd_pipeline_stage_blocked_seconds",
    "time each stage spent blocked on a full downstream queue "
    "(backpressure)", labels=("stage",))
_IDLE = telemetry.counter(
    "sd_pipeline_stage_idle_seconds",
    "time each stage spent waiting on an empty upstream queue",
    labels=("stage",))
_COMMIT_TXNS = telemetry.counter(
    "sd_commit_txns_total",
    "durable transactions opened by the pipeline committer (group commit "
    "coalesces SD_COMMIT_GROUP pages into each)")
_COMMIT_PAGES = telemetry.counter(
    "sd_commit_txn_pages_total",
    "pipeline pages made durable through group-commit transactions")
_GATHER_SHARDS = telemetry.gauge(
    "sd_gather_shards",
    "parallel gather shards per page in the sharded prefetch stage "
    "(SD_SCAN_SHARDS; 1 = classic single-thread prefetch)")
_GATHER_INFLIGHT = telemetry.gauge(
    "sd_gather_inflight",
    "gather shard slices currently executing across the shard workers")
_SHARD_TASKS = telemetry.counter(
    "sd_gather_shard_tasks_total",
    "page slices executed per gather shard worker (occupancy skew across "
    "shards shows up as per-label imbalance)", labels=("shard",))

#: the page span the calling prefetch or gather thread works for
_PAGE = threading.local()


def page_span():
    """The ``pipeline.page`` span of the page this thread is reading, or
    None off the page stage: what the identifier's gather span pins as
    its parent, so it nests in its page on the gather threads too."""
    return getattr(_PAGE, "span", None)

#: poll quantum of every queue wait: also bounds how long a drain waits on
#: a stage blocked on a full or empty queue
_POLL_S = 0.05

#: how long a partial commit group may wait for more pages before it
#: commits anyway: a commit-bound pipeline fills its groups, a page- or
#: hash-bound one degrades toward smaller groups instead of holding
#: finished pages back
GROUP_LINGER_S = 0.5

#: the committer's retry over a group's ``spec.commit`` calls, above the
#: connection's own busy timeout. The retried group never half-applies: an
#: exception out of ``spec.commit`` means nothing durable happened (spec.py)
COMMIT_RETRY = RetryPolicy(attempts=4, base_s=0.25, max_s=2.0,
                           multiplier=2.0, jitter=0.5, budget_s=15.0)

_DONE = object()


#: per-join bound when draining stage threads: a stage stuck in a hung
#: device or I/O call must not strand the job (the reference's default for
#: ``SD_PIPELINE_DRAIN_S``, which the port does not read)
DRAIN_S = 10.0


def pipeline_enabled() -> bool:
    """Streaming is the default for jobs that opt in; ``SD_PIPELINE=0``
    sends every job back to the sequential step loop."""
    return os.environ.get("SD_PIPELINE", "1").lower() not in ("0", "false", "off")


def pipeline_depth() -> int:
    """Bounded-queue depth between stages (``SD_PIPELINE_DEPTH``, min 1)."""
    try:
        return max(1, int(os.environ.get("SD_PIPELINE_DEPTH", "2")))
    except ValueError:
        return 2


def scan_shards() -> int:
    """Gather shards a page (``SD_SCAN_SHARDS``, clamped to 1..16; default
    min(4, cores)). 1 is the single prefetch thread."""
    raw = os.environ.get("SD_SCAN_SHARDS", "").strip()
    if raw:
        try:
            return max(1, min(int(raw), 16))
        except ValueError:
            pass
    return min(4, os.cpu_count() or 1)


def commit_group() -> int:
    """Pages a durable transaction (``SD_COMMIT_GROUP``, min 1, default 8);
    1 is one transaction a page."""
    try:
        return max(1, int(os.environ.get("SD_COMMIT_GROUP", "8")))
    except ValueError:
        return 8


class _StageFailure:
    """An exception caught on a stage thread, handed to the committer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class _PageTicket:
    """Ordered-merge ticket of one split page. The split thread queues it
    to the merger BEFORE its slices fan out, so pages re-serialize in split
    order however the gather threads interleave. The gather threads fill
    ``results`` and count ``remaining`` down under ``lock``; the last one
    sets ``done``, on which the merger waits."""

    __slots__ = ("header", "parts", "results", "remaining", "done", "lock", "span")

    def __init__(self, header: dict, parts: list, span: Any) -> None:
        self.header = header
        self.parts = parts
        self.results: list[Any] = [None] * len(parts)
        self.remaining = len(parts)
        self.done = threading.Event()
        self.lock = threading.Lock()
        #: the page's detached ``pipeline.page`` span: entered by the split
        #: thread, parent of every slice span, exited by the merger
        self.span = span


class PipelineExecutor:
    """Drive one pipelined job run; advances the job's state exactly as the
    sequential step loop in ``DynJob.run`` would."""

    def __init__(self, spec: "PipelineSpec", ctx: "WorkerContext", dyn_job: "DynJob",
                 errors: list[str]) -> None:
        self.spec = spec
        self.ctx = ctx
        self.dyn_job = dyn_job
        self.job = dyn_job.job
        self.state = dyn_job.state
        self.errors = errors
        depth = pipeline_depth()
        self._pages: queue.Queue[Any] = queue.Queue(maxsize=depth)
        self._results: queue.Queue[Any] = queue.Queue(maxsize=depth)
        self._shards = (scan_shards()
                        if (spec.split is not None and spec.shard is not None
                            and spec.merge is not None) else 1)
        self._sharded = self._shards > 1
        self._tickets: queue.Queue[Any] = queue.Queue(maxsize=depth)
        self._shard_q: queue.Queue[Any] = queue.Queue(maxsize=self._shards * (depth + 1))
        self._stop = threading.Event()
        #: the job's trace (None with telemetry off); the stage spans pin
        #: the ``pipeline.run`` span as their parent
        self.trace = getattr(dyn_job, "trace", None)
        self._wall_sp = None
        # busy seconds by stage (span sums), added to by three threads
        self._stats_lock = threading.Lock()
        self._page_s = 0.0
        self._hash_s = 0.0
        self._commit_s = 0.0
        self._batches = 0
        self._txns = 0

    def _persist_checkpoint(self) -> None:
        """Write the committed state into the job's report row, so a killed
        process resumes here. Best effort: a failed write costs re-run
        work (the previous checkpoint), never correctness."""
        try:
            report = self.dyn_job.report
            report.data = self.dyn_job.serialize_state()
            report.upsert(self.ctx.library.db)
        except Exception:
            logger.exception("pipeline %s: checkpoint persist failed (a resume starts at "
                             "the previous checkpoint)", self.job.NAME)

    # -- bounded put that never deadlocks a drain ----------------------------
    def _put(self, q: queue.Queue, item: Any) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _observe_shares(self, scratch: dict[str, Any]) -> None:
        """Publish each stage's busy share of the pipeline wall so far into
        ``scratch["stage_shares"]``, which adaptive page sizing reads before
        it sizes the next page."""
        if self._wall_sp is None:
            return
        wall = self._wall_sp.elapsed_s()
        if wall <= 0.05:
            return
        with self._stats_lock:
            scratch["stage_shares"] = {"page": self._page_s / wall,
                                       "hash": self._hash_s / wall,
                                       "commit": self._commit_s / wall}

    def _scratch(self) -> dict[str, Any]:
        return {"step_index": self.state.step_number, "steps": self.state.steps,
                "shards": self._shards}

    # -- stage threads -------------------------------------------------------
    def _prefetch_loop(self, budget: int) -> None:
        scratch = self._scratch()
        try:
            while (budget > 0 or self.spec.adaptive) and not self._stop.is_set():
                self._observe_shares(scratch)
                with telemetry.span(self.trace, "pipeline.page", parent=self._wall_sp) as sp:
                    _PAGE.span = sp
                    try:
                        payload = self.spec.page(self.ctx, self.state.data, scratch)
                    finally:
                        _PAGE.span = None
                    if payload is None:
                        sp.set(empty=True)
                with self._stats_lock:
                    self._page_s += sp.duration_s
                _BUSY.inc(sp.duration_s, stage="page")
                if payload is None:
                    break
                budget -= 1
                t0 = time.perf_counter()
                ok = self._put(self._pages, payload)
                _BLOCKED.inc(time.perf_counter() - t0, stage="page")
                if not ok:
                    return  # draining
            self._put(self._pages, _DONE)
        except BaseException as e:  # noqa: BLE001 — forwarded to the committer
            self._put(self._pages, _StageFailure(e))

    def _split_loop(self, budget: int) -> None:
        scratch = self._scratch()
        try:
            while (budget > 0 or self.spec.adaptive) and not self._stop.is_set():
                self._observe_shares(scratch)
                # detached: entered here, exited by the merger once the
                # page reassembles, so its duration is the page's wall
                sp = telemetry.span(self.trace, "pipeline.page", parent=self._wall_sp,
                                    detached=True, shards=self._shards)
                sp.__enter__()
                try:
                    with telemetry.span(self.trace, "pipeline.split", parent=sp):
                        header = self.spec.split(self.ctx, self.state.data, scratch)
                except BaseException:
                    sp.__exit__(None, None, None)
                    raise
                if header is None:
                    # the out-of-work probe counts as page time, as the
                    # None-returning page call does
                    sp.set(empty=True)
                    sp.__exit__(None, None, None)
                    with self._stats_lock:
                        self._page_s += sp.duration_s
                    _BUSY.inc(sp.duration_s, stage="page")
                    break
                budget -= 1
                parts = header.pop("parts")
                ticket = _PageTicket(header, parts, sp)
                # the ticket goes BEFORE the fan-out: merge order is fixed
                # here, slice completion order is free
                t0 = time.perf_counter()
                ok = self._put(self._tickets, ticket)
                if ok:
                    for idx in range(len(parts)):
                        if not self._put(self._shard_q, (ticket, idx)):
                            return  # draining
                _BLOCKED.inc(time.perf_counter() - t0, stage="page")
                if not ok:
                    return  # draining
            self._put(self._tickets, _DONE)
        except BaseException as e:  # noqa: BLE001 — forwarded to the committer
            self._put(self._tickets, _StageFailure(e))

    def _shard_loop(self, shard_idx: int) -> None:
        """One gather thread: takes page slices off the shared queue in
        arrival order (work-stealing across pages: a slow slice of page N
        never idles a thread that could start page N+1)."""
        label = str(shard_idx)
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                ticket, idx = self._shard_q.get(timeout=_POLL_S)
            except queue.Empty:
                _IDLE.inc(time.perf_counter() - t0, stage="gather")
                continue
            _GATHER_INFLIGHT.inc()
            result: Any = None
            try:
                with telemetry.span(self.trace, "pipeline.gather", parent=ticket.span,
                                    shard=shard_idx, part=idx) as sp:
                    _PAGE.span = ticket.span
                    try:
                        result = self.spec.shard(self.ctx, self.state.data, ticket.parts[idx])
                    except BaseException as e:  # noqa: BLE001 — fails the page at the merger
                        result = _StageFailure(e)
                        sp.set(failed=repr(e))
                    finally:
                        _PAGE.span = None
                _BUSY.inc(sp.duration_s, stage="gather")
                _SHARD_TASKS.inc(shard=label)
            except BaseException as e:  # noqa: BLE001 — span plumbing
                if result is None:
                    result = _StageFailure(e)
            finally:
                # unconditional: a slice that dies for any reason must fail
                # its page at the merger, never leave ``remaining`` stuck
                # and hang the pipeline
                _GATHER_INFLIGHT.dec()
                with ticket.lock:
                    ticket.results[idx] = result
                    ticket.remaining -= 1
                    last = ticket.remaining == 0
                if last:
                    ticket.done.set()

    def _merge_loop(self) -> None:
        """Completes tickets strictly in split order and forwards each
        reassembled page, so dispatch and commit see the sequential page
        stream whatever the slices' interleaving."""
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = self._tickets.get(timeout=_POLL_S)
                except queue.Empty:
                    _IDLE.inc(time.perf_counter() - t0, stage="merge")
                    continue
                if item is _DONE or isinstance(item, _StageFailure):
                    self._put(self._pages, item)
                    return
                ticket = item
                t0 = time.perf_counter()
                while not ticket.done.wait(timeout=_POLL_S):
                    if self._stop.is_set():
                        return  # draining; the page span is abandoned
                _IDLE.inc(time.perf_counter() - t0, stage="merge")
                failure = next((r for r in ticket.results
                                if isinstance(r, _StageFailure)), None)
                if failure is not None:
                    # the first failed slice fails the page, as a raised
                    # page call would; the committer classifies it
                    ticket.span.__exit__(type(failure.exc), failure.exc, None)
                    self._put(self._pages, failure)
                    return
                with telemetry.span(self.trace, "pipeline.merge", parent=ticket.span):
                    payload = self.spec.merge(self.ctx, self.state.data, ticket.header,
                                              ticket.results)
                ticket.span.__exit__(None, None, None)
                with self._stats_lock:
                    self._page_s += ticket.span.duration_s
                _BUSY.inc(ticket.span.duration_s, stage="page")
                t0 = time.perf_counter()
                ok = self._put(self._pages, payload)
                _BLOCKED.inc(time.perf_counter() - t0, stage="page")
                if not ok:
                    return  # draining
        except BaseException as e:  # noqa: BLE001 — forwarded to the committer
            self._put(self._pages, _StageFailure(e))

    def _dispatch_loop(self) -> None:
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = self._pages.get(timeout=_POLL_S)
                except queue.Empty:
                    _IDLE.inc(time.perf_counter() - t0, stage="hash")
                    continue
                if item is _DONE or isinstance(item, _StageFailure):
                    self._put(self._results, item)
                    return
                # closes after the digests are on the host: the process
                # call returns hex strings read back from the card
                with telemetry.span(self.trace, "pipeline.hash", parent=self._wall_sp) as sp:
                    result = self.spec.process(self.ctx, self.state.data, item)
                with self._stats_lock:
                    self._hash_s += sp.duration_s
                _BUSY.inc(sp.duration_s, stage="hash")
                t0 = time.perf_counter()
                ok = self._put(self._results, result)
                _BLOCKED.inc(time.perf_counter() - t0, stage="hash")
                if not ok:
                    return  # draining
        except BaseException as e:  # noqa: BLE001 — forwarded to the committer
            self._put(self._results, _StageFailure(e))

    def _threads(self, budget: int) -> list[threading.Thread]:
        if self._sharded:
            return [
                threading.Thread(target=self._split_loop, args=(budget,), daemon=True,
                                 name="pipeline-prefetch"),
                *[threading.Thread(target=self._shard_loop, args=(i,), daemon=True,
                                   name=f"pipeline-gather-{i}") for i in range(self._shards)],
                threading.Thread(target=self._merge_loop, daemon=True, name="pipeline-merge"),
                threading.Thread(target=self._dispatch_loop, daemon=True,
                                 name="pipeline-dispatch"),
            ]
        return [
            threading.Thread(target=self._prefetch_loop, args=(budget,), daemon=True,
                             name="pipeline-prefetch"),
            threading.Thread(target=self._dispatch_loop, daemon=True, name="pipeline-dispatch"),
        ]

    # -- the committer (job thread) ------------------------------------------
    def _flush(self, pending: list[Any]) -> None:
        """Commit ``pending`` pages in one transaction (retried while the
        error is transient), then account them."""
        if not pending:
            return
        state = self.state
        db = self.ctx.library.db
        # spec.commit assigns only top-level keys of ``data`` (spec.py): a
        # shallow snapshot makes a group attempt restartable
        snapshot = dict(state.data)

        def attempt() -> list[Any]:
            try:
                if len(pending) == 1:
                    return [self.spec.commit(self.ctx, state.data, pending[0])]
                with db.transaction():
                    return [self.spec.commit(self.ctx, state.data, it) for it in pending]
            except BaseException:
                state.data.clear()
                state.data.update(snapshot)
                raise

        with telemetry.span(self.trace, "pipeline.commit", parent=self._wall_sp,
                            pages=len(pending)) as sp:
            try:
                # a pause during the backoff serializes the last committed group
                results = retry_call(attempt, policy=COMMIT_RETRY, classify=is_transient,
                                     cancel_check=lambda: self.ctx.check_commands(self.dyn_job))
            except (OSError, sqlite3.OperationalError) as e:
                if not is_disk_full(e):
                    raise
                note_disk_full("commit")
                # retrying cannot free space and failing would throw the run
                # away: end Paused at the last committed group (this group
                # rolled back and ``data`` was restored above)
                self.errors.append(f"commit hit a full disk (ENOSPC); paused at "
                                   f"batch {self._batches}: {e!r}")
                logger.error("pipeline %s: disk full during commit; pausing at committed "
                             "batch %d", self.job.NAME, self._batches)
                raise JobPaused(self.dyn_job.serialize_state(), errors=self.errors) from e
        with self._stats_lock:
            self._commit_s += sp.duration_s
            self._txns += 1
        _BUSY.inc(sp.duration_s, stage="commit")
        _COMMIT_TXNS.inc()
        _COMMIT_PAGES.inc(len(pending))
        pending.clear()
        for result in results:
            self._batches += 1
            if result.more_steps:
                raise JobError(f"{self.job.NAME}: pipelined jobs cannot append steps mid-run")
            merge_metadata(state.run_metadata, result.metadata)
            self.errors.extend(result.errors)
            state.step_number += 1
            if state.step_number > len(state.steps):
                # adaptive pages outran init's fixed-size estimate: extend
                # it so progress totals stay coherent
                state.steps.append(dict(state.steps[-1]))
            self.ctx.progress(completed_task_count=state.step_number,
                              task_count=len(state.steps))
        self._persist_checkpoint()
        # one post-commit db.commit per durable transaction (the search
        # index's watermark moves past the group's rows)
        self.ctx.library.emit("db.commit", {"source": "pipeline", "job": self.job.NAME,
                                            "txns": self._txns})

    def run(self) -> None:
        state = self.state
        budget = len(state.steps) - state.step_number
        # an adaptive spec may need more or fewer pages than init's
        # estimate: then the run ends when page() returns None
        if budget <= 0 and not self.spec.adaptive:
            return
        # entered before the stage threads start, so its span id exists
        # for their parent pins; its duration is ``pipeline_wall_s``
        wall_sp = telemetry.span(self.trace, "pipeline.run", job=self.job.NAME)
        wall_sp.__enter__()
        self._wall_sp = wall_sp
        _GATHER_SHARDS.set(self._shards)
        threads = self._threads(budget)
        for t in threads:
            t.start()
        group_n = commit_group()
        pending: list[Any] = []
        pending_since = 0.0  # when the oldest uncommitted page arrived
        try:
            while True:
                # pause, shutdown and cancel land here, after the last
                # committed group: the pending pages are dropped
                self.ctx.check_commands(self.dyn_job)
                t0 = time.perf_counter()
                try:
                    item = self._results.get(timeout=_POLL_S)
                except queue.Empty:
                    _IDLE.inc(time.perf_counter() - t0, stage="commit")
                    if pending and time.perf_counter() - pending_since > GROUP_LINGER_S:
                        self._flush(pending)
                    continue
                if item is _DONE:
                    self._flush(pending)
                    break
                if isinstance(item, _StageFailure):
                    # finished pages first: the job ends on a committed
                    # group boundary, in page order
                    self._flush(pending)
                    exc = item.exc
                    if is_transient(exc):
                        self.errors.append(f"pipeline stage failed transiently; paused at "
                                           f"batch {self._batches}: {exc!r}")
                        logger.warning("pipeline %s: transient stage failure, pausing at "
                                       "committed batch %d: %r", self.job.NAME,
                                       self._batches, exc)
                        raise JobPaused(self.dyn_job.serialize_state(),
                                        errors=self.errors) from exc
                    raise exc
                if not pending:
                    pending_since = time.perf_counter()
                pending.append(item)
                if len(pending) >= group_n:
                    self._flush(pending)
        finally:
            wall_sp.__exit__(None, None, None)
            self._drain(threads)
        wall_s = wall_sp.duration_s

        # pages ran dry before init's step estimate (rows vanished since
        # init, as sequential steps whose read comes back empty): jump to
        # the sequential loop's last step_number
        if state.step_number < len(state.steps):
            state.step_number = len(state.steps)
            self.ctx.progress(completed_task_count=state.step_number)
        merge_metadata(state.run_metadata, {
            "pipeline_page_s": self._page_s,
            "pipeline_hash_s": self._hash_s,
            "pipeline_commit_s": self._commit_s,
            "pipeline_wall_s": wall_s,
            "pipeline_batches": self._batches,
            # a string on purpose: merge_metadata sums numbers
            "pipeline_shards": str(self._shards),
            "commit_txns": self._txns,
        })
        logger.debug("pipeline %s: %d batches in %d txns, page %.3fs | hash %.3fs | "
                     "commit %.3fs | wall %.3fs", self.job.NAME, self._batches, self._txns,
                     self._page_s, self._hash_s, self._commit_s, wall_s)

    def _drain(self, threads: list[threading.Thread]) -> None:
        """Stop the stages: set the stop event, empty the queues so no
        producer stays blocked, join each thread with a bound. A thread that
        outlives two bounds (stuck in a hung device or I/O call) is a daemon
        and is given up, and the leak becomes a soft error of the job."""
        self._stop.set()
        for q in (self._pages, self._results, self._tickets, self._shard_q):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in threads:
            t.join(timeout=DRAIN_S)
            if not t.is_alive():
                continue
            logger.warning("pipeline %s: %s still running after %.1fs drain timeout; "
                           "joining once more", self.job.NAME, t.name, DRAIN_S)
            t.join(timeout=DRAIN_S)
            if t.is_alive():
                msg = (f"pipeline stage thread {t.name} leaked: still running "
                       f"{2 * DRAIN_S:.1f}s after drain (stuck in a hung gather or "
                       f"device call); its result is discarded")
                logger.error("pipeline %s: %s", self.job.NAME, msg)
                self.errors.append(msg)
