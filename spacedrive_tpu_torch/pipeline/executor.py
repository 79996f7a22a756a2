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
- No telemetry registry: stage busy times are ``time.perf_counter``
  intervals (the reference's spans degrade to the same bare timers).
"""

from __future__ import annotations

import logging
import os
import queue
import sqlite3
import threading
import time
from typing import TYPE_CHECKING, Any

from ..jobs import JobError, JobPaused, merge_metadata
from ..retry import RetryPolicy, is_disk_full, is_transient, retry_call

if TYPE_CHECKING:
    from ..jobs import DynJob, WorkerContext
    from .spec import PipelineSpec

logger = logging.getLogger(__name__)

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

    __slots__ = ("header", "parts", "results", "remaining", "done", "lock", "t0")

    def __init__(self, header: dict, parts: list, t0: float) -> None:
        self.header = header
        self.parts = parts
        self.results: list[Any] = [None] * len(parts)
        self.remaining = len(parts)
        self.done = threading.Event()
        self.lock = threading.Lock()
        #: when the split started: the page's wall runs to its merge
        self.t0 = t0


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
        self._wall_t0: float | None = None
        # busy seconds by stage, added to by three threads
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
        if self._wall_t0 is None:
            return
        wall = time.perf_counter() - self._wall_t0
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
                t0 = time.perf_counter()
                payload = self.spec.page(self.ctx, self.state.data, scratch)
                with self._stats_lock:
                    self._page_s += time.perf_counter() - t0
                if payload is None:
                    break
                budget -= 1
                if not self._put(self._pages, payload):
                    return  # draining
            self._put(self._pages, _DONE)
        except BaseException as e:  # noqa: BLE001 — forwarded to the committer
            self._put(self._pages, _StageFailure(e))

    def _split_loop(self, budget: int) -> None:
        scratch = self._scratch()
        try:
            while (budget > 0 or self.spec.adaptive) and not self._stop.is_set():
                self._observe_shares(scratch)
                t0 = time.perf_counter()
                header = self.spec.split(self.ctx, self.state.data, scratch)
                if header is None:
                    # the out-of-work probe counts as page time, as the
                    # None-returning page call does
                    with self._stats_lock:
                        self._page_s += time.perf_counter() - t0
                    break
                budget -= 1
                parts = header.pop("parts")
                ticket = _PageTicket(header, parts, t0)
                # the ticket goes BEFORE the fan-out: merge order is fixed
                # here, slice completion order is free
                if not self._put(self._tickets, ticket):
                    return  # draining
                for idx in range(len(parts)):
                    if not self._put(self._shard_q, (ticket, idx)):
                        return  # draining
            self._put(self._tickets, _DONE)
        except BaseException as e:  # noqa: BLE001 — forwarded to the committer
            self._put(self._tickets, _StageFailure(e))

    def _shard_loop(self) -> None:
        """One gather thread: takes page slices off the shared queue in
        arrival order (work-stealing across pages: a slow slice of page N
        never idles a thread that could start page N+1)."""
        while not self._stop.is_set():
            try:
                ticket, idx = self._shard_q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            result: Any = None
            try:
                result = self.spec.shard(self.ctx, self.state.data, ticket.parts[idx])
            except BaseException as e:  # noqa: BLE001 — fails the page at the merger
                result = _StageFailure(e)
            finally:
                # unconditional: a slice that dies for any reason must fail
                # its page at the merger, never leave ``remaining`` stuck
                # and hang the pipeline
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
                try:
                    item = self._tickets.get(timeout=_POLL_S)
                except queue.Empty:
                    continue
                if item is _DONE or isinstance(item, _StageFailure):
                    self._put(self._pages, item)
                    return
                ticket = item
                while not ticket.done.wait(timeout=_POLL_S):
                    if self._stop.is_set():
                        return  # draining
                failure = next((r for r in ticket.results
                                if isinstance(r, _StageFailure)), None)
                if failure is not None:
                    # the first failed slice fails the page, as a raised
                    # page call would; the committer classifies it
                    self._put(self._pages, failure)
                    return
                payload = self.spec.merge(self.ctx, self.state.data, ticket.header,
                                          ticket.results)
                with self._stats_lock:
                    self._page_s += time.perf_counter() - ticket.t0
                if not self._put(self._pages, payload):
                    return  # draining
        except BaseException as e:  # noqa: BLE001 — forwarded to the committer
            self._put(self._pages, _StageFailure(e))

    def _dispatch_loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    item = self._pages.get(timeout=_POLL_S)
                except queue.Empty:
                    continue
                if item is _DONE or isinstance(item, _StageFailure):
                    self._put(self._results, item)
                    return
                t0 = time.perf_counter()
                result = self.spec.process(self.ctx, self.state.data, item)
                with self._stats_lock:
                    self._hash_s += time.perf_counter() - t0
                if not self._put(self._results, result):
                    return  # draining
        except BaseException as e:  # noqa: BLE001 — forwarded to the committer
            self._put(self._results, _StageFailure(e))

    def _threads(self, budget: int) -> list[threading.Thread]:
        if self._sharded:
            return [
                threading.Thread(target=self._split_loop, args=(budget,), daemon=True,
                                 name="pipeline-prefetch"),
                *[threading.Thread(target=self._shard_loop, daemon=True,
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

        t0 = time.perf_counter()
        try:
            # a pause during the backoff serializes the last committed group
            results = retry_call(attempt, policy=COMMIT_RETRY, classify=is_transient,
                                 cancel_check=lambda: self.ctx.check_commands(self.dyn_job))
        except (OSError, sqlite3.OperationalError) as e:
            if not is_disk_full(e):
                raise
            # retrying cannot free space and failing would throw the run
            # away: end Paused at the last committed group (this group
            # rolled back and ``data`` was restored above)
            self.errors.append(f"commit hit a full disk (ENOSPC); paused at "
                               f"batch {self._batches}: {e!r}")
            logger.error("pipeline %s: disk full during commit; pausing at committed "
                         "batch %d", self.job.NAME, self._batches)
            raise JobPaused(self.dyn_job.serialize_state(), errors=self.errors) from e
        with self._stats_lock:
            self._commit_s += time.perf_counter() - t0
            self._txns += 1
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
        self._wall_t0 = time.perf_counter()
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
                try:
                    item = self._results.get(timeout=_POLL_S)
                except queue.Empty:
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
            wall_s = time.perf_counter() - self._wall_t0
            self._drain(threads)

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
