"""Partitioned sync ingest: shard windows into K independent apply lanes.

A copy of ``spacedrive_tpu/sync/lanes.py``: incoming windows are sharded
by **(model, record-id prefix)** into K lanes, each a worker thread with
its own bounded queue and its own :class:`~.ingest.Ingester` (windows
grouped under one session transaction), so independent records arbitrate
and apply concurrently while records that share arbitration history never
split across lanes. ``SD_SYNC_INGEST_LANES`` (the reference's name) sets
K; 1, the default, is the single serial path.

Why this is convergence-safe (K=1 and K=4 end in the same rows):

- arbitration is strictly **per record** — a shared op's effect depends
  only on its own record's logged history, and one record's ops always
  land in one lane, in window order;
- arrival order across records does not matter — lanes only reorder
  across records;
- ops whose application READS other records (relation ops linking two
  endpoints, shared ops carrying ``ref`` FK markers) are deferred to a
  **second wave** applied after every lane of the window drains, so a
  referenced row created elsewhere in the same window is present exactly
  as it would be under serial timestamp-ordered apply;
- instance clock floors are merged across lanes after the barrier — a
  poison in one lane caps the floor below itself even when another lane
  applied later ops from the same instance — and persisted only once all
  lane transactions committed (floors never run ahead of durability).

The pool is **per library** (the apply side is single-writer per library
database; lanes overlap decode, the prefetch SELECTs on the reader
connection and arbitration while durable writes serialize on the writer
lock) and closed with it. :meth:`IngestLanes.status` reports the queues;
the reference's gauges are kept too: ``sd_sync_ingest_lane_count``,
``sd_sync_ingest_lane_depth{lane}``, ``sd_sync_ingest_lane_busy{lane}`` and
``sd_sync_ingest_lane_ops_total{lane}``. Each window may carry its sender's
trace-context envelope (``ctxs``, one per window): every shard's
``sync.apply`` span parents under it, and with lanes the merger records
the window's lag and time once its floors are durable (the lanes skip it).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any

from .. import telemetry
from ..models import Instance
from ..telemetry import mesh
from .crdt import is_ref
from .ingest import Ingester, shared_poison_caps

if TYPE_CHECKING:
    from ..library import Library

logger = logging.getLogger(__name__)

#: K — 1 keeps the exact pre-lane single-path behavior (the default)
LANES_ENV = "SD_SYNC_INGEST_LANES"
#: bounded depth of each lane's work queue (submissions, not ops); a full
#: lane applies backpressure to the submitter, never unbounded buffering
LANE_DEPTH = 8
MAX_LANES = 16

_LANE_COUNT = telemetry.gauge(
    "sd_sync_ingest_lane_count", "configured sync ingest apply lanes")
_LANE_DEPTH = telemetry.gauge(
    "sd_sync_ingest_lane_depth", "queued submissions per ingest lane",
    labels=("lane",))
_LANE_BUSY = telemetry.gauge(
    "sd_sync_ingest_lane_busy", "1 while the lane is applying a shard",
    labels=("lane",))
_LANE_OPS = telemetry.counter(
    "sd_sync_ingest_lane_ops_total", "CRDT ops applied per ingest lane",
    labels=("lane",))
_WINDOW_SECONDS = telemetry.histogram(
    "sd_sync_window_seconds", "latency of one ingest window",
    labels=("peer",))


def lane_count() -> int:
    try:
        n = int(os.environ.get(LANES_ENV, "1"))
    except ValueError:
        return 1
    return max(1, min(MAX_LANES, n))


def _has_ref(data: Any) -> bool:
    if is_ref(data):
        return True
    if isinstance(data, dict):
        return any(is_ref(v) for v in data.values())
    return False


def lane_key(wire: dict[str, Any], lanes: int) -> int | None:
    """Shard index for one wire op, or ``None`` for the deferred second
    wave (ops whose APPLICATION reads other records: relation links and
    ``ref``-carrying shared ops). Sharding is (model, record-id prefix) —
    deterministic, so a poisoned record replays into the same lane."""
    typ = wire.get("typ")
    if not isinstance(typ, dict):
        return 0  # malformed: any lane may drop it
    if typ.get("_t") == "relation":
        return None
    if _has_ref(typ.get("data")):
        return None
    key = f"{typ.get('model')}\x00{str(typ.get('record_id'))[:8]}"
    return zlib.crc32(key.encode("utf-8", "replace")) % lanes


@dataclass
class _LaneTask:
    """One lane's share of a submission: the per-window shards with their
    windows' envelopes, in window order, applied under one session
    transaction."""

    ingester: Ingester
    parts: list[tuple[list[dict[str, Any]], Any]]
    done: threading.Event = field(default_factory=threading.Event)
    applied: int = 0
    clocks: dict[str, int] = field(default_factory=dict)
    caps: dict[str, int] = field(default_factory=dict)
    error: BaseException | None = None


class Submission:
    """Handle for one in-flight lane submission.

    ``submit()`` returns immediately after the lane shards are enqueued,
    so lane K of window N overlaps window N+1's decode/enqueue — the
    merger thread completes submissions strictly in submission order
    (wave-2 apply, then the cross-lane floor merge), preserving the
    ordering rule floors depend on. ``wait()`` blocks until this
    submission's floors persisted (or raises its first error) — exactly
    the old barrier semantics, now opt-out per submission."""

    __slots__ = ("windows", "ctxs", "peer", "label", "tasks", "wave2", "t0",
                 "applied", "advanced", "error", "_done", "_fanout_done")

    def __init__(self, windows, peer: str | None, ctxs=None) -> None:
        self.windows = windows
        #: the sender's trace-context envelope of each window (or None)
        self.ctxs = list(ctxs) if ctxs is not None else [None] * len(windows)
        self.peer = peer
        self.label = mesh.peer_label(peer)
        self.tasks: list[tuple[int, _LaneTask]] = []
        self.wave2: list[list[dict[str, Any]]] = []
        self.t0 = time.perf_counter()
        self.applied = 0
        self.advanced = False
        self.error: BaseException | None = None
        self._done = threading.Event()
        self._fanout_done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> tuple[int, bool]:
        if not self._done.wait(timeout):
            raise TimeoutError("lane submission still in flight")
        if self.error is not None:
            raise self.error
        return self.applied, self.advanced

    def _finish(self, error: BaseException | None = None) -> None:
        # first finisher wins: the close()/submit ticket race can have
        # both the merger and the submitter trying to settle one handle
        if self._done.is_set():
            return
        self.error = error
        self._done.set()


class IngestLanes:
    """K apply lanes over one library. ``receive``/``receive_many`` block
    until the submission is durable and the merged clock floors are
    persisted; ``submit`` returns a :class:`Submission` handle instead, so
    a pipelining submitter can overlap
    window N+1's decode with window N's apply. Submissions COMPLETE in
    submission order regardless (the merger thread), so the cross-lane
    floor-merge ordering rule — floors persist only after every lane txn
    of that submission committed, and never out of order — holds under
    pipelining exactly as under the barrier."""

    def __init__(self, library: "Library", lanes: int | None = None) -> None:
        self.library = library
        self.lanes = lanes if lanes is not None else lane_count()
        self._lock = threading.Lock()
        #: (peer, lane index) -> Ingester — an ingester's batch caches and
        #: poison memory are single-threaded state, so each is owned by
        #: exactly one lane thread (plus one wave-2 ingester per peer,
        #: used only on the merger thread under _wave2_lock)
        self._ingesters: dict[tuple[str | None, int], Ingester] = {}
        self._queues: list[queue.Queue[_LaneTask | None]] = []
        self._threads: list[threading.Thread] = []
        self._wave2_lock = threading.Lock()
        self._closed = False
        self._windows = 0
        self._submissions = 0
        #: ops applied by each lane (the JAX package's lane counter)
        self.ops_by_lane = [0] * max(self.lanes, 1)
        self._merge_q: queue.Queue[Submission | None] = queue.Queue(
            maxsize=LANE_DEPTH)
        self._merger: threading.Thread | None = None
        if self.lanes > 1:
            for i in range(self.lanes):
                q: queue.Queue[_LaneTask | None] = queue.Queue(
                    maxsize=LANE_DEPTH)
                t = threading.Thread(
                    target=self._worker, args=(i, q), daemon=True,
                    name=f"sync-lane-{library.id[:8]}-{i}")
                self._queues.append(q)
                self._threads.append(t)
                t.start()
            self._merger = threading.Thread(
                target=self._merge_loop, daemon=True,
                name=f"sync-merge-{library.id[:8]}")
            self._merger.start()
        _LANE_COUNT.set(self.lanes)

    # -- public entry points -------------------------------------------------
    def receive(self, ops: list[dict[str, Any]], peer: str | None = None,
                ctx=None) -> tuple[int, bool]:
        """One window. Returns (applied, floor_advanced)."""
        return self.receive_many([ops], peer=peer, ctxs=[ctx])

    def receive_many(self, windows: list[list[dict[str, Any]]],
                     peer: str | None = None, ctxs=None) -> tuple[int, bool]:
        """Apply several buffered windows (the Actor's flush group) as one
        submission and BLOCK until its floors persisted — the pre-pipeline
        barrier semantics, kept for the Actor."""
        if not windows:
            return 0, False
        if self.lanes <= 1:
            return self._receive_serial(windows, peer, ctxs)
        return self.submit(windows, peer=peer, ctxs=ctxs).wait()

    def submit(self, windows: list[list[dict[str, Any]]],
               peer: str | None = None, ctxs=None) -> Submission:
        """Enqueue one submission's lane shards and return its handle
        WITHOUT waiting for the apply: lane K starts on window N while the
        submitter decodes window N+1.
        Backpressure is intact — bounded lane queues block this call, and
        the bounded merge queue caps how many submissions can be in flight
        at once. Window order is preserved within every lane (per-lane
        FIFO) and across submissions (one merger, submission order)."""
        if self.lanes <= 1:
            # serial path has no lanes to overlap: complete synchronously
            sub = Submission(windows, peer, ctxs)
            try:
                sub.applied, sub.advanced = self._receive_serial(
                    windows, peer, sub.ctxs)
                sub._finish()
            except BaseException as e:  # noqa: BLE001 — surfaced by wait()
                sub._finish(e)
            return sub
        sub = Submission(windows, peer, ctxs)
        with self._lock:  # concurrent submitters: += is read-then-write
            self._submissions += 1
        # shard every window; wave-2 ops keep original (window, op) order
        lane_parts: list[list[tuple[list[dict[str, Any]], Any]]] = [
            [] for _ in range(self.lanes)]
        for ops, ctx in zip(windows, sub.ctxs):
            shards: list[list[dict[str, Any]]] = [
                [] for _ in range(self.lanes)]
            deferred: list[dict[str, Any]] = []
            for wire in ops:
                idx = lane_key(wire, self.lanes)
                if idx is None:
                    deferred.append(wire)
                else:
                    shards[idx].append(wire)
            for i, shard in enumerate(shards):
                if shard:
                    lane_parts[i].append((shard, ctx))
            if deferred:
                sub.wave2.append((deferred, ctx))

        # enqueue the merge ticket FIRST: the merger completes submissions
        # strictly in ticket order, so a later submit can never merge its
        # floors ahead of this one (bounded: caps in-flight submissions)
        while True:
            if self._closed:
                raise RuntimeError("ingest lane pool is closed")
            try:
                self._merge_q.put(sub, timeout=1.0)
                break
            except queue.Full:
                continue
        if self._closed:
            # close() may have sentineled + drained between our closed
            # check and the put — the ticket would sit unserviced forever;
            # settle the handle ourselves (first-finisher-wins: a merger
            # that DID race us to it already settled it, we no-op).
            # Finish BEFORE releasing the fan-out event: a merger still
            # draining tickets must see done() and skip, never complete a
            # submission whose shards were never enqueued.
            err = RuntimeError("ingest lane pool is closed")
            sub._finish(err)
            sub._fanout_done.set()
            raise err
        # fan the shards out (bounded queues: a saturated lane blocks the
        # submitter — backpressure, not buffering). A failure mid-fanout
        # FAILS the whole submission before releasing the merger: merging
        # the enqueued subset's floors could advance past the ops of a
        # shard that never made it to its lane.
        try:
            for i, parts in enumerate(lane_parts):
                if not parts:
                    continue
                task = _LaneTask(self._ingester(peer, i), parts)
                while True:
                    if self._closed:
                        raise RuntimeError("ingest lane pool is closed")
                    try:
                        self._queues[i].put(task, timeout=1.0)
                        break
                    except queue.Full:
                        continue
                sub.tasks.append((i, task))
        except BaseException as e:
            # lanes that DID get their shards may log ops while the floor
            # merge is skipped; protect this submission's ops from being
            # floor-leapfrogged by other in-flight submissions
            self._protect_unpersisted(sub)
            sub._finish(e)            # before the fan-out event: the
            sub._fanout_done.set()    # merger's done() check sees it
            raise
        # the merger may already be waiting on this ticket; mark the shard
        # fan-out complete so it knows the task list is final
        sub._fanout_done.set()
        return sub

    def _protect_unpersisted(self, sub: Submission) -> None:
        """A FAILED submission persists no floors, but some of its ops may
        sit durably logged in lanes that committed — and submissions still
        in flight behind it (a pipelining session, another peer forwarding
        the same origin instances) may carry HIGHER timestamps whose floor
        merge would silently leapfrog the failed submission's never-logged
        ops (lost forever: the retry pulls from durable floors). Register
        every op of the failed submission in the library-wide sticky caps:
        every later floor merge stays capped below them until each op is
        durably logged on re-delivery (the heal paths in
        Ingester._ingest_pass), exactly the poison-op discipline."""
        caps = shared_poison_caps(self.library)
        for ops in sub.windows:
            for wire in ops:
                op_id = wire.get("id")
                if isinstance(op_id, str):
                    caps.add(op_id, wire.get("instance"),
                             wire.get("timestamp"))

    # -- the ordered merger ---------------------------------------------------
    def _merge_loop(self) -> None:
        while True:
            sub = self._merge_q.get()
            if sub is None:
                return
            try:
                self._complete(sub)
            except BaseException as e:  # noqa: BLE001 — handed to wait()
                sub._finish(e)

    def _complete(self, sub: Submission) -> None:
        """Barrier on one submission's lane tasks, run its wave 2, merge +
        persist floors — in merger-thread order."""
        # the submitter enqueues the merge ticket before the lane shards;
        # wait for the fan-out to finish so sub.tasks is complete
        while not sub._fanout_done.wait(timeout=0.2):
            if self._closed:
                self._protect_unpersisted(sub)
                sub._finish(RuntimeError("ingest lane pool closed with a "
                                         "submission in flight"))
                return
        if sub.done():
            return  # the submitter failed the fan-out; persist nothing
        for _i, task in sub.tasks:
            while not task.done.wait(timeout=1.0):
                # close() fails drained tasks; a task that raced in after
                # the drain would otherwise strand the merger forever
                if self._closed and not task.done.wait(timeout=2.0):
                    self._protect_unpersisted(sub)
                    sub._finish(RuntimeError(
                        "ingest lane pool closed with a submission "
                        "in flight"))
                    return

        applied = sum(t.applied for _i, t in sub.tasks)
        merged_clocks: dict[str, int] = {}
        merged_caps: dict[str, int] = {}
        first_error: BaseException | None = None
        for _i, task in sub.tasks:
            if task.error is not None:
                first_error = first_error or task.error
                continue
            for pub_id, ts in task.clocks.items():
                if ts > merged_clocks.get(pub_id, 0):
                    merged_clocks[pub_id] = ts
            for pub_id, cap in task.caps.items():
                merged_caps[pub_id] = min(merged_caps.get(pub_id, cap), cap)

        # wave 2: ops that read other records apply AFTER the barrier, in
        # original order, on the merger thread (one merger per pool, so
        # two submissions' wave-2 shards can never interleave an ingester)
        if sub.wave2 and first_error is None:
            w2 = self._ingester(sub.peer, -1)
            try:
                with self._wave2_lock, w2.session():
                    for ops, ctx in sub.wave2:
                        applied += w2.receive(ops, ctx, defer_clocks=True)
                clocks, caps = self._take_deferred(w2)
                for pub_id, ts in clocks.items():
                    if ts > merged_clocks.get(pub_id, 0):
                        merged_clocks[pub_id] = ts
                for pub_id, cap in caps.items():
                    merged_caps[pub_id] = min(
                        merged_caps.get(pub_id, cap), cap)
            except Exception as e:  # lane-equivalent failure: floors hold
                # the rolled-back session's deferred clocks must not
                # linger on the shared wave-2 ingester — a later
                # submission would merge them and advance floors past
                # ops that were never durably logged
                self._take_deferred(w2)
                first_error = e

        # cross-lane floor merge: only-raise, then poison caps only-lower.
        # If ANY lane failed, persist NOTHING: the failed lane may hold
        # earlier ops from the same origin instance as a lane that
        # committed, and advancing the floor past them would lose them
        # forever (the committed lanes' ops are durably LOGGED, so the
        # idempotent re-pull skips them as duplicates — floors catch up
        # on the retry). Under pipelining that is not enough: LATER
        # submissions already in flight may carry higher timestamps of
        # the same instances, and THEIR floor merges would leapfrog this
        # submission's never-logged ops — sticky-cap them first.
        if first_error is not None:
            self._protect_unpersisted(sub)
            sub._finish(first_error)
            return
        # clamp with the LIVE library-wide sticky caps too: a lane task of
        # this submission may have computed its end-of-pass caps BEFORE an
        # earlier submission's merger-time failure registered protection
        # for the same instances (the tasks run concurrently; only the
        # merger is ordered) — re-reading here, in merger order, closes
        # that window
        for pub_id, cap in shared_poison_caps(self.library) \
                .floor_caps().items():
            merged_caps[pub_id] = min(merged_caps.get(pub_id, cap), cap)
        for pub_id, cap in merged_caps.items():
            if merged_clocks.get(pub_id, 0) > cap:
                merged_clocks[pub_id] = cap
        advanced = self._persist_floors(merged_clocks)

        # the window-level recording the lanes skipped: the lag from each
        # window's envelope, and the submission's wall time split across
        # its windows (one observation a window, as on the serial path)
        elapsed = time.perf_counter() - sub.t0
        window_seconds = _WINDOW_SECONDS.labels(peer=sub.label)
        for ops, ctx in zip(sub.windows, sub.ctxs):
            max_ts = max((w.get("timestamp") for w in ops
                          if isinstance(w.get("timestamp"), int)), default=0)
            mesh.record_ingest_window(sub.label, ctx, max_ts)
            window_seconds.observe(elapsed / len(sub.windows))
        with self._lock:  # merger thread races K=1 submitters
            self._windows += len(sub.windows)
        logger.debug("lane ingest: %d windows, %d applied in %.3fs",
                     len(sub.windows), applied, elapsed)
        sub.applied = applied
        sub.advanced = advanced
        sub._finish()

    def _receive_serial(self, windows, peer: str | None, ctxs=None) -> tuple[int, bool]:
        """K=1: the exact pre-lane path (session-grouped windows)."""
        ing = self._ingester(peer, 0)
        applied = 0
        with ing.session():
            for ops, ctx in zip(windows, ctxs or [None] * len(windows)):
                applied += ing.receive(ops, ctx)
        with self._lock:  # K=1 serial windows arrive from many threads
            self._windows += len(windows)
            self._submissions += 1
        return applied, ing.last_floor_advanced

    # -- internals -----------------------------------------------------------
    def _ingester(self, peer: str | None, lane: int) -> Ingester:
        with self._lock:
            ing = self._ingesters.get((peer, lane))
            if ing is None:
                ing = Ingester(self.library, peer=peer)
                self._ingesters[(peer, lane)] = ing
            return ing

    @staticmethod
    def _take_deferred(ing: Ingester) -> tuple[dict[str, int], dict[str, int]]:
        clocks, caps = ing.deferred_clocks, ing.deferred_caps
        ing.deferred_clocks, ing.deferred_caps = {}, {}
        return clocks, caps

    def _persist_floors(self, clocks: dict[str, int]) -> bool:
        """Only-raise floor persistence, AFTER every lane txn committed —
        a floor must never run ahead of the durability of its ops."""
        if not clocks:
            return False
        db = self.library.db
        advanced = False
        with db.transaction():
            for pub_id, ts in clocks.items():
                row = db.find_one(Instance, {"pub_id": pub_id})
                if row is not None and (row["timestamp"] or 0) < ts:
                    db.update(Instance, {"pub_id": pub_id},
                              {"timestamp": ts})
                    advanced = True
        return advanced

    def _worker(self, idx: int, q: "queue.Queue[_LaneTask | None]") -> None:
        lane = str(idx)
        busy = _LANE_BUSY.labels(lane=lane)
        depth = _LANE_DEPTH.labels(lane=lane)
        ops_total = _LANE_OPS.labels(lane=lane)
        while True:
            task = q.get()
            depth.set(q.qsize())
            if task is None:
                return
            busy.set(1)
            try:
                ing = task.ingester
                with ing.session():  # one durable txn per lane task
                    for ops, ctx in task.parts:
                        task.applied += ing.receive(ops, ctx, defer_clocks=True)
                task.clocks, task.caps = self._take_deferred(ing)
                n_ops = sum(len(ops) for ops, _ctx in task.parts)
                self.ops_by_lane[idx] += n_ops
                ops_total.inc(n_ops)
            except Exception as e:
                # session txn rolled back: none of this lane's shards are
                # durable, so its clocks must not merge (re-pulled intact)
                self._take_deferred(task.ingester)
                task.error = e
                logger.exception("ingest lane %d failed", idx)
            finally:
                busy.set(0)
                task.done.set()

    # -- lifecycle / introspection -------------------------------------------
    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join(timeout=5)
        # fail any task queued behind the sentinel so its submitter
        # unblocks with an error instead of waiting on a dead worker
        for q in self._queues:
            while True:
                try:
                    task = q.get_nowait()
                except queue.Empty:
                    break
                if task is not None and not task.done.is_set():
                    task.error = RuntimeError("ingest lane pool closed")
                    task.done.set()
        # stop the merger and fail any submission still ticketed so a
        # pipelining submitter's wait() unblocks with an error
        if self._merger is not None:
            self._merge_q.put(None)
            self._merger.join(timeout=5)
            while True:
                try:
                    sub = self._merge_q.get_nowait()
                except queue.Empty:
                    break
                if sub is not None and not sub.done():
                    self._protect_unpersisted(sub)
                    sub._finish(RuntimeError("ingest lane pool closed"))

    def status(self) -> dict[str, Any]:
        return {
            "lanes": self.lanes,
            "queue_depths": [q.qsize() for q in self._queues],
            "queue_bound": LANE_DEPTH,
            "windows": self._windows,
            "submissions": self._submissions,
        }


_POOL_LOCK = threading.Lock()


def get_lane_pool(library: "Library", lanes: int | None = None) -> IngestLanes:
    """The library's shared lane pool (memoized on the library object;
    closed with it). Serialized: two first callers racing the check-then-
    set would each build a pool and leak the loser's K lane threads."""
    with _POOL_LOCK:
        pool = library.__dict__.get("_ingest_lanes")
        if pool is None or (lanes is not None and pool.lanes != lanes):
            if pool is not None:
                pool.close()
            pool = IngestLanes(library, lanes=lanes)
            library.__dict__["_ingest_lanes"] = pool
        return pool
