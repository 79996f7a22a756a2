"""Structured spans: per-job trace trees with JSONL export.

A :class:`Trace` is one job run's tree of timed spans. The worker opens
the trace (root span = the job), the pipeline executor and job code open
child spans with ``with trace.span("pipeline.page"): ...`` — nesting
follows each *thread's* own span stack (the prefetch/dispatch/commit
threads each build their own chain under the root), so a pipelined run
produces the same tree shape a sequential run does, just with
overlapping timestamps.

Spans always MEASURE (two ``perf_counter`` calls) even when telemetry is
disabled or no trace exists — the stage timings that feed job reports
(``pipeline_page_s``, ``gather_s``…) read span durations, so the report
contract cannot depend on the telemetry switch. Only *recording* (the
tree, the JSONL file, the ``telemetry.jobTrace`` query) is gated: with
no trace a span is a plain timer.

Export: ``<data_dir>/logs/traces/<trace_id>.jsonl``, one span record per
line (trace_id, span_id, parent_id, name, start_unix, duration_s,
attrs). Completed traces also stay in a bounded in-process ring so
``telemetry.jobTrace`` serves them without touching disk.
"""

from __future__ import annotations

import itertools
import json
import logging
import re
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

#: completed traces kept in memory for the jobTrace query (ring, FIFO)
MAX_TRACES = 128

ROOT_SPAN_ID = 0

#: the innermost trace the CURRENT THREAD has an open span in — how code
#: far from the worker (the remote-hasher dispatch, a p2p request) finds
#: the trace context to propagate without threading it through every call
_CURRENT = threading.local()

#: the innermost OPEN span per thread id, as (trace_id, span name) — the
#: cross-thread mirror of the thread-local above. The sampling profiler
#: (telemetry/profiler.py) attributes wall samples from ITS thread to the
#: sampled thread's active span, and a thread-local cannot be read from
#: another thread. Plain dict ops are atomic under the GIL; entries are
#: removed when a thread's span stack empties, so the dict stays bounded
#: by live threads.
_ACTIVE_BY_THREAD: dict[int, tuple[str, str]] = {}


def current_trace() -> "Trace | None":
    return getattr(_CURRENT, "trace", None)


def active_span(tid: int) -> tuple[str, str] | None:
    """(trace_id, span name) of the innermost open span on thread ``tid``,
    or None while that thread has no span open — the profiler's
    attribution read (any thread may call this about any other)."""
    return _ACTIVE_BY_THREAD.get(tid)


class Span:
    """A timed section. Context manager; reentrant-unsafe by design (one
    span object = one enter/exit)."""

    __slots__ = ("name", "attrs", "trace", "span_id", "parent_id",
                 "start_unix", "duration_s", "error", "_t0", "_pinned",
                 "_detached")

    def __init__(self, name: str, trace: "Trace | None" = None,
                 attrs: dict[str, Any] | None = None,
                 parent: "Span | None" = None,
                 parent_id: int | None = None,
                 detached: bool = False) -> None:
        self.name = name
        self.trace = trace
        self.attrs = attrs or {}
        self.span_id = -1
        self.parent_id = ROOT_SPAN_ID
        self.start_unix = 0.0
        self.duration_s = 0.0
        self.error = False
        self._t0 = 0.0
        # explicit cross-thread parent (pipeline stage threads open their
        # spans under the job thread's pipeline.run span; the per-thread
        # stack cannot see it). ``parent_id`` pins a parent known only by
        # id — the CROSS-NODE case, where the parent span lives in another
        # process and arrived as a trace-context envelope (telemetry/mesh).
        # a DETACHED span never joins any thread's nesting stack: it is
        # entered on one thread and exited on another (the sharded
        # prefetch page span — opened by the split coordinator, closed by
        # the ordered merger), so stack-based nesting would corrupt the
        # opener's chain. Children attach via an explicit ``parent=`` pin;
        # the detached span itself must pin its own parent (or root).
        self._detached = detached
        self._pinned = False
        if parent is not None and parent.span_id >= 0:
            self.parent_id = parent.span_id
            self._pinned = True
        elif parent_id is not None and parent_id >= 0:
            self.parent_id = parent_id
            self._pinned = True

    def set(self, **attrs: Any) -> None:
        """Attach attributes discovered mid-span (byte counts, batch
        sizes)."""
        self.attrs.update(attrs)

    def elapsed_s(self) -> float:
        """Seconds since entry — usable while the span is still open."""
        return time.perf_counter() - self._t0

    def __enter__(self) -> "Span":
        if self.trace is not None:
            self.trace._enter(self)
        self.start_unix = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, _exc, _tb) -> bool:
        self.duration_s = time.perf_counter() - self._t0
        if exc_type is not None:
            self.error = True
        if self.trace is not None:
            self.trace._exit(self)
        return False


class Trace:
    """One job run's span tree. Thread-safe: each thread nests along its
    own stack; finished spans append under one lock."""

    def __init__(self, trace_id: str, name: str,
                 attrs: dict[str, Any] | None = None,
                 span_id_base: int = 0) -> None:
        self.trace_id = trace_id
        self.name = name
        self.attrs = dict(attrs or {})
        self.finished = False
        self._final_s: float | None = None
        self._lock = threading.Lock()
        # ``span_id_base``: mesh traces allocate ids above a per-node base
        # so two nodes appending to ONE logical trace (stitched later by
        # trace_id) can never collide on span ids
        self._ids = itertools.count(span_id_base + 1)
        self._records: list[dict[str, Any]] = []
        self._tls = threading.local()
        self._root_start_unix = time.time()
        self._root_t0 = time.perf_counter()

    # -- span plumbing -------------------------------------------------------
    def span(self, name: str, parent: Span | None = None,
             parent_id: int | None = None, detached: bool = False,
             **attrs: Any) -> Span:
        """``parent`` pins an explicit (possibly cross-thread) parent;
        ``parent_id`` pins a remote (cross-node) parent by bare id;
        ``detached`` makes a span owned by no thread stack (enter and
        exit may happen on different threads); otherwise the opening
        thread's current span is the parent."""
        return Span(name, trace=self, attrs=attrs, parent=parent,
                    parent_id=parent_id, detached=detached)

    def _stack(self) -> list[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def _enter(self, span: Span) -> None:
        if span._detached:
            # no stack, no thread-local bookkeeping: just an id. The
            # parent must be pinned explicitly (or defaults to the root).
            span.span_id = next(self._ids)
            return
        stack = self._stack()
        if not span._pinned:
            span.parent_id = stack[-1].span_id if stack else ROOT_SPAN_ID
        span.span_id = next(self._ids)
        stack.append(span)
        _CURRENT.trace = self
        # deliberately lock-free: each thread writes only ITS OWN key and
        # single dict ops are GIL-atomic; the profiler's cross-thread read
        # tolerates a stale entry (one mis-attributed sample)
        _ACTIVE_BY_THREAD[threading.get_ident()] = (self.trace_id, span.name)

    def current_span_id(self) -> int:
        """Id of the calling thread's innermost open span (the root when
        none is open) — what an outbound trace-context envelope carries."""
        stack = self._stack()
        return stack[-1].span_id if stack else ROOT_SPAN_ID

    def _exit(self, span: Span) -> None:
        if span._detached:
            self._record(span)
            return
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # mismatched nesting: drop back to it
            del stack[stack.index(span):]
        tid = threading.get_ident()
        # lock-free per-thread key writes, like _enter (GIL-atomic)
        if stack:
            _ACTIVE_BY_THREAD[tid] = (self.trace_id, stack[-1].name)
        else:
            _ACTIVE_BY_THREAD.pop(tid, None)
        if not stack and getattr(_CURRENT, "trace", None) is self:
            _CURRENT.trace = None
        self._record(span)

    def _record(self, span: Span) -> None:
        record = {
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "name": span.name,
            "start_unix": round(span.start_unix, 6),
            "duration_s": round(span.duration_s, 6),
        }
        if span.attrs:
            record["attrs"] = span.attrs
        if span.error:
            record["error"] = True
        with self._lock:
            self._records.append(record)

    def event(self, name: str, **attrs: Any) -> None:
        """A zero-duration marker in the tree (a fault fired, an edge)."""
        record: dict[str, Any] = {
            "span_id": next(self._ids),
            "parent_id": ROOT_SPAN_ID,
            "name": name,
            "start_unix": round(time.time(), 6),
            "duration_s": 0.0,
            "event": True,
        }
        if attrs:
            record["attrs"] = attrs
        with self._lock:
            self._records.append(record)

    # -- lifecycle -----------------------------------------------------------
    def elapsed_s(self) -> float:
        return time.perf_counter() - self._root_t0

    def finish(self) -> None:
        if self.finished:
            return
        final_s = round(self.elapsed_s(), 6)
        root = {
            "span_id": ROOT_SPAN_ID,
            "parent_id": None,
            "name": self.name,
            "start_unix": round(self._root_start_unix, 6),
            "duration_s": final_s,
        }
        if self.attrs:
            root["attrs"] = self.attrs
        with self._lock:
            self._records.append(root)
            self.finished = True
            self._final_s = final_s

    # -- reads ---------------------------------------------------------------
    def records(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._records)

    def tree(self) -> dict[str, Any]:
        recs = self.records()
        if not any(r["span_id"] == ROOT_SPAN_ID for r in recs):
            recs.append({"span_id": ROOT_SPAN_ID, "parent_id": None,
                         "name": self.name,
                         "start_unix": round(self._root_start_unix, 6),
                         "duration_s": round(self.elapsed_s(), 6),
                         "attrs": self.attrs or {}})
        return build_tree(self.trace_id, recs)

    def totals(self) -> dict[str, dict[str, float]]:
        """Aggregate finished spans by name: {name: {count, total_s}} —
        the summarized form attached to JobReport metadata."""
        out: dict[str, dict[str, float]] = {}
        for r in self.records():
            if r.get("event"):
                continue
            agg = out.setdefault(r["name"], {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] = round(agg["total_s"] + r["duration_s"], 6)
        return out

    def total_s(self, name: str) -> float:
        """Summed duration of every finished span called ``name`` — how
        stage timings flow from span data back into job metadata."""
        return self.totals().get(name, {}).get("total_s", 0.0)

    def summary(self) -> dict[str, Any]:
        # a finished trace's duration is FROZEN at finish() — snapshots
        # read long after completion must not report ever-growing values
        final = self._final_s
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "duration_s": (final if final is not None
                           else round(self.elapsed_s(), 6)),
            "spans": self.totals(),
        }


def build_tree(trace_id: str, records: list[dict[str, Any]]) -> dict[str, Any]:
    """Nest flat span records into the root's tree (children ordered by
    start time). Orphans (parent never finished) attach to the root."""
    nodes = {r["span_id"]: {**r, "children": []} for r in records}
    root = nodes.get(ROOT_SPAN_ID)
    if root is None:
        root = {"span_id": ROOT_SPAN_ID, "parent_id": None, "name": "?",
                "start_unix": 0.0, "duration_s": 0.0, "children": []}
        nodes[ROOT_SPAN_ID] = root
    for r in sorted(records, key=lambda r: (r["start_unix"], r["span_id"])):
        if r["span_id"] == ROOT_SPAN_ID:
            continue
        parent = nodes.get(r.get("parent_id"), root)
        if parent is nodes[r["span_id"]]:
            parent = root
        parent["children"].append(nodes[r["span_id"]])
    root["trace_id"] = trace_id
    return root


# -- the in-process trace ring -------------------------------------------------

_TRACES_LOCK = threading.Lock()
_TRACES: "OrderedDict[str, Trace]" = OrderedDict()


def remember(trace: Trace) -> None:
    with _TRACES_LOCK:
        _TRACES[trace.trace_id] = trace
        _TRACES.move_to_end(trace.trace_id)
        while len(_TRACES) > MAX_TRACES:
            _TRACES.popitem(last=False)


def get_trace(trace_id: str) -> Trace | None:
    with _TRACES_LOCK:
        return _TRACES.get(trace_id)


def recent_traces(limit: int = 16) -> list[dict[str, Any]]:
    with _TRACES_LOCK:
        traces = list(_TRACES.values())[-limit:]
    return [t.summary() for t in reversed(traces)]


def clear_traces() -> None:
    with _TRACES_LOCK:
        _TRACES.clear()


# -- JSONL export / reload -----------------------------------------------------

def traces_dir(base_dir: str | Path) -> Path:
    return Path(base_dir) / "logs" / "traces"


def export_trace(trace: Trace, base_dir: str | Path) -> str | None:
    """Write one JSONL file per trace — atomically (tempfile→fsync→rename,
    utils/atomic), so a kill mid-export can never leave a torn file under
    the export name. Best-effort: a full disk (the ``trace_export`` chaos
    seam rehearses it) degrades to the in-memory ring only, and must not
    fail the job that owns the trace."""
    try:
        from .. import faults
        from ..atomic import atomic_write_text

        faults.inject("trace_export", key=trace.trace_id)
        out_dir = traces_dir(base_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{trace.trace_id}.jsonl"
        atomic_write_text(path, "".join(
            json.dumps({"trace_id": trace.trace_id, **record}, default=str)
            + "\n" for record in trace.records()))
        return str(path)
    except OSError as e:
        import errno as _errno

        if getattr(e, "errno", None) == _errno.ENOSPC:
            from ..retry import note_disk_full

            note_disk_full("trace_export")
        logger.exception("could not export trace %s (serving from the "
                         "in-memory ring only)", trace.trace_id)
        return None


#: trace ids are job-report UUIDs; anything else (path separators, "..")
#: must never reach the filesystem — jobTrace takes caller-supplied ids
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def load_trace_tree(trace_id: str, base_dir: str | Path) -> dict[str, Any] | None:
    """Rebuild an exported trace's tree (the jobTrace fallback after the
    in-memory ring evicted it or the process restarted).

    Tolerates torn lines: a crash mid-append (pre-atomic exports, or a
    file truncated by a full disk) leaves a final line cut mid-record —
    that line is skipped with a warning instead of poisoning the whole
    export. Only a file with NO decodable record reads as missing."""
    if not _TRACE_ID_RE.match(trace_id) or ".." in trace_id:
        return None
    path = traces_dir(base_dir) / f"{trace_id}.jsonl"
    try:
        lines = path.read_text().splitlines()
    except OSError:
        return None
    records = []
    dropped = 0
    for line in lines:
        if not line.strip():
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            dropped += 1
            continue
        if isinstance(record, dict) and "span_id" in record:
            records.append(record)
        else:
            dropped += 1
    if dropped:
        logger.warning("trace %s: skipped %d torn/garbage line(s) in %s",
                       trace_id, dropped, path.name)
    if not records:
        return None
    return build_tree(trace_id, records)
