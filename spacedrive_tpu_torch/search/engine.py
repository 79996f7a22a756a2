"""SearchEngine: ``search.paths`` / ``search.pathsCount`` served from a
device-resident columnar index.

Counterpart of ``spacedrive_tpu/search/engine.py``. Each library gets a
:class:`~.columnar.ColumnarIndex` (the host master) and a
:class:`~.columnar.DeviceMirror` on ``node.device``; a query's filter
predicates are scored there by the CUDA kernels of :mod:`.kernels` and the
engine returns the matching row ids (or their count).

Correctness ladder (SQLite stays the oracle):

1. **Eligibility** — :func:`~.columnar.parse_predicate` accepts only filter
   sets the index answers bit-exactly; wildcards, tag subqueries and
   over-long needles stay on SQLite.
2. **Freshness** — a synchronous bus hook on ``db.commit`` (emitted by the
   jobs after every committed step and at exit), ``invalidate_query``
   (emitted by the API's mutations and at the end of the scan's jobs),
   ``sync.newMessage`` (emitted when sync logs or ingests operations) and
   ``job_progress`` bumps a per-library ``pending`` counter, a refresh stamps the index
   with the watermark it read under, and a query is served from the index
   ONLY when the two are equal. A post-commit query therefore never sees
   pre-watermark rows: while a refresh is in flight the query falls back to
   SQLite.
3. **Scoring** — on ``node.device``, always. A kernel that fails to build
   or launch raises out of :meth:`SearchEngine.count` /
   :meth:`SearchEngine.candidate_ids`: there is no CPU engine and no
   deadline to degrade to (the JAX package's hybrid router and its CPU
   engine are not ported, nor the ``sd_search_router_*`` families that
   describe them).
4. **Hydration** — the engine returns ROW IDS only; the handler re-runs the
   exact SQL SELECT over ``fp.id IN (...)`` so ORDER BY / LIMIT / cursor
   semantics reproduce the SQL path byte for byte. A candidate set larger
   than :attr:`SearchEngine.MAX_HYDRATE` goes back to SQL.

Refresh is **incremental**: appends ride an ``id > max_id`` scan
(AUTOINCREMENT ids are monotonic), updates/deletes ride the
:class:`~..models.base.RowJournal` change feed (model-helper writes note
their row; raw writes flood → full rebuild), and a COUNT(*) verify catches
anything that slipped past both (FK cascades into file_path). A refresh also
brings the device mirror up to date, so queries never pay the upload.

``SD_SEARCH_ENGINE=device`` arms the engine (default ``sqlite`` keeps every
query on the SQL path), as in the JAX package.

:meth:`SearchEngine.prefers_inprocess` is the router's question at dispatch
(reference :236-262): True when the handler in this process will serve the
query from the device index (an engine procedure, the library registered
and fresh, the predicate eligible, and for ``search.paths`` a filter whose
candidate set has not overflowed ``MAX_HYDRATE``), so the pool and the
replica tier, which have no index, are skipped. The first sighting of a
library registers it and answers False while the index builds.

Telemetry (reference :86-103): ``sd_search_queries_total{backend}`` and
``sd_search_query_seconds{backend}`` (``device`` for the kernels on the
card, ``cpu`` for their plain versions on a CPU node, ``sqlite`` for a
handler that served SQL while the engine is armed; an engine query's time
ends at the mask's one read back to the host, :func:`.columnar.eval_mask_device`),
``sd_search_fallbacks_total{reason}`` (``ineligible``, ``stale``,
``toolarge``), ``sd_search_refresh_{seconds,total}`` and, per library (its
id's first 8 characters), ``sd_search_index_{rows,bytes}`` and
``sd_search_refresh_lag`` (watermark bumps behind; 0 is fresh).

An incremental refresh reads the changed rows, the appended rows and the
row count in one read snapshot (:meth:`..models.base.Database.snapshot`),
so a write committed between those reads cannot make the count disagree
with the rows and force a needless full rebuild.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import TYPE_CHECKING, Any

import numpy as np

from .. import telemetry
from . import columnar
from .columnar import ColumnarIndex, DeviceMirror, parse_predicate

if TYPE_CHECKING:
    from ..library import Library
    from ..node import Node

logger = logging.getLogger(__name__)

#: the events that move a library's watermark, the reference's set
#: (``sync.newMessage``: a peer's operations were ingested, or this
#: library logged its own); over-bumping costs a refresh, under-bumping
#: would serve stale rows
BUMP_KINDS = frozenset({"db.commit", "invalidate_query", "sync.newMessage",
                        "job_progress"})

#: procedures the engine can serve
ENGINE_PROCS = frozenset({"search.paths", "search.pathsCount"})

# help texts live in telemetry._declare_core
_INDEX_ROWS = telemetry.gauge("sd_search_index_rows", labels=("library",))
_INDEX_BYTES = telemetry.gauge("sd_search_index_bytes", labels=("library",))
_REFRESH_SECONDS = telemetry.histogram("sd_search_refresh_seconds")
_REFRESH_TOTAL = telemetry.counter("sd_search_refresh_total", labels=("kind",))
_REFRESH_LAG = telemetry.gauge("sd_search_refresh_lag", labels=("library",))
_QUERIES = telemetry.counter("sd_search_queries_total", labels=("backend",))
_QUERY_SECONDS = telemetry.histogram("sd_search_query_seconds", labels=("backend",))
_FALLBACKS = telemetry.counter("sd_search_fallbacks_total", labels=("reason",))


class _LibState:
    """Per-library index + watermark state (all mutation under ``lock``)."""

    __slots__ = ("lib_id", "lock", "wm_lock", "refresh_lock", "index",
                 "mirror", "journal", "pending", "built_wm")

    def __init__(self, lib_id: str, journal, device) -> None:
        self.lib_id = lib_id
        self.lock = threading.Lock()
        # watermark fields get their own tiny lock so the SYNCHRONOUS
        # post-commit bump hook never waits behind a scoring pass or a
        # refresh holding ``lock``. Nesting order where both are held:
        # lock → wm_lock.
        self.wm_lock = threading.Lock()
        # serializes whole refresh passes (refresher thread vs a synchronous
        # refresh_now): two interleaved passes could drain the journal in
        # one and stamp freshness from the other
        self.refresh_lock = threading.Lock()
        self.index: ColumnarIndex | None = None
        self.mirror = DeviceMirror(device)
        self.journal = journal
        self.pending = 0       # bumped by the bus hook, post-commit
        self.built_wm = -1     # pending value the index was built under

    def fresh(self) -> bool:
        """Watermark equality under ``wm_lock`` only — safe to call with or
        without ``lock`` held."""
        with self.wm_lock:
            return self.index is not None and self.built_wm == self.pending


class SearchEngine:
    """One per Node (``node.search_engine``); None when the gate is off."""

    #: largest candidate set hydrated through ``fp.id IN (...)``; past it
    #: the plain SQL scan serves (an IN-list that long would lose to it)
    MAX_HYDRATE = 20_000

    def __init__(self, node: "Node") -> None:
        self.node = node
        self.enabled = True
        self._states: dict[str, _LibState] = {}
        self._states_lock = threading.Lock()
        #: filter signatures whose candidate set overflowed MAX_HYDRATE:
        #: those dispatches keep going to the pool (or a peer) instead of
        #: being scored here only to run their SQL scan in this process.
        #: Bounded, evicted in insertion order.
        self._toolarge: dict[str, None] = {}
        self._served = 0
        #: the ``backend`` label of the engine's queries
        self._backend = "device" if node.device.type == "cuda" else "cpu"
        self._refreshes = {"full": 0, "incremental": 0}
        self._wake = threading.Event()
        self._stopped = threading.Event()
        node.events.on(self._on_event)
        self._refresher_thread = threading.Thread(
            target=self._refresher, name="sd-search-refresher", daemon=True)
        self._refresher_thread.start()

    @classmethod
    def maybe_start(cls, node: "Node") -> "SearchEngine | None":
        """``SD_SEARCH_ENGINE=sqlite|device`` — default sqlite (the gate)."""
        gate = os.environ.get("SD_SEARCH_ENGINE", "sqlite").strip().lower()
        if gate != "device":
            return None
        return cls(node)

    def stop(self) -> None:
        self._stopped.set()
        self._wake.set()
        self.node.events.off(self._on_event)
        self._refresher_thread.join(timeout=30)

    def set_enabled(self, value: bool) -> None:
        """Runtime bypass (the engine-vs-SQLite A/B): disabled, every lookup
        returns None and the handler serves SQL."""
        self.enabled = bool(value)

    # -- invalidation ----------------------------------------------------------
    def _on_event(self, event) -> None:
        if event.kind not in BUMP_KINDS or not event.library_id:
            return
        state = self._states.get(event.library_id)
        if state is None:
            return
        with state.wm_lock:
            state.pending += 1
        self._wake.set()

    # -- registration ----------------------------------------------------------
    def _ensure(self, library: "Library") -> _LibState:
        state = self._states.get(library.id)
        if state is not None:
            return state
        with self._states_lock:
            state = self._states.get(library.id)
            if state is None:
                journal = library.db.attach_row_journal(
                    ("file_path", "object"), flood_on_delete=("object",))
                state = _LibState(library.id, journal, self.node.device)
                self._states[library.id] = state
                self._wake.set()  # kick the initial build
        return state

    # -- dispatch-time routing (the router's pool and replica bypass) ----------
    def prefers_inprocess(self, key: str, library_id: str | None, arg: Any) -> bool:
        """True when this dispatch should skip the reader pool and the
        replica tier because the handler here will serve it from the
        device index. One dict lookup and a predicate parse, no scoring."""
        if key not in ENGINE_PROCS or not self.enabled or not library_id:
            return False
        state = self._states.get(library_id)
        if state is None:
            # first sighting: register the library (it builds in the
            # background) and let the other rungs serve meanwhile
            try:
                self._ensure(self.node.libraries.get(library_id))
            except KeyError:
                pass
            return False
        if not state.fresh():
            return False
        pred, _why = parse_predicate(arg or {})
        if pred is None:
            return False
        if key == "search.paths":  # a count never hydrates: no size limit
            with self._states_lock:
                if self._filter_sig(library_id, arg) in self._toolarge:
                    return False
        return True

    _FILTER_KEYS = ("location_id", "search", "extensions", "kinds", "favorite",
                    "include_hidden", "materialized_path", "tags", "date_range",
                    "size_range")

    @classmethod
    def _filter_sig(cls, lib_id: str | None, arg: Any) -> str:
        arg = arg if isinstance(arg, dict) else {}
        try:
            return f"{lib_id}|" + json.dumps({k: arg.get(k) for k in cls._FILTER_KEYS},
                                             sort_keys=True, default=str)
        except (TypeError, ValueError):
            return f"{lib_id}|?"

    # -- the query surface -----------------------------------------------------
    def count(self, library: "Library", arg: Any) -> int | None:
        """search.pathsCount: the full answer (a mask sum), or None → serve
        SQL."""
        got = self._query(library, arg)
        if got is None:
            return None
        mask, _ids = got
        return int(mask.sum())

    def candidate_ids(self, library: "Library", arg: Any) -> np.ndarray | None:
        """search.paths: the EXACT matching row-id set for the filter
        predicates (ordering/cursor/limit stay in SQL), or None → serve SQL
        (also when the set is larger than ``MAX_HYDRATE``)."""
        got = self._query(library, arg)
        if got is None:
            return None
        _mask, ids = got
        if len(ids) > self.MAX_HYDRATE:
            _FALLBACKS.inc(reason="toolarge")
            with self._states_lock:
                self._toolarge[self._filter_sig(library.id, arg)] = None
                while len(self._toolarge) > 256:
                    self._toolarge.pop(next(iter(self._toolarge)))
            return None
        return ids

    def _query(self, library: "Library",
               arg: Any) -> tuple[np.ndarray, np.ndarray] | None:
        if not self.enabled:
            return None
        pred, why = parse_predicate(arg or {})
        if pred is None:
            _FALLBACKS.inc(reason=why or "ineligible")
            return None
        state = self._ensure(library)
        with state.lock:
            if not state.fresh():
                _FALLBACKS.inc(reason="stale")
                self._wake.set()
                return None
            t0 = time.perf_counter()
            # a host mask: the time ends at its one read back from the card
            mask = columnar.eval_mask_device(state.index, state.mirror, pred)
            dt = time.perf_counter() - t0
            ids = state.index.ids[: state.index.n][mask]
        _QUERIES.inc(backend=self._backend)
        _QUERY_SECONDS.observe(dt, backend=self._backend)
        with self._states_lock:
            self._served += 1
        return mask, ids

    def note_sqlite_serve(self, seconds: float) -> None:
        """A handler served SQL while the engine is armed."""
        _QUERIES.inc(backend="sqlite")
        _QUERY_SECONDS.observe(seconds, backend="sqlite")

    # -- refresh ---------------------------------------------------------------
    def refresh_now(self, library: "Library") -> None:
        """Synchronous refresh to the current watermark."""
        state = self._ensure(library)
        with state.refresh_lock:
            self._refresh_state_locked(state)

    def _refresher(self) -> None:
        while not self._stopped.is_set():
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            if self._stopped.is_set():
                return
            for state in list(self._states.values()):
                if state.fresh():
                    continue
                try:
                    with state.refresh_lock:
                        self._refresh_state_locked(state)
                except Exception:
                    # a failed refresh leaves the index stale — queries keep
                    # falling back to SQLite, the next bump retries
                    logger.exception("search index refresh failed for %s",
                                     state.lib_id)

    def _refresh_state_locked(self, state: _LibState) -> None:
        """Bring the index (and its device mirror) up to the library's
        current watermark. SELECTs and a full build run outside the state
        lock; only the swap or the incremental mutation takes it. Loops until
        the watermark is stable across a whole pass."""
        for _ in range(64):  # watermark churn bound; stale is always safe
            if self._stopped.is_set():
                return
            try:
                library = self.node.libraries.get(state.lib_id)
            except KeyError:
                return  # unloaded
            with state.lock:
                with state.wm_lock:
                    w0 = state.pending
                idx = state.index
                max_id = idx.max_id if idx is not None else 0
            drained = state.journal.drain()
            t0 = time.perf_counter()
            if idx is None or drained["flood"]:
                rows = library.db.query(columnar.LOADER_SQL + " ORDER BY fp.id")
                new_idx = ColumnarIndex()
                new_idx.build(rows)
                del rows
                mirror = DeviceMirror(self.node.device)
                mirror.sync(new_idx)
                with state.lock:
                    with state.wm_lock:
                        state.index, state.mirror = new_idx, mirror
                        state.built_wm = w0
                        done = state.pending == w0
                with self._states_lock:
                    self._refreshes["full"] += 1
                _REFRESH_TOTAL.inc(kind="full")
            else:
                dirty = self._resolve_dirty(library, drained)
                if dirty is None:
                    # unresolvable note (vanished pub_id): full next pass
                    state.journal.publish_one("file_path", "flood", None)
                    continue
                # one snapshot: a write committed between these reads
                # would make the count disagree with the rows
                with library.db.snapshot() as query:
                    fresh_rows = self._load_rows(query, dirty)
                    appends = query(columnar.LOADER_SQL + " WHERE fp.id > ? ORDER BY fp.id",
                                    [max_id])
                    total = query("SELECT COUNT(*) n FROM file_path")[0]["n"]
                with state.lock:
                    if state.index is not idx:
                        continue
                    ok = True
                    found = set()
                    for row in fresh_rows:
                        found.add(int(row["id"]))
                        ok = ok and idx.upsert(row)
                    for row_id in dirty:
                        if row_id not in found:
                            idx.delete_id(row_id)
                    for row in appends:
                        ok = ok and idx.upsert(row)
                    ok = ok and idx.alive_count == total
                    if ok:
                        state.mirror.sync(idx)
                        with state.wm_lock:
                            state.built_wm = w0
                            done = state.pending == w0
                if not ok:
                    # out-of-order insert or an untracked cascade into
                    # file_path (e.g. a location CASCADE delete): rebuild
                    state.journal.publish_one("file_path", "flood", None)
                    continue
                with self._states_lock:
                    self._refreshes["incremental"] += 1
                _REFRESH_TOTAL.inc(kind="incremental")
            _REFRESH_SECONDS.observe(time.perf_counter() - t0)
            self._publish_gauges(state)
            if done:
                return

    def _publish_gauges(self, state: _LibState) -> None:
        label = state.lib_id[:8]
        with state.lock:
            idx = state.index
            if idx is not None:
                _INDEX_ROWS.set(idx.alive_count, library=label)
                _INDEX_BYTES.set(idx.nbytes, library=label)
            with state.wm_lock:
                lag = max(0, state.pending - state.built_wm)
        _REFRESH_LAG.set(lag, library=label)

    def _resolve_dirty(self, library: "Library",
                       drained: dict[str, Any]) -> set[int] | None:
        """Journal notes → the file_path row-id set to re-select; None when a
        note cannot be resolved (forces a full rebuild)."""
        dirty: set[int] = set(drained["ids"].get("file_path", ()))
        fp_pubs = drained["pub_ids"].get("file_path", set())
        if fp_pubs:
            resolved = self._ids_for(
                library, "SELECT id FROM file_path WHERE pub_id IN ({})",
                sorted(fp_pubs))
            if len(resolved) < len(fp_pubs):
                return None  # a pub_id vanished: deletion we can't place
            dirty |= resolved
        obj_ids = drained["ids"].get("object", set())
        if obj_ids:
            dirty |= self._ids_for(
                library, "SELECT id FROM file_path WHERE object_id IN ({})",
                sorted(obj_ids))
        obj_pubs = drained["pub_ids"].get("object", set())
        if obj_pubs:
            dirty |= self._ids_for(
                library,
                "SELECT id FROM file_path WHERE object_id IN "
                "(SELECT id FROM object WHERE pub_id IN ({}))",
                sorted(obj_pubs))
        return dirty

    @staticmethod
    def _ids_for(library: "Library", sql_tpl: str, values: list) -> set[int]:
        out: set[int] = set()
        for lo in range(0, len(values), 500):
            chunk = values[lo: lo + 500]
            marks = ",".join("?" for _ in chunk)
            for row in library.db.query(sql_tpl.format(marks), chunk):
                out.add(int(row["id"]))
        return out

    @staticmethod
    def _load_rows(query, ids: set[int]) -> list:
        rows: list = []
        ordered = sorted(ids)
        for lo in range(0, len(ordered), 500):
            chunk = ordered[lo: lo + 500]
            marks = ",".join("?" for _ in chunk)
            rows.extend(query(columnar.LOADER_SQL + f" WHERE fp.id IN ({marks})", chunk))
        return rows

    # -- introspection ---------------------------------------------------------
    def status(self) -> dict[str, Any]:
        libs = {}
        for lib_id, state in list(self._states.items()):
            with state.lock:
                idx = state.index
                with state.wm_lock:
                    pending, built_wm = state.pending, state.built_wm
                libs[lib_id] = {
                    "rows": idx.alive_count if idx is not None else 0,
                    "bytes": idx.nbytes if idx is not None else 0,
                    "overflow_rows": len(idx.overflow) if idx else 0,
                    "pending": pending,
                    "built_wm": built_wm,
                    "fresh": state.fresh(),
                    "mirror_uploads": state.mirror.uploads,
                    "mirror_patches": state.mirror.patches,
                    "mirror_cap": state.mirror.cap,
                    "mirror_bytes": sum(t.numel() * t.element_size()
                                        for t in state.mirror.arrays.values()),
                }
        return {
            "enabled": self.enabled,
            "device": str(self.node.device),
            "served": self._served,
            "refreshes": dict(self._refreshes),
            "libraries": libs,
        }
