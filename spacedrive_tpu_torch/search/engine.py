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
2. **Freshness** — a synchronous ``db.commit`` bus hook (emitted by the
   jobs after every committed step and at exit) bumps a per-library
   ``pending`` counter, a refresh stamps the index
   with the watermark it read under, and a query is served from the index
   ONLY when the two are equal. A post-commit query therefore never sees
   pre-watermark rows: while a refresh is in flight the query falls back to
   SQLite.
3. **Scoring** — on ``node.device``, always. A kernel that fails to build
   or launch raises out of :meth:`SearchEngine.count` /
   :meth:`SearchEngine.candidate_ids`: there is no CPU engine and no
   deadline to degrade to (the JAX package's hybrid router, its CPU engine
   and its telemetry are not ported).
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
"""

from __future__ import annotations

import logging
import os
import threading
from typing import TYPE_CHECKING, Any

import numpy as np

from . import columnar
from .columnar import ColumnarIndex, DeviceMirror, parse_predicate

if TYPE_CHECKING:
    from ..library import Library
    from ..node import Node

logger = logging.getLogger(__name__)

#: the event that moves a library's watermark (over-bumping costs a
#: refresh, under-bumping would serve stale rows)
BUMP_KIND = "db.commit"


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
        self._served = 0
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
        if event.kind != BUMP_KIND or not event.library_id:
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
            return None
        return ids

    def _query(self, library: "Library",
               arg: Any) -> tuple[np.ndarray, np.ndarray] | None:
        if not self.enabled:
            return None
        pred, _why = parse_predicate(arg or {})
        if pred is None:
            return None
        state = self._ensure(library)
        with state.lock:
            if not state.fresh():
                self._wake.set()
                return None
            mask = columnar.eval_mask_device(state.index, state.mirror, pred)
            ids = state.index.ids[: state.index.n][mask]
        with self._states_lock:
            self._served += 1
        return mask, ids

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
            else:
                dirty = self._resolve_dirty(library, drained)
                if dirty is None:
                    # unresolvable note (vanished pub_id): full next pass
                    state.journal.publish_one("file_path", "flood", None)
                    continue
                fresh_rows = self._load_rows(library, dirty)
                appends = library.db.query(
                    columnar.LOADER_SQL + " WHERE fp.id > ? ORDER BY fp.id",
                    [max_id])
                total = library.db.query(
                    "SELECT COUNT(*) n FROM file_path")[0]["n"]
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
            if done:
                return

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
    def _load_rows(library: "Library", ids: set[int]) -> list:
        rows: list = []
        ordered = sorted(ids)
        for lo in range(0, len(ordered), 500):
            chunk = ordered[lo: lo + 500]
            marks = ",".join("?" for _ in chunk)
            rows.extend(library.db.query(
                columnar.LOADER_SQL + f" WHERE fp.id IN ({marks})", chunk))
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
