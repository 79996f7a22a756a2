"""Sync ingest: receive → arbitrate against the op log → apply → log → clock.

A copy of ``spacedrive_tpu/sync/ingest.py`` (:class:`Ingester` and the pull
loop :class:`Actor`). The op log IS the CRDT state:

- EVERY op is logged (even ones with no materialized effect), so shadow
  information propagates transitively and future arbitration sees the full
  history;
- an op's *effect* is computed against the record's logged history with a
  deterministic (timestamp, op-id) total order — equivalent to replaying the
  record's ops in timestamp order, so every arrival order converges
  (tests/test_sync.py::test_cross_kind_arrival_order_converges proves all
  4! permutations agree):

  * update u:f applies unless a later delete, same-field update, or a later
    create that specifies f exists (per-field LWW);
  * create applies unless a later create/delete exists; fields with later
    updates are stripped, the rest merge into the row;
  * delete with no later create/update removes the row; with later ops it
    takes PARTIAL effect — fields last written before the delete are
    cleared, the row survives (exactly the in-order outcome where the
    delete removes the row and later updates re-materialize it).

An op that fails to apply for a reason in its content is logged without
effect; one that fails transiently (the ``sync_apply`` fault seam sits
before each apply) is a poison op: its origin's floor is capped below it
across windows (:class:`PoisonCaps`) until a later round logs it.

Telemetry, as the reference's: per peer (:func:`..telemetry.mesh.peer_label`)
``sd_sync_ops_ingested_total``, ``sd_sync_ops_applied_total``,
``sd_sync_window_seconds``, ``sd_sync_shed_replays_total`` and
``sd_sync_apply_delay_seconds`` (each op durably logged this window, its
HLC stamp against the wall clock). ``receive`` takes the sender's
trace-context envelope (``ctx``): the window's ``sync.apply`` span parents
under the sender's span in the trace it names, and the envelope's
watermark and backlog move ``sd_sync_peer_lag_{ops,seconds}``. The plain
:data:`STATS` keep the process's totals. An :class:`Actor` whose pull round raises keeps the exception
(:attr:`Actor.error`) and stops pulling: its caller reads it, nothing logs
it away.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import queue
import sys
import threading
import time
from typing import TYPE_CHECKING, Any, Callable

from .. import faults, telemetry
from ..telemetry import mesh
from ..models import Instance, RelationOperationRow, SharedOperationRow
from .apply import ApplyError, apply_relation, apply_shared, model_for
from .hlc import to_unix
from .crdt import CREATE, DELETE, UPDATE_PREFIX, CRDTOperation, RelationOp, SharedOp
from .manager import SyncMessage

if TYPE_CHECKING:
    from ..library import Library

logger = logging.getLogger(__name__)

#: transport: clocks, count -> (wire_ops, has_more). A direct call to the
#: peer library's ``sync.get_ops`` until p2p carries it over the network.
Transport = Callable[[dict[str, int], int], tuple[list[dict[str, Any]], bool]]

BATCH = 100  # GetOpsArgs.count used by the reference's integration test
#: production pull window: large enough that the batch prefetch and the
#: optimistic single-savepoint pass amortize per-window costs
PROD_BATCH = 1000
#: ops per durable flush when windows are grouped in an ingest session —
#: bounds both the WAL commit cadence and how much a mid-round failure
#: can roll back (everything re-pulls idempotently either way)
SESSION_FLUSH_OPS = 4000

_OPS_INGESTED = telemetry.counter(
    "sd_sync_ops_ingested_total", "CRDT ops received for ingest",
    labels=("peer",))
_OPS_APPLIED = telemetry.counter(
    "sd_sync_ops_applied_total",
    "ingested CRDT ops with materialized effect", labels=("peer",))
_WINDOW_SECONDS = telemetry.histogram(
    "sd_sync_window_seconds", "latency of one ingest window",
    labels=("peer",))
_SHED_REPLAYS = telemetry.counter(
    "sd_sync_shed_replays_total",
    "known-poison replays deferred past the per-round fairness cap",
    labels=("peer",))


#: every ingester's totals: ``ingested`` (ops received), ``applied`` (with
#: a materialized effect), ``windows``, ``window_s`` (their seconds) and
#: ``shed_replays`` (poison replays deferred past the per-round cap)
STATS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    STATS.clear()


def _update_field(kind: str) -> str | None:
    return kind[len(UPDATE_PREFIX):] if kind.startswith(UPDATE_PREFIX) else None


class PoisonCaps:
    """Library-wide sticky floor caps for unhealed poison ops.

    The per-pass ``poison_cap`` in :meth:`Ingester._ingest_pass` only
    protects the floor inside the window that SAW the poison. Any
    transport that does not immediately re-serve the poisoned op — a
    pipelined session whose cursor ran ahead, a session resuming after a
    partition heal, a *different* peer forwarding later ops from the same
    origin instance — could then advance the instance floor past the
    unapplied op in a later window, losing it forever. This registry
    makes the cap STICKY and library-scoped: every poisoned op holds its
    origin instance's floor below itself across windows, ingesters, and
    lanes until the op durably logs (heal), so the transport keeps
    re-serving it no matter which path delivers the next window.

    Bounded like the per-ingester poison memory: past ``MAX_OPS`` the
    oldest half is evicted — an evicted entry means a still-unhealed op
    loses its floor protection, the same degradation the id-set eviction
    already accepts, and only reachable under an adversarial poison storm.
    """

    MAX_OPS = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: op id -> (origin instance pub_id, op timestamp)
        self._ops: dict[str, tuple[str, int]] = {}

    def add(self, op_id: str, instance: Any, ts: Any) -> None:
        if not isinstance(instance, str) or not isinstance(ts, int):
            return  # unattributable — no floor movement for it at all
        with self._lock:
            self._ops[op_id] = (instance, ts)
            if len(self._ops) > self.MAX_OPS:
                for k in list(self._ops)[: self.MAX_OPS // 2]:
                    del self._ops[k]

    def heal(self, op_id: str) -> bool:
        if not self._ops:  # common case: nothing poisoned, no lock
            return False
        with self._lock:
            return self._ops.pop(op_id, None) is not None

    def floor_caps(self) -> dict[str, int]:
        """Per-instance floor cap (strictly below the oldest unhealed
        poison op of that instance); empty when nothing is poisoned —
        the common case, one lock + len check."""
        with self._lock:
            if not self._ops:
                return {}
            caps: dict[str, int] = {}
            for instance, ts in self._ops.values():
                cap = ts - 1
                if cap < caps.get(instance, cap + 1):
                    caps[instance] = cap
            return caps


def shared_poison_caps(library: "Library") -> PoisonCaps:
    """The library's one sticky-cap registry (every ingester of a library
    shares it — poison in one lane/peer path caps the floor for all)."""
    caps = library.__dict__.get("_sync_poison_caps")
    if caps is None:
        caps = library.__dict__.setdefault("_sync_poison_caps",
                                           PoisonCaps())
    return caps


class Ingester:
    """Synchronous core (usable inline); Actor wraps it in a thread."""

    #: fairness bound on poison REPLAYS per ingest pass: ops that already
    #: failed in a previous round get at most this many re-attempts per
    #: round before the rest are deferred (floor capped, no DB work), so a
    #: hot poisoned record can never starve live ingest of fresh windows
    REPLAY_OPS_PER_ROUND = 64
    #: memory bound on the known-poison id set (oldest half evicted past
    #: this — an evicted id simply counts as fresh again next round)
    POISON_MEMORY = 4096

    def __init__(self, library: "Library", peer: str | None = None) -> None:
        self.library = library
        #: identity of the node whose ops this ingester receives (None for
        #: transport-less/test ingest) — attribution only, never auth
        self.peer = peer
        self._peer_label = mesh.peer_label(peer)
        # per-peer series, resolved once
        self._ops_ingested = _OPS_INGESTED.labels(peer=self._peer_label)
        self._ops_applied = _OPS_APPLIED.labels(peer=self._peer_label)
        self._window_seconds = _WINDOW_SECONDS.labels(peer=self._peer_label)
        self._apply_delay = mesh.apply_delay_series(self._peer_label)
        self._shed_replays = _SHED_REPLAYS.labels(peer=self._peer_label)
        #: HLC stamps of the ops durably logged this window
        self._fresh_ts: list[int] = []
        #: op ids that poisoned in an earlier round (id -> failure count);
        #: replays of these are fairness-capped per round (REPLAY_OPS_PER_
        #: ROUND) and the whole batch skips the optimistic pass (a known
        #: poison would abort it every time — pure wasted savepoint work)
        self._poison_seen: dict[str, int] = {}
        #: library-wide sticky floor caps (shared across every ingester of
        #: this library): an unhealed poison op caps its instance's floor
        #: in EVERY window, not just the one that saw it fail
        self._sticky_caps = shared_poison_caps(library)
        #: lane mode (set by sync/lanes.py): receive() skips floor
        #: persistence, accumulating the observed clocks/caps for the
        #: dispatcher to merge across lanes
        self.deferred_clocks: dict[str, int] = {}
        self.deferred_caps: dict[str, int] = {}
        #: whether the last receive() advanced any instance's clock floor —
        #: the single source of truth the pull loops use to detect a stuck
        #: window (a batch whose every op is skipped would otherwise be
        #: re-pulled identically forever)
        self.last_floor_advanced = False
        # per-batch prefetch caches (None outside receive()): the hot loop
        # must not pay one history/dup/instance query PER OP — at 1000-op
        # pull windows that caps ingest near 8k ops/s. receive() loads each
        # record's history, the batch's already-logged ids, and the known
        # instances in a handful of IN-queries, then keeps the caches
        # coherent as ops are logged so intra-batch arbitration still sees
        # every earlier op of the same batch.
        self._shared_hist: dict[tuple[str, str], list[dict[str, Any]]] | None = None
        self._rel_hist: dict[tuple[str, str, str], list[dict[str, Any]]] | None = None
        self._logged_ids: set[str] | None = None
        self._known_instances: set[str] | None = None

    @contextlib.contextmanager
    def session(self):
        """Group several pull windows under ONE durable transaction.

        The per-window overhead of small windows is mostly the
        per-receive() BEGIN IMMEDIATE…COMMIT — a WAL commit per window.
        Inside a session the per-window transactions join this outer one
        (models/base._Txn is re-entrant), so the pull loop pays one commit
        per flush instead of one per window. Safe because ingestion is
        idempotent: a mid-session failure rolls the whole flush window back
        and the un-advanced clock floors make the transport replay it.
        """
        with self.library.db.transaction():
            yield
        # the grouped windows are durable NOW — the per-receive() bump
        # skips itself while a session transaction is open, so this is the
        # one post-commit signal for the whole flush
        self.library.emit("db.commit", {"source": "sync.session"})

    # -- history helpers -----------------------------------------------------
    def _history(self, t: SharedOp) -> list[dict[str, Any]]:
        if self._shared_hist is not None:
            key = (t.model, str(t.record_id))
            rows = self._shared_hist.get(key)
            if rows is not None:
                return rows
        return self.library.db.find(
            SharedOperationRow, {"model": t.model, "record_id": str(t.record_id)})

    @staticmethod
    def _later(rows: list[dict[str, Any]], op: CRDTOperation) -> list[dict[str, Any]]:
        """Ops strictly after ``op`` in the (timestamp, id) total order —
        the deterministic cross-instance tiebreak."""
        key = (op.timestamp, op.id)
        return [r for r in rows if (r["timestamp"], r["id"]) > key]

    def _already_logged(self, op: CRDTOperation) -> bool:
        if self._logged_ids is not None:
            return op.id in self._logged_ids
        t = op.typ
        row_model = SharedOperationRow if isinstance(t, SharedOp) else RelationOperationRow
        return self.library.db.find_one(row_model, {"id": op.id}) is not None

    # -- batch prefetch ------------------------------------------------------
    @staticmethod
    def _chunks(items: list, size: int = 400):
        for i in range(0, len(items), size):
            yield items[i : i + size]

    def _prefetch(self, ops: list[CRDTOperation]) -> None:
        db = self.library.db
        shared = [op for op in ops if isinstance(op.typ, SharedOp)]
        rel = [op for op in ops if isinstance(op.typ, RelationOp)]

        logged: set[str] = set()
        for table, group in (("shared_operation", shared),
                             ("relation_operation", rel)):
            for chunk in self._chunks([op.id for op in group]):
                marks = ",".join("?" * len(chunk))
                for r in db.query(
                        f"SELECT id FROM {table} WHERE id IN ({marks})", chunk):
                    logged.add(r["id"])
        self._logged_ids = logged

        shist: dict[tuple[str, str], list[dict[str, Any]]] = {}
        by_model: dict[str, set[str]] = {}
        for op in shared:
            key = (op.typ.model, str(op.typ.record_id))
            shist.setdefault(key, [])
            by_model.setdefault(key[0], set()).add(key[1])
        for model, rids in by_model.items():
            for chunk in self._chunks(sorted(rids)):
                marks = ",".join("?" * len(chunk))
                for r in db.query(
                        "SELECT * FROM shared_operation WHERE model = ? "
                        f"AND record_id IN ({marks})", [model, *chunk]):
                    d = SharedOperationRow.decode_row(r)
                    shist[(model, d["record_id"])].append(d)
        self._shared_hist = shist

        rhist: dict[tuple[str, str, str], list[dict[str, Any]]] = {}
        by_relation: dict[str, set[str]] = {}
        for op in rel:
            key = (op.typ.relation, str(op.typ.item_id), str(op.typ.group_id))
            rhist.setdefault(key, [])
            by_relation.setdefault(key[0], set()).add(key[1])
        for relation, items in by_relation.items():
            for chunk in self._chunks(sorted(items)):
                marks = ",".join("?" * len(chunk))
                for r in db.query(
                        "SELECT * FROM relation_operation WHERE relation = ? "
                        f"AND item_id IN ({marks})", [relation, *chunk]):
                    d = RelationOperationRow.decode_row(r)
                    key = (relation, d["item_id"], d["group_id"])
                    if key in rhist:  # item_id IN over-fetches other groups
                        rhist[key].append(d)
        self._rel_hist = rhist

        self._known_instances = {r["pub_id"] for r in db.find(Instance)}

    def _cache_logged(self, op: CRDTOperation) -> None:
        """Mirror a durably-logged op into the batch caches so later ops of
        the same batch arbitrate against it exactly as a DB re-query would."""
        if self._logged_ids is not None:
            self._logged_ids.add(op.id)
        t = op.typ
        if isinstance(t, SharedOp):
            if self._shared_hist is not None:
                self._shared_hist.setdefault(
                    (t.model, str(t.record_id)), []).append({
                        "id": op.id, "timestamp": op.timestamp,
                        "model": t.model, "record_id": str(t.record_id),
                        "kind": t.kind, "data": t.data,
                    })
        elif self._rel_hist is not None:
            self._rel_hist.setdefault(
                (t.relation, str(t.item_id), str(t.group_id)), []).append({
                    "id": op.id, "timestamp": op.timestamp,
                    "relation": t.relation, "item_id": str(t.item_id),
                    "group_id": str(t.group_id), "kind": t.kind,
                    "data": t.data,
                })

    # -- shared-op arbitration ----------------------------------------------
    def _apply_shared_convergent(self, op: CRDTOperation) -> bool:
        """Apply ``op``'s effect given the record's logged history; returns
        whether anything was materialized."""
        # chaos seam: a crash here during the optimistic pass must roll the
        # batch savepoint back and re-run carefully with per-op isolation
        faults.inject("sync_apply", key=op.id)
        db = self.library.db
        t: SharedOp = op.typ
        history = self._history(t)
        later = self._later(history, op)

        field = _update_field(t.kind)
        if field is not None:
            for r in later:
                if r["kind"] in (DELETE, t.kind):
                    return False
                if r["kind"] == CREATE and isinstance(r["data"], dict) \
                        and field in r["data"]:
                    return False
            apply_shared(db, t)
            return True

        if t.kind == CREATE:
            if not later:  # fast path: nothing can shadow a lone create
                apply_shared(db, t)
                return True
            if any(r["kind"] in (CREATE, DELETE) for r in later):
                return False
            shadowed = {_update_field(r["kind"]) for r in later
                        if r["kind"].startswith(UPDATE_PREFIX)}
            data = {k: v for k, v in (t.data or {}).items() if k not in shadowed}
            apply_shared(db, SharedOp(t.model, t.record_id, CREATE, data))
            return True

        if t.kind == DELETE:
            if any(r["kind"] in (CREATE, DELETE) for r in later):
                return False  # later create revives / later tombstone wins
            survivors = [r for r in later
                         if r["kind"].startswith(UPDATE_PREFIX)
                         or r["kind"] == CREATE]
            if not survivors:
                apply_shared(db, t)
                return True
            # partial effect: the in-order outcome is "delete the row, then
            # later updates re-materialize it" — so clear every field whose
            # last write precedes the delete
            key = (op.timestamp, op.id)
            last: dict[str, tuple[int, str]] = {}
            for r in history:
                rkey = (r["timestamp"], r["id"])
                f = _update_field(r["kind"])
                if f is not None:
                    if rkey > last.get(f, (0, "")):
                        last[f] = rkey
                elif r["kind"] == CREATE and isinstance(r["data"], dict):
                    for cf in r["data"]:
                        if rkey > last.get(cf, (0, "")):
                            last[cf] = rkey
            model = model_for(t.model)
            sync_spec = model.SYNC
            dead = {f: None for f, lk in last.items()
                    if lk < key and f in model.FIELDS and f != sync_spec.id}
            if dead:
                db.update(model, {sync_spec.id: t.record_id}, dead)
            return bool(dead)

        raise ApplyError(f"unknown shared op kind {t.kind!r}")

    # -- relation-op arbitration --------------------------------------------
    def _apply_relation_convergent(self, op: CRDTOperation) -> bool:
        """Relations are link rows (little data, no partial-delete
        reconstruction needed): tombstone-aware kind matrix."""
        faults.inject("sync_apply", key=op.id)
        db = self.library.db
        t: RelationOp = op.typ
        key = (t.relation, str(t.item_id), str(t.group_id))
        rows = self._rel_hist.get(key) if self._rel_hist is not None else None
        if rows is None:
            rows = db.find(RelationOperationRow,
                           {"relation": t.relation, "item_id": str(t.item_id),
                            "group_id": str(t.group_id)})
        later = self._later(rows, op)
        for r in later:
            if r["kind"] == DELETE:
                return False
            if r["kind"] == CREATE and t.kind in (CREATE, DELETE):
                return False
            if r["kind"] == t.kind and t.kind.startswith(UPDATE_PREFIX):
                return False
        apply_relation(db, t)
        return True

    # -- plumbing ------------------------------------------------------------
    def _ensure_instance(self, pub_id: str) -> None:
        """Ops can arrive from an origin we have no instance row for yet
        (transitive propagation ahead of pairing metadata). Create a minimal
        row so logging and clock persistence have a home instead of
        poisoning the batch."""
        import datetime as _dt

        db = self.library.db
        if self._known_instances is not None:
            known = pub_id in self._known_instances
        else:
            known = db.find_one(Instance, {"pub_id": pub_id}) is not None
        if not known:
            now = _dt.datetime.now(_dt.timezone.utc)
            db.insert(Instance, {
                "pub_id": pub_id, "identity": "", "node_id": "",
                "node_name": "(unknown)", "node_platform": 0,
                "last_seen": now, "date_created": now, "timestamp": 0,
            }, or_ignore=True)
            if self._known_instances is not None:
                self._known_instances.add(pub_id)
            logger.warning("sync ingest created placeholder instance %s", pub_id)

    # -- application ---------------------------------------------------------
    def _own_origin(self) -> str:
        """This node's id (the span-id base of a continued mesh trace)."""
        node = getattr(self.library, "node", None)
        if node is not None:
            try:
                return str(node.config.get().get("id") or self.library.id)
            except Exception:
                pass
        return self.library.id

    def receive(self, wire_ops: list[dict[str, Any]],
                ctx: "mesh.TraceContext | None" = None,
                defer_clocks: bool = False) -> int:
        """Ingest a batch; returns the number of ops with materialized
        effect (shadowed ops are still logged). ``ctx`` is the sender's
        trace-context envelope (module docstring).

        ``defer_clocks`` is the lane-shard mode (sync/lanes.py): the
        instance clock floors are NOT persisted here — the observed
        clocks and poison caps accumulate into ``deferred_clocks`` /
        ``deferred_caps`` for the dispatcher to merge across every lane
        of the window (a poison in one lane must cap the floor even when
        another lane applied later ops from the same instance); the
        window's lag and time are then the dispatcher's to record."""
        db = self.library.db
        sync = self.library.sync
        window_t0 = time.perf_counter()
        STATS["ingested"] += len(wire_ops)
        self._ops_ingested.inc(len(wire_ops))

        # decode first (one malformed wire op — bad '_t', wrong key set —
        # from a buggy or malicious member must not abort the batch and
        # wedge the sync session forever), so the prefetch sees the batch's
        # full key set
        decoded: list[CRDTOperation] = []
        for wire in wire_ops:
            try:
                decoded.append(CRDTOperation.from_wire(wire))
            except Exception as e:
                logger.warning("sync ingest dropped malformed op: %s", e)

        trace = mesh.continue_trace(ctx, origin=self._own_origin())
        apply_span = mesh.remote_span(trace, ctx, "sync.apply", peer=self._peer_label,
                                      ops=len(decoded))
        apply_span.__enter__()
        applied = 0
        self._fresh_ts = []

        # NOTE on the raw SAVEPOINTs: db.transaction() holds the connection
        # RLock for the whole batch, so no other thread can interleave
        # statements between a savepoint and its release/rollback — which
        # also keeps the prefetched caches coherent for the whole batch.
        #
        # Two-pass execution: the OPTIMISTIC pass runs the whole batch under
        # a single savepoint with no per-op bookkeeping and the op-log
        # written as one executemany at the end — the happy path pays ~3
        # statements per op instead of 6. Any failure rolls the whole pass
        # back and the CAREFUL pass re-runs it with per-op savepoints and
        # the documented poison/floor semantics. Both passes are
        # deterministic over the same prefetched state, so a clean optimistic
        # pass is bit-identical to what the careful pass would have done.
        # a batch carrying known-poison replays skips the optimistic pass:
        # the poison would abort it deterministically, paying a full batch
        # savepoint rollback before every careful re-run
        has_known_poison = (bool(self._poison_seen)
                            and any(op.id in self._poison_seen
                                    for op in decoded))
        try:
            with db.transaction():
                if has_known_poison:
                    self._prefetch(decoded)
                    applied, seen_clocks, caps = self._ingest_pass(
                        decoded, careful=True)
                else:
                    self._prefetch(decoded)
                    db.execute("SAVEPOINT ingest_batch")
                    try:
                        applied, seen_clocks, caps = self._ingest_pass(
                            decoded, careful=False)
                        db.execute("RELEASE ingest_batch")
                    except Exception:
                        db.execute("ROLLBACK TO ingest_batch")
                        db.execute("RELEASE ingest_batch")
                        logger.exception("optimistic ingest pass failed; "
                                         "re-running per-op")
                        # the rollback may have deleted placeholder Instance
                        # rows the id-memo already recorded
                        sync._instance_ids.clear()
                        self._prefetch(decoded)  # DB rolled back: rebuild
                        applied, seen_clocks, caps = self._ingest_pass(
                            decoded, careful=True)
                if defer_clocks:
                    # lane mode: accumulate for the dispatcher's cross-lane
                    # merge (floors only-raise; caps only-lower)
                    for pub_id, ts in seen_clocks.items():
                        if ts > self.deferred_clocks.get(pub_id, 0):
                            self.deferred_clocks[pub_id] = ts
                    for pub_id, cap in caps.items():
                        self.deferred_caps[pub_id] = min(
                            self.deferred_caps.get(pub_id, cap), cap)
                else:
                    # persist per-origin clocks (ingest.rs:136-159)
                    self.last_floor_advanced = False
                    for pub_id, ts in seen_clocks.items():
                        row = db.find_one(Instance, {"pub_id": pub_id})
                        if row is not None and (row["timestamp"] or 0) < ts:
                            db.update(Instance, {"pub_id": pub_id},
                                      {"timestamp": ts})
                            self.last_floor_advanced = True
        finally:
            # caches are batch-scoped; standalone method calls stay query-based
            self._shared_hist = self._rel_hist = None
            self._logged_ids = self._known_instances = None
            # the instance-id memo is likewise batch-scoped: a transaction
            # rollback (exception out of the with-block) can delete
            # placeholder Instance rows whose ids were already memoized, and
            # rowids can be recycled — repopulating costs one query per
            # instance per batch
            sync._instance_ids.clear()
            apply_span.set(applied=applied)
            apply_span.__exit__(*sys.exc_info())
        STATS["applied"] += applied
        self._ops_applied.inc(applied)
        # bump the search engine's watermark only once the window is
        # DURABLE. Inside a session() the outer transaction is still open
        # here (txn_depth > 0) — the commit lands at session exit, which
        # emits instead.
        if db._txn_depth == 0:
            self.library.emit("db.commit", {"source": "sync.ingest",
                                            "ops": len(decoded)})
        window_s = time.perf_counter() - window_t0
        STATS["windows"] += 1
        STATS["window_s"] += window_s
        if not defer_clocks:
            self._window_seconds.observe(window_s)
            mesh.record_ingest_window(self._peer_label, ctx,
                                      max((op.timestamp for op in decoded), default=0))
        if telemetry.enabled():
            now_unix = time.time()
            for ts in self._fresh_ts:
                self._apply_delay.observe(max(0.0, now_unix - to_unix(ts)))
        self._fresh_ts = []
        if applied:
            sync._broadcast(SyncMessage.INGESTED)
        return applied

    def _ingest_pass(self, decoded: list[CRDTOperation], careful: bool
                     ) -> tuple[int, dict[str, int], dict[str, int]]:
        db = self.library.db
        sync = self.library.sync
        applied = 0
        seen_clocks: dict[str, int] = {}
        pending_log: list[CRDTOperation] = []
        #: replay fairness budget: re-attempts of KNOWN-poison ops this
        #: pass; fresh ops never count against it
        replay_budget = self.REPLAY_OPS_PER_ROUND
        # per pass: an aborted optimistic pass rolled its log rows back
        self._fresh_ts = []
        # Dropped-op floor policy, by failure class (careful pass):
        #
        # - TRANSIENT failures (savepoint rollback: DB error while logging)
        #   cap the instance's floor below the failed op for the rest of the
        #   batch — ops are timestamp-ordered, so a later successful op from
        #   the same instance would otherwise push the floor past it and it
        #   would never be re-pulled (lost, breaking convergence).
        # - PERMANENT garbage (decode/validation failure) is dropped with no
        #   cap: it can never apply anywhere, and pinning the floor below an
        #   immutable bad op in the origin's log would stall that peer link
        #   forever once more than one window of ops accumulates behind it.
        #   A beyond-drift timestamp sorts after all sane ops anyway, so it
        #   rides the window tail without blocking floor advancement.
        poison_cap: dict[str, int] = {}
        # pass-start snapshot of the library-wide sticky caps: ops that
        # poisoned in EARLIER windows (possibly other lanes/peers) keep
        # holding their instance's floor down even when this window does
        # not contain them — without this, a window of later ops from the
        # same instance would advance the floor past the unapplied poison
        # and it could never be re-served (divergence)
        sticky = self._sticky_caps.floor_caps()

        def _advance(instance: str, ts: int) -> None:
            cap = poison_cap.get(instance)
            if cap is not None:
                ts = min(ts, cap)
            s_cap = sticky.get(instance)
            if s_cap is not None:
                ts = min(ts, s_cap)
            if ts > seen_clocks.get(instance, 0):
                seen_clocks[instance] = ts

        def _poison(instance: Any, ts: Any) -> None:
            if not isinstance(instance, str) or not isinstance(ts, int):
                return  # unattributable — no floor movement for it at all
            cap = min(poison_cap.get(instance, ts - 1), ts - 1)
            poison_cap[instance] = cap
            if seen_clocks.get(instance, 0) > cap:
                seen_clocks[instance] = cap

        for op in decoded:
            if not sync.clock.update(op.timestamp):
                # beyond the drift bound (uhlc parity): deferred, not
                # lost — a skewed-but-honest peer's ops sort after all
                # sane ops, so they ride the window tail without
                # blocking floor advancement and apply once wall time
                # catches up. debug level: this repeats every round for
                # the duration of the skew.
                logger.debug("sync ingest deferred op %s: timestamp %d "
                             "beyond drift bound", op.id, op.timestamp)
                continue
            if op.instance == sync.instance_pub_id:
                continue  # our own op reflected back
            if self._already_logged(op):
                # duplicate delivery — already durable, safe to advance
                # (and if it was ever sticky-poisoned, some path logged it:
                # the cap must lift or the floor would stall forever)
                if op.id in self._poison_seen or sticky:
                    self._poison_seen.pop(op.id, None)
                    if self._sticky_caps.heal(op.id):
                        sticky = self._sticky_caps.floor_caps()
                _advance(op.instance, op.timestamp)
                continue
            if not careful:
                # optimistic: any per-op failure aborts the pass (the caller
                # rolls the batch savepoint back and re-runs carefully)
                if isinstance(op.typ, SharedOp):
                    effect = self._apply_shared_convergent(op)
                else:
                    effect = self._apply_relation_convergent(op)
                self._ensure_instance(op.instance)
                pending_log.append(op)
                self._cache_logged(op)
                self._fresh_ts.append(op.timestamp)
                _advance(op.instance, op.timestamp)
                if effect:
                    applied += 1
                continue
            # replay fairness cap: an op that
            # already poisoned in an earlier round gets a bounded number
            # of re-attempts per round; past the budget it is deferred
            # outright (floor capped as if it failed again, zero DB work)
            # so a hot poisoned record cannot starve the fresh tail of
            # the window
            replayed = op.id in self._poison_seen
            if replayed:
                if replay_budget <= 0:
                    _poison(op.instance, op.timestamp)
                    # re-register the sticky cap (eviction-proofing): the
                    # deferred replay stays floor-protected
                    self._sticky_caps.add(op.id, op.instance, op.timestamp)
                    STATS["shed_replays"] += 1
                    self._shed_replays.inc()
                    continue
                replay_budget -= 1
            # per-op savepoint: effect + log commit or roll back as a
            # unit — an applied-but-unlogged op would be invisible to
            # future arbitration and never propagate transitively
            db.execute("SAVEPOINT ingest_op")
            try:
                # ANY materialization failure — known (ApplyError) or
                # not (bad data shapes deep in SQL) — is deterministic in
                # the op's content, so retrying can never succeed: roll
                # back just the effect and still log the op, or it would
                # neither propagate transitively nor let the floor
                # advance past it (a permanent wedge). Only failures in
                # the logging infrastructure itself (below) are treated
                # as transient.
                db.execute("SAVEPOINT ingest_effect")
                try:
                    if isinstance(op.typ, SharedOp):
                        effect = self._apply_shared_convergent(op)
                    else:
                        effect = self._apply_relation_convergent(op)
                    db.execute("RELEASE ingest_effect")
                except Exception as e:
                    db.execute("ROLLBACK TO ingest_effect")
                    db.execute("RELEASE ingest_effect")
                    # TRANSIENT classes (sqlite busy, EIO/EINTR) are NOT
                    # deterministic in the op's content — logging such an
                    # op "without effect" would advance the floor past it
                    # and lose the materialization forever (divergence).
                    # Escalate to the poison path instead: floor capped
                    # below the op, replayed next round, applies once the
                    # contention clears (an injected ``sync_apply:eio``
                    # takes this path).
                    from ..retry import is_sqlite_busy, is_transient_io

                    if is_sqlite_busy(e) or is_transient_io(e):
                        raise
                    log = (logger.warning if isinstance(e, ApplyError)
                           else logger.exception)
                    log("sync op %s logged without effect: %s", op.id, e)
                    effect = False
                self._ensure_instance(op.instance)
                sync.log_ops([op])  # ALWAYS — the log is the CRDT state
            except Exception:
                # a single poison op must not abort the whole batch and
                # leave the Actor re-pulling it forever; its clock floor
                # is NOT advanced (and is capped below the poison op for
                # the rest of the batch), so it will be retried next round
                db.execute("ROLLBACK TO ingest_op")
                db.execute("RELEASE ingest_op")
                # the rollback may have deleted a placeholder Instance row
                # this op just created — later ops of the batch must
                # re-create it, not trust the caches
                if self._known_instances is not None:
                    self._known_instances.discard(op.instance)
                sync._instance_ids.pop(op.instance, None)
                _poison(op.instance, op.timestamp)
                self._remember_poison(op.id)
                # sticky: this op holds its instance's floor below itself
                # across FUTURE windows too, until it durably logs
                self._sticky_caps.add(op.id, op.instance, op.timestamp)
                logger.exception("sync ingest skipped poison op %s", op.id)
                continue
            db.execute("RELEASE ingest_op")
            if replayed:
                self._poison_seen.pop(op.id, None)  # healed
                if self._sticky_caps.heal(op.id):
                    sticky = self._sticky_caps.floor_caps()
            self._cache_logged(op)
            self._fresh_ts.append(op.timestamp)
            # advance the clock floor only once the op is durably logged
            _advance(op.instance, op.timestamp)
            if effect:
                applied += 1
        if pending_log:
            sync.log_ops(pending_log)
        # hand the dispatcher the LIVE sticky caps too: in lane mode the
        # poisoned op may sit in a different lane's ingester than the one
        # applying this instance's later ops — the cross-lane floor merge
        # must see the cap regardless of which lane returned it
        for instance, cap in self._sticky_caps.floor_caps().items():
            if cap < poison_cap.get(instance, cap + 1):
                poison_cap[instance] = cap
        return applied, seen_clocks, poison_cap

    def _remember_poison(self, op_id: str) -> None:
        # pop+reinsert so a repeat offender moves to the back of the
        # insertion order: eviction below is then LRU — it drops ids not
        # seen poisoning recently, never the hot still-failing ones the
        # replay cap and optimistic-pass skip exist for
        self._poison_seen[op_id] = self._poison_seen.pop(op_id, 0) + 1
        if len(self._poison_seen) > self.POISON_MEMORY:
            # evict the oldest half (insertion order); an evicted id just
            # counts as fresh on its next replay
            for k in list(self._poison_seen)[: self.POISON_MEMORY // 2]:
                del self._poison_seen[k]


class Actor:
    """Threaded pull loop: ``notify()`` wakes it; it pulls batches from the
    transport until has_more is false, then waits again, holding the
    library's ``sync.ingest_round`` for the round. A round that raises ends
    the loop: the exception stays in :attr:`error`, and :meth:`wait_idle`
    and :meth:`stop` raise it."""

    def __init__(self, library: "Library", transport: Transport,
                 batch: int = PROD_BATCH) -> None:
        self.ingester = Ingester(library)
        self.library = library
        self.transport = transport
        self.batch = batch
        #: the exception that ended the loop, or None
        self.error: BaseException | None = None
        #: ops pulled from the transport, pull rounds run, and the seconds
        #: spent ingesting what was pulled (the transport's excluded)
        self.pulled = 0
        self.rounds = 0
        self.ingest_s = 0.0
        # wakes COALESCE: one pending wake already guarantees a full pull
        # round, so the queue stays bounded no matter how fast notify()
        # fires
        self._wake: queue.Queue[object | None] = queue.Queue(maxsize=4)
        self._idle = threading.Condition()
        self._busy = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"sync-ingest-{library.id[:8]}")
        self._stopped = False
        self._thread.start()

    def notify(self) -> None:
        with self._idle:  # the loop reads the queue's state under it
            self._busy = True
            try:
                self._wake.put_nowait(object())
            except queue.Full:
                pass  # a wake is already pending; this one is subsumed

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Block until no wake is pending and no round runs; raises the
        loop's exception. False on timeout."""
        with self._idle:
            done = self._idle.wait_for(
                lambda: self.error is not None or not self._busy, timeout)
        if self.error is not None:
            raise RuntimeError("sync ingest round failed") from self.error
        return done

    def stop(self) -> None:
        self._stopped = True
        try:
            self._wake.put_nowait(None)
        except queue.Full:
            pass  # queue non-empty: the loop will see _stopped on next get
        self._thread.join(timeout=5)
        if self.error is not None:
            raise RuntimeError("sync ingest round failed") from self.error

    def _run(self) -> None:
        while True:
            item = self._wake.get()
            if item is None or self._stopped:
                return
            try:
                with self.library.sync.ingest_round:
                    self._round()
            except BaseException as e:  # noqa: BLE001 — kept for the caller
                with self._idle:
                    self.error = e
                    self._idle.notify_all()
                return
            with self._idle:
                if self._wake.empty():
                    self._busy = False
                    self._idle.notify_all()

    def _round(self) -> None:
        self.rounds += 1
        done = False
        while not done:
            # PHASE 1 — the transport, NO transaction held: pull up to a
            # flush window's worth of ops, advancing the clocks locally
            # from the pulled envelopes (the durable floors only move once
            # ingested, so re-asking the transport with the same floors
            # would replay the same window)
            clocks = self.library.sync.timestamps()
            windows: list[list[dict]] = []
            pulled = 0
            while True:
                ops, has_more = self.transport(clocks, self.batch)
                if ops:
                    windows.append(ops)
                    pulled += len(ops)
                    for wire in ops:
                        inst, ts = wire.get("instance"), wire.get("timestamp")
                        if isinstance(inst, str) and isinstance(ts, int) \
                                and ts > clocks.get(inst, 0):
                            clocks[inst] = ts
                if not has_more:
                    done = True
                    break
                if not ops or pulled >= SESSION_FLUSH_OPS:
                    break
            self.pulled += pulled
            # PHASE 2 — one durable transaction over the buffered windows
            # (per-window receive() semantics preserved), or, with
            # SD_SYNC_INGEST_LANES > 1, the library's partitioned lane pool
            if windows:
                from .lanes import get_lane_pool, lane_count

                t0 = time.perf_counter()
                if lane_count() > 1:
                    _, advanced = get_lane_pool(self.library).receive_many(windows)
                    self.ingester.last_floor_advanced = advanced
                else:
                    with self.ingester.session():
                        for ops in windows:
                            self.ingester.receive(ops)
                self.ingest_s += time.perf_counter() - t0
                if not self.ingester.last_floor_advanced:
                    # the final window was entirely skipped — the durable
                    # floors did not move, so the transport would replay
                    # the identical window forever
                    logger.warning("ingest made no progress; ending round")
                    done = True
