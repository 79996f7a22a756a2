"""Read replicas over the sync mesh: a peer's pool-marked queries served
from this node's copy of the library.

Counterpart of ``spacedrive_tpu/server/replica.py``. CRDT sync already
copies a library to every paired peer; this module lets a peer's
pool-marked rspc queries (``@router.library_query(..., pool=True)``, unless
``replica=False``) be answered by a **watermark-eligible** replica over the
p2p ``H_QUERY`` header. On a replica that holds the card, the search
handlers score on its device index: a laptop searches the library on the
desktop.

The contract, in dispatch order:

- **Never a stale row.** A replica serves only when its applied
  per-instance clocks (``SyncManager.timestamps()``) cover the client's
  ``require`` map, the client's authored floors
  (``SyncManager.require_watermark()``: per-publisher maxima over the
  client's own op log, written in the transaction that made its rows), so
  eligibility implies the replica holds every row the client has. A
  lagging replica answers ``not_eligible`` with its own clocks.
- **Degrade, don't wedge.** :meth:`ReplicaRouter.dispatch` returns None on
  any miss (no peer, none eligible, busy, an error) and the router goes on
  to the local pool and then the handler in process.
- **The accept layer.** A replica admits each query through the node's
  ingest budget (``try_admit(f"query:{label}", 1, 0)``, the instance the
  sync receive path uses), so a flooded replica answers ``busy`` with its
  ``retry_after_ms`` instead of buffering.
- **Byte identity.** A page is encoded once, by :func:`encode_reply`, the
  pool's and the shell's encoder, so a replica's page splices into the
  shell's envelope and compares byte for byte with the local one.

- **Row ids stay home.** Only the procedures whose answers and arguments
  are free of node-local row ids and read synced tables alone are
  replica-dispatchable (``replica=`` in :mod:`..api.router`); a count
  filtered by a location or tag id (``names_local_ids``) stays local, and a
  replica refuses one. The reference serves id-bearing pages from a
  replica, whose ids are its own (ROADMAP Queue 3).

The ``replica_serve`` fault seam is injected where the query is served:
inside the pool worker when the replica's pool serves it (``seam=`` on
``ReaderPool.dispatch``), else in this process, where a ``kill`` is the
replica node dying mid-query. A query the replica's device index will
answer (``SearchEngine.prefers_inprocess``) skips its pool, where the
reference sends every query to the pool when one runs (ROADMAP Queue 3). The handler's kernel launches count under
origin ``replica-serve`` (``ops._kernels.LAUNCHES_BY_ORIGIN``).

Peer choice keeps an EWMA of each peer's latency with a hysteresis of
1.25 and a probe of the slowest peer every 16th dispatch; a peer sits out
0.25 s after ``not_eligible``, its own ``retry_after_ms`` after ``busy``,
and 0.1 s x 2^fails (at most 5 s) after an error; a dispatch tries at most
2 peers. ``SD_REPLICAS=0`` keeps every query local;
``SD_REPLICA_TIMEOUT_S`` (5) bounds a peer's answer. Telemetry, as the
reference's: ``sd_replica_dispatches_total{peer,outcome}``,
``sd_replica_eligibility_rejections_total{peer}``,
``sd_replica_failovers_total{reason}``, ``sd_replica_request_seconds{peer}``
and, on the serving side, ``sd_replica_serves_total{outcome}`` (``peer`` is
:func:`..telemetry.mesh.peer_label`); :data:`STATS` keeps the same counts
as plain numbers (``dispatches_<outcome>``, ``failovers_<reason>``,
``serves_<outcome>``, ``eligibility_rejections``).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import sqlite3
import threading
import time
from typing import TYPE_CHECKING, Any, Callable

from .. import faults, telemetry
from ..faults import PeerBusyError
from ..telemetry import mesh
from ..telemetry.mesh import peer_label
from ..telemetry.registry import REQUEST_BUCKETS
from ..sync.admission import Busy

if TYPE_CHECKING:
    from ..node import Node

logger = logging.getLogger(__name__)

STATS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    STATS.clear()


def _count(key: str, n: int = 1) -> None:
    from ..ops import _kernels

    _kernels.count(STATS, key, n)


# help texts live in telemetry._declare_core
_DISPATCHES = telemetry.counter("sd_replica_dispatches_total", labels=("peer", "outcome"))
_ELIGIBILITY = telemetry.counter("sd_replica_eligibility_rejections_total", labels=("peer",))
_FAILOVERS = telemetry.counter("sd_replica_failovers_total", labels=("reason",))
_SECONDS = telemetry.histogram("sd_replica_request_seconds", labels=("peer",),
                               buckets=REQUEST_BUCKETS)
_SERVES = telemetry.counter("sd_replica_serves_total", labels=("outcome",))


def _served(outcome: str) -> None:
    _count(f"serves_{outcome}")
    _SERVES.inc(outcome=outcome)


def _dispatched(peer: str, outcome: str) -> None:
    _count(f"dispatches_{outcome}")
    _DISPATCHES.inc(peer=peer_label(peer), outcome=outcome)


def _failed_over(reason: str) -> None:
    _count(f"failovers_{reason}")
    _FAILOVERS.inc(reason=reason)


def encode_reply(result: Any) -> bytes:
    """The wire encoder of a replica's page: the pool worker's and the
    shell's ``json.dumps(result, default=str)``."""
    return json.dumps(result, default=str).encode()


def covers(have: dict[str, int], require: dict[str, int]) -> bool:
    """``have`` (a replica's applied clocks) covers ``require`` (the
    client's floors) iff every instance with a positive floor is known here
    at no less; an instance never heard of covers only floor 0."""
    for pub, floor in (require or {}).items():
        if int(floor or 0) <= 0:
            continue
        if int(have.get(pub, 0) or 0) < int(floor):
            return False
    return True


def replica_timeout_s() -> float:
    """The budget of one peer's answer (``SD_REPLICA_TIMEOUT_S``, 5 s),
    well under the pool's request timeout."""
    try:
        return max(0.1, float(os.environ.get("SD_REPLICA_TIMEOUT_S", "5")))
    except ValueError:
        return 5.0


# ---------------------------------------------------------------------------
# replica side: serve one remote query
# ---------------------------------------------------------------------------


def serve_query(node: "Node", payload: dict, peer: str = "") -> dict:
    """Serve one ``H_QUERY`` dispatch on this node. Never raises; answers

    - ``{"ok": True, "raw": bytes}``: the encoded page;
    - ``{"ok": False, "kind": "not_eligible", "watermark": {...}}``: this
      replica's clocks did not cover ``payload["require"]``;
    - ``{"ok": False, "kind": "busy", "retry_after_ms": int}``: admission
      shed it (or an injected ``replica_serve:busy``);
    - ``{"ok": False, "kind": "error", "error": str}``: anything else.

    With a local pool armed, the pool serves (the ``replica_serve`` seam
    inside the worker) unless this node's device index will answer
    (``prefers_inprocess``, as the local ladder asks); a pool failure is an
    error, never a re-run here, so the client's ladder does the failing
    over.
    """
    from ..api.router import QUERY, ApiError, RawJson, names_local_ids
    from ..ops import _kernels

    key = str(payload.get("key") or "")
    library_id = payload.get("library_id")
    arg = payload.get("arg")
    require = payload.get("require") or {}
    proc = node.router.procedures.get(key)
    if proc is None or proc.kind != QUERY or not proc.pool or not proc.replica:
        _served("error")
        return {"ok": False, "kind": "error", "error": f"{key!r} is not replica-dispatchable"}
    if names_local_ids(arg):
        _served("error")
        return {"ok": False, "kind": "error", "error": f"{key!r} names the client's row ids"}
    try:
        library = node.libraries.get(library_id)
    except KeyError:
        # a library this node does not hold: as ineligible as a lag
        _served("not_eligible")
        return {"ok": False, "kind": "not_eligible", "watermark": {}}
    have = library.sync.timestamps()
    if not covers(have, require):
        _served("not_eligible")
        return {"ok": False, "kind": "not_eligible", "watermark": have}
    verdict = node.ingest_budget.try_admit(f"query:{peer_label(peer)}", 1, 0)
    if isinstance(verdict, Busy):
        _served("busy")
        return {"ok": False, "kind": "busy", "retry_after_ms": verdict.retry_after_ms}
    try:
        pool = getattr(node, "reader_pool", None)
        engine = getattr(node, "search_engine", None)
        if pool is not None and not (engine is not None
                                     and engine.prefers_inprocess(key, library_id, arg)):
            from .pool import PoolUnavailable

            try:
                served = pool.dispatch(key, arg, library_id, seam="replica_serve")
            except PoolUnavailable as e:
                _served("error")
                return {"ok": False, "kind": "error", "error": f"replica pool unavailable: {e}"}
            raw = served.data if isinstance(served, RawJson) else encode_reply(served)
        else:
            # in process: a `kill` here is this replica dying mid-query
            faults.inject("replica_serve", key=key)
            with _kernels.origin("replica-serve"):
                result = proc.fn(node, library, arg)
            raw = encode_reply(result)
        _served("ok")
        return {"ok": True, "raw": raw}
    except PeerBusyError as e:
        _served("busy")
        return {"ok": False, "kind": "busy", "retry_after_ms": e.retry_after_ms}
    except ApiError as e:
        _served("error")
        return {"ok": False, "kind": "error", "error": str(e)}
    except Exception as e:  # noqa: BLE001 — reported to the client, whose ladder serves it
        _served("error")
        return {"ok": False, "kind": "error", "error": f"{type(e).__name__}: {e}"}
    finally:
        verdict.release()


# ---------------------------------------------------------------------------
# client side: the replica rung of the ladder
# ---------------------------------------------------------------------------

#: how long a not-eligible peer sits out before it is asked again
NOT_ELIGIBLE_COOLDOWN_S = 0.25
#: the error backoff: base * 2^fails, capped
ERROR_BACKOFF_BASE_S = 0.1
ERROR_BACKOFF_MAX_S = 5.0
#: EWMA smoothing and the switch hysteresis
EWMA_ALPHA = 0.3
HYSTERESIS = 1.25
#: every Nth dispatch probes the slowest peer, so a recovered one can win
EXPLORE_EVERY = 16
#: peers tried a dispatch before the ladder goes on
MAX_ATTEMPTS = 2


class _PeerState:
    __slots__ = ("ewma_s", "until", "fails")

    def __init__(self) -> None:
        self.ewma_s = 0.0       # 0: never measured
        self.until = 0.0        # the monotonic time the peer sits out to
        self.fails = 0


class ReplicaRouter:
    """Picks a watermark-eligible peer for a pool-marked query and
    dispatches it; returns None whenever the local ladder should take over.

    ``candidates(library_id) -> [peer_id]`` and ``transport(peer_id,
    payload, nbytes) -> reply dict`` (raising a ``ConnectionError``-family
    error on a link failure, :class:`PeerBusyError` on BUSY) are injected:
    :meth:`maybe_start` wires the p2p manager, the tests in-process
    closures."""

    def __init__(self, node: "Node", candidates: Callable[[str], list[str]],
                 transport: Callable[[str, dict, int], dict]) -> None:
        self.node = node
        self._candidates = candidates
        self._transport = transport
        self._lock = threading.Lock()
        self._peers: dict[str, _PeerState] = {}
        self._dispatch_seq = 0
        self._clock = time.monotonic
        self.max_attempts = MAX_ATTEMPTS

    @classmethod
    def maybe_start(cls, node: "Node") -> "ReplicaRouter | None":
        """Serve pool-marked queries from the peers that replicate the
        library, over ``H_QUERY``. None when p2p is down or
        ``SD_REPLICAS=0``."""
        if os.environ.get("SD_REPLICAS", "").strip() == "0":
            return None
        p2p = getattr(node, "p2p", None)
        if p2p is None:
            return None

        def candidates(library_id: str) -> list[str]:
            return p2p.query_peers(library_id)

        def transport(peer_id: str, payload: dict, nbytes: int) -> dict:
            return p2p.run_coro(p2p.request_query(peer_id, payload),
                                timeout=replica_timeout_s() + 5.0)

        return cls(node, candidates, transport)

    def _require(self, library_id: str) -> dict[str, int] | None:
        try:
            library = self.node.libraries.get(library_id)
        except KeyError:
            return None
        # authored floors, not the clock map: the clock merges forward on
        # every ingest, so this node's own entry could never be covered
        try:
            return library.sync.require_watermark()
        except sqlite3.Error:
            return None  # a library closing under the dispatch: go local

    def _state(self, peer: str) -> _PeerState:
        st = self._peers.get(peer)
        if st is None:
            st = self._peers[peer] = _PeerState()
        return st

    def _order(self, peers: list[str]) -> list[str]:
        """The available peers, best EWMA first, an incumbent displaced
        only by a challenger 1/HYSTERESIS faster, the slowest promoted
        every EXPLORE_EVERY dispatches."""
        now = self._clock()
        with self._lock:
            self._dispatch_seq += 1
            explore = (self._dispatch_seq % EXPLORE_EVERY) == 0
            avail = [p for p in peers if self._state(p).until <= now]
            if not avail:
                return []
            avail.sort(key=lambda p: self._peers[p].ewma_s)  # unmeasured first
            if len(avail) > 1:
                best, runner = avail[0], avail[1]
                b, r = self._peers[best].ewma_s, self._peers[runner].ewma_s
                # keep the slightly slower incumbent, proxied by a lower
                # fail count at comparable latency
                if (b > 0 and r > 0 and b * HYSTERESIS > r
                        and self._peers[runner].fails < self._peers[best].fails):
                    avail[0], avail[1] = runner, best
                if explore:
                    avail.insert(0, avail.pop())
            return avail

    def _backoff(self, st: _PeerState) -> None:
        with self._lock:
            st.fails += 1
            st.until = self._clock() + min(ERROR_BACKOFF_BASE_S * (2 ** st.fails),
                                           ERROR_BACKOFF_MAX_S)

    def dispatch(self, key: str, arg: Any, library_id: str | None) -> Any:
        """The replica rung for one pool-marked query: a
        :class:`~..api.router.RawJson` page, or None for the local rungs
        (counted in ``failovers_<reason>`` whenever a peer was on hand)."""
        from ..api.router import RawJson

        if not library_id:
            return None
        peers = self._candidates(library_id)
        if not peers:
            return None  # the rung is not armed for this library: silent
        require = self._require(library_id)
        if require is None:
            return None
        order = self._order(peers)
        if not order:
            _failed_over("no_peers")
            return None
        payload = {"library_id": library_id, "key": key, "arg": arg, "require": require}
        # the dispatching thread's span (a request trace): the replica's
        # serve stitches under it
        ctx = mesh.outbound_context(origin=str(self.node.config.get().get("id") or ""))
        if ctx is not None:
            payload["ctx"] = ctx.to_wire()
        nbytes = len(json.dumps(payload, default=str))
        last_reason = "error"
        for peer in order[:self.max_attempts]:
            st = self._state(peer)
            t0 = self._clock()
            try:
                reply = self._transport(peer, payload, nbytes)
            except PeerBusyError as e:
                with self._lock:
                    st.until = self._clock() + e.retry_after_ms / 1000.0
                _dispatched(peer, "busy")
                last_reason = "busy"
                continue
            except Exception as e:  # noqa: BLE001 — a link failure: back off, go on
                self._backoff(st)
                _dispatched(peer, "error")
                logger.debug("replica %s transport failed: %s", peer_label(peer), e)
                last_reason = "error"
                continue
            dt = self._clock() - t0
            if not isinstance(reply, dict):
                self._backoff(st)
                _dispatched(peer, "error")
                last_reason = "error"
                continue
            if reply.get("ok"):
                raw = reply.get("raw")
                if not isinstance(raw, (bytes, bytearray)):
                    _dispatched(peer, "error")
                    last_reason = "error"
                    continue
                with self._lock:
                    st.fails = 0
                    st.ewma_s = dt if st.ewma_s <= 0 else EWMA_ALPHA * dt + (1 - EWMA_ALPHA) * st.ewma_s
                _dispatched(peer, "ok")
                _SECONDS.observe(dt, peer=peer_label(peer))
                return RawJson(bytes(raw))
            kind = reply.get("kind")
            if kind == "not_eligible":
                with self._lock:
                    st.until = self._clock() + NOT_ELIGIBLE_COOLDOWN_S
                _dispatched(peer, "not_eligible")
                _count("eligibility_rejections")
                _ELIGIBILITY.inc(peer=peer_label(peer))
                last_reason = "not_eligible"
            elif kind == "busy":
                with self._lock:
                    st.until = self._clock() + int(reply.get("retry_after_ms") or 250) / 1000.0
                _dispatched(peer, "busy")
                last_reason = "busy"
            else:
                self._backoff(st)
                _dispatched(peer, "error")
                last_reason = "error"
        _failed_over(last_reason)
        return None

    def status(self) -> dict[str, Any]:
        now = self._clock()
        with self._lock:
            return {
                "peers": {peer_label(p): {"ewma_ms": round(st.ewma_s * 1000.0, 3),
                                          "cooldown_s": round(max(0.0, st.until - now), 3),
                                          "fails": st.fails}
                          for p, st in self._peers.items()},
                "dispatches": self._dispatch_seq,
            }
