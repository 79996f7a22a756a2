"""NetworkedLibraries: per-library peer state and sync sessions over the
wire.

A trimmed copy of ``spacedrive_tpu/p2p/nlm.py``, on the same wire:

- the state of every other instance of each library (``Unavailable``,
  ``Discovered``, ``Connected``), keyed by the instance's public identity,
  rebuilt from the instance table on the library-manager events
  (:meth:`..library.Libraries.subscribe`);
- :meth:`NetworkedLibraries.originate`: on each ``SyncMessage.CREATED`` of
  a library's sync manager (one per commit that logged operations) this
  node opens ``Header::Sync(library_id)`` + ``NewOperations`` to every
  connected member peer and serves its ``GetOperations`` pulls from
  ``sync.get_ops``. One live session a (library, peer): events that arrive
  meanwhile coalesce into one rerun. A session that fails on a transient
  error (a dropped link, a BUSY answer) retries on ``ORIGINATE_RETRY``'s
  backoff, never before a BUSY's advised wait, and is dropped when the
  peer's acknowledged watermark already covers the log. A BUSY answer is
  the peer saying when to come back, not a failure: it does not count
  toward ``ORIGINATE_RETRY.attempts``, only the time budget bounds it (the
  reference counts it, so five BUSY answers in a row strand the rest of
  the log until the library's next commit);
- :meth:`NetworkedLibraries.responder`: pulls windows of
  ``OPS_PER_REQUEST`` with this library's per-instance clocks, admits each
  through the node's ingest budget (over it: a BUSY frame with the durable
  clocks, and the session ends) and feeds it to the :class:`..sync.Ingester`
  (or the ingest lanes, ``SD_SYNC_INGEST_LANES`` > 1) off the loop.

Trace propagation, as the reference's (:315-517): each push session that
dialled is one mesh trace (:func:`..telemetry.mesh.new_trace`, id
``sync-<library>-<uuid>``, span ids above this node's base), each served
window a ``sync.window`` span whose envelope (the trace, the span, this
node's id, its HLC and the backlog left) rides the operations frame; the
responder's ``sync.apply`` spans parent under it, and each side exports its
half under ``<data_dir>/logs/traces/`` (the responder without a root), so
the two files stitch into one tree by ``trace_id``. ``sync.push`` and
``sync.session`` events; ``sd_sync_remote_sessions_total``,
``sd_p2p_busy_replies_total``, ``sd_p2p_busy_received_total`` and
``sd_p2p_busy_backoff_seconds_total``. :data:`STATS` counts sessions,
windows and ops on both sides, and the BUSY frames sent and received. The
reference's network fault model is not ported.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import uuid
from typing import TYPE_CHECKING, Any

from .. import faults, telemetry
from ..faults import PeerBusyError
from ..retry import RetryPolicy, is_transient
from ..telemetry import mesh
from .identity import remote_identity_of
from .proto import (SYNC_NEW_OPERATIONS, Header, main_request_busy, main_request_done,
                    main_request_get_operations, operations_frame, read_exact, read_json,
                    read_json_sized)

if TYPE_CHECKING:
    from ..library import Library
    from .manager import P2PManager, Peer

logger = logging.getLogger(__name__)

OPS_PER_REQUEST = 1000

#: the backoff of a push session's retries after a flap or a BUSY answer
ORIGINATE_RETRY = RetryPolicy(attempts=5, base_s=0.2, max_s=5.0, budget_s=60.0)

UNAVAILABLE = "Unavailable"
DISCOVERED = "Discovered"
CONNECTED = "Connected"

#: ``pushed_sessions`` / ``pushed_windows`` / ``pushed_ops`` (originator),
#: ``pulled_sessions`` / ``pulled_windows`` / ``pulled_ops`` (responder),
#: ``busy_sent``, ``busy_received``
STATS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    STATS.clear()


def _count(key: str, n: int = 1) -> None:
    from ..ops import _kernels

    _kernels.count(STATS, key, n)


def _transient(e: BaseException) -> bool:
    """The reference's union class: a dropped or refused link is transient."""
    return is_transient(e) or isinstance(e, (ConnectionError, TimeoutError,
                                             asyncio.TimeoutError))


class NetworkedLibraries:
    def __init__(self, manager: "P2PManager") -> None:
        self.manager = manager
        self.node = manager.node
        # library id -> instance identity -> {"state", "peer"}
        self._libraries: dict[str, dict[str, dict[str, Any]]] = {}
        self._hooked: set[str] = set()
        # (library id, peer id) -> the clocks that peer acknowledged as
        # durable (each GetOperations request, each BUSY frame)
        self._ack_watermarks: dict[tuple[str, str], dict[str, int]] = {}
        # single-flight latches, flipped between awaits on the one loop
        self._originating: set[tuple[str, str]] = set()
        self._rerun: set[tuple[str, str]] = set()

    def attach(self) -> None:
        """Follow the library-manager events (a load for each open library
        first); called once the loop is up."""
        from ..library import LibraryManagerEvent as E

        def on_event(event: str, library) -> None:
            if event == E.DELETE:
                self._libraries.pop(library.id, None)
                self._hooked.discard(library.id)
                return
            self._load_library(library)

        self.node.libraries.subscribe(on_event)

    # -- state ---------------------------------------------------------------
    def _load_library(self, library: "Library") -> None:
        from ..models import Instance

        entry: dict[str, dict[str, Any]] = {}
        own = self.manager.remote_identity.encode()
        for row in library.db.find(Instance):
            try:
                ident = remote_identity_of(row["identity"]).encode()
            except ValueError:
                continue
            if ident != own:
                entry[ident] = {"state": UNAVAILABLE, "peer": None}
        self._libraries[library.id] = entry
        if library.id not in self._hooked and library.sync is not None:
            self._hooked.add(library.id)
            library.sync.subscribe(lambda msg, lib=library: self._on_sync_message(lib, msg))
        for peer in list(self.manager.peers.values()):
            self.peer_seen(peer)

    def _on_sync_message(self, library: "Library", msg: str) -> None:
        from ..sync.manager import SyncMessage

        if msg == SyncMessage.CREATED:
            self.manager.schedule(self.originate(library))

    def peer_seen(self, peer: "Peer") -> None:
        """Instance states from a peer's advertised per-library identities;
        a shared library's peer that newly connects gets a push."""
        state = CONNECTED if peer.connected else DISCOVERED
        own = self.manager.remote_identity.encode()
        for lib_id, idents in (peer.metadata.get("instances") or {}).items():
            lib_entry = self._libraries.get(lib_id)
            if lib_entry is None:
                continue
            for ident in idents:
                if ident == own:
                    continue
                cur = lib_entry.setdefault(ident, {"state": UNAVAILABLE, "peer": None})
                newly_connected = state == CONNECTED and cur["state"] != CONNECTED
                cur["state"] = state
                cur["peer"] = peer.identity
                if newly_connected:
                    try:
                        library = self.node.libraries.get(lib_id)
                    except KeyError:
                        continue
                    self.manager.schedule(self.originate(library))

    def peer_lost(self, peer: "Peer") -> None:
        for lib_entry in self._libraries.values():
            for cur in lib_entry.values():
                if cur["peer"] == peer.identity:
                    cur["state"] = UNAVAILABLE
                    cur["peer"] = None

    def state(self) -> dict[str, Any]:
        """The ``p2p.nlmState`` payload."""
        return {lib_id: {"instances": dict(entry)} for lib_id, entry in self._libraries.items()}

    # -- membership ----------------------------------------------------------
    def member_nodes(self, library: "Library") -> set[str]:
        """The node identities paired into this library: the
        handshake-proven identities its instance rows record. The
        authorization anchor of sync sessions, file and thumbnail serving
        and the hash service."""
        from ..models import Instance

        return {r["node_remote_identity"] for r in library.db.find(Instance)
                if r.get("node_remote_identity")}

    # -- acknowledged watermarks ---------------------------------------------
    def _record_ack(self, library_id: str, peer_id: str, clocks: Any) -> None:
        """Fold a peer's declared durable clocks into its watermark (only
        ever raised)."""
        if not isinstance(clocks, dict):
            return
        wm = self._ack_watermarks.setdefault((library_id, peer_id), {})
        for pub_id, ts in clocks.items():
            if isinstance(pub_id, str) and isinstance(ts, int) and ts > wm.get(pub_id, 0):
                wm[pub_id] = ts

    def ack_watermark(self, library_id: str, peer_id: str) -> dict[str, int] | None:
        wm = self._ack_watermarks.get((library_id, peer_id))
        return dict(wm) if wm is not None else None

    def _acked_everything(self, library: "Library", peer_id: str) -> bool:
        wm = self._ack_watermarks.get((library.id, peer_id))
        if wm is None:
            return False
        ops, _has_more = library.sync.get_ops(dict(wm), 1)
        return not ops

    # -- originator ----------------------------------------------------------
    async def originate(self, library: "Library") -> None:
        """Tell every connected member peer that this library has new ops;
        each pulls them over the same substream (one direction)."""
        loop = asyncio.get_running_loop()
        try:
            members = await loop.run_in_executor(None, self.member_nodes, library)
        except Exception as e:  # noqa: BLE001 — a closed library: no push
            logger.debug("sync originate for %s skipped: %s", library.id[:8], e)
            return
        targets = {p.identity for p in list(self.manager.peers.values())
                   if p.connected and p.identity in members}
        await asyncio.gather(*(self._originate_single_flight(library, p) for p in targets))

    async def _originate_single_flight(self, library: "Library", peer_id: str) -> None:
        key = (library.id, peer_id)
        if key in self._originating:
            self._rerun.add(key)
            return
        self._originating.add(key)
        try:
            while True:
                self._rerun.discard(key)
                await self._originate_with_retry(library, peer_id)
                if key not in self._rerun:
                    return
        finally:
            self._originating.discard(key)
            self._rerun.discard(key)

    async def _originate_with_retry(self, library: "Library", peer_id: str) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + ORIGINATE_RETRY.budget_s
        retries = flaps = 0
        while True:
            try:
                await self._originate_to(library, peer_id)
                return
            except Exception as e:  # noqa: BLE001 — classified below
                if not _transient(e):
                    logger.debug("sync originate to %s failed: %s", peer_id[:12], e)
                    return
                busy = isinstance(e, PeerBusyError)
                retries += 1
                flaps = flaps + (not busy)
                if flaps >= ORIGINATE_RETRY.attempts:
                    logger.warning("sync originate to %s gave up after %d attempts: %s",
                                   peer_id[:12], retries, e)
                    return
                delay = ORIGINATE_RETRY.delay(min(retries - 1, 8))
                if busy:
                    # the peer said when to come back: never earlier
                    delay = max(delay, e.retry_after_ms / 1000.0)
                    _count("busy_received")
                    mesh.record_busy_received(mesh.peer_label(peer_id))
                if loop.time() + delay > deadline:
                    logger.warning("sync originate to %s ran out of its retry budget: %s",
                                   peer_id[:12], e)
                    return
                try:
                    done = await loop.run_in_executor(None, self._acked_everything,
                                                      library, peer_id)
                except Exception:  # noqa: BLE001 — cannot prove done: retry
                    done = False
                if done:
                    return
                if busy:
                    mesh.record_busy_backoff(delay)
                await asyncio.sleep(delay)

    async def _originate_to(self, library: "Library", peer_id: str) -> None:
        faults.inject("p2p_send", key=peer_id)
        origin = str(self.node.config.get().get("id") or "")
        reader, writer, _meta = await self.manager.open_stream(peer_id)
        # one mesh trace a session, made once the dial succeeded (a retry
        # loop toward an offline peer must not fill the trace ring)
        trace = mesh.new_trace("sync.push", origin,
                               f"sync-{library.id[:8]}-{uuid.uuid4().hex[:12]}",
                               library_id=library.id, peer=mesh.peer_label(peer_id))
        windows = served = 0
        try:
            writer.write(Header.sync(library.id).to_bytes())
            writer.write(SYNC_NEW_OPERATIONS)
            await writer.drain()
            loop = asyncio.get_running_loop()
            while True:
                req = await read_json(reader)
                kind = req.get("req")
                if kind == "busy":
                    # an explicit ack of what is durable, then back off
                    self._record_ack(library.id, peer_id, req.get("watermark"))
                    raise PeerBusyError(f"peer {peer_id[:12]} shed the window",
                                        retry_after_ms=int(req.get("retry_after_ms") or 0))
                if kind != "get_ops":
                    break  # done
                clocks = req.get("clocks") or {}
                self._record_ack(library.id, peer_id, clocks)
                count = int(req.get("count") or OPS_PER_REQUEST)

                def _serve(clocks=clocks, count=count):
                    ops, has_more = library.sync.get_ops(clocks, count)
                    # the backlog left after this window: the receiver's
                    # sd_sync_peer_lag_ops
                    pending = (max(0, library.sync.ops_pending(clocks) - len(ops))
                               if has_more else 0)
                    return ops, has_more, pending

                with telemetry.span(trace, "sync.window") as span:
                    ops, has_more, pending = await loop.run_in_executor(None, _serve)
                    span.set(ops=len(ops), has_more=has_more, pending=pending)
                    ctx = None
                    if trace is not None:
                        ctx = mesh.TraceContext(trace.trace_id, span.span_id, origin,
                                                hlc=library.sync.clock.last,
                                                pending=pending).to_wire()
                    writer.write(operations_frame(ops, has_more, ctx=ctx))
                    await writer.drain()
                windows += 1
                served += len(ops)
            _count("pushed_sessions")
            _count("pushed_windows", windows)
            _count("pushed_ops", served)
        finally:
            writer.close()
            if trace is not None:
                trace.attrs.update(windows=windows, ops=served)
                node = self.node

                def _export() -> None:
                    telemetry.finish_trace(trace, export_dir=node.data_dir)
                    mesh.prune_session_traces(node.data_dir)

                await asyncio.get_running_loop().run_in_executor(None, _export)
        telemetry.event("sync.push", peer=mesh.peer_label(peer_id), library_id=library.id,
                        windows=windows, ops=served)

    # -- responder -----------------------------------------------------------
    async def responder(self, reader, writer, library_id: str, peer: "Peer") -> None:
        """The ingest pull loop of an incoming sync substream."""
        try:
            library = self.node.libraries.get(library_id)
        except KeyError:
            writer.write(main_request_done())
            await writer.drain()
            return
        loop = asyncio.get_running_loop()
        members = await loop.run_in_executor(None, self.member_nodes, library)
        if peer.identity not in members:
            logger.warning("rejected sync for %s from non-member %s", library_id[:8],
                           peer.identity[:12])
            writer.write(main_request_done())
            await writer.drain()
            return
        notify = await read_exact(reader, 1)
        if notify != SYNC_NEW_OPERATIONS:
            logger.warning("unexpected sync message %r", notify)
            return
        from ..sync.admission import Busy
        from ..sync.ingest import Ingester
        from ..sync.lanes import get_lane_pool, lane_count

        ingester = Ingester(library, peer=peer.identity)
        label = mesh.peer_label(peer.identity)
        budget = self.node.ingest_budget
        windows = total_ops = 0
        shed = False
        last_ctx: mesh.TraceContext | None = None
        while True:
            clocks = await loop.run_in_executor(None, library.sync.timestamps)
            writer.write(main_request_get_operations(clocks, OPS_PER_REQUEST))
            await writer.drain()
            batch, nbytes = await read_json_sized(reader)
            ops = batch.get("ops") or []
            # the sender's envelope: our apply spans stitch under its
            # window spans, and it carries the lag
            ctx = mesh.TraceContext.from_wire(batch.get("ctx"))
            if ctx is not None:
                last_ctx = ctx
            if ops:
                verdict = budget.try_admit(label, len(ops), nbytes)
                if isinstance(verdict, Busy):
                    # shed, don't buffer: the durable clocks are the ack
                    writer.write(main_request_busy(verdict.retry_after_ms, clocks))
                    await writer.drain()
                    _count("busy_sent")
                    mesh.record_busy_sent(label)
                    shed = True
                    break

                def _apply(ops=ops, ctx=ctx) -> None:
                    if lane_count() > 1:
                        _applied, advanced = get_lane_pool(library).receive(
                            ops, peer=peer.identity, ctx=ctx)
                        ingester.last_floor_advanced = advanced
                    else:
                        ingester.receive(ops, ctx)

                try:
                    await loop.run_in_executor(None, _apply)
                finally:
                    verdict.release()
                windows += 1
                total_ops += len(ops)
                if not ingester.last_floor_advanced:
                    # every op of the window was skipped: the peer would
                    # serve the same window forever
                    logger.warning("sync session with %s made no progress; ending round",
                                   peer.identity[:12])
                    break
            if not batch.get("has_more"):
                break
        if not shed:
            writer.write(main_request_done())
            await writer.drain()
        _count("pulled_sessions")
        _count("pulled_windows", windows)
        _count("pulled_ops", total_ops)
        if last_ctx is not None:
            # our half of the stitched trace: the sender's export holds the
            # root and the window spans, ours the apply spans
            from ..telemetry import spans as _spans

            trace = _spans.get_trace(last_ctx.trace_id)
            node = self.node
            if trace is not None:
                await loop.run_in_executor(
                    None, lambda: mesh.export_partial(trace, node.data_dir))
        mesh.record_session(label)
        telemetry.event("sync.session", peer=label, library_id=library_id,
                        windows=windows, ops=total_ops)
        self.manager.emit({"type": "SyncIngested", "library_id": library_id,
                           "from": peer.identity})
