"""P2PManager: authenticated sessions, the peer registry, header dispatch.

A trimmed copy of ``spacedrive_tpu/p2p/manager.py``, byte-compatible on
the wire with it:

- one asyncio thread a node (``p2p-manager``) runs the TCP listener, the
  optional UDP beacons (:mod:`.discovery`, only when
  ``p2p_discovery_port`` is set), the static-peer pings and every session;
  :meth:`P2PManager.run_coro` and :meth:`P2PManager.schedule` hand it
  coroutines from other threads;
- a connection is dialed and handshaken once a peer pair (SIGMA-style:
  both ephemeral X25519 keys in the clear, everything after them sealed,
  :mod:`.secure`; both sides sign a transcript with their node key), then
  multiplexed (:mod:`.mux`): every exchange is a substream that starts with
  a :class:`~.proto.Header`;
- inbound substreams dispatch by header: ping (the current metadata),
  pair (:mod:`.pairing`), sync (:mod:`.nlm`), spacedrop (plain, with an
  accept decision) and delta spacedrop (:mod:`.delta`), file and thumbnail
  serving to library members (files only with the ``filesOverP2P``
  feature), and the shared hasher service (``H_HASH``): a member peer's
  cas messages hashed on this node's device hasher, each batch admitted
  through the node's ingest budget (BUSY with the advised backoff when it
  is over). A failed kernel launch fails the exchange; nothing answers
  from a plain version;
- ``H_QUERY`` (reference :1002-1089): a member peer's pool-marked query
  answered from this node's replica of the library by
  :func:`..server.replica.serve_query` (eligibility, admission, the
  ``replica_serve`` seam; on a node with the card the search handlers score
  there, their launches under origin ``replica-serve``), in an executor;
  the reply is one JSON head, and an ``ok`` head's ``size`` page bytes
  follow it. :meth:`P2PManager.query_peers` and
  :meth:`P2PManager.request_query` are the client side
  (:class:`..server.replica.ReplicaRouter`).

Telemetry, as the reference's: an ``H_HASH`` request carries the
caller's trace-context envelope (``ctx``), and the serving peer hashes
under a ``p2p.hash_serve`` span parented under it (a continued trace of
the same ``trace_id``); an ``H_QUERY`` carries the dispatching thread's
envelope the same way, served under ``replica.serve``.
``sd_p2p_hash_requests_total`` and ``sd_p2p_hash_bytes_total`` count the
batches a peer answered, ``sd_p2p_hash_serve_total{peer}`` and
``sd_p2p_hash_serve_bytes_total{peer}`` the batches served, and BUSY
answers count in ``sd_p2p_busy_replies_total`` /
``sd_p2p_busy_received_total``; :data:`STATS` keeps the same counts as
plain numbers. Not ported: the accept layer's session throttle and
auto-ban (``throttle.py``) and the network fault model
(``faults/net.py``), with their families.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import threading
import time
import uuid
from pathlib import Path
from typing import TYPE_CHECKING, Any

from .. import telemetry
from ..telemetry import mesh
from . import delta as delta_proto
from .discovery import DiscoveredPeer, Discovery
from .identity import Identity, RemoteIdentity, remote_identity_of
from .mux import MuxConn
from .proto import (H_DELTA, H_FILE, H_HASH, H_PAIR, H_PING, H_QUERY, H_SPACEDROP, H_SYNC,
                    H_THUMBNAIL, Header, ProtocolError, Range, SpaceblockRequest,
                    block_size_for, json_frame, read_block_msg, read_exact, read_json)
from .secure import (SecureReader, SecureWriter, derive_session_keys, gen_ephemeral,
                     transcript)
from .spaceblock import receive_file, send_file

if TYPE_CHECKING:
    from ..node import Node

logger = logging.getLogger(__name__)

#: ``hash_requests`` / ``_messages`` / ``_bytes``: H_HASH batches this node
#: shipped and a peer answered; ``hash_served`` / ``_messages`` / ``_bytes``:
#: batches this node hashed for peers; ``hash_busy_sent``: batches it shed
STATS: collections.Counter = collections.Counter()

_HASH_REQS = telemetry.counter(
    "sd_p2p_hash_requests_total", "outbound remote-hasher batches")
_HASH_REQ_BYTES = telemetry.counter(
    "sd_p2p_hash_bytes_total",
    "cas-message bytes shipped to remote hashers")

#: deadline for reading a peer-declared H_HASH payload
HASH_PAYLOAD_TIMEOUT = 30.0

MAGIC = b"SDP4"
SPACEDROP_TIMEOUT = 60.0
HANDSHAKE_TIMEOUT = 20.0
#: how often the static peers are pinged
STATIC_PING_S = 10.0


def reset_counts() -> None:
    STATS.clear()


def _count(key: str, n: int = 1) -> None:
    from ..ops import _kernels

    _kernels.count(STATS, key, n)


async def _read_all_payload(reader, sizes: list[int], collect: bool) -> list[bytes] | None:
    """Read every declared H_HASH segment (``collect=False`` drains them);
    callers bound it with ``asyncio.wait_for``."""
    if collect:
        return [await read_exact(reader, s) for s in sizes]
    for s in sizes:
        await read_exact(reader, s)
    return None


class Peer:
    def __init__(self, identity: str, host: str, port: int, metadata: dict[str, Any]) -> None:
        self.identity = identity
        self.host = host
        self.port = port
        self.metadata = metadata
        self.connected = False

    def to_wire(self) -> dict[str, Any]:
        return {"identity": self.identity, "host": self.host, "port": self.port,
                "connected": self.connected, "name": self.metadata.get("name"),
                "accelerator": self.metadata.get("accelerator")}


class P2PManager:
    def __init__(self, node: "Node") -> None:
        from .nlm import NetworkedLibraries
        from .pairing import PairingManager

        self.node = node
        cfg = node.config.get()
        self.identity = Identity.from_seed(cfg["keypair_seed"])
        self.remote_identity = self.identity.to_remote_identity()
        self.peers: dict[str, Peer] = {}
        self.port: int | None = None
        self.discovery: Discovery | None = None
        self.pairing = PairingManager(self)
        self.nlm = NetworkedLibraries(self)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._stop: asyncio.Event | None = None
        self._server: asyncio.AbstractServer | None = None
        self._ready = threading.Event()
        self._start_error: BaseException | None = None
        self._spacedrop_in: dict[str, dict[str, Any]] = {}
        self._spacedrop_cancel: dict[str, asyncio.Event] = {}
        # one multiplexed connection a peer identity: _muxes is the dial
        # cache, _live_muxes every connection (for shutdown)
        self._muxes: dict[str, MuxConn] = {}
        self._live_muxes: set[MuxConn] = set()
        self._mux_dial_locks: dict[str, asyncio.Lock] = {}
        self._metadata_cache: tuple[dict, float] | None = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True, name="p2p-manager")
        self._thread.start()
        if not self._ready.wait(15):
            raise RuntimeError("p2p manager failed to start")
        if self._start_error is not None:
            raise RuntimeError(f"p2p bring-up failed: {self._start_error}")
        self.nlm.attach()

    def _run(self) -> None:
        try:
            asyncio.run(self._main())
        except Exception as e:
            logger.exception("p2p event loop died")
            self._start_error = e
            self._ready.set()

    async def _main(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        cfg = self.node.config.get()
        self._server = await asyncio.start_server(
            self._on_connection, "0.0.0.0", cfg.get("p2p_port") or 0)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("p2p listening on :%d as %s", self.port,
                    self.remote_identity.encode()[:12])
        disc_port = cfg.get("p2p_discovery_port")
        if disc_port:
            self.discovery = Discovery(int(disc_port), self.metadata,
                                       on_peer=self._on_discovered,
                                       on_expired=self._on_expired)
            try:
                await self.discovery.start()
            except OSError as e:  # beacons fail soft where UDP is refused
                logger.warning("p2p discovery unavailable: %s", e)
                self.discovery = None
        static = cfg.get("p2p_static_peers") or []
        pinger = asyncio.create_task(self._static_peer_loop(static)) if static else None
        self._ready.set()
        await self._stop.wait()
        if pinger:
            pinger.cancel()
        if self.discovery:
            await self.discovery.stop()
        # release every session first: Server.wait_closed waits for the
        # connection handlers, which park on mux.closed
        for mux in list(self._live_muxes):
            await mux.aclose()
        self._live_muxes.clear()
        self._muxes.clear()
        self._server.close()
        await self._server.wait_closed()

    def stop(self) -> None:
        if self._loop is None or self._stop is None:
            return
        try:
            self._loop.call_soon_threadsafe(self._stop.set)
            self._thread.join(timeout=10)
        except RuntimeError:
            pass

    # -- metadata / events ---------------------------------------------------
    def metadata(self) -> dict[str, Any]:
        """PeerMetadata: the node's identity, name, port, the public
        identities of every library's instances, and the accelerator record
        (what peers route cas messages by). Cached for 2 s: it runs on the
        loop and reads every library's instance table."""
        cached = self._metadata_cache
        if cached is not None and time.monotonic() - cached[1] < 2.0:
            return cached[0]
        from ..models import Instance

        cfg = self.node.config.get()
        instances: dict[str, list[str]] = {}
        for library in self.node.libraries.list():
            idents = []
            for row in library.db.find(Instance):
                try:
                    idents.append(remote_identity_of(row["identity"]).encode())
                except ValueError:
                    continue  # a placeholder identity
            instances[library.id] = idents
        meta = {"identity": self.remote_identity.encode(), "node_id": cfg["id"],
                "name": cfg["name"], "port": self.port,
                "operating_system": cfg.get("platform", 0), "instances": instances,
                "accelerator": cfg.get("accelerator", {})}
        self._metadata_cache = (meta, time.monotonic())
        return meta

    def emit(self, event: dict[str, Any]) -> None:
        self.node.emit("p2p", event)

    def _on_discovered(self, dp: DiscoveredPeer, is_new: bool) -> None:
        peer = self.peers.get(dp.identity)
        if peer is None:
            peer = Peer(dp.identity, dp.host, dp.port, dp.metadata)
            self.peers[dp.identity] = peer
        else:
            peer.host, peer.port, peer.metadata = dp.host, dp.port, dp.metadata
        if is_new:
            self.emit({"type": "DiscoveredPeer", "peer": peer.to_wire()})
        self.nlm.peer_seen(peer)

    def _on_expired(self, dp: DiscoveredPeer) -> None:
        peer = self.peers.pop(dp.identity, None)
        if peer is not None:
            self.emit({"type": "ExpiredPeer", "identity": dp.identity})
            self.nlm.peer_lost(peer)

    async def _static_peer_loop(self, static: list[str]) -> None:
        """Ping the configured ``host:port`` peers now and then: the
        handshake is also the metadata exchange."""
        while True:
            for entry in static:
                try:
                    host, port = entry.rsplit(":", 1)
                    await self._ping((host, int(port)))
                except Exception as e:  # noqa: BLE001 — retried next round
                    logger.debug("static peer %s unreachable: %s", entry, e)
            await asyncio.sleep(STATIC_PING_S)

    async def broadcast(self, data: bytes) -> int:
        """Send ``data`` down a fresh substream of every connected peer's
        session; returns how many peers took it."""
        async def one(peer_id: str) -> None:
            _reader, writer, _meta = await self.open_stream(peer_id)
            try:
                writer.write(data)
                await writer.drain()
            finally:
                writer.close()

        targets = [p.identity for p in list(self.peers.values()) if p.connected]
        results = await asyncio.gather(*(one(t) for t in targets), return_exceptions=True)
        return sum(1 for r in results if not isinstance(r, BaseException))

    async def ping_all(self) -> int:
        """Ping every connected peer, refreshing its metadata."""
        targets = [p for p in list(self.peers.values()) if p.connected]
        results = await asyncio.gather(*(self._ping((t.host, t.port)) for t in targets),
                                       return_exceptions=True)
        return sum(1 for r in results if not isinstance(r, BaseException))

    async def _ping(self, addr: tuple[str, int]) -> None:
        reader, writer, _meta = await self.open_stream(f"{addr[0]}:{addr[1]}")
        try:
            writer.write(Header.ping().to_bytes())
            await writer.drain()
            fresh = await asyncio.wait_for(read_json(reader), 10)
            if fresh.get("identity"):
                self._register_connected(fresh, addr[0])
        finally:
            writer.close()

    # -- handshake (secure.py's docstring has the protocol) ------------------
    async def _handshake_out(self, reader, writer, expected_identity: str | None = None):
        eph, e_i = gen_ephemeral()
        writer.write(MAGIC + e_i)
        await writer.drain()
        e_r = await read_exact(reader, 32)
        k_i2r, k_r2i = derive_session_keys(eph, e_r, e_i, e_r)
        sr, sw = SecureReader(reader, k_r2i), SecureWriter(writer, k_i2r)
        auth = await read_json(sr)  # the responder proves its identity only
        peer_ident = RemoteIdentity.decode(auth["identity"])
        # a dial to a known identity is pinned to it
        if expected_identity is not None and auth["identity"] != expected_identity:
            raise ProtocolError("peer identity mismatch")
        if not peer_ident.verify(bytes.fromhex(auth["sig"]),
                                 transcript("resp", e_i, e_r, auth["identity"])):
            raise ProtocolError("peer failed challenge")
        my_ident = self.remote_identity.encode()
        sw.write(json_frame({**self.metadata(), "sig": self.identity.sign(
            transcript("init", e_i, e_r, my_ident, auth["identity"])).hex()}))
        await sw.drain()
        meta = await read_json(sr)  # sent only after it verified us
        return sr, sw, {**meta, "identity": auth["identity"]}

    async def _handshake_in(self, reader, writer):
        if await read_exact(reader, 4) != MAGIC:
            raise ProtocolError("bad magic")
        e_i = await read_exact(reader, 32)
        eph, e_r = gen_ephemeral()
        writer.write(e_r)
        await writer.drain()
        k_i2r, k_r2i = derive_session_keys(eph, e_i, e_i, e_r)
        sr, sw = SecureReader(reader, k_i2r), SecureWriter(writer, k_r2i)
        my_ident = self.remote_identity.encode()
        sw.write(json_frame({"identity": my_ident, "sig": self.identity.sign(
            transcript("resp", e_i, e_r, my_ident)).hex()}))
        await sw.drain()
        hello = await read_json(sr)
        peer_ident = RemoteIdentity.decode(hello["identity"])
        if not peer_ident.verify(bytes.fromhex(hello["sig"]),
                                 transcript("init", e_i, e_r, hello["identity"], my_ident)):
            raise ProtocolError("peer failed challenge")
        sw.write(json_frame(self.metadata()))
        await sw.drain()
        return sr, sw, hello

    def _register_connected(self, meta: dict[str, Any], host: str) -> Peer:
        ident = meta["identity"]
        peer = self.peers.get(ident)
        if peer is None:
            peer = Peer(ident, host, int(meta.get("port") or 0), meta)
            self.peers[ident] = peer
        else:
            peer.host, peer.metadata = host, meta
            if meta.get("port"):
                peer.port = int(meta["port"])
        first = not peer.connected
        peer.connected = True
        if first:
            self.emit({"type": "ConnectedPeer", "identity": ident})
        self.nlm.peer_seen(peer)
        return peer

    # -- outgoing streams ----------------------------------------------------
    def _resolve_addr(self, peer_id: str) -> tuple[str, int]:
        peer = self.peers.get(peer_id)
        if peer is not None:
            return peer.host, peer.port
        if ":" in peer_id:  # direct host:port (the static-peer path)
            host, port = peer_id.rsplit(":", 1)
            return host, int(port)
        raise KeyError(f"unknown peer {peer_id}")

    async def _open_stream_addr(self, addr: tuple[str, int],
                                expected_identity: str | None = None):
        reader, writer = await asyncio.wait_for(asyncio.open_connection(*addr),
                                                HANDSHAKE_TIMEOUT)
        try:
            sr, sw, meta = await asyncio.wait_for(
                self._handshake_out(reader, writer, expected_identity), HANDSHAKE_TIMEOUT)
        except Exception:
            writer.close()
            raise
        self._register_connected(meta, addr[0])
        return sr, sw, meta

    async def open_stream(self, peer_id: str):
        """``(reader, writer, peer_metadata)``: one substream of the peer's
        session, dialed and handshaken at the first exchange. A failed dial
        demotes a known peer."""
        expected = peer_id if peer_id in self.peers else None
        try:
            mux, meta = await self._get_mux(peer_id, expected)
            sub = mux.open_substream()
            return sub, sub, meta
        except (OSError, asyncio.TimeoutError, ProtocolError):
            peer = self.peers.get(peer_id)
            if peer is not None and peer.connected:
                peer.connected = False
                self.emit({"type": "DisconnectedPeer", "identity": peer.identity})
                self.nlm.peer_lost(peer)
            raise

    async def _get_mux(self, peer_id: str, expected_identity: str | None):
        """The peer's live session, dialing once under a per-peer lock so
        concurrent exchanges share one connection."""
        existing = self._muxes.get(peer_id)
        if existing is not None and existing.alive:
            return existing, existing.meta
        lock = self._mux_dial_locks.setdefault(peer_id, asyncio.Lock())
        async with lock:
            existing = self._muxes.get(peer_id)
            if existing is not None and existing.alive:
                return existing, existing.meta
            sr, sw, meta = await self._open_stream_addr(self._resolve_addr(peer_id),
                                                        expected_identity)
            peer = self.peers[meta["identity"]]
            mux = self._adopt_connection(sr, sw, meta, peer, initiator=True)
            if peer_id != meta["identity"]:  # a host:port dial: index both
                self._muxes[peer_id] = mux
            return mux, meta

    def _adopt_connection(self, sr, sw, meta: dict, peer: Peer, initiator: bool) -> MuxConn:
        ident = meta["identity"]

        async def on_inbound(sub) -> None:
            await self._dispatch_substream(sub, peer)

        mux = MuxConn(sr, sw, initiator=initiator, on_inbound=on_inbound,
                      name=f"{'out' if initiator else 'in'}:{ident[:8]}")
        mux.meta = meta
        self._muxes[ident] = mux
        self._live_muxes.add(mux)

        async def reap() -> None:
            await mux.closed.wait()
            self._live_muxes.discard(mux)
            for key in [k for k, v in list(self._muxes.items()) if v is mux]:
                self._muxes.pop(key, None)
            # demote only when no live session to this identity remains
            still_alive = [v for v in self._live_muxes
                           if v.alive and getattr(v, "meta", {}).get("identity") == ident]
            if peer.connected and not still_alive:
                peer.connected = False
                self.emit({"type": "DisconnectedPeer", "identity": ident})
                self.nlm.peer_lost(peer)
            elif still_alive and self._muxes.get(ident) is None:
                self._muxes[ident] = still_alive[0]

        task = asyncio.get_running_loop().create_task(reap())
        task.add_done_callback(self._log_task_error)
        return mux

    # -- cross-thread helpers ------------------------------------------------
    def run_coro(self, coro, timeout: float | None = None):
        """Run a coroutine on the p2p loop from another thread."""
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout)

    def schedule(self, coro) -> None:
        """Fire-and-forget a coroutine on the p2p loop."""
        def _spawn() -> None:
            task = self._loop.create_task(coro)
            task.add_done_callback(self._log_task_error)

        self._loop.call_soon_threadsafe(_spawn)

    @staticmethod
    def _log_task_error(task: asyncio.Task) -> None:
        if not task.cancelled() and task.exception() is not None:
            logger.error("p2p task failed", exc_info=task.exception())

    # -- inbound dispatch ----------------------------------------------------
    async def _on_connection(self, reader, writer) -> None:
        host = writer.get_extra_info("peername", ("?", 0))[0]
        try:
            sr, sw, meta = await asyncio.wait_for(self._handshake_in(reader, writer),
                                                  HANDSHAKE_TIMEOUT)
            peer = self._register_connected(meta, host)
        except (ProtocolError, asyncio.TimeoutError, OSError) as e:
            logger.debug("p2p connection from %s failed: %s", host, e)
            writer.close()
            return
        except Exception:
            logger.exception("p2p connection handler crashed")
            writer.close()
            return
        # the accept callback lives as long as the session
        mux = self._adopt_connection(sr, sw, meta, peer, initiator=False)
        await mux.closed.wait()

    async def _dispatch_substream(self, sub, peer: Peer) -> None:
        """One inbound substream = one header-tagged exchange. A failed
        exchange RESETs the substream, so the peer fails fast."""
        failed = True
        try:
            header = await Header.from_stream(sub)
            if header.kind == H_PING:
                sub.write(json_frame({**self.metadata(),
                                      "identity": self.remote_identity.encode()}))
                await sub.drain()
            elif header.kind == H_PAIR:
                await self.pairing.responder(sub, sub, peer)
            elif header.kind == H_SYNC:
                await self.nlm.responder(sub, sub, header.payload, peer)
            elif header.kind == H_SPACEDROP:
                await self._spacedrop_receive(sub, sub, header.payload, peer)
            elif header.kind == H_FILE:
                await self._serve_file(sub, sub, header.payload, peer)
            elif header.kind == H_THUMBNAIL:
                await self._serve_thumbnail(sub, sub, header.payload, peer)
            elif header.kind == H_HASH:
                await self._serve_hash_batch(sub, sub, header.payload, peer)
            elif header.kind == H_DELTA:
                await delta_proto.serve_delta(self, sub, sub, header.payload, peer)
            elif header.kind == H_QUERY:
                await self._serve_query(sub, sub, header.payload, peer)
            else:
                logger.warning("unhandled header kind %s", header.kind)
            failed = False
        except (ProtocolError, asyncio.TimeoutError, OSError, asyncio.IncompleteReadError) as e:
            logger.debug("p2p exchange from %s failed: %s", peer.identity[:8], e)
        except Exception:
            logger.exception("p2p substream handler crashed")
        finally:
            if failed:
                sub.reset()
            else:
                sub.close()

    # -- spacedrop -----------------------------------------------------------
    def spacedrop(self, peer_id: str, paths: list[str]) -> list[str]:
        """Offer files to a peer; returns the drop ids."""
        ids = []
        for p in paths:
            drop_id = str(uuid.uuid4())
            ids.append(drop_id)
            self.schedule(self._spacedrop_send(drop_id, peer_id, Path(p)))
        return ids

    def spacedrop_delta(self, peer_id: str, paths: list[str]) -> list[str]:
        """Delta spacedrop (:mod:`.delta`): only the chunks the peer lacks
        travel. The same accept, cancel and events as a plain drop."""
        ids = []
        for p in paths:
            drop_id = str(uuid.uuid4())
            ids.append(drop_id)
            self.schedule(delta_proto.send_delta(self, drop_id, peer_id, Path(p)))
        return ids

    async def _spacedrop_send(self, drop_id: str, peer_id: str, path: Path) -> None:
        cancel = asyncio.Event()
        self._spacedrop_cancel[drop_id] = cancel
        try:
            size = path.stat().st_size
            req = SpaceblockRequest(name=path.name, size=size, block_size=block_size_for(size))
            reader, writer, _meta = await self.open_stream(peer_id)
            try:
                writer.write(Header.spacedrop(req).to_bytes())
                await writer.drain()
                decision = await asyncio.wait_for(read_exact(reader, 1), SPACEDROP_TIMEOUT)
                if decision != b"\x01":
                    self.emit({"type": "SpacedropRejected", "id": drop_id})
                    return
                sent = await send_file(
                    writer, path, req,
                    progress=lambda done, total: self.emit(
                        {"type": "SpacedropProgress", "id": drop_id,
                         "percent": int(done * 100 / max(1, total))}),
                    cancelled=cancel)
                await writer.drain()
                self.emit({"type": "SpacedropDone", "id": drop_id, "bytes": sent})
            finally:
                writer.close()
        except (OSError, asyncio.TimeoutError, ProtocolError) as e:
            self.emit({"type": "SpacedropFailed", "id": drop_id, "error": str(e)})
        finally:
            self._spacedrop_cancel.pop(drop_id, None)

    async def _spacedrop_receive(self, reader, writer, req: SpaceblockRequest,
                                 peer: Peer) -> None:
        drop_id = str(uuid.uuid4())
        fut: asyncio.Future = self._loop.create_future()
        self._spacedrop_in[drop_id] = {"future": fut, "req": req, "peer": peer.identity}
        self.emit({"type": "SpacedropRequest", "id": drop_id, "identity": peer.identity,
                   "name": req.name, "size": req.size})
        try:
            target_dir = await asyncio.wait_for(fut, SPACEDROP_TIMEOUT)
        except asyncio.TimeoutError:
            target_dir = None
        finally:
            self._spacedrop_in.pop(drop_id, None)
        if target_dir is None:
            writer.write(b"\x00")
            await writer.drain()
            self.emit({"type": "SpacedropRejected", "id": drop_id})
            return
        writer.write(b"\x01")
        await writer.drain()
        from ..objects.fs import find_available_name

        # the offered name is the peer's: keep only its basename
        safe_name = Path(req.name).name or "received.bin"
        target = find_available_name(Path(target_dir) / safe_name)
        cancel = asyncio.Event()
        self._spacedrop_cancel[drop_id] = cancel
        try:
            ok = await receive_file(
                reader, target, req,
                progress=lambda done, total: self.emit(
                    {"type": "SpacedropProgress", "id": drop_id,
                     "percent": int(done * 100 / max(1, total))}),
                cancelled=cancel)
            self.emit({"type": "SpacedropDone" if ok else "SpacedropFailed",
                       "id": drop_id, "path": str(target)})
        finally:
            self._spacedrop_cancel.pop(drop_id, None)

    def accept_spacedrop(self, drop_id: str, target_dir: str | None) -> None:
        entry = self._spacedrop_in.get(drop_id)
        if entry is None:
            raise KeyError(f"no pending spacedrop {drop_id}")
        self._loop.call_soon_threadsafe(
            lambda: entry["future"].done() or entry["future"].set_result(target_dir))

    def cancel_spacedrop(self, drop_id: str) -> None:
        entry = self._spacedrop_in.get(drop_id)
        if entry is not None:
            self._loop.call_soon_threadsafe(
                lambda: entry["future"].done() or entry["future"].set_result(None))
            return
        cancel = self._spacedrop_cancel.get(drop_id)
        if cancel is not None:
            self._loop.call_soon_threadsafe(cancel.set)

    # -- files over p2p ------------------------------------------------------
    async def _serve_file(self, reader, writer, payload: dict, peer: Peer) -> None:
        """A ranged read of one of a library's files, for a member peer, when
        the ``filesOverP2P`` feature is on."""
        from ..config import BackendFeature
        from ..jobs.error import JobError
        from ..models import FilePath
        from ..objects.fs import file_path_abs

        if not self.node.config.has_feature(BackendFeature.FILES_OVER_P2P):
            writer.write(json_frame({"ok": False, "error": "filesOverP2P disabled"}))
            await writer.drain()
            return

        def _lookup():
            library = self.node.libraries.get(payload["library_id"])
            if peer.identity not in self.nlm.member_nodes(library):
                raise KeyError("not a member of this library")
            row = library.db.find_one(FilePath, {"pub_id": payload["file_path_pub_id"]})
            if row is None:
                raise KeyError("file_path not found")
            _row, p = file_path_abs(library.db, row["id"])
            return p, p.stat().st_size

        try:
            path, size = await asyncio.get_running_loop().run_in_executor(None, _lookup)
        except (KeyError, OSError, JobError) as e:
            writer.write(json_frame({"ok": False, "error": str(e)}))
            await writer.drain()
            return
        rng = Range.from_wire(payload.get("range"))
        req = SpaceblockRequest(name=path.name, size=size, block_size=block_size_for(size),
                                range=rng)
        writer.write(json_frame({"ok": True, **req.to_wire()}))
        await writer.drain()
        await send_file(writer, path, req)
        await writer.drain()

    async def _serve_thumbnail(self, reader, writer, payload: dict, peer: Peer) -> None:
        """A cached preview, for a member peer of a library that tracks the
        content."""
        from ..models import FilePath
        from ..objects.media.thumbnail import thumbnail_path

        cas_id = str(payload.get("cas_id", ""))

        def _lookup() -> bytes:
            library = self.node.libraries.get(payload["library_id"])
            if peer.identity not in self.nlm.member_nodes(library):
                raise KeyError("not a member of this library")
            if ("/" in cas_id or ".." in cas_id
                    or library.db.find_one(FilePath, {"cas_id": cas_id}) is None):
                raise KeyError("no such cas_id in this library")
            return thumbnail_path(self.node.data_dir, cas_id).read_bytes()

        try:
            body = await asyncio.get_running_loop().run_in_executor(None, _lookup)
        except (KeyError, OSError) as e:
            # a fixed message: an OSError's text names local paths
            logger.debug("thumbnail serve refused (%s): %s", cas_id[:8], e)
            writer.write(json_frame({"ok": False, "error": "no such thumbnail"}))
            await writer.drain()
            return
        writer.write(json_frame({"ok": True, "size": len(body)}))
        writer.write(body)
        await writer.drain()

    # -- the shared hasher service (H_HASH) ----------------------------------
    #: per-request limits; the total sits under the mux's 64 MiB buffer
    HASH_MAX_COUNT = 4096
    HASH_MAX_MSG = 256 * 1024
    HASH_MAX_TOTAL = 48 * 1024 * 1024

    async def _serve_hash_batch(self, reader, writer, payload: dict, peer: Peer) -> None:
        """Hash a member peer's cas messages on this node's device hasher.
        A refused batch's payload is still drained (bounded in bytes and
        time), so the refusal, not a reset, reaches the peer."""
        sizes = payload.get("sizes")
        if (not isinstance(sizes, list) or not sizes or len(sizes) > self.HASH_MAX_COUNT
                or not all(isinstance(s, int) and 0 < s <= self.HASH_MAX_MSG for s in sizes)
                or sum(sizes) > self.HASH_MAX_TOTAL):
            if isinstance(sizes, list):
                declared = sum(s for s in sizes if isinstance(s, int) and s > 0)

                async def _drain(total: int) -> None:
                    for _ in range(total // 65536):
                        await read_exact(reader, 65536)
                    if total % 65536:
                        await read_exact(reader, total % 65536)

                try:
                    await asyncio.wait_for(_drain(min(declared, 512 * 1024 * 1024)),
                                           HASH_PAYLOAD_TIMEOUT)
                except (asyncio.TimeoutError, asyncio.IncompleteReadError, ProtocolError):
                    pass
            writer.write(json_frame({"ok": False, "error": "bad batch shape"}))
            await writer.drain()
            return

        async def refuse(reply: dict) -> None:
            try:
                await asyncio.wait_for(_read_all_payload(reader, sizes, collect=False),
                                       HASH_PAYLOAD_TIMEOUT)
            except (asyncio.TimeoutError, asyncio.IncompleteReadError, ProtocolError):
                pass
            writer.write(json_frame(reply))
            await writer.drain()

        loop = asyncio.get_running_loop()
        member = await loop.run_in_executor(
            None, lambda: any(peer.identity in self.nlm.member_nodes(lib)
                              for lib in self.node.libraries.list()))
        if not member:
            await refuse({"ok": False, "error": "not a member"})
            return
        from ..sync.admission import Busy

        label = mesh.peer_label(peer.identity)
        verdict = self.node.ingest_budget.try_admit(label, len(sizes), sum(sizes))
        if isinstance(verdict, Busy):
            _count("hash_busy_sent")
            mesh.record_busy_sent(label)
            await refuse({"ok": False, "error": "busy", "busy": True,
                          "retry_after_ms": verdict.retry_after_ms})
            return
        from ..objects.hasher import hash_messages
        from ..ops import _kernels

        try:
            try:
                messages = await asyncio.wait_for(
                    _read_all_payload(reader, sizes, collect=True), HASH_PAYLOAD_TIMEOUT)
            except asyncio.TimeoutError:
                messages = None
            if messages is not None:
                # the requester's envelope parents this serve under its
                # job trace (stitched by trace_id)
                ctx = mesh.TraceContext.from_wire(payload.get("ctx"))
                trace = mesh.continue_trace(
                    ctx, origin=str(self.node.config.get().get("id") or ""), name="p2p.hash")

                def _hash() -> list[str]:
                    with _kernels.origin("hash-serve"):
                        return hash_messages(self.node, messages)

                with mesh.remote_span(trace, ctx, "p2p.hash_serve", peer=label,
                                      files=len(messages), bytes=sum(sizes)):
                    ids = await loop.run_in_executor(None, _hash)
        finally:
            # the payload is hashed (or abandoned): nothing of it stays
            # buffered. Released before the reply, so the peer's next batch,
            # sent as soon as it reads the reply, never finds this one
            # still counted in flight (the reference releases after the
            # reply's drain, and sheds such a batch when two exceed the
            # budget)
            verdict.release()
        if messages is None:
            writer.write(json_frame({"ok": False, "error": "payload read timed out"}))
            await writer.drain()
            return
        _count("hash_served")
        _count("hash_served_messages", len(messages))
        _count("hash_served_bytes", sum(sizes))
        mesh.record_hash_serve(label, sum(sizes))
        writer.write(json_frame({"ok": True, "ids": ids}))
        await writer.drain()

    async def request_hash_batch(self, peer_id: str, messages: list[bytes],
                                 ctx: "mesh.TraceContext | None" = None) -> list[str]:
        """Ship cas messages to a peer's hasher; its cas_ids, in order. A
        BUSY answer raises :class:`~..faults.PeerBusyError`. ``ctx`` is
        captured on the calling thread (this coroutine runs on the p2p
        loop, which holds no span)."""
        from .. import faults
        from ..faults import PeerBusyError

        faults.inject("p2p_send", key=peer_id)
        reader, writer, _meta = await self.open_stream(peer_id)
        try:
            writer.write(Header.hash_batch(
                [len(m) for m in messages],
                ctx=ctx.to_wire() if ctx is not None else None).to_bytes())
            for m in messages:
                writer.write(m)
            await writer.drain()
            reply = await read_json(reader)
            if not reply.get("ok"):
                if reply.get("busy"):
                    mesh.record_busy_received(mesh.peer_label(peer_id))
                    raise PeerBusyError("peer hasher busy",
                                        retry_after_ms=int(reply.get("retry_after_ms") or 0))
                raise ProtocolError(reply.get("error", "hash batch refused"))
            ids = reply["ids"]
            if len(ids) != len(messages):
                raise ProtocolError("hash batch reply count mismatch")
            # counted once the peer answered: a batch that fell back to
            # this node's device was never shipped
            _count("hash_requests")
            _count("hash_request_messages", len(messages))
            _count("hash_request_bytes", sum(len(m) for m in messages))
            _HASH_REQS.inc()
            _HASH_REQ_BYTES.inc(sum(len(m) for m in messages))
            return [str(i) for i in ids]
        finally:
            writer.close()

    # -- replica queries (H_QUERY) -------------------------------------------
    #: the largest page a replica's answer may declare
    QUERY_MAX_BYTES = 64 << 20

    async def _serve_query(self, reader, writer, payload: dict, peer: Peer) -> None:
        """Answer a member peer's pool-marked query from this node's
        replica: the membership gate, then ``serve_query`` in an executor
        so the read never parks the p2p loop."""
        from ..server.replica import serve_query

        def _serve() -> dict:
            try:
                library = self.node.libraries.get(payload.get("library_id"))
            except KeyError:
                return {"ok": False, "kind": "not_eligible", "watermark": {}}
            if peer.identity not in self.nlm.member_nodes(library):
                return {"ok": False, "kind": "error", "error": "not a member"}
            return serve_query(self.node, payload, peer=peer.identity)

        # the client's envelope: the serve stitches under its request
        ctx = mesh.TraceContext.from_wire(payload.get("ctx"))
        trace = mesh.continue_trace(ctx, origin=str(self.node.config.get().get("id") or ""),
                                    name="replica.query")
        with mesh.remote_span(trace, ctx, "replica.serve", peer=mesh.peer_label(peer.identity),
                              key=str(payload.get("key") or "")) as sp:
            reply = await asyncio.get_running_loop().run_in_executor(None, _serve)
            sp.set(ok=bool(reply.get("ok")), kind=reply.get("kind"))
        raw = reply.pop("raw", None)
        if reply.get("ok") and isinstance(raw, (bytes, bytearray)):
            writer.write(json_frame({"ok": True, "size": len(raw)}))
            writer.write(bytes(raw))
        else:
            writer.write(json_frame(reply))
        await writer.drain()

    def query_peers(self, library_id: str) -> list[str]:
        """The connected peers paired into ``library_id``: the replica
        router's candidates (the membership gate of every other service)."""
        try:
            library = self.node.libraries.get(library_id)
        except KeyError:
            return []
        members = self.nlm.member_nodes(library)
        return [ident for ident in members
                if (p := self.peers.get(ident)) is not None and p.connected]

    async def request_query(self, peer_id: str, payload: dict) -> dict:
        """Send one pool-marked query to a replica peer: its reply in
        ``serve_query``'s shape; a BUSY answer raises
        :class:`~..faults.PeerBusyError` (``retry_after_ms``, 250 when
        absent), a link failure a ``ConnectionError``-family error."""
        from .. import faults
        from ..faults import PeerBusyError
        from ..server.replica import replica_timeout_s

        faults.inject("p2p_send", key=peer_id)
        timeout = replica_timeout_s()
        reader, writer, _meta = await asyncio.wait_for(self.open_stream(peer_id), timeout)
        try:
            writer.write(Header.query(payload["library_id"], payload["key"], payload.get("arg"),
                                      payload.get("require") or {},
                                      ctx=payload.get("ctx")).to_bytes())
            await writer.drain()
            head = await asyncio.wait_for(read_json(reader), timeout)
            if head.get("ok"):
                size = int(head.get("size") or 0)
                if size < 0 or size > self.QUERY_MAX_BYTES:
                    raise ProtocolError(f"absurd query reply size {size}")
                raw = await asyncio.wait_for(read_exact(reader, size), timeout)
                return {"ok": True, "raw": raw}
            if head.get("kind") == "busy":
                mesh.record_busy_received(mesh.peer_label(peer_id))
                raise PeerBusyError("replica busy",
                                    retry_after_ms=int(head.get("retry_after_ms") or 250))
            return head
        finally:
            writer.close()

    async def request_thumbnail(self, peer_id: str, library_id: str, cas_id: str) -> bytes:
        """A member peer's cached preview bytes."""
        reader, writer, _meta = await self.open_stream(peer_id)
        try:
            writer.write(Header.thumbnail(library_id, cas_id).to_bytes())
            await writer.drain()
            head = await read_json(reader)
            if not head.get("ok"):
                raise ProtocolError(head.get("error", "thumbnail refused"))
            size = int(head["size"])
            if size > 16 * 1024 * 1024:
                raise ProtocolError("absurd thumbnail size")
            return await read_exact(reader, size)
        finally:
            writer.close()

    async def request_file(self, peer_id: str, library_id: str, file_path_pub_id: str,
                           rng: Range, sink) -> int:
        """A peer's file bytes (``rng`` of them) into ``sink``, a writable
        binary file object; returns the bytes written."""
        reader, writer, _meta = await self.open_stream(peer_id)
        try:
            writer.write(Header.file(library_id, file_path_pub_id, rng).to_bytes())
            await writer.drain()
            head = await read_json(reader)
            if not head.get("ok"):
                raise ProtocolError(head.get("error", "file request refused"))
            req = SpaceblockRequest.from_wire(head)
            total = (req.size if req.range.end is None
                     else min(req.range.end, req.size)) - req.range.start
            got = 0
            while got < total:
                msg = await read_block_msg(reader)
                if msg is None:
                    raise ProtocolError("peer cancelled file transfer")
                _offset, data = msg
                sink.write(data)
                got += len(data)
            return got
        finally:
            writer.close()

    # -- state for the API ---------------------------------------------------
    def peer_list(self) -> list[dict[str, Any]]:
        return [p.to_wire() for p in self.peers.values()]

    def nlm_state(self) -> dict[str, Any]:
        return self.nlm.state()

    def pair(self, peer_id: str) -> int:
        return self.pairing.originator(peer_id)

    def pairing_response(self, pairing_id: int, decision: Any) -> None:
        self.pairing.decision(pairing_id, decision)
