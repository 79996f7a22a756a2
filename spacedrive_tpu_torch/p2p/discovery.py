"""LAN peer discovery: UDP beacons + static peer list.

A copy of ``spacedrive_tpu/p2p/discovery.py``. Role of the reference's mDNS daemon (crates/p2p/src/discovery/mdns.rs:20,
60s re-advertisement with metadata TXT records): each node periodically
broadcasts a small JSON beacon carrying its PeerMetadata equivalent
(peer_metadata.rs — node id/name, public identity, TCP port, per-library
instance identities, accelerator inventory for remote-hasher routing) and
expires peers it stops hearing from.

Design differences, deliberate for this environment:

- plain UDP broadcast (255.255.255.255 + 127.0.0.1) on a fixed port with
  SO_REUSEPORT instead of true mDNS — zero-dependency, works between
  processes on one host and on a flat LAN; beacons fail soft where the
  network refuses broadcast;
- a static peer list (``p2p_static_peers`` node-config key) for networks
  where UDP is filtered — the manager handshake doubles as metadata
  exchange, so a bare ``host:port`` is enough to bootstrap.
"""

from __future__ import annotations

import asyncio
import json
import logging
import socket
import time
from dataclasses import dataclass, field
from typing import Any, Callable

logger = logging.getLogger(__name__)

BEACON_INTERVAL = 10.0  # seconds (reference re-advertises every 60s)
PEER_EXPIRY = 3.5 * BEACON_INTERVAL


@dataclass
class DiscoveredPeer:
    identity: str            # RemoteIdentity b64 (the peer id)
    host: str
    port: int                # TCP listen port
    metadata: dict[str, Any] = field(default_factory=dict)
    last_seen: float = field(default_factory=time.monotonic)

    @property
    def addr(self) -> tuple[str, int]:
        return self.host, self.port


class _BeaconProtocol(asyncio.DatagramProtocol):
    def __init__(self, discovery: "Discovery") -> None:
        self.discovery = discovery

    def datagram_received(self, data: bytes, addr: tuple[str, int]) -> None:
        self.discovery._on_beacon(data, addr)


class Discovery:
    """Runs inside the P2P manager's event loop."""

    def __init__(self, port: int, metadata_fn: Callable[[], dict[str, Any]],
                 on_peer: Callable[[DiscoveredPeer, bool], None],
                 on_expired: Callable[[DiscoveredPeer], None]) -> None:
        self.port = port
        self.metadata_fn = metadata_fn  # fresh beacon payload each tick
        self.on_peer = on_peer          # (peer, is_new)
        self.on_expired = on_expired
        self.peers: dict[str, DiscoveredPeer] = {}
        self._transport: asyncio.DatagramTransport | None = None
        self._task: asyncio.Task | None = None
        self._own_identity: str | None = None

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if hasattr(socket, "SO_REUSEPORT"):
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        sock.setblocking(False)
        sock.bind(("0.0.0.0", self.port))
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _BeaconProtocol(self), sock=sock)
        self._task = asyncio.create_task(self._tick_loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._transport:
            self._transport.close()

    async def _tick_loop(self) -> None:
        while True:
            try:
                self._send_beacon()
                self._expire()
            except Exception:
                logger.exception("discovery tick failed")
            await asyncio.sleep(BEACON_INTERVAL)

    def _send_beacon(self) -> None:
        meta = self.metadata_fn()
        self._own_identity = meta.get("identity")
        payload = json.dumps({"sd": 1, **meta}).encode()
        for dest in ("255.255.255.255", "127.0.0.1"):
            try:
                self._transport.sendto(payload, (dest, self.port))
            except OSError as e:  # broadcast can be refused
                logger.debug("beacon to %s failed: %s", dest, e)

    def _expire(self) -> None:
        cutoff = time.monotonic() - PEER_EXPIRY
        for ident in [i for i, p in self.peers.items() if p.last_seen < cutoff]:
            peer = self.peers.pop(ident)
            logger.info("peer expired: %s", ident[:12])
            self.on_expired(peer)

    def _on_beacon(self, data: bytes, addr: tuple[str, int]) -> None:
        try:
            meta = json.loads(data.decode())
        except ValueError:
            return
        if meta.get("sd") != 1:
            return
        identity = meta.get("identity")
        if not identity or identity == self._own_identity:
            return  # our own broadcast reflected back
        is_new = identity not in self.peers
        peer = DiscoveredPeer(identity=identity, host=addr[0],
                              port=int(meta.get("port", 0)), metadata=meta)
        self.peers[identity] = peer
        self.on_peer(peer, is_new)
