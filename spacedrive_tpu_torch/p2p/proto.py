"""Wire protocol: framing, headers, sync-session and spaceblock messages.

A copy of ``spacedrive_tpu/p2p/proto.py``; the bytes it writes equal the
reference's for the same values, so a port node and a JAX node speak one
wire. The surface mirrors the upstream project's:

- ``Header`` discriminators follow core/src/p2p/protocol.rs:13-27
  (0=Spacedrop, 1=Ping, 2=Pair, 3=Sync, 4=File, 5=Connected), then this
  system's 6=Thumbnail, 7=Hash (the shared hasher service), 8=Delta and
  9=Query (the replica tier's; the port does not serve it yet, but the
  header stays so the wire stays the same);
- sync sessions speak ``NewOperations``, then a responder-driven
  ``GetOperations`` / ``Operations`` pull loop, with ``busy`` when the
  responder's admission budget sheds a window;
- spaceblock messages (Block/Cancelled).

A 1-byte discriminator, then u32-length-prefixed JSON frames for
structured payloads; block payloads are raw bytes after a fixed header.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass, field
from typing import Any

MAX_FRAME = 64 << 20  # defensive bound for a control-plane frame


class ProtocolError(Exception):
    pass


# -- framing -----------------------------------------------------------------

async def read_exact(reader: asyncio.StreamReader, n: int) -> bytes:
    try:
        return await reader.readexactly(n)
    except asyncio.IncompleteReadError as e:
        raise ProtocolError(f"stream closed mid-read ({len(e.partial)}/{n})") from e


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    n = int.from_bytes(await read_exact(reader, 4), "big")
    if n > MAX_FRAME:
        raise ProtocolError(f"frame too large: {n}")
    return await read_exact(reader, n)


def frame(payload: bytes) -> bytes:
    return len(payload).to_bytes(4, "big") + payload


async def read_json(reader: asyncio.StreamReader) -> Any:
    return json.loads((await read_frame(reader)).decode())


async def read_json_sized(reader: asyncio.StreamReader) -> tuple[Any, int]:
    """(decoded frame, wire byte length) — the receive-path admission
    budget accounts bytes from the actual frame size, not an estimate."""
    raw = await read_frame(reader)
    return json.loads(raw.decode()), len(raw)


def json_frame(obj: Any) -> bytes:
    return frame(json.dumps(obj, separators=(",", ":")).encode())


# -- spaceblock requests -----------------------------------------------------

BLOCK_SIZES = tuple(1 << p for p in range(10, 28))  # 1KiB..128MiB


def block_size_for(file_size: int) -> int:
    """Power-of-two block size scaled to the transfer (block_size.rs:
    from_size). Small files move in one block; big ones in 128KiB+ blocks
    so progress events stay frequent without drowning in framing."""
    for size in BLOCK_SIZES:
        if file_size <= size * 256:
            return size
    return BLOCK_SIZES[-1]


@dataclass(frozen=True)
class Range:
    """Full file or byte sub-range [start, end) (spaceblock sb_request Range)."""

    start: int = 0
    end: int | None = None  # None = to EOF

    def to_wire(self) -> list:
        return [self.start, self.end]

    @classmethod
    def from_wire(cls, v: Any) -> "Range":
        if not v:
            return cls()
        return cls(int(v[0]), None if v[1] is None else int(v[1]))


@dataclass(frozen=True)
class SpaceblockRequest:
    """Offer/request metadata preceding a block transfer
    (spaceblock/sb_request.rs)."""

    name: str
    size: int
    block_size: int
    range: Range = field(default_factory=Range)

    def to_wire(self) -> dict:
        return {"name": self.name, "size": self.size,
                "block_size": self.block_size, "range": self.range.to_wire()}

    @classmethod
    def from_wire(cls, v: dict) -> "SpaceblockRequest":
        return cls(str(v["name"]), int(v["size"]), int(v["block_size"]),
                   Range.from_wire(v.get("range")))


# -- headers (protocol.rs:13-27) --------------------------------------------

H_SPACEDROP = 0
H_PING = 1
H_PAIR = 2
H_SYNC = 3
H_FILE = 4
H_CONNECTED = 5
H_THUMBNAIL = 6
H_HASH = 7
H_DELTA = 8
H_QUERY = 9


@dataclass(frozen=True)
class Header:
    kind: int
    payload: Any = None  # kind-specific

    # constructors ---------------------------------------------------------
    @classmethod
    def ping(cls) -> "Header":
        return cls(H_PING)

    @classmethod
    def pair(cls) -> "Header":
        return cls(H_PAIR)

    @classmethod
    def sync(cls, library_id: str) -> "Header":
        return cls(H_SYNC, library_id)

    @classmethod
    def spacedrop(cls, req: SpaceblockRequest) -> "Header":
        return cls(H_SPACEDROP, req)

    @classmethod
    def file(cls, library_id: str, file_path_pub_id: str, rng: Range) -> "Header":
        return cls(H_FILE, {"library_id": library_id,
                            "file_path_pub_id": file_path_pub_id,
                            "range": rng.to_wire()})

    @classmethod
    def connected(cls, identities: list[str]) -> "Header":
        return cls(H_CONNECTED, identities)

    @classmethod
    def thumbnail(cls, library_id: str, cas_id: str) -> "Header":
        """Fetch a member library's cached preview by cas_id — the on-demand
        form of the reference's sync_preview_media location knob."""
        return cls(H_THUMBNAIL, {"library_id": library_id, "cas_id": cas_id})

    @classmethod
    def hash_batch(cls, sizes: list[int],
                   ctx: dict | None = None) -> "Header":
        """Shared-hasher request (BASELINE config 5): ``sizes[i]`` bytes of
        pre-gathered cas message follow the header for each item; the peer
        replies with the cas_ids. ``ctx`` is the caller's trace-context
        envelope (:class:`..telemetry.mesh.TraceContext` in its wire form),
        under which the serving peer parents its ``p2p.hash_serve`` span."""
        payload: dict = {"sizes": sizes}
        if ctx is not None:
            payload["ctx"] = ctx
        return cls(H_HASH, payload)

    @classmethod
    def delta(cls, transfer_id: str, name: str, size: int,
              chunks: list[list]) -> "Header":
        """Delta spacedrop offer: the sender's full chunk
        manifest (``[[chunk_hash, length], ...]`` in file order, ops/cdc.py
        geometry) rides the header; the receiver answers with the chunk
        hashes it already holds, and only the missing ones cross the wire
        as spaceblock block messages."""
        return cls(H_DELTA, {"transfer_id": transfer_id, "name": name,
                             "size": size, "chunks": chunks})

    @classmethod
    def query(cls, library_id: str, key: str, arg: Any,
              require: dict[str, int], ctx: dict | None = None) -> "Header":
        """Replica query dispatch: run the pool-marked rspc
        query ``key`` against the peer's replica of ``library_id``.
        ``require`` is the client's applied per-instance HLC clock map —
        the watermark the replica must cover to be eligible. ``ctx`` is the
        optional trace-context envelope."""
        payload: dict = {"library_id": library_id, "key": key, "arg": arg,
                         "require": require}
        if ctx is not None:
            payload["ctx"] = ctx
        return cls(H_QUERY, payload)

    # wire -----------------------------------------------------------------
    def to_bytes(self) -> bytes:
        b = bytes([self.kind])
        if self.kind == H_PING:
            return b
        if self.kind == H_PAIR:
            return b
        if self.kind == H_SYNC:
            return b + json_frame(self.payload)
        if self.kind == H_SPACEDROP:
            return b + json_frame(self.payload.to_wire())
        if self.kind in (H_FILE, H_CONNECTED, H_THUMBNAIL, H_HASH, H_DELTA,
                         H_QUERY):
            return b + json_frame(self.payload)
        raise ProtocolError(f"unknown header kind {self.kind}")

    @classmethod
    async def from_stream(cls, reader: asyncio.StreamReader) -> "Header":
        kind = (await read_exact(reader, 1))[0]
        if kind in (H_PING, H_PAIR):
            return cls(kind)
        if kind == H_SYNC:
            return cls(kind, str(await read_json(reader)))
        if kind == H_SPACEDROP:
            return cls(kind, SpaceblockRequest.from_wire(await read_json(reader)))
        if kind in (H_FILE, H_CONNECTED, H_THUMBNAIL, H_HASH, H_DELTA,
                    H_QUERY):
            return cls(kind, await read_json(reader))
        raise ProtocolError(f"invalid header discriminator {kind}")


# -- sync session messages ---------------------------------------------------

SYNC_NEW_OPERATIONS = b"N"  # SyncMessage::NewOperations (sync/proto.rs)


def main_request_get_operations(clocks: dict[str, int], count: int) -> bytes:
    """Responder → originator: GetOpsArgs pull (sync/mod.rs responder loop)."""
    return json_frame({"req": "get_ops", "clocks": clocks, "count": count})


def main_request_done() -> bytes:
    return json_frame({"req": "done"})


def main_request_busy(retry_after_ms: int,
                      watermark: dict[str, int]) -> bytes:
    """Responder → originator: admission control shed this window.
    ``watermark`` is the responder's DURABLE per-instance clocks — an
    explicit acknowledgment of everything applied so far, so the
    originator resumes from it after ``retry_after_ms`` instead of
    restarting the push."""
    return json_frame({"req": "busy", "retry_after_ms": int(retry_after_ms),
                       "watermark": watermark})


def operations_frame(ops: list[dict], has_more: bool,
                     ctx: dict | None = None) -> bytes:
    """Originator → responder: one batch of wire ops. ``ctx`` is the
    sender's trace-context envelope (:class:`..telemetry.mesh.TraceContext`
    in its wire form), or None."""
    payload: dict = {"ops": ops, "has_more": has_more}
    if ctx is not None:
        payload["ctx"] = ctx
    return json_frame(payload)


# -- spaceblock stream messages ---------------------------------------------

MSG_BLOCK = 0
MSG_CANCELLED = 1


def block_msg(offset: int, data: bytes) -> bytes:
    return (bytes([MSG_BLOCK]) + offset.to_bytes(8, "big")
            + len(data).to_bytes(4, "big") + data)


def cancel_msg() -> bytes:
    return bytes([MSG_CANCELLED])


async def read_block_msg(reader: asyncio.StreamReader) -> tuple[int, bytes] | None:
    """Returns (offset, data) or None for Cancelled."""
    kind = (await read_exact(reader, 1))[0]
    if kind == MSG_CANCELLED:
        return None
    if kind != MSG_BLOCK:
        raise ProtocolError(f"invalid spaceblock discriminator {kind}")
    offset = int.from_bytes(await read_exact(reader, 8), "big")
    n = int.from_bytes(await read_exact(reader, 4), "big")
    if n > MAX_FRAME:
        raise ProtocolError(f"block too large: {n}")
    return offset, await read_exact(reader, n)
