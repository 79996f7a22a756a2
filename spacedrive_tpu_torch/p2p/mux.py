"""Spacetime substream multiplexing: many exchanges over ONE connection.

A copy of ``spacedrive_tpu/p2p/mux.py``, frame for frame. Upstream: crates/p2p/src/spacetime/ — the custom libp2p NetworkBehaviour
giving the application unicast substreams over a single QUIC connection
("sits between libp2p and the application... authentication, chucking",
spacetime/mod.rs:1-2; UnicastStream in stream.rs). TCP has no native
substreams, so this module carries a yamux-shaped framing on top of the
encrypted record layer (secure.py):

    frame := type(1) ‖ stream_id(4 BE) ‖ length(4 BE) ‖ payload

    OPEN  — first frame of a new substream (payload empty)
    DATA  — payload bytes for the stream
    CLOSE — half-close: the sender is done writing (reader sees EOF)
    RESET — abort: both directions die, pending reads fail

Stream ids are odd for the connection initiator and even for the responder
(enforced on receive), so simultaneous opens cannot collide. Large writes
queue per-substream and are flushed frame-at-a-time inside drain() with the
event loop yielding between frames, so one bulk transfer interleaves fairly
with concurrent exchanges instead of monopolizing the pipe or buffering a
whole spaceblock in the transport. Each substream's receive side is a real
asyncio.StreamReader fed by the demux loop — existing protocol code
(Header.from_stream, read_json, spaceblock) works on substreams unchanged.
Per-stream receive buffering is bounded: a peer overflowing BUFFER_CAP on
an unread stream gets that stream RESET, never unbounded memory.

One mutually-authenticated handshake now covers every exchange between a
peer pair for the life of the connection (the reference's QUIC session has
the same property), instead of one AKE per exchange.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Any, Awaitable, Callable

logger = logging.getLogger(__name__)

T_OPEN = 1
T_DATA = 2
T_CLOSE = 3
T_RESET = 4

FRAME_MAX = 128 * 1024          # payload cap per DATA frame (fairness)
BUFFER_CAP = 64 * 1024 * 1024   # per-substream unread cap (abuse guard)

_HDR = struct.Struct(">BII")


class MuxError(ConnectionError):
    """ConnectionError subclass so every existing p2p error path that
    handles a dead socket (except OSError / ConnectionError) also handles a
    dead or reset substream."""


class Substream:
    """One virtual stream: StreamReader-compatible receive side + a writer
    facade matching asyncio.StreamWriter's surface (write/drain/close/
    wait_closed/get_extra_info)."""

    def __init__(self, conn: "MuxConn", stream_id: int) -> None:
        self._conn = conn
        self.stream_id = stream_id
        self.reader = asyncio.StreamReader()
        self._write_closed = False
        self._reset = False
        self._out: list[bytes] = []  # pending frame payloads (flushed in drain)

    # -- reader surface (delegates; demux feeds self.reader) ----------------
    async def readexactly(self, n: int) -> bytes:
        return await self.reader.readexactly(n)

    async def read(self, n: int = -1) -> bytes:
        return await self.reader.read(n)

    async def readline(self) -> bytes:
        return await self.reader.readline()

    def at_eof(self) -> bool:
        return self.reader.at_eof()

    # -- writer surface ------------------------------------------------------
    def write(self, data: bytes) -> None:
        if self._write_closed or self._reset:
            raise MuxError(f"substream {self.stream_id} is closed for writing")
        for off in range(0, len(data), FRAME_MAX):
            self._out.append(bytes(data[off:off + FRAME_MAX]))

    async def drain(self) -> None:
        """Flush pending frames one at a time, yielding between frames so
        concurrent substreams interleave on the wire."""
        while self._out:
            if self._reset:
                self._out.clear()
                raise MuxError(f"substream {self.stream_id} was reset")
            chunk = self._out.pop(0)
            await self._conn._write_frame(T_DATA, self.stream_id, chunk)
        await self._conn._drain()

    def close(self) -> None:
        """Half-close (CLOSE frame): remote reader sees EOF; our reader
        stays usable until the remote half-closes too. Pending frames are
        emitted synchronously first (callers that skip the final drain keep
        the old StreamWriter.close semantics)."""
        if self._write_closed or self._reset:
            return
        self._write_closed = True
        for chunk in self._out:
            self._conn._queue_sync(T_DATA, self.stream_id, chunk)
        self._out.clear()
        self._conn._queue_control(T_CLOSE, self.stream_id)
        self._conn._maybe_forget(self.stream_id)

    async def wait_closed(self) -> None:
        await self._conn._drain()

    def reset(self) -> None:
        if self._reset:
            return
        self._reset = True
        self._write_closed = True
        self._out.clear()
        self.reader.feed_eof()
        self._conn._queue_control(T_RESET, self.stream_id)
        self._conn._forget(self.stream_id)

    def get_extra_info(self, name: str, default: Any = None) -> Any:
        return self._conn.writer.get_extra_info(name, default)


class MuxConn:
    """One encrypted connection carrying many substreams.

    ``on_inbound(substream)`` is awaited as a task for every remote OPEN.
    """

    def __init__(self, reader, writer, initiator: bool,
                 on_inbound: Callable[[Substream], Awaitable[None]],
                 name: str = "") -> None:
        self.reader = reader
        self.writer = writer
        self.name = name
        self._next_id = 1 if initiator else 2
        self._streams: dict[int, Substream] = {}
        self._half_closed_remote: set[int] = set()
        self._on_inbound = on_inbound
        self._write_lock = asyncio.Lock()
        self.closed = asyncio.Event()
        self._tasks: set[asyncio.Task] = set()
        self._read_task = asyncio.get_running_loop().create_task(
            self._read_loop())

    # -- opening -------------------------------------------------------------
    def open_substream(self) -> Substream:
        if self.closed.is_set():
            raise MuxError("connection is closed")
        stream_id = self._next_id
        # single event-loop thread: every open_substream runs on the loop,
        # and _write_lock is an asyncio.Lock serializing FRAME interleave,
        # not thread concurrency — the += can never race itself
        self._next_id += 2
        sub = Substream(self, stream_id)
        self._streams[stream_id] = sub
        self._queue_control(T_OPEN, stream_id)
        return sub

    # -- frame emission ------------------------------------------------------
    async def _write_frame(self, frame_type: int, stream_id: int,
                           payload: bytes) -> None:
        """One frame per lock hold: the await inside is the fairness point
        where other substreams' drains interleave."""
        async with self._write_lock:
            self.writer.write(_HDR.pack(frame_type, stream_id, len(payload))
                              + payload)
            await self.writer.drain()

    def _queue_sync(self, frame_type: int, stream_id: int,
                    payload: bytes) -> None:
        try:
            self.writer.write(_HDR.pack(frame_type, stream_id, len(payload))
                              + payload)
        except Exception:
            pass  # connection already torn down

    def _queue_control(self, frame_type: int, stream_id: int) -> None:
        self._queue_sync(frame_type, stream_id, b"")

    async def _drain(self) -> None:
        async with self._write_lock:
            await self.writer.drain()

    # -- demux loop ----------------------------------------------------------
    async def _read_loop(self) -> None:
        try:
            while True:
                head = await self.reader.readexactly(_HDR.size)
                frame_type, stream_id, length = _HDR.unpack(head)
                payload = (await self.reader.readexactly(length)
                           if length else b"")
                if frame_type == T_OPEN:
                    # id-parity rule: the remote may only open ids from ITS
                    # half of the space (we are initiator → remote ids even)
                    remote_parity = 0 if self._next_id % 2 == 1 else 1
                    if stream_id % 2 != remote_parity:
                        logger.warning("mux %s: OPEN with local-side id %d "
                                       "rejected", self.name, stream_id)
                        self._queue_control(T_RESET, stream_id)
                        continue
                    if stream_id in self._streams:
                        continue  # duplicate OPEN: ignore
                    sub = Substream(self, stream_id)
                    self._streams[stream_id] = sub
                    task = asyncio.get_running_loop().create_task(
                        self._on_inbound(sub))
                    self._tasks.add(task)
                    task.add_done_callback(self._tasks.discard)
                elif frame_type == T_DATA:
                    sub = self._streams.get(stream_id)
                    if sub is None or stream_id in self._half_closed_remote:
                        continue  # stale/reset stream: drop
                    buffered = len(sub.reader._buffer)  # bounded-abuse guard
                    if buffered + length > BUFFER_CAP:
                        logger.warning("mux %s: stream %d overflowed %d bytes"
                                       " unread; resetting", self.name,
                                       stream_id, BUFFER_CAP)
                        sub.reset()
                        continue
                    sub.reader.feed_data(payload)
                elif frame_type == T_CLOSE:
                    sub = self._streams.get(stream_id)
                    self._half_closed_remote.add(stream_id)
                    if sub is not None:
                        sub.reader.feed_eof()
                        self._maybe_forget(stream_id)
                elif frame_type == T_RESET:
                    sub = self._streams.pop(stream_id, None)
                    self._half_closed_remote.discard(stream_id)
                    if sub is not None:
                        sub._reset = True
                        sub._write_closed = True
                        sub.reader.feed_eof()
                else:
                    raise MuxError(f"unknown frame type {frame_type}")
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass  # remote closed the connection
        except Exception as e:
            from .proto import ProtocolError

            if isinstance(e, ProtocolError):
                # secure-record EOF surfaces as ProtocolError: a normal close
                logger.debug("mux %s: closed (%s)", self.name, e)
            else:
                logger.exception("mux %s: demux loop failed", self.name)
        finally:
            await self._teardown()

    def _maybe_forget(self, stream_id: int) -> None:
        """Drop bookkeeping once BOTH directions are done."""
        sub = self._streams.get(stream_id)
        if (sub is not None and sub._write_closed
                and stream_id in self._half_closed_remote):
            self._streams.pop(stream_id, None)
            self._half_closed_remote.discard(stream_id)

    def _forget(self, stream_id: int) -> None:
        self._streams.pop(stream_id, None)
        self._half_closed_remote.discard(stream_id)

    async def _teardown(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        for sub in list(self._streams.values()):
            sub._reset = True
            sub._write_closed = True
            sub.reader.feed_eof()
        self._streams.clear()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass

    def close(self) -> None:
        self._read_task.cancel()
        for task in list(self._tasks):
            task.cancel()

    async def aclose(self) -> None:
        """Deterministic shutdown: cancel the demux + handlers and wait for
        teardown (closed set, transport closed)."""
        self.close()
        await self._teardown()

    @property
    def alive(self) -> bool:
        return not self.closed.is_set()
