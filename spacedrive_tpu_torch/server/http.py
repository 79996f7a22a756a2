"""Minimal HTTP/1.1 + WebSocket plumbing on asyncio streams.

Copy of ``spacedrive_tpu/server/http.py`` (``Request`` :49, ``Response``
:61, ``read_request`` :90, ``parse_range`` :128, ``write_response`` :152,
``WebSocket`` :197), pure transport: request parsing, keep-alive,
fixed-length responses, byte-range file streaming (the HttpRange behaviour
of custom_uri.rs), and RFC 6455 websocket upgrade and frames
(text/close/ping/pong, client-masked). Websocket text messages count in
``sd_http_ws_messages_total{direction}``.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import io
import struct
import urllib.parse
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from .. import telemetry

_WS_MESSAGES = telemetry.counter(
    "sd_http_ws_messages_total",
    "websocket text messages by direction (in = client frames, out = "
    "responses/subscription events)", labels=("direction",))

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024
FILE_CHUNK = 256 * 1024

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

STATUS_TEXT = {
    200: "OK", 101: "Switching Protocols", 204: "No Content",
    206: "Partial Content", 400: "Bad Request", 401: "Unauthorized",
    404: "Not Found", 405: "Method Not Allowed",
    416: "Range Not Satisfiable", 429: "Too Many Requests", 500: "Internal Server Error",
}


class HttpError(Exception):
    def __init__(self, status: int, message: str = "") -> None:
        super().__init__(message or STATUS_TEXT.get(status, str(status)))
        self.status = status


@dataclass
class Request:
    method: str
    path: str
    query: dict[str, str]
    headers: dict[str, str]
    body: bytes

    def header(self, name: str, default: str = "") -> str:
        return self.headers.get(name.lower(), default)


@dataclass
class Response:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    #: when set, the body is streamed from this file path honoring `range`
    file_path: Path | None = None
    file_range: tuple[int, int] | None = None  # inclusive start, exclusive end

    @classmethod
    def json(cls, obj: Any, status: int = 200) -> "Response":
        import json as _json

        # default=str: DB rows surface datetimes; the wire gets ISO strings
        return cls(status, {"content-type": "application/json"},
                   _json.dumps(obj, default=str).encode())

    @classmethod
    def text(cls, s: str, status: int = 200) -> "Response":
        return cls(status, {"content-type": "text/plain; charset=utf-8"}, s.encode())

    @classmethod
    def error(cls, status: int, message: str = "") -> "Response":
        return cls.json({"error": message or STATUS_TEXT.get(status, "")}, status)


async def read_request(reader: asyncio.StreamReader) -> Request | None:
    """Parse one request; None on clean EOF."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise HttpError(400, "truncated request head")
    except asyncio.LimitOverrunError:
        raise HttpError(400, "header section too large")
    if len(raw) > MAX_HEADER_BYTES:
        raise HttpError(400, "header section too large")
    head = raw.decode("latin-1").split("\r\n")
    try:
        method, target, _version = head[0].split(" ", 2)
    except ValueError:
        raise HttpError(400, "malformed request line")
    headers: dict[str, str] = {}
    for line in head[1:]:
        if not line:
            continue
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    parsed = urllib.parse.urlsplit(target)
    query = dict(urllib.parse.parse_qsl(parsed.query))
    try:
        length = int(headers.get("content-length", "0") or 0)
    except ValueError:
        raise HttpError(400, "malformed content-length")
    if length < 0 or length > MAX_BODY_BYTES:
        raise HttpError(400, "bad body length")
    body = await reader.readexactly(length) if length else b""
    return Request(method.upper(), urllib.parse.unquote(parsed.path),
                   query, headers, body)


def parse_range(header: str, size: int) -> tuple[int, int] | None:
    """`Range: bytes=a-b` → (start, end_exclusive); None = whole file.
    Raises HttpError(416) on unsatisfiable ranges (custom_uri HttpRange)."""
    if not header:
        return None
    if not header.startswith("bytes="):
        raise HttpError(416, "unsupported range unit")
    spec = header[len("bytes="):].split(",")[0].strip()
    start_s, _, end_s = spec.partition("-")
    try:
        if start_s == "":  # suffix range: last N bytes
            n = int(end_s)
            if n <= 0:
                raise ValueError
            return max(0, size - n), size
        start = int(start_s)
        end = int(end_s) + 1 if end_s else size
    except ValueError:
        raise HttpError(416, "malformed range")
    if start >= size or start < 0 or end <= start:
        raise HttpError(416, "range out of bounds")
    return start, min(end, size)


async def write_response(writer: asyncio.StreamWriter, req: Request,
                         resp: Response) -> None:
    headers = dict(resp.headers)
    if resp.file_path is not None:
        size = resp.file_path.stat().st_size
        rng = resp.file_range
        if rng is None:
            start, end = 0, size
        else:
            start, end = rng
            resp.status = 206
            headers["content-range"] = f"bytes {start}-{end - 1}/{size}"
        headers.setdefault("accept-ranges", "bytes")
        headers["content-length"] = str(end - start)
        _write_head(writer, resp.status, headers)
        if req.method != "HEAD":
            with open(resp.file_path, "rb") as fh:
                fh.seek(start)
                left = end - start
                while left > 0:
                    chunk = fh.read(min(FILE_CHUNK, left))
                    if not chunk:
                        break
                    writer.write(chunk)
                    await writer.drain()
                    left -= len(chunk)
        return
    headers["content-length"] = str(len(resp.body))
    _write_head(writer, resp.status, headers)
    if req.method != "HEAD":
        writer.write(resp.body)
    await writer.drain()


def _write_head(writer: asyncio.StreamWriter, status: int,
                headers: dict[str, str]) -> None:
    lines = [f"HTTP/1.1 {status} {STATUS_TEXT.get(status, '')}"]
    for name, value in headers.items():
        lines.append(f"{name}: {value}")
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))


# ---------------------------------------------------------------------------
# WebSocket (RFC 6455)
# ---------------------------------------------------------------------------

class WebSocket:
    """Server-side socket after upgrade. Text frames carry JSON-RPC."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter) -> None:
        self._reader = reader
        self._writer = writer
        self.closed = False

    @staticmethod
    def accept_key(client_key: str) -> str:
        digest = hashlib.sha1((client_key + _WS_GUID).encode()).digest()
        return base64.b64encode(digest).decode()

    async def send_text(self, text: str) -> None:
        if self.closed:
            return
        _WS_MESSAGES.inc(direction="out")
        await self._send_frame(0x1, text.encode())

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        head = bytearray([0x80 | opcode])
        n = len(payload)
        if n < 126:
            head.append(n)
        elif n < 1 << 16:
            head.append(126)
            head += struct.pack(">H", n)
        else:
            head.append(127)
            head += struct.pack(">Q", n)
        self._writer.write(bytes(head) + payload)
        await self._writer.drain()

    async def recv(self) -> str | None:
        """Next text message (handles ping/pong/continuation); None on close."""
        message = io.BytesIO()
        opcode_in_progress = None
        while True:
            try:
                b1, b2 = await self._reader.readexactly(2)
            except (asyncio.IncompleteReadError, ConnectionError):
                self.closed = True
                return None
            fin, opcode = b1 & 0x80, b1 & 0x0F
            masked, length = b2 & 0x80, b2 & 0x7F
            if length == 126:
                (length,) = struct.unpack(">H", await self._reader.readexactly(2))
            elif length == 127:
                (length,) = struct.unpack(">Q", await self._reader.readexactly(8))
            if length > MAX_BODY_BYTES:
                await self.close(1009)
                return None
            mask = await self._reader.readexactly(4) if masked else b"\x00" * 4
            payload = bytearray(await self._reader.readexactly(length))
            if masked:
                for i in range(len(payload)):
                    payload[i] ^= mask[i & 3]
            if opcode == 0x8:  # close
                await self.close()
                return None
            if opcode == 0x9:  # ping → pong
                await self._send_frame(0xA, bytes(payload))
                continue
            if opcode == 0xA:  # pong
                continue
            if opcode in (0x1, 0x2):
                opcode_in_progress = opcode
                message = io.BytesIO()
            elif opcode != 0x0 or opcode_in_progress is None:
                await self.close(1002)
                return None
            message.write(bytes(payload))
            if fin:
                data = message.getvalue()
                _WS_MESSAGES.inc(direction="in")
                if opcode_in_progress == 0x1:
                    return data.decode("utf-8", errors="replace")
                return data.decode("latin-1")  # binary surfaced as text rpc

    async def close(self, code: int = 1000) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            await self._send_frame(0x8, struct.pack(">H", code))
        except (ConnectionError, RuntimeError):
            pass
