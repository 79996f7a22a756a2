"""A stdlib client of the server shell's HTTP and websocket routes.

Shared by the port's server tests and ``chip_smoke.py``; it imports neither
jax nor a package of this repository. ``WsClient`` speaks RFC 6455 with
masked text frames, which is what the shell's JSON-RPC needs.
"""

from __future__ import annotations

import base64
import hashlib
import json
import secrets
import socket
import struct
import urllib.error
import urllib.parse
import urllib.request

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def get(base: str, path: str, headers: dict | None = None,
        timeout: float = 60) -> tuple[int, dict, bytes]:
    """(status, lower-cased headers, body) of a GET; an HTTP error status is
    returned, not raised."""
    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, {k.lower(): v for k, v in resp.headers.items()}, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, {k.lower(): v for k, v in e.headers.items()}, e.read()


def post(base: str, path: str, payload, timeout: float = 120) -> tuple[int, bytes]:
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"content-type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def rspc_get(base: str, key: str, arg=None, library_id: str | None = None) -> bytes:
    """The raw body of ``GET /rspc/<key>``; raises unless it answers 200."""
    query = {"arg": json.dumps(arg)} if arg is not None else {}
    if library_id is not None:
        query["library_id"] = library_id
    status, _headers, body = get(base, f"/rspc/{key}?{urllib.parse.urlencode(query)}")
    if status != 200:
        raise RuntimeError(f"GET {key}: {status} {body[:300]!r}")
    return body


def rspc_post(base: str, key: str, arg=None, library_id: str | None = None) -> bytes:
    """The raw body of ``POST /rspc/<key>``; raises unless it answers 200."""
    status, body = post(base, f"/rspc/{key}", {"arg": arg, "library_id": library_id})
    if status != 200:
        raise RuntimeError(f"POST {key}: {status} {body[:300]!r}")
    return body


def rspc(base: str, key: str, arg=None, library_id: str | None = None):
    """The decoded ``result`` of ``POST /rspc/<key>``."""
    return json.loads(rspc_post(base, key, arg, library_id))["result"]


class WsClient:
    """A websocket to ``/rspc/ws``: :meth:`call` sends one JSON-RPC message
    and returns the next message with its id; :meth:`recv` returns the next
    message of any id."""

    def __init__(self, host: str, port: int, path: str = "/rspc/ws",
                 headers: dict | None = None) -> None:
        self.sock = socket.create_connection((host, port), timeout=60)
        key = base64.b64encode(secrets.token_bytes(16)).decode()
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
                           "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n"
                           f"{extra}\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("the server closed the socket during the upgrade")
            head += chunk
        head, self._buf = head.split(b"\r\n\r\n", 1)
        self.status = int(head.split(b" ", 2)[1])
        if self.status != 101:
            return
        expect = base64.b64encode(hashlib.sha1((key + _WS_GUID).encode()).digest())
        if expect not in head:
            raise ConnectionError(f"bad Sec-WebSocket-Accept in {head!r}")
        self._next_id = 0
        self.pending: list[dict] = []

    def send(self, obj) -> None:
        payload = json.dumps(obj).encode()
        mask = secrets.token_bytes(4)
        head = bytearray([0x81])
        n = len(payload)
        if n < 126:
            head.append(0x80 | n)
        elif n < 1 << 16:
            head.append(0x80 | 126)
            head += struct.pack(">H", n)
        else:
            head.append(0x80 | 127)
            head += struct.pack(">Q", n)
        head += mask
        reps = -(-n // 4)
        masked = (int.from_bytes(payload.ljust(reps * 4, b"\0"), "little")
                  ^ int.from_bytes(mask * reps, "little")).to_bytes(reps * 4, "little")[:n]
        self.sock.sendall(bytes(head) + masked)

    def _frame(self) -> tuple[int, bytes] | None:
        """Take one whole frame off the buffer: (opcode, payload), or None
        (nothing taken) while it is incomplete."""
        buf = self._buf
        if len(buf) < 2:
            return None
        opcode, length, at = buf[0] & 0x0F, buf[1] & 0x7F, 2
        if length == 126:
            if len(buf) < 4:
                return None
            (length,), at = struct.unpack(">H", buf[2:4]), 4
        elif length == 127:
            if len(buf) < 10:
                return None
            (length,), at = struct.unpack(">Q", buf[2:10]), 10
        if len(buf) < at + length:
            return None
        self._buf = buf[at + length:]
        return opcode, buf[at:at + length]

    def recv_raw(self, timeout: float = 60.0) -> bytes | None:
        """The payload of the next text frame (None on a close frame).
        Raises TimeoutError when none arrives in ``timeout`` s; a frame in
        part received stays buffered."""
        self.sock.settimeout(timeout)
        while True:
            frame = self._frame()
            if frame is None:
                chunk = self.sock.recv(1 << 16)
                if not chunk:
                    raise ConnectionError("the websocket closed")
                self._buf += chunk
                continue
            opcode, payload = frame
            if opcode == 0x8:
                return None
            if opcode not in (0x9, 0xA):
                return payload

    def recv(self, timeout: float = 60.0) -> dict | None:
        if self.pending:
            return self.pending.pop(0)
        raw = self.recv_raw(timeout)
        return None if raw is None else json.loads(raw)

    def call_raw(self, method: str, path: str, input_=None,
                 timeout: float = 120.0) -> tuple[int, bytes]:
        """Send one message; (its id, the raw reply with that id). Messages
        of other ids (subscription events) are kept for :meth:`recv`."""
        self._next_id += 1
        msg_id = self._next_id
        self.send({"id": msg_id, "method": method, "params": {"path": path, "input": input_}})
        while True:
            raw = self.recv_raw(timeout)
            if raw is None:
                raise ConnectionError("the websocket closed")
            msg = json.loads(raw)
            if msg.get("id") == msg_id:
                return msg_id, raw
            self.pending.append(msg)

    def call(self, method: str, path: str, input_=None, timeout: float = 120.0) -> dict:
        return json.loads(self.call_raw(method, path, input_, timeout)[1])

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
