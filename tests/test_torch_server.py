"""The port's server shell (spacedrive_tpu_torch/server) on the CPU.

- ``server.http``'s ``read_request``, ``parse_range`` and websocket frames
  against ``spacedrive_tpu.server.http`` on the same bytes (equal results,
  or the same HttpError status and text);
- an in-process ``Server`` on a CPU node: rspc over GET and POST, the
  websocket's query, mutation, subscription and ``subscriptionStop``, a
  ranged thumbnail and a ranged file (206, ``Content-Range``), basic auth
  (401), the 404 of a file another instance owns, a handler's error (500)
  and a stop that ends the subscription pumps;
- one boot of ``python -m spacedrive_tpu_torch.server --device cpu`` in a
  child process: ``LISTENING``, ``/health``, then SIGTERM exits 0.
"""

import asyncio
import json
import os
import signal
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from spacedrive_tpu.server import http as jax_http
from spacedrive_tpu_torch import faults
from spacedrive_tpu_torch.models import FilePath, Location
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects.media.thumbnail import thumbnail_path
from spacedrive_tpu_torch.server import Server
from spacedrive_tpu_torch.server import http
from tests.torch_serve_client import WsClient, get, post, rspc, rspc_get
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


# -- the transport against the reference's, on the same bytes -----------------


def run_both(fn):
    """``fn(module)`` under asyncio for both packages' http modules:
    (reference result, port result); a raise becomes its type, its status
    (an HttpError's) and its text."""
    out = []
    for mod in (jax_http, http):
        try:
            out.append(asyncio.run(fn(mod)))
        except Exception as e:  # noqa: BLE001 — compared by the caller
            out.append((type(e).__name__, getattr(e, "status", None), str(e)))
    return out


def reader_of(data: bytes, eof: bool = True) -> asyncio.StreamReader:
    reader = asyncio.StreamReader(limit=1 << 20)
    reader.feed_data(data)
    if eof:
        reader.feed_eof()
    return reader


REQUESTS = [
    b"GET /rspc/search.paths?arg=%7B%22search%22%3A%22a%20b%22%7D&library_id=x HTTP/1.1\r\n"
    b"Host: h\r\nRange: bytes=0-9\r\n\r\n",
    b"POST /rspc/tags.create HTTP/1.1\r\nContent-Length: 11\r\nX-Odd:  spaced  \r\n\r\n"
    b'{"arg": {}}',
    b"GET /spacedrive/file/a%20b/1/2 HTTP/1.1\r\n\r\n",
    b"BROKEN\r\n\r\n",
    b"GET / HTTP/1.1\r\nContent-Length: nope\r\n\r\n",
    b"GET / HTTP/1.1\r\nContent-Length: -5\r\n\r\n",
    b"GET / HTTP/1.1\r\nHost",
    b"",
]


@pytest.mark.parametrize("raw", REQUESTS, ids=lambda r: r[:24].decode("latin-1"))
def test_read_request_matches_jax(raw):
    async def parse(mod):
        req = await mod.read_request(reader_of(raw))
        return None if req is None else (req.method, req.path, req.query, req.headers, req.body)

    want, got = run_both(parse)
    assert got == want


RANGES = [("", 100), ("bytes=0-9", 100), ("bytes=90-", 100), ("bytes=-10", 100),
          ("bytes=-500", 100), ("bytes=50-2000", 100), ("bytes=100-", 100), ("bytes=5-4", 100),
          ("bytes=-0", 100), ("bytes=a-b", 100), ("items=0-1", 100), ("bytes=0-1,5-6", 100),
          ("bytes=0-0", 1)]


@pytest.mark.parametrize("header,size", RANGES, ids=[f"{h or 'none'}/{n}" for h, n in RANGES])
def test_parse_range_matches_jax(header, size):
    out = []
    for mod in (jax_http, http):
        try:
            out.append(mod.parse_range(header, size))
        except (jax_http.HttpError, http.HttpError) as e:
            out.append(("HttpError", e.status, str(e)))
    assert out[1] == out[0]


def client_frame(payload: bytes, opcode: int = 0x1, fin: bool = True,
                 mask: bytes = b"\x11\x22\x33\x44") -> bytes:
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head.append(0x80 | n)
    elif n < 1 << 16:
        head += bytes([0x80 | 126]) + struct.pack(">H", n)
    else:
        head += bytes([0x80 | 127]) + struct.pack(">Q", n)
    return bytes(head) + mask + bytes(b ^ mask[i & 3] for i, b in enumerate(payload))


class SinkWriter:
    """An asyncio.StreamWriter stand-in that keeps what is written."""

    def __init__(self) -> None:
        self.data = bytearray()

    def write(self, b: bytes) -> None:
        self.data += b

    async def drain(self) -> None:
        pass


FRAMES = {
    "short": client_frame(b'{"id":1}'),
    "medium": client_frame(b"x" * 300),
    "long": client_frame(b"y" * 70_000),
    "ping_then_text": client_frame(b"p", opcode=0x9) + client_frame(b"after ping"),
    "fragmented": client_frame(b"frag", fin=False) + client_frame(b"ment", opcode=0x0),
    "binary": client_frame(bytes(range(200, 256)), opcode=0x2),
    "close": client_frame(struct.pack(">H", 1000), opcode=0x8),
    "orphan_continuation": client_frame(b"x", opcode=0x0),
    "truncated": client_frame(b"cut off here")[:9],
}


@pytest.mark.parametrize("name", FRAMES)
def test_websocket_frames_match_jax(name):
    async def exchange(mod):
        writer = SinkWriter()
        ws = mod.WebSocket(reader_of(FRAMES[name]), writer)
        got = await ws.recv()
        await ws.send_text(f"reply to {name} " + "z" * (70_000 if name == "long" else 10))
        return got, bytes(writer.data), ws.closed

    want, got = run_both(exchange)
    assert got == want
    assert http.WebSocket.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="  # RFC 6455 1.3


# -- an in-process server on a CPU node ---------------------------------------


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A scanned CPU node behind a Server: (node, server, base url, library
    id, tree)."""
    from PIL import Image

    base = tmp_path_factory.mktemp("serve")
    tree = base / "tree"
    tree.mkdir()
    (tree / "doc.txt").write_bytes(blob(1, 5000))
    pixels = np.frombuffer(blob(2, 600 * 800 * 3), np.uint8).reshape(600, 800, 3)
    Image.fromarray(pixels).save(tree / "photo.png")
    # p2p off: the 404 of another instance's file is the offline answer
    # (tests/test_torch_p2p.py serves such files over p2p)
    mp = pytest.MonkeyPatch()
    mp.setenv("SD_P2P_DISABLED", "1")
    node = Node(base / "data", device="cpu", watch_locations=False)
    mp.undo()
    server = Server(node, "127.0.0.1", 0)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        lib = rspc(url, "libraries.create", {"name": "served"})["id"]
        rspc(url, "locations.create", {"path": str(tree)}, lib)
        assert node.jobs.wait_idle(120)
        yield node, server, url, lib, tree
    finally:
        server.stop()
        node.shutdown()


def test_rspc_over_get_and_post(served):
    node, _server, url, lib, _tree = served
    assert get(url, "/health")[2] == b"OK"
    arg = {"search": "o", "take": 5}
    want = json.dumps({"result": node.router.resolve("search.paths", arg, lib)}, default=str)
    assert rspc_get(url, "search.paths", arg, lib).decode() == want
    status, body = post(url, "/rspc/search.paths", {"arg": arg, "library_id": lib})
    assert status == 200 and body.decode() == want
    assert rspc(url, "search.pathsCount", {}, lib) == node.router.resolve(
        "search.pathsCount", {}, lib) == 3
    assert json.loads(rspc_get(url, "buildInfo"))["result"]["version"]
    status, _h, body = get(url, "/rspc/tags.create?arg=%7B%7D")
    assert status == 405 and b"use POST" in body
    status, body = post(url, "/rspc/no.such", {})
    assert status == 400 and b"unknown procedure" in body
    status, body = post(url, "/rspc/search.paths", {"arg": {}})
    assert status == 400 and b"library_id required" in body
    assert get(url, "/rspc/x?arg=%7Bnot-json")[0] == 400
    keys = {p["key"] for p in json.loads(get(url, "/schema")[2])["procedures"]}
    assert {"search.paths", "jobs.progress", "tags.assign"} <= keys
    assert json.loads(get(url, "/info")[2])["server"] == "spacedrive_tpu_torch"
    assert get(url, "/")[0] == 404


def test_a_handler_error_answers_500(served):
    _node, server, url, lib, _tree = served
    faults.install("rspc:eio")
    try:
        status, body = post(url, "/rspc/search.paths", {"arg": {}, "library_id": lib})
        assert status == 500
        ws = WsClient("127.0.0.1", server.port)
        try:
            reply = ws.call("query", "buildInfo")
            assert reply["result"] == {"type": "error",
                                       "data": {"code": 500, "message": "internal error"}}
        finally:
            ws.close()
    finally:
        faults.clear()


def test_websocket_query_mutation_and_subscription(served):
    node, server, _url, lib, _tree = served
    ws = WsClient("127.0.0.1", server.port)
    try:
        envelope = {"library_id": lib, "arg": {"search": "doc"}}
        msg_id, raw = ws.call_raw("query", "search.paths", envelope)
        want = {"jsonrpc": "2.0", "id": msg_id, "result": {
            "type": "response", "data": node.router.resolve("search.paths", {"search": "doc"},
                                                            lib)}}
        assert raw.decode() == json.dumps(want, default=str)
        started = ws.call("subscription", "invalidation.listen")
        sub_id = started["id"]
        assert started["result"] == {"type": "started"}
        made = ws.call("mutation", "tags.create", {"library_id": lib, "arg": {"name": "ws"}})
        assert made["result"]["data"]["name"] == "ws"
        event = ws.recv()
        assert event["id"] == sub_id and event["result"]["type"] == "event"
        assert event["result"]["data"] == {"kind": "invalidate_query", "library_id": lib,
                                           "payload": {"key": "tags.list"}}
        ws.send({"id": 99, "method": "subscriptionStop", "params": {"subscriptionId": sub_id}})
        assert ws.recv() == {"jsonrpc": "2.0", "id": 99, "result": {"type": "stopped"}}
        ws.call("mutation", "tags.create", {"library_id": lib, "arg": {"name": "after"}})
        assert ws.pending == []
        assert ws.call("subscription", "no.such")["result"]["type"] == "error"
        assert ws.call("bogus", "x")["result"]["data"]["code"] == 400
    finally:
        ws.close()


def test_ranged_thumbnail_and_file(served):
    node, _server, url, lib, tree = served
    row = node.libraries.get(lib).db.find_one(FilePath, {"name": "photo"})
    thumb = thumbnail_path(node.data_dir, row["cas_id"])
    data = thumb.read_bytes()
    status, headers, body = get(url, f"/spacedrive/thumbnail/{row['cas_id'][:2]}/"
                                     f"{row['cas_id']}.webp", {"Range": "bytes=10-99"})
    assert status == 206 and body == data[10:100]
    assert headers["content-range"] == f"bytes 10-99/{len(data)}"
    assert headers["content-type"] == "image/webp"
    status, _h, body = get(url, f"/spacedrive/thumbnail/{row['cas_id'][:2]}/"
                                f"{row['cas_id']}.webp")
    assert status == 200 and body == data
    assert get(url, "/spacedrive/thumbnail/ab/" + "ab" * 8 + ".webp")[0] == 404
    assert get(url, f"/spacedrive/thumbnail/{row['cas_id'][:2]}/{row['cas_id']}.webp",
               {"Range": f"bytes={len(data)}-"})[0] == 416
    src = (tree / "photo.png").read_bytes()
    path = f"/spacedrive/file/{lib}/{row['location_id']}/{row['id']}"
    status, headers, body = get(url, path, {"Range": "bytes=-100"})
    assert status == 206 and body == src[-100:]
    assert headers["content-range"] == f"bytes {len(src) - 100}-{len(src) - 1}/{len(src)}"
    assert headers["content-type"] == "image/png"
    assert get(url, path)[2] == src
    assert get(url, f"/spacedrive/file/{lib}/{row['location_id'] + 1}/{row['id']}")[0] == 404
    assert get(url, f"/spacedrive/file/{lib}/x/1")[0] == 400
    assert get(url, "/spacedrive/file/nolib/1/1")[0] == 404


def test_a_file_another_instance_owns_is_a_404(served):
    node, _server, url, lib, _tree = served
    library = node.libraries.get(lib)
    db = library.db
    # a paired peer's instance (location.instance_id is a foreign key)
    peer = library.add_remote_instance({"pub_id": "remote-instance", "identity": "R:peer",
                                        "node_id": "peer-node", "node_name": "peer",
                                        "node_platform": 3})
    loc = db.insert(Location, {"pub_id": "remote-loc", "name": "r", "path": "/elsewhere",
                               "instance_id": peer})
    fp = db.insert(FilePath, {"pub_id": "remote-fp", "location_id": loc, "name": "x",
                              "extension": "bin", "materialized_path": "/", "is_dir": 0})
    status, _h, body = get(url, f"/spacedrive/file/{lib}/{loc}/{fp}")
    assert status == 404 and b"p2p is offline" in body


def test_basic_auth(served):
    node = served[0]
    server = Server(node, "127.0.0.1", 0, auth="user:pass")
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        assert get(url, "/health")[0] == 200
        status, headers, _body = get(url, "/rspc/buildInfo")
        assert status == 401 and headers["www-authenticate"].startswith("Basic")
        good = {"Authorization": "Basic dXNlcjpwYXNz"}
        assert get(url, "/rspc/buildInfo", {"Authorization": "Basic d3Jvbmc6eA=="})[0] == 401
        assert get(url, "/rspc/buildInfo", good)[0] == 200
        assert WsClient("127.0.0.1", server.port).status == 401
        ws = WsClient("127.0.0.1", server.port, headers=good)
        assert ws.status == 101 and ws.call("query", "buildInfo")["result"]["type"] == "response"
        ws.close()
    finally:
        server.stop()


def test_stop_ends_the_subscription_pumps(served):
    node = served[0]
    server = Server(node, "127.0.0.1", 0)
    server.start()
    ws = WsClient("127.0.0.1", server.port)
    assert ws.call("subscription", "notifications.listen")["result"]["type"] == "started"
    pumps = [thread for _sub, thread in server._pumps]  # registered before the ack
    assert len(pumps) == 1
    server.stop()
    assert not any(t.is_alive() for t in pumps)
    assert not server._thread.is_alive()
    ws.close()


# -- the entry point ----------------------------------------------------------


def test_the_entry_point_boots_and_stops_on_sigterm(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "SD_LOG": "WARNING"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacedrive_tpu_torch.server", "--device", "cpu",
         "--data-dir", str(tmp_path / "data"), "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=tmp_path)
    try:
        line = proc.stdout.readline()
        assert line.startswith("LISTENING 127.0.0.1:"), (line, proc.stderr.read())
        url = "http://" + line.split()[1]
        assert get(url, "/health")[2] == b"OK"
        assert rspc(url, "nodeState")["data_path"] == str(tmp_path / "data")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
