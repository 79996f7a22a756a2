"""Headless server shell: HTTP + websocket transport over the node's router.

Counterpart of ``spacedrive_tpu/server/shell.py`` (the reference's
apps/server: axum's ``/health``, the ``/spacedrive`` custom_uri and the
``/rspc`` websocket). Procedures resolve on a worker-thread pool, so a slow
query never stalls the accept loop, which runs on its own thread; each
websocket subscription is pumped into its socket by a thread of its own.

Routes:
    GET  /health                                   → "OK" (never behind auth)
    GET  /info                                     → server/node JSON
    GET  /rspc/<key>?arg=<json>[&library_id=]      → query
    POST /rspc/<key>   {"arg":..,"library_id":..}  → query or mutation
    GET  /rspc/ws (Upgrade: websocket)             → JSON-RPC incl. subscriptions
    GET  /spacedrive/thumbnail/<shard>/<cas>.webp  → thumbnail cache, ranged
    GET  /spacedrive/file/<library>/<loc>/<fp_id>  → file bytes, ranged
    GET  /schema                                   → router schema export

websocket JSON-RPC (the rspc wire shape):
    → {"id":1,"method":"query"|"mutation","params":{"path":k,"input":..}}
    ← {"jsonrpc":"2.0","id":1,"result":{"type":"response","data":..}}
    → {"id":2,"method":"subscription","params":{"path":k,"input":..}}
    ← {"jsonrpc":"2.0","id":2,"result":{"type":"event","data":..}} (each event)
    → {"id":3,"method":"subscriptionStop","params":{"subscriptionId":2}}
Library-scoped procedures take input = {"library_id":.., "arg":..}.

An error a handler raises (a kernel's included) answers 500, an
:class:`~..api.router.ApiError` 400, and a :class:`~..api.router.BusyError`
(admission shed the dispatch) 429 with a ``Retry-After`` header (seconds,
rounded up) and ``retry_after_ms`` in the JSON error; over the websocket its
error code is 429 (the reference answers it 400, ROADMAP Queue 3).
:meth:`Server.start` binds, then brings up the reader pool
(:class:`~.pool.ReaderPool`, ``SD_SERVE_WORKERS``, reference :124-138,
which starts it before the bind) on a thread of its own unless the node
already has one, and :meth:`Server.stop` stops the pool it started. A page a worker or a replica encoded (:class:`~..api.router.RawJson`)
is spliced into the ``{"result": ...}`` envelope byte for byte. Without ``auth`` the shell refuses the
key procedures that hand out or move secrets
(``api.routers.keys.SECRET_PROCEDURES``) on every transport, with a 400. A file in a location another
instance owns is fetched from that instance's node over p2p
(``_serve_remote``, reference :527-560: the ``H_FILE`` header, the range
forwarded, at most ``MAX_REMOTE_SPOOL`` bytes a request), and a thumbnail
missing here from the node that owns the content (reference :394-471,
cached locally, a miss remembered for 30 s); with p2p off, or the owning
node not connected, both answer 404.

Telemetry (reference :70-91, :271-279, :573-661, :774-790): ``GET
/metrics`` is the Prometheus text of the registry (behind auth, like every
route but ``/health``); ``GET /telemetry/stream`` is the flight recorder as
server-sent events, each with ``id:`` its ring ``seq``, the ring replayed
first from ``?after=<seq>`` or ``Last-Event-ID``, then one pump thread a
tail forwards the node's ``telemetry.event`` bus events, with a ``:
keepalive`` comment when idle; a client that disconnects ends its tail,
and :meth:`Server.stop` closes and joins every tail. Each request counts in
``sd_http_requests_total{route,status}``, ``sd_http_request_seconds{route}``
and ``sd_http_response_bytes_total{route}`` (the route its first path
segment from a closed set; a file or range response counts its window),
and each rspc call's payload sizes in ``sd_rspc_payload_bytes_total``. Not
ported: ``/`` (the web explorer) and ``/client/*``.
"""

from __future__ import annotations

import asyncio
import base64
import io
import json
import logging
import math
import secrets
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import TYPE_CHECKING, Any

from .. import telemetry
from ..api.router import ApiError, BusyError, RawJson
from ..telemetry.registry import REQUEST_BUCKETS
from ..telemetry.requests import record_payload
from .http import HttpError, Request, Response, WebSocket, parse_range, read_request, write_response

if TYPE_CHECKING:
    from ..node import Node

logger = logging.getLogger(__name__)

#: the most bytes one remote file request spools before it answers
MAX_REMOTE_SPOOL = 64 * 1024 * 1024
#: how long a remote thumbnail miss is remembered
THUMB_MISS_S = 30.0

#: the route label's closed set (a path's first segment), never the raw path
_HTTP_ROUTES = {"health", "metrics", "info", "rspc", "schema", "client", "spacedrive"}
_HTTP_REQUESTS = telemetry.counter(
    "sd_http_requests_total",
    "HTTP requests served by the shell, by route class and status",
    labels=("route", "status"))
_HTTP_SECONDS = telemetry.histogram(
    "sd_http_request_seconds", "HTTP request latency per route class",
    labels=("route",), buckets=REQUEST_BUCKETS)
_HTTP_BYTES = telemetry.counter(
    "sd_http_response_bytes_total",
    "response payload bytes per route class (file/range streams count "
    "the streamed window)", labels=("route",))


def _route_class(path: str) -> str:
    head = path.split("/", 2)[1] if path.startswith("/") else path
    if path == "/telemetry/stream":
        return "stream"
    if not head:
        return "root"
    return head if head in _HTTP_ROUTES else "other"


class Server:
    def __init__(self, node: "Node", host: str = "127.0.0.1", port: int = 8080,
                 auth: str | None = None) -> None:
        """``auth``: optional "user:password" enabling basic auth on every
        route but /health."""
        self.node = node
        self.host = host
        self.port = port
        self.auth = auth
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._thread: threading.Thread | None = None
        self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="rspc")
        self._ready = threading.Event()
        #: live websocket subscriptions: (subscription, pump thread);
        #: stop() closes and joins them
        self._pumps: set[tuple[Any, threading.Thread]] = set()
        self._pumps_lock = threading.Lock()
        #: open /telemetry/stream tails: (stop event, pump thread, bus
        #: subscription); stop() closes and joins them
        self._sse_tails: set[tuple[threading.Event, threading.Thread, Any]] = set()
        self._sse_lock = threading.Lock()
        #: cas_id -> when a remote thumbnail miss may be asked again
        self._thumb_miss: dict[str, float] = {}
        #: True when start() brought the node's reader pool up
        self._owns_pool = False
        #: the thread that starts the pool after the bind, and what stopped it
        self._pool_thread: threading.Thread | None = None
        self._pool_lock = threading.Lock()
        self._stopping = False
        self.pool_error: BaseException | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Run the accept loop on its own thread and return once bound; then
        bring up the reader pool on a thread of its own unless the node has
        one (or ``SD_SERVE_WORKERS=0``). The reference starts the pool
        before it binds; here the pool's forkserver (a fresh interpreter
        that imports torch) takes seconds, which the bind need not wait
        for. Until the pool is attached the ladder serves in process;
        :meth:`wait_pool` waits for it and raises what kept it from
        starting."""
        self._thread = threading.Thread(target=self._run, name="sd-server", daemon=True)
        self._thread.start()
        if not self._ready.wait(10):
            raise RuntimeError("server failed to bind")
        from .pool import configured_workers

        if getattr(self.node, "reader_pool", None) is None and configured_workers() > 0:
            self._pool_thread = threading.Thread(target=self._start_pool,
                                                 name="sd-serve-pool-start", daemon=True)
            self._pool_thread.start()

    def _start_pool(self) -> None:
        from .pool import ReaderPool

        try:
            pool = ReaderPool.maybe_start(self.node)
        except BaseException as exc:  # noqa: BLE001 — kept for wait_pool, logged as an error
            self.pool_error = exc
            logger.exception("the reader pool did not start; queries are served in process")
            return
        with self._pool_lock:
            if pool is not None and not self._stopping:
                self.node.reader_pool = pool
                self._owns_pool = True
                return
        if pool is not None:
            pool.stop()  # the server stopped while the pool started

    def wait_pool(self, timeout: float = 120.0):
        """The node's reader pool once the start that :meth:`start` began
        has ended (None with ``SD_SERVE_WORKERS=0``); raises the error
        that kept the pool from starting, or ``TimeoutError``."""
        if self._pool_thread is not None:
            self._pool_thread.join(timeout)
            if self._pool_thread.is_alive():
                raise TimeoutError(f"the reader pool did not start in {timeout:.0f} s")
        if self.pool_error is not None:
            raise self.pool_error
        return getattr(self.node, "reader_pool", None)

    def _run(self) -> None:
        asyncio.run(self._serve())

    async def _serve(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(self._client, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self._ready.set()
        logger.info("server listening on %s:%s", self.host, self.port)
        async with self._server:
            try:
                await self._server.serve_forever()
            except asyncio.CancelledError:
                pass

    def stop(self) -> None:
        """Close every subscription (its pump ends), stop the loop, join the
        loop's and the pumps' threads, and shut the worker pool."""
        with self._pumps_lock:
            pumps = list(self._pumps)
        for sub, _thread in pumps:
            sub.close()
        with self._sse_lock:
            tails = list(self._sse_tails)
        for stop_event, _thread, sub in tails:
            stop_event.set()
            sub.close()
        loop, server = self._loop, self._server
        if loop is not None and server is not None:
            try:
                loop.call_soon_threadsafe(server.close)
                loop.call_soon_threadsafe(
                    lambda: [t.cancel() for t in asyncio.all_tasks(loop)])
            except RuntimeError:
                pass  # the loop is already closed
        if self._thread is not None:
            self._thread.join(timeout=5)
        for _sub, thread in pumps:
            if thread.is_alive():
                thread.join(timeout=5)
        for _stop_event, thread, _sub in tails:
            if thread.is_alive():
                thread.join(timeout=5)
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._pool_lock:
            self._stopping = True
        if self._pool_thread is not None:
            self._pool_thread.join(timeout=120)
        if self._owns_pool and self.node.reader_pool is not None:
            self.node.reader_pool.stop()
            self.node.reader_pool = None
            self._owns_pool = False

    # -- connection handling -------------------------------------------------
    async def _client(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                try:
                    req = await read_request(reader)
                except HttpError as e:
                    await write_response(writer, Request("GET", "/", {}, {}, b""),
                                         Response.error(e.status, str(e)))
                    break
                if req is None:
                    break
                if req.header("upgrade", "").lower() == "websocket":
                    try:
                        await self._websocket(req, reader, writer)
                    except HttpError as e:
                        await write_response(writer, req, Response.error(e.status, str(e)))
                    break
                if req.method == "GET" and req.path == "/telemetry/stream":
                    # the connection becomes an event stream, as the
                    # websocket branch above becomes a socket
                    try:
                        await self._sse_stream(req, reader, writer)
                    except HttpError as e:
                        await write_response(writer, req, Response.error(e.status, str(e)))
                    break
                t0 = time.perf_counter()
                try:
                    resp = await self._route(req)
                except HttpError as e:
                    resp = Response.error(e.status, str(e))
                    if e.status == 401:
                        resp.headers["www-authenticate"] = 'Basic realm="spacedrive"'
                except BusyError as e:
                    resp = _busy_response(e)
                except ApiError as e:
                    resp = Response.error(400, str(e))
                except Exception:
                    logger.exception("request failed: %s %s", req.method, req.path)
                    resp = Response.error(500)
                _observe_http(req, resp, time.perf_counter() - t0)
                await write_response(writer, req, resp)
                if req.header("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    def _check_auth(self, req: Request) -> None:
        if self.auth is None:
            return
        expect = "Basic " + base64.b64encode(self.auth.encode()).decode()
        if not secrets.compare_digest(req.header("authorization").encode("utf-8", "replace"),
                                      expect.encode()):
            raise HttpError(401, "authentication required")

    async def _route(self, req: Request) -> Response:
        parts = [p for p in req.path.split("/") if p]
        if req.path == "/health":
            return Response.text("OK")
        self._check_auth(req)
        if req.path == "/metrics":
            # in-memory state only: no database, safe on the accept loop
            return Response(
                headers={"content-type": "text/plain; version=0.0.4; charset=utf-8"},
                body=telemetry.render_prometheus().encode())
        if not parts:
            raise HttpError(404)
        if parts[0] == "info":
            return Response.json({"server": "spacedrive_tpu_torch",
                                  "node": self.node.config.get().get("name")})
        if parts[0] == "rspc":
            return await self._rspc_http(req, "/".join(parts[1:]))
        if parts[0] == "schema":
            return Response.json(self.node.router.schema())
        if parts[0] == "spacedrive":
            return await self._custom_uri(req, parts[1:])
        raise HttpError(404)

    # -- rspc over plain HTTP ------------------------------------------------
    async def _rspc_http(self, req: Request, key: str) -> Response:
        if not key:
            raise HttpError(404)
        try:
            if req.method == "GET":
                # GET is side-effect-free: queries only (mutations need POST)
                proc = self.node.router.procedures.get(key)
                if proc is not None and proc.kind != "query":
                    raise HttpError(405, f"{key} is a {proc.kind}; use POST")
                arg = json.loads(req.query["arg"]) if "arg" in req.query else None
                library_id = req.query.get("library_id")
            elif req.method == "POST":
                payload = json.loads(req.body.decode() or "{}")
                arg = payload.get("arg")
                library_id = payload.get("library_id")
            else:
                raise HttpError(405)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise HttpError(400, f"malformed request payload: {e}")
        try:
            result = await self._resolve(key, arg, library_id, raw=True)
        except (BusyError, ApiError) as e:
            resp = (_busy_response(e) if isinstance(e, BusyError)
                    else Response.json({"error": str(e)}, 400))
            if key in self.node.router.procedures:
                # mounted keys only: a client's made-up key must not mint
                # label values
                record_payload(key, len(req.body), len(resp.body))
            return resp
        if isinstance(result, RawJson):
            # a worker's or a replica's bytes, encoded by Response.json's own
            # call: the prefix matches json.dumps' ': ' separator, so the
            # body equals the in-process encoding byte for byte
            resp = Response(200, {"content-type": "application/json"},
                            b'{"result": ' + result.data + b"}")
        else:
            resp = Response.json({"result": result})
        # the wire sizes: only the transport sees the serialized bytes
        record_payload(key, len(req.body), len(resp.body))
        return resp

    async def _resolve(self, key: str, arg: Any, library_id: str | None,
                       raw: bool = False) -> Any:
        """Resolve on the worker pool; every transport (GET, POST, the
        websocket) comes through here, so without auth the secret key
        procedures are refused for all of them."""
        if self.auth is None:
            from ..api.routers.keys import SECRET_PROCEDURES

            if key in SECRET_PROCEDURES:
                raise ApiError(
                    f"{key} returns secret material and is disabled while "
                    "the server runs without auth — start the shell with "
                    "credentials (--auth / SD_AUTH) to enable it")
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._pool, lambda: self.node.router.resolve(key, arg, library_id, raw=raw))

    # -- custom_uri ------------------------------------------------------------
    async def _custom_uri(self, req: Request, parts: list[str]) -> Response:
        if req.method not in ("GET", "HEAD"):
            raise HttpError(405)
        if len(parts) == 3 and parts[0] == "thumbnail":
            from ..objects.media.thumbnail import thumbnail_dir

            shard, name = parts[1], parts[2]
            if "/" in name or ".." in name or ".." in shard:
                raise HttpError(400)
            path = Path(thumbnail_dir(self.node.data_dir)) / shard / name
            if not path.is_file() and name.endswith(".webp"):
                cas_id = name[:-len(".webp")]
                if shard != cas_id[:2]:
                    raise HttpError(404, "no such thumbnail")
                # a preview a paired node owns: fetched once into the cache
                await self._fetch_remote_thumbnail(cas_id, path)
            if not path.is_file():
                raise HttpError(404, "no such thumbnail")
            rng = parse_range(req.header("range"), path.stat().st_size)
            return Response(headers={"content-type": "image/webp"},
                            file_path=path, file_range=rng)
        if len(parts) == 4 and parts[0] == "file":
            return await self._serve_file(req, parts[1], parts[2], parts[3])
        raise HttpError(404)

    async def _fetch_remote_thumbnail(self, cas_id: str, dest: Path) -> None:
        """Pull a preview from a connected node that owns content with this
        cas_id (best effort: a miss stays a 404)."""
        from ..models import FilePath, Instance, Location

        p2p = self.node.p2p
        if p2p is None:
            return
        now = time.monotonic()
        if self._thumb_miss.get(cas_id, 0.0) > now:
            return
        loop = asyncio.get_running_loop()

        def _owners() -> list:
            out = []
            for library in self.node.libraries.list():
                row = library.db.find_one(FilePath, {"cas_id": cas_id})
                if row is None:
                    continue
                location = library.db.find_one(Location, {"id": row["location_id"]})
                if location is None or location.get("instance_id") in (None, library.instance_id):
                    continue  # local content: nothing to fetch
                instance = library.db.find_one(Instance, {"id": location["instance_id"]})
                peer_id = instance and instance.get("node_remote_identity")
                if peer_id and peer_id in p2p.peers:
                    out.append((library, peer_id))
            return out

        for library, peer_id in await loop.run_in_executor(self._pool, _owners):
            future = asyncio.run_coroutine_threadsafe(
                p2p.request_thumbnail(peer_id, library.id, cas_id), p2p._loop)
            try:
                body = await asyncio.wait_for(asyncio.wrap_future(future), 15)
            except Exception as e:  # noqa: BLE001 — try the next owner
                logger.debug("remote thumbnail %s: %s", cas_id[:8], e)
                continue

            def _persist() -> None:
                from ..atomic import atomic_write_bytes

                dest.parent.mkdir(parents=True, exist_ok=True)
                atomic_write_bytes(dest, body)

            await loop.run_in_executor(self._pool, _persist)
            self._thumb_miss.pop(cas_id, None)
            return
        self._thumb_miss[cas_id] = time.monotonic() + THUMB_MISS_S

    async def _serve_remote(self, req: Request, library, location, row) -> Response:
        """A file of a location another instance owns: its ranged bytes over
        the p2p ``H_FILE`` header from the owning node."""
        from ..models import Instance
        from ..p2p.proto import Range

        p2p = self.node.p2p
        if p2p is None:
            raise HttpError(404, "remote file and p2p is offline")
        instance = library.db.find_one(Instance, {"id": location["instance_id"]})
        if instance is None:
            raise HttpError(404, "unknown owning instance")
        peer_id = instance.get("node_remote_identity")
        if not peer_id:
            raise HttpError(404, "instance has no p2p identity")
        if peer_id not in p2p.peers:
            raise HttpError(404, "owning node is not connected")
        size = int(row.get("size_in_bytes") or 0)
        rng = parse_range(req.header("range"), size) if size else None
        start, end = rng if rng else (0, size)
        if end - start > MAX_REMOTE_SPOOL:
            raise HttpError(416, f"remote serve is capped at {MAX_REMOTE_SPOOL} bytes "
                                 f"per request; use Range")
        sink = io.BytesIO()
        future = asyncio.run_coroutine_threadsafe(
            p2p.request_file(peer_id, library.id, row["pub_id"],
                             Range(start, end if rng else None), sink), p2p._loop)
        try:
            await asyncio.wait_for(asyncio.wrap_future(future), 60)
        except Exception as e:  # noqa: BLE001 — the owner refused or went away
            raise HttpError(404, f"remote fetch failed: {e}")
        headers = {"content-type": _MIME.get((row.get("extension") or "").lower(),
                                             "application/octet-stream"),
                   "accept-ranges": "bytes"}
        status = 200
        if rng:
            headers["content-range"] = f"bytes {start}-{end - 1}/{size}"
            status = 206
        return Response(status, headers, sink.getvalue())

    async def _serve_file(self, req: Request, library_id: str,
                          location_id: str, file_path_id: str) -> Response:
        from ..models import FilePath, Location

        try:
            library = self.node.libraries.get(library_id)
        except KeyError:
            raise HttpError(404, "no such library")
        try:
            fp_id, loc_id = int(file_path_id), int(location_id)
        except ValueError:
            raise HttpError(400, "file/location ids must be integers")
        db = library.db
        row = db.find_one(FilePath, {"id": fp_id})
        if row is None or row["location_id"] != loc_id:
            raise HttpError(404, "no such file_path")
        location = db.find_one(Location, {"id": row["location_id"]})
        if location is None:
            raise HttpError(404, "no such location")
        if location.get("instance_id") not in (None, library.instance_id):
            # another instance's location: its bytes come over p2p
            return await self._serve_remote(req, library, location, row)
        name = row["name"] + (f".{row['extension']}" if row["extension"] else "")
        path = Path(location["path"]) / (row["materialized_path"] or "/").lstrip("/") / name
        try:
            size = path.stat().st_size
        except OSError as e:
            raise HttpError(404, f"file missing on disk: {e}")
        rng = parse_range(req.header("range"), size)
        ext = (row.get("extension") or "").lower()
        return Response(headers={"content-type": _MIME.get(ext, "application/octet-stream")},
                        file_path=path, file_range=rng)

    # -- the flight recorder over SSE -------------------------------------------
    async def _sse_stream(self, req: Request, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        """``GET /telemetry/stream``: one SSE message a telemetry event.
        The tail subscribes to the bus before it replays the ring, so no
        event falls between the two (one may come twice; ``seq`` tells)."""
        self._check_auth(req)
        try:
            after = int(req.query.get("after") or req.header("last-event-id") or -1)
        except ValueError:
            after = -1
        sub = self.node.events.subscribe()
        loop = asyncio.get_running_loop()
        stop = threading.Event()

        async def send(frame: bytes) -> None:
            writer.write(frame)
            await writer.drain()

        def pump() -> None:
            """Its own thread: a tail parked on the bus must not hold a
            worker of the rspc pool."""
            while not stop.is_set():
                event = sub.get(timeout=15.0)
                if sub.closed or stop.is_set():
                    return
                if event is None:
                    frame = b": keepalive\n\n"
                elif event.kind != "telemetry.event":
                    continue
                else:
                    frame = _sse_frame(event.payload or {})
                try:
                    asyncio.run_coroutine_threadsafe(send(frame), loop).result(10)
                except Exception:
                    return  # the client went away: the normal end of a tail

        thread = threading.Thread(target=pump, daemon=True, name="sse-telemetry")
        tail = (stop, thread, sub)
        try:
            writer.write(b"HTTP/1.1 200 OK\r\ncontent-type: text/event-stream\r\n"
                         b"cache-control: no-cache\r\nconnection: close\r\n\r\n")
            # counted at accept: the stream never reaches the per-request
            # accounting of the route loop
            _HTTP_REQUESTS.inc(route="stream", status="200")
            for record in telemetry.recent_events(limit=256,
                                                  after_seq=after if after >= 0 else None):
                writer.write(_sse_frame(record))
            await writer.drain()
            with self._sse_lock:
                self._sse_tails.add(tail)
            thread.start()
            # an SSE client sends nothing: any read that ends is the hang-up
            while await reader.read(1024):
                pass
        except (ConnectionError, OSError, asyncio.CancelledError):
            pass
        finally:
            stop.set()
            sub.close()  # wakes the pump at once
            with self._sse_lock:
                self._sse_tails.discard(tail)
            # no join on the loop (the pump may wait on a send scheduled
            # here); stop() joins

    def sse_tails(self) -> int:
        """Open ``/telemetry/stream`` tails."""
        with self._sse_lock:
            return len(self._sse_tails)

    # -- rspc over websocket -------------------------------------------------
    async def _websocket(self, req: Request, reader: asyncio.StreamReader,
                         writer: asyncio.StreamWriter) -> None:
        self._check_auth(req)
        key = req.header("sec-websocket-key")
        if not key:
            raise HttpError(400, "missing websocket key")
        writer.write(("HTTP/1.1 101 Switching Protocols\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Accept: {WebSocket.accept_key(key)}\r\n\r\n").encode())
        await writer.drain()
        ws = WebSocket(reader, writer)
        subs: dict[Any, tuple[Any, threading.Thread]] = {}
        loop = asyncio.get_running_loop()
        send_lock = asyncio.Lock()

        async def send(obj: dict) -> None:
            async with send_lock:
                await ws.send_text(json.dumps(obj, default=str))

        def pump(sub_id: Any, subscription) -> None:
            """Worker thread: drain a subscription into the socket until it
            is closed or the socket fails."""
            for event in subscription:
                if subscription.filter is not None and not subscription.filter(event):
                    continue
                payload = {"jsonrpc": "2.0", "id": sub_id,
                           "result": {"type": "event",
                                      "data": {"kind": event.kind, "payload": event.payload,
                                               "library_id": event.library_id}}}
                try:
                    asyncio.run_coroutine_threadsafe(send(payload), loop).result(10)
                except Exception:
                    break

        try:
            while True:
                raw = await ws.recv()
                if raw is None:
                    break
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    await send({"jsonrpc": "2.0", "id": None,
                                "result": {"type": "error",
                                           "data": {"code": 400, "message": "bad json"}}})
                    continue
                await self._ws_message(msg, send, subs, pump)
        finally:
            # no join here: this runs on the loop, which a pump may be
            # waiting on; a closed subscription ends its pump, and stop()
            # joins what is left
            for subscription, _thread in subs.values():
                subscription.close()

    async def _ws_message(self, msg: dict, send, subs: dict, pump) -> None:
        msg_id = msg.get("id")
        method = msg.get("method")
        params = msg.get("params") or {}
        path = params.get("path", "")
        library_id, arg = _split_library_args(params.get("input"))

        async def reply_error(code: int, message: str, **extra) -> None:
            await send({"jsonrpc": "2.0", "id": msg_id,
                        "result": {"type": "error",
                                   "data": {"code": code, "message": message, **extra}}})

        if method in ("query", "mutation"):
            try:
                data = await self._resolve(path, arg, library_id)
            except BusyError as e:
                await reply_error(429, str(e), retry_after_ms=e.retry_after_ms)
                return
            except ApiError as e:
                await reply_error(400, str(e))
                return
            except Exception:
                logger.exception("ws %s %s failed", method, path)
                await reply_error(500, "internal error")
                return
            await send({"jsonrpc": "2.0", "id": msg_id,
                        "result": {"type": "response", "data": data}})
        elif method == "subscription":
            try:
                subscription = self.node.router.subscribe(path, arg, library_id)
            except ApiError as e:
                await reply_error(400, str(e))
                return
            stale = subs.pop(msg_id, None)
            if stale is not None:
                stale[0].close()  # a reused id: stop the old stream first
            thread = threading.Thread(target=pump, args=(msg_id, subscription),
                                      name=f"ws-sub-{path}", daemon=True)
            subs[msg_id] = (subscription, thread)
            with self._pumps_lock:
                self._pumps = {p for p in self._pumps if p[1].is_alive()}
                self._pumps.add((subscription, thread))
            # the ack goes out before the pump starts, so "started" precedes
            # every event
            await send({"jsonrpc": "2.0", "id": msg_id, "result": {"type": "started"}})
            thread.start()
        elif method == "subscriptionStop":
            pair = subs.pop(params.get("subscriptionId", msg_id), None)
            if pair is not None:
                pair[0].close()
            await send({"jsonrpc": "2.0", "id": msg_id, "result": {"type": "stopped"}})
        else:
            await reply_error(400, f"unknown method {method!r}")


def _sse_frame(record: dict) -> bytes:
    data = json.dumps(record, default=str)
    seq = record.get("seq")
    head = f"id: {seq}\n" if seq is not None else ""
    return f"{head}data: {data}\n\n".encode()


def _observe_http(req: Request, resp: Response, duration_s: float) -> None:
    """Per-route accounting; a file or range response counts its window."""
    if not telemetry.enabled():
        return
    route = _route_class(req.path)
    _HTTP_REQUESTS.inc(route=route, status=str(resp.status))
    _HTTP_SECONDS.observe(duration_s, route=route)
    if resp.file_path is not None:
        try:
            size = resp.file_path.stat().st_size
        except OSError:
            size = 0
        start, end = resp.file_range or (0, size)
        _HTTP_BYTES.inc(max(0, end - start), route=route)
    elif resp.body:
        _HTTP_BYTES.inc(len(resp.body), route=route)


def _busy_response(e: BusyError) -> Response:
    """429 with ``Retry-After`` in whole seconds, rounded up, and the
    milliseconds in the JSON error."""
    resp = Response.json({"error": str(e), "retry_after_ms": e.retry_after_ms}, 429)
    resp.headers["retry-after"] = str(max(1, math.ceil(e.retry_after_ms / 1000)))
    return resp


def _split_library_args(input_: Any) -> tuple[str | None, Any]:
    """The library envelope: {"library_id": .., "arg": ..} → (lib, arg)."""
    if isinstance(input_, dict) and "library_id" in input_:
        return input_["library_id"], input_.get("arg")
    return None, input_


_MIME = {
    "webp": "image/webp", "png": "image/png", "jpg": "image/jpeg",
    "jpeg": "image/jpeg", "gif": "image/gif", "svg": "image/svg+xml",
    "mp4": "video/mp4", "webm": "video/webm", "mp3": "audio/mpeg",
    "pdf": "application/pdf", "txt": "text/plain", "json": "application/json",
    "html": "text/html",
}
