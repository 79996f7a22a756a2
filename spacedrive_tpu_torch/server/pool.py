"""Multi-process reader pool: pool-marked queries served off the node's
process.

Counterpart of ``spacedrive_tpu/server/pool.py``. N worker processes each
hold their OWN read-only SQLite connection per library
(``Database(readonly=True)``, :mod:`..models.base`) and serve the router's
pool-marked queries (``@router.library_query(..., pool=True)``: pure readers
of ``library.db``, ``node.libraries`` and ``node.data_dir``). Writes,
mutations, jobs, sync, subscriptions and the device search engine never
leave the node's process.

- **Dispatch**: ``Router.resolve`` hands a pool-marked query to
  :meth:`ReaderPool.dispatch`; one worker serves one request at a time,
  checked out from an idle list in FIFO ticket order, and answers over a
  pipe with the page already encoded (``json.dumps(result, default=str)``,
  the shell's encoder), which the shell splices into its envelope. Any pool
  failure raises :class:`PoolUnavailable` and the router serves the query
  in process: queries are read-only, so the re-run is always safe.
- **Invalidation**: a per-library watermark, bumped by a synchronous bus
  hook on every data-changing event (:data:`BUMP_KINDS`), rides every
  dispatch; a worker's page cache (:class:`_PageCache`) hits only at the
  same watermark, and every SELECT reads a fresh WAL snapshot, so a read
  dispatched after a commit never returns rows from before it. A swapped
  database file (``library.reload``, a backup restore) advances the
  library's reader epoch: each worker closes and reopens its connection.
- **Supervision**: a supervisor thread pings idle workers every
  ``SD_SERVE_HEALTH_S`` (1 s; the ping carries the watermarks and returns
  the worker's stats), reaps and respawns dead ones; a dispatcher whose
  worker dies or stays silent past ``SD_SERVE_REQUEST_TIMEOUT_S`` (30 s)
  retires it and fails the request over. A checkout waits at most
  ``SD_SERVE_QUEUE_WAIT_S`` (2 s) for an idle worker. Between
  ``SD_SERVE_WORKERS_MIN`` and ``SD_SERVE_WORKERS_MAX`` (both default to
  the configured count, so the pool is fixed-size unless a range is
  opened) the supervisor grows the pool when the windowed queue-wait p95
  passes ``SD_SERVE_GROW_WAIT_S`` and shrinks it below
  ``SD_SERVE_SHRINK_WAIT_S``.

``SD_SERVE_WORKERS=0`` turns the pool off (:meth:`ReaderPool.maybe_start`
returns None); unset it is ``min(4, cpu_count)``. A pool that cannot start
raises; only :class:`PoolUnavailable` at dispatch falls through.

**Start method: ``forkserver``, where the reference forks
(``pool.py:377``).** By the time the shell starts the pool, the port's
node process holds a CUDA context and a dozen threads (the p2p loop, the
search refresher, the job workers, CUDA's own). A ``fork`` of it
would copy every lock one of those threads held at that instant: SQLite's
static mutexes, a fault plan's lock, the launch counters' lock; a worker
that then takes one waits forever, and CUDA in the child raises "Cannot
re-initialize CUDA in forked subprocess". The forkserver is a fresh
interpreter started from ``sys.executable``: it imports the router's
modules once (:data:`PRELOAD`; importing them initializes no CUDA), has one
thread and no CUDA context, and forks every worker from that clean state,
whenever the pool starts or respawns a slot. The cost is the server's
first start (an interpreter and the torch import, a few seconds once a
process); the workers' answers are the same bytes. A worker never touches
CUDA: its :class:`_ReaderNode` has no device and no search engine, so the
search handlers serve SQL. Nothing is inherited, so what the worker needs
travels in its arguments: the page cache's size and the armed fault plan
(:func:`..faults.current_spec`), installed anew in each worker.

Telemetry: the reference's ``sd_serve_*`` families, recorded in the node's
process at the dispatch seam from each reply (a worker disables its own
registry at start: it lives in another process, and no scrape reads it):
``sd_serve_worker_requests_total{worker,outcome}`` (``ok``, ``api_error``,
``error``, ``failover``; ``worker`` the slot, or ``pool`` for a dispatch
no worker took), ``sd_serve_worker_request_seconds{worker}``,
``sd_serve_worker_cache_total{worker,result}``,
``sd_serve_worker_restarts_total{worker,reason}``, ``sd_serve_workers``,
``sd_serve_invalidations_total``, ``sd_serve_queue_wait_seconds`` and
``sd_serve_pool_resizes_total{direction}`` with a ``pool.resize`` event.
:data:`STATS` keeps the same counts as plain numbers (``requests_ok`` /
``_api_error`` / ``_error`` / ``_failover``, ``cache_hits`` / ``_misses``,
``restarts_<reason>``, ``invalidations``, ``resizes_<direction>``);
:meth:`ReaderPool.status`.
"""

from __future__ import annotations

import collections
import json
import logging
import multiprocessing
import os
import threading
import time
from collections import OrderedDict, deque
from pathlib import Path
from typing import TYPE_CHECKING, Any

from .. import faults, telemetry
from ..telemetry.registry import REQUEST_BUCKETS, estimate_quantiles

if TYPE_CHECKING:
    from ..node import Node

logger = logging.getLogger(__name__)

#: event kinds that mean "committed rows changed" for a library: the
#: watermark bump set. Over-bumping costs cache hits; under-bumping would
#: serve stale pages
BUMP_KINDS = frozenset({"db.commit", "invalidate_query", "sync.newMessage",
                        "job_progress"})
#: event kinds that mean "the database FILE was swapped" (a backup
#: restore): a worker's open connection still points at the old inode, so
#: these advance the library's reader epoch and every worker reopens
RELOAD_KINDS = frozenset({"library.reload"})

#: what the forkserver imports once, before it forks any worker: the router
#: and the sub-routers ``api.router.mount`` imports (one missing here is
#: imported by each worker instead)
PRELOAD = ("spacedrive_tpu_torch.server.pool", "spacedrive_tpu_torch.api.router",
           *(f"spacedrive_tpu_torch.api.routers.{name}" for name in (
               "backups", "categories", "files", "jobs", "keys", "libraries", "locations",
               "nodes", "notifications", "p2p", "preferences", "root", "search", "sync",
               "tags", "telemetry", "volumes")))

# help texts live in telemetry._declare_core
_REQUESTS = telemetry.counter("sd_serve_worker_requests_total",
                              labels=("worker", "outcome"))
_SECONDS = telemetry.histogram("sd_serve_worker_request_seconds",
                               labels=("worker",), buckets=REQUEST_BUCKETS)
_CACHE = telemetry.counter("sd_serve_worker_cache_total", labels=("worker", "result"))
_RESTARTS = telemetry.counter("sd_serve_worker_restarts_total",
                              labels=("worker", "reason"))
_LIVE = telemetry.gauge("sd_serve_workers")
_INVALIDATIONS = telemetry.counter("sd_serve_invalidations_total")
_QUEUE_WAIT = telemetry.histogram("sd_serve_queue_wait_seconds", buckets=REQUEST_BUCKETS)
_RESIZES = telemetry.counter("sd_serve_pool_resizes_total", labels=("direction",))

STATS: collections.Counter = collections.Counter()


def reset_counts() -> None:
    STATS.clear()


def _count(key: str, n: int = 1) -> None:
    from ..ops import _kernels

    _kernels.count(STATS, key, n)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


class PoolUnavailable(Exception):
    """The pool could not serve this dispatch (not running, disabled,
    saturated, or the worker died mid-request): the router serves it in
    process, always safe for a read-only query."""


def configured_workers() -> int:
    """``SD_SERVE_WORKERS`` (0 turns the pool off); default
    ``min(4, cpu_count)``."""
    raw = os.environ.get("SD_SERVE_WORKERS", "").strip()
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            pass
    return min(4, os.cpu_count() or 1)


# ---------------------------------------------------------------------------
# worker side (runs in the forked child)
# ---------------------------------------------------------------------------


class _PageCache:
    """Watermark-keyed LRU over encoded pages. An entry hits only when its
    watermark equals the request's for that library, so invalidation is a
    watermark bump: no explicit delete races with reads."""

    def __init__(self, capacity: int) -> None:
        self.capacity = max(0, capacity)
        self._entries: OrderedDict[tuple, tuple[int, Any]] = OrderedDict()
        self._watermarks: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def sync(self, watermarks: dict[str, int]) -> None:
        """Fold the node's watermarks in and drop stale entries (eviction
        between requests; the per-request check is authoritative)."""
        for lib, wm in watermarks.items():
            if wm > self._watermarks.get(lib, 0):
                self._watermarks[lib] = wm
        stale = [k for k, (wm, _r) in self._entries.items()
                 if wm != self._watermarks.get(k[0], 0)]
        for k in stale:
            del self._entries[k]

    def lookup(self, lib: str, proc: str, arg: Any, wm: int):
        """(hit, key, page): the key is reused for :meth:`store`."""
        if wm > self._watermarks.get(lib, 0):
            self._watermarks[lib] = wm
        try:
            key = (lib, proc, json.dumps(arg, sort_keys=True, default=str))
        except (TypeError, ValueError):
            return False, None, None
        entry = self._entries.get(key)
        if entry is not None and entry[0] == wm:
            self._entries.move_to_end(key)
            return True, key, entry[1]
        if entry is not None and wm > entry[0]:
            del self._entries[key]  # a stale entry
        elif entry is not None:
            # a straggler: this request is older than the cached page (its
            # watermark was read before a bump): serve it fresh, neither
            # evicting nor overwriting the newer entry
            return False, None, None
        return False, key, None

    def drop_library(self, lib: str) -> None:
        """An epoch change: every cached page of this library is void."""
        for key in [k for k in self._entries if k[0] == lib]:
            del self._entries[key]

    def store(self, key: tuple | None, wm: int, page: Any) -> None:
        if key is None or self.capacity == 0:
            return
        self._entries[key] = (wm, page)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)


class _ReaderLibrary:
    """What a pool handler may touch of a library: ``id`` and a read-only
    ``db``."""

    __slots__ = ("id", "db")

    def __init__(self, lib_id: str, db: Any) -> None:
        self.id = lib_id
        self.db = db


class _ReaderLibraries:
    """Opens ``libraries/<id>.db`` read-only on first use (so libraries
    made after the worker started are visible); a missing file is the
    router's 404. A higher epoch closes and reopens the connection."""

    def __init__(self, libraries_dir: Path) -> None:
        self.dir = libraries_dir
        self._open: dict[str, _ReaderLibrary] = {}
        self._epochs: dict[str, int] = {}

    def get(self, lib_id: str, epoch: int = 0) -> _ReaderLibrary:
        import sqlite3

        from ..api.router import ApiError
        from ..models import ALL_MODELS, Database

        if epoch > self._epochs.get(lib_id, 0):
            # the node swapped the file (a restore): the open connection
            # points at the old inode
            self._epochs[lib_id] = epoch
            stale = self._open.pop(lib_id, None)
            if stale is not None:
                try:
                    stale.db.close()
                except sqlite3.Error:
                    pass
        lib = self._open.get(lib_id)
        if lib is not None:
            return lib
        # the id becomes a file name
        if not lib_id or any(c in lib_id for c in "/\\") or ".." in lib_id or len(lib_id) > 64:
            raise ApiError(f"library {lib_id!r} not loaded", code=404)
        path = self.dir / f"{lib_id}.db"
        if not path.is_file():
            raise ApiError(f"library {lib_id!r} not loaded", code=404)
        try:
            db = Database(path, ALL_MODELS, readonly=True)
        except sqlite3.Error as e:
            raise ApiError(f"library {lib_id!r} unreadable: {e}", code=404) from None
        lib = _ReaderLibrary(lib_id, db)
        self._open[lib_id] = lib
        return lib


class _ReaderNode:
    """The node a handler sees inside a worker: its libraries and data dir,
    no device and no search engine (the search handlers serve SQL); a
    handler reaching for anything else gets an AttributeError, which the
    worker reports and the dispatcher fails over."""

    def __init__(self, data_dir: Path) -> None:
        self.data_dir = Path(data_dir)
        self.libraries = _ReaderLibraries(self.data_dir / "libraries")
        self.reader_pool = None  # a worker never nests a pool
        self.search_engine = None


def _serve_one(runtime_node, router, cache: _PageCache, msg: dict) -> dict:
    from ..api.router import QUERY, ApiError

    key = msg.get("proc", "")
    arg = msg.get("arg")
    library_id = msg.get("library_id")
    wm = int(msg.get("wm") or 0)
    epoch = int(msg.get("epoch") or 0)
    try:
        faults.inject("serve_worker", key=key)
        # a caller may name an extra seam for this dispatch (the replica
        # tier's ``replica_serve``), so its faults land in the worker that
        # serves the query, not in the node's process
        extra_seam = msg.get("seam")
        if extra_seam:
            faults.inject(str(extra_seam), key=key)
        proc = router.procedures.get(key)
        if proc is None or proc.kind != QUERY or not proc.pool:
            raise ApiError(f"{key} is not pool-dispatchable")
        if epoch > runtime_node.libraries._epochs.get(library_id or "", 0):
            cache.drop_library(library_id or "")
        hit, cache_key, cached = cache.lookup(library_id or "", key, arg, wm)
        if hit:
            return {"ok": True, "raw": cached, "hit": True}
        result = proc.fn(runtime_node, runtime_node.libraries.get(library_id, epoch=epoch), arg)
        # encoded once, here, with the shell's encoder: the node's process
        # neither decodes nor re-encodes the page, and a hit replays bytes
        encoded = json.dumps(result, default=str).encode()
        cache.store(cache_key, wm, encoded)
        return {"ok": True, "raw": encoded, "hit": False}
    except ApiError as e:
        return {"ok": False, "api": True, "error": str(e), "code": e.code}
    except Exception as e:  # noqa: BLE001 — a 500-class error, as in process
        return {"ok": False, "api": False, "error": f"{type(e).__name__}: {e}"}


def _worker_main(conn, data_dir: str, slot: int, cache_size: int,
                 fault_spec: str | None) -> None:
    """The worker's loop: requests and control messages over one pipe."""
    from ..api.router import mount as api_mount

    # this process's registry is never scraped: the node records the
    # serve families from each reply
    telemetry.set_enabled(False)
    if fault_spec:
        faults.install(fault_spec)
    node = _ReaderNode(Path(data_dir))
    router = api_mount(node)
    cache = _PageCache(cache_size)
    served = 0
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError, KeyboardInterrupt):
            break
        except Exception:  # noqa: BLE001
            # a garbled frame: the parent's state is unknowable; exit and
            # let the supervisor respawn a clean process
            break
        if not isinstance(msg, dict):
            continue
        ctl = msg.get("ctl")
        if ctl == "shutdown":
            break
        if ctl == "sync":
            cache.sync(msg.get("watermarks") or {})
            reply: dict[str, Any] = {"ok": True, "pong": True, "served": served,
                                     "cache_entries": len(cache)}
        else:
            reply = _serve_one(node, router, cache, msg)
            served += 1
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            break
        except Exception as e:  # noqa: BLE001 — an unpicklable reply
            try:
                conn.send({"ok": False, "api": False, "error": f"unpicklable response: {e}"})
            except Exception:  # noqa: BLE001
                break


# ---------------------------------------------------------------------------
# node side
# ---------------------------------------------------------------------------


def _context():
    """The forkserver context, its server preloading :data:`PRELOAD`
    (set before the server's first start; a later call changes nothing)."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(list(PRELOAD))
    return ctx


class _Worker:
    __slots__ = ("slot", "proc", "conn", "generation", "dead")

    def __init__(self, slot: int, proc, conn, generation: int) -> None:
        self.slot = slot
        self.proc = proc
        self.conn = conn
        self.generation = generation
        self.dead = False


class ReaderPool:
    def __init__(self, node: "Node", workers: int | None = None) -> None:
        self.node = node
        self.workers = configured_workers() if workers is None else workers
        self._ctx = _context()
        self._idle: list[_Worker] = []
        # FIFO checkout tickets: one a dispatching thread
        self._tickets: deque[object] = deque()
        self._cv = threading.Condition()
        self._wm_lock = threading.Lock()
        self._watermarks: dict[str, int] = {}
        self._epochs: dict[str, int] = {}
        self._enabled = True
        self._cache_hits = 0
        self._cache_misses = 0
        self._running = False
        self._generation = 0
        self._restarts = 0
        self._failovers = 0
        self._worker_stats: dict[int, dict] = {}
        self._respawn_wake = threading.Event()
        self._supervisor: threading.Thread | None = None
        self.cache_size = _env_int("SD_SERVE_CACHE", 256)
        self.health_s = _env_float("SD_SERVE_HEALTH_S", 1.0)
        self.request_timeout_s = _env_float("SD_SERVE_REQUEST_TIMEOUT_S", 30.0)
        self.queue_wait_s = _env_float("SD_SERVE_QUEUE_WAIT_S", 2.0)
        # the autosizer's range; both ends default to the configured count
        self.min_workers = max(1, _env_int("SD_SERVE_WORKERS_MIN", self.workers))
        self.max_workers = max(self.min_workers,
                               _env_int("SD_SERVE_WORKERS_MAX", self.workers))
        self.workers = min(max(self.workers, self.min_workers), self.max_workers)
        self._slots: list[_Worker | None] = [None] * self.workers
        self.autosize_cooldown_s = _env_float("SD_SERVE_AUTOSIZE_COOLDOWN_S",
                                              max(2.0, 2 * self.health_s))
        self.grow_wait_s = _env_float("SD_SERVE_GROW_WAIT_S", 0.05)
        self.shrink_wait_s = _env_float("SD_SERVE_SHRINK_WAIT_S", 0.005)
        #: the checkouts' queue waits by bucket (the last one +Inf), and the
        #: snapshot the autosizer took last (its window is the difference)
        self._qw_counts = [0] * (len(REQUEST_BUCKETS) + 1)
        self._qw_prev: list[int] | None = None
        self._last_resize = time.monotonic()
        self._resizes = 0

    @classmethod
    def maybe_start(cls, node: "Node") -> "ReaderPool | None":
        """The shell's entry point: None when ``SD_SERVE_WORKERS=0``."""
        n = configured_workers()
        if n <= 0:
            return None
        return cls(node, workers=n).start()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ReaderPool":
        if self.workers <= 0:
            raise ValueError("ReaderPool needs at least one worker")
        self._running = True
        try:
            for slot in range(self.workers):
                self._spawn(slot)
        except BaseException:
            # a partial start: nobody else holds a handle to stop them
            self.stop()
            raise
        self.node.events.on(self._on_event)
        self._supervisor = threading.Thread(target=self._supervise,
                                            name="sd-serve-supervisor", daemon=True)
        self._supervisor.start()
        logger.info("reader pool started: %d workers (forkserver)", self.workers)
        return self

    def stop(self) -> None:
        self._running = False
        self._respawn_wake.set()
        self.node.events.off(self._on_event)
        if self._supervisor is not None:
            self._supervisor.join(timeout=5)
        with self._cv:
            workers = [w for w in self._slots if w is not None]
            # a worker not in the idle list is checked out by a dispatcher
            # that may be mid-send on its pipe: it gets a kill (the
            # dispatcher sees EOF and fails over), not a second writer
            idle = set(self._idle)
            self._slots = [None] * self.workers
            _LIVE.set(0.0)
            self._idle.clear()
            self._cv.notify_all()
        for w in workers:
            if w not in idle:
                w.proc.kill()
                continue
            try:
                w.conn.send({"ctl": "shutdown"})
            except (BrokenPipeError, OSError):
                pass
        deadline = time.monotonic() + 2.0
        for w in workers:
            w.proc.join(timeout=max(0.0, deadline - time.monotonic()))
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=2)
            try:
                w.conn.close()
            except OSError:
                pass

    def set_enabled(self, value: bool) -> None:
        """Disabled, every dispatch raises PoolUnavailable and the router
        serves in process; the workers stay warm (the A/B of the tests and
        the chip phase)."""
        self._enabled = bool(value)
        with self._cv:
            self._cv.notify_all()  # parked checkouts re-check the gate

    def worker_pids(self) -> list[int]:
        with self._cv:
            return [w.proc.pid for w in self._slots if w is not None]

    # -- invalidation --------------------------------------------------------
    def _on_event(self, event) -> None:
        """Synchronous bus hook, run after the commit that emitted the
        event: later dispatches carry a fresher watermark than any page
        cached before it. Eviction rides the supervisor's next ping."""
        lib_id = getattr(event, "library_id", None)
        if not lib_id:
            return
        if event.kind in RELOAD_KINDS:
            with self._wm_lock:
                self._epochs[lib_id] = self._epochs.get(lib_id, 0) + 1
                self._watermarks[lib_id] = self._watermarks.get(lib_id, 0) + 1
            _count("invalidations")
            _INVALIDATIONS.inc()
            return
        if event.kind not in BUMP_KINDS:
            return
        with self._wm_lock:
            self._watermarks[lib_id] = self._watermarks.get(lib_id, 0) + 1
        _count("invalidations")
        _INVALIDATIONS.inc()

    def watermark(self, lib_id: str | None) -> tuple[int, int]:
        """(watermark, epoch): the freshness pair every dispatch carries."""
        if not lib_id:
            return 0, 0
        with self._wm_lock:
            return self._watermarks.get(lib_id, 0), self._epochs.get(lib_id, 0)

    def _failover(self, why: str, worker: str = "pool") -> None:
        with self._wm_lock:
            self._failovers += 1
        _count(f"requests_{why}")
        _REQUESTS.inc(worker=worker, outcome=why)

    # -- dispatch ------------------------------------------------------------
    def dispatch(self, key: str, arg: Any, library_id: str | None,
                 seam: str | None = None) -> Any:
        """Serve one pool-marked query on a worker: a :class:`RawJson`
        page, or the handler's ApiError; :class:`PoolUnavailable` when the
        caller should serve it in process (a worker's non-Api error
        included: the re-run there raises the original). ``seam`` names a
        fault seam injected inside the worker for this dispatch."""
        from ..api.router import ApiError, RawJson

        if not (self._running and self._enabled):
            raise PoolUnavailable("pool not running")
        try:
            worker = self._checkout()
        except PoolUnavailable:
            self._failover("failover")
            raise
        wm, epoch = self.watermark(library_id)
        req = {"proc": key, "arg": arg, "library_id": library_id, "wm": wm, "epoch": epoch}
        if seam:
            req["seam"] = seam
        label = str(worker.slot)
        t0 = time.perf_counter()
        try:
            worker.conn.send(req)
            if not worker.conn.poll(self.request_timeout_s):
                raise TimeoutError(f"no reply in {self.request_timeout_s:.0f}s")
            reply = worker.conn.recv()
        except TimeoutError as e:
            self._retire(worker, reason="timeout")
            self._failover("failover", label)
            raise PoolUnavailable(f"worker {worker.slot} wedged: {e}") from None
        except Exception as e:  # noqa: BLE001
            # EOF (the worker died) or anything else mid-frame: the pipe's
            # state is unknowable, so the worker is retired either way
            self._retire(worker, reason="crash")
            self._failover("failover", label)
            raise PoolUnavailable(f"worker {worker.slot} died: {e}") from None
        if not isinstance(reply, dict):
            self._retire(worker, reason="crash")
            self._failover("failover", label)
            raise PoolUnavailable(f"malformed worker reply: {type(reply)}")
        _SECONDS.observe(time.perf_counter() - t0, worker=label)
        self._checkin(worker)
        if "hit" in reply:
            _count("cache_hits" if reply["hit"] else "cache_misses")
            _CACHE.inc(worker=label, result="hit" if reply["hit"] else "miss")
            with self._wm_lock:
                if reply["hit"]:
                    self._cache_hits += 1
                else:
                    self._cache_misses += 1
        if reply.get("ok"):
            _count("requests_ok")
            _REQUESTS.inc(worker=label, outcome="ok")
            return RawJson(reply["raw"])
        if reply.get("api"):
            _count("requests_api_error")
            _REQUESTS.inc(worker=label, outcome="api_error")
            raise ApiError(str(reply.get("error")), code=int(reply.get("code") or 400))
        # a non-Api handler failure: served in process, where a handler
        # that reached past the worker's surface works and a broken one
        # raises its original exception
        self._failover("error", label)
        raise PoolUnavailable(f"worker handler error: {reply.get('error')}")

    def _observe_wait(self, seconds: float) -> None:
        i = next((i for i, b in enumerate(REQUEST_BUCKETS) if seconds <= b),
                 len(REQUEST_BUCKETS))
        with self._wm_lock:
            self._qw_counts[i] += 1
        _QUEUE_WAIT.observe(seconds)

    def _checkout(self) -> _Worker:
        # the queue wait is far shorter than the request timeout: when every
        # worker is busy, spilling to the in-process path keeps the tail
        # bounded. FIFO tickets keep a late arrival from barging past a
        # waiter on every wake-up.
        t0 = time.monotonic()
        deadline = t0 + self.queue_wait_s
        ticket = object()
        with self._cv:
            self._tickets.append(ticket)
            try:
                while True:
                    if not (self._running and self._enabled):
                        raise PoolUnavailable("pool stopping")
                    if self._idle and self._tickets[0] is ticket:
                        self._observe_wait(time.monotonic() - t0)
                        return self._idle.pop()
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        # a spill records its whole wait: the autosizer's
                        # grow signal must see the overload that spills
                        self._observe_wait(time.monotonic() - t0)
                        raise PoolUnavailable("pool saturated")
                    self._cv.wait(timeout=remaining)
            finally:
                try:
                    self._tickets.remove(ticket)
                except ValueError:
                    pass
                if self._idle and self._tickets:
                    self._cv.notify_all()  # the new head may be parked

    def _checkin(self, worker: _Worker) -> None:
        with self._cv:
            if worker.dead or worker.slot >= len(self._slots) or \
                    self._slots[worker.slot] is not worker:
                return
            self._idle.append(worker)
            # notify_all: only the head ticket may take it
            self._cv.notify_all()

    # -- supervision ---------------------------------------------------------
    def _spawn(self, slot: int) -> None:
        """Start a worker into ``slot``; the start happens outside the pool
        lock, only the install takes it."""
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(
            target=_worker_main,
            args=(child_conn, str(self.node.data_dir), slot, self.cache_size,
                  faults.current_spec()),
            name=f"sd-serve-w{slot}", daemon=True)
        proc.start()
        child_conn.close()
        with self._cv:
            installed = self._running and slot < len(self._slots) and self._slots[slot] is None
            if installed:
                self._generation += 1
                worker = _Worker(slot, proc, parent_conn, self._generation)
                self._slots[slot] = worker
                self._idle.append(worker)
                self._cv.notify_all()  # the head ticket must see it
                _LIVE.set(sum(1 for w in self._slots if w is not None))
        if not installed:
            # stopped (or lost a race) while starting: discard it
            proc.kill()
            proc.join(timeout=2)
            parent_conn.close()

    def _retire(self, worker: _Worker, reason: str) -> None:
        """Drop a dead or wedged worker and wake the supervisor to respawn
        its slot; never waits on the process."""
        with self._cv:
            if worker.dead:
                return
            worker.dead = True
            if worker.slot < len(self._slots) and self._slots[worker.slot] is worker:
                self._slots[worker.slot] = None
            if worker in self._idle:
                self._idle.remove(worker)
            _LIVE.set(sum(1 for w in self._slots if w is not None))
        with self._wm_lock:
            self._restarts += 1
        _count(f"restarts_{reason}")
        _RESTARTS.inc(worker=str(worker.slot), reason=reason)
        try:
            worker.proc.kill()
        except (OSError, ValueError):
            pass
        try:
            worker.conn.close()
        except OSError:
            pass
        self._respawn_wake.set()

    def _supervise(self) -> None:
        """Every ``health_s``: respawn empty slots, reap idle workers that
        died unseen, ping the rest, and let the autosizer decide."""
        while self._running:
            self._respawn_wake.wait(timeout=self.health_s)
            self._respawn_wake.clear()
            if not self._running:
                return
            empty: list[int] = []
            with self._cv:
                for slot in range(self.workers):
                    w = self._slots[slot]
                    if w is not None and not w.proc.is_alive():
                        # died idle (a SIGKILL, the OOM killer): reap here
                        w.dead = True
                        if w in self._idle:
                            self._idle.remove(w)
                        self._slots[slot] = None
                        with self._wm_lock:
                            self._restarts += 1
                        _count("restarts_crash")
                        _RESTARTS.inc(worker=str(slot), reason="crash")
                        _LIVE.set(sum(1 for x in self._slots if x is not None))
                        w = None
                    if w is None:
                        empty.append(slot)
            for slot in empty:
                if not self._running:
                    break
                try:
                    self._spawn(slot)
                except Exception as e:  # noqa: BLE001
                    # a transient start failure (EAGAIN): the slot stays
                    # empty and the next tick retries
                    logger.warning("worker %d respawn failed: %s", slot, e)
                    break
            self._ping_idle_workers()
            try:
                self._autosize()
            except Exception:  # noqa: BLE001 — a resize never takes the supervisor down
                logger.exception("pool autosize failed")

    def _autosize(self) -> None:
        """One decision a tick: grow when the windowed queue-wait p95 says
        dispatches park behind busy workers, shrink when the pool idles.
        Inactive unless ``SD_SERVE_WORKERS_MIN/MAX`` open a range."""
        if self.max_workers <= self.min_workers or not self._running:
            return
        if time.monotonic() - self._last_resize < self.autosize_cooldown_s:
            return
        with self._wm_lock:
            counts = list(self._qw_counts)
        prev = self._qw_prev or [0] * len(counts)
        window = [c - p for c, p in zip(counts, prev)]
        self._qw_prev = counts
        # no checkout since the last tick is the strongest shrink signal
        p95 = (estimate_quantiles(REQUEST_BUCKETS, window, qs=(0.95,))[0.95]
               if sum(window) else 0.0)
        if p95 > self.grow_wait_s and self.workers < self.max_workers:
            self._resize("grow", p95)
        elif p95 < self.shrink_wait_s and self.workers > self.min_workers:
            self._resize("shrink", p95)

    def _resize(self, direction: str, p95: float) -> None:
        if direction == "grow":
            with self._cv:
                if not self._running or self.workers >= self.max_workers:
                    return
                slot = self.workers
                self._slots.append(None)
                self.workers += 1
            try:
                self._spawn(slot)
            except Exception as e:  # noqa: BLE001 — the respawn sweep retries
                logger.warning("grown worker %d spawn failed: %s", slot, e)
        else:
            with self._cv:
                if self.workers <= self.min_workers:
                    return
                slot = self.workers - 1
                w = self._slots[slot]
                if w is None or w not in self._idle:
                    # only an idle top slot may go: a checked-out worker's
                    # dispatcher indexes the slots by number
                    return
                self._idle.remove(w)
                self._slots.pop()
                self.workers -= 1
                w.dead = True
                _LIVE.set(sum(1 for x in self._slots if x is not None))
            try:
                w.conn.send({"ctl": "shutdown"})
            except (BrokenPipeError, OSError):
                pass
            try:
                w.conn.close()
            except OSError:
                pass
        with self._wm_lock:
            self._resizes += 1
        self._last_resize = time.monotonic()
        _count(f"resizes_{direction}")
        _RESIZES.inc(direction=direction)
        telemetry.event("pool.resize", direction=direction, workers=self.workers,
                        queue_wait_p95_ms=round(p95 * 1000.0, 2),
                        min=self.min_workers, max=self.max_workers)
        logger.info("pool %s -> %d workers (queue-wait p95 %.1f ms)",
                    direction, self.workers, p95 * 1000.0)

    def _ping_idle_workers(self) -> None:
        with self._wm_lock:
            watermarks = dict(self._watermarks)
        for slot in range(self.workers):
            with self._cv:
                w = self._slots[slot] if slot < len(self._slots) else None
                if w is None or w not in self._idle:
                    continue  # busy or empty: its dispatcher watches it
                self._idle.remove(w)
            try:
                w.conn.send({"ctl": "sync", "watermarks": watermarks})
                if not w.conn.poll(min(5.0, self.request_timeout_s)):
                    raise TimeoutError("ping timed out")
                pong = w.conn.recv()
                if isinstance(pong, dict) and pong.get("pong"):
                    self._worker_stats[slot] = {"served": pong.get("served", 0),
                                                "cache_entries": pong.get("cache_entries", 0),
                                                "pid": w.proc.pid}
                self._checkin(w)
            except Exception:  # noqa: BLE001
                # any pipe failure retires the checked-out worker: letting
                # it escape would leak the slot and end the supervisor
                self._retire(w, reason="health")

    # -- introspection -------------------------------------------------------
    def status(self) -> dict[str, Any]:
        with self._cv:
            live = [w for w in self._slots if w is not None]
            alive = sum(1 for w in live if w.proc.is_alive())
            idle = len(self._idle)
        return {
            "workers": self.workers,
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "alive": alive,
            "idle": idle,
            "enabled": self._enabled,
            "running": self._running,
            "start_method": "forkserver",
            "restarts": self._restarts,
            "resizes": self._resizes,
            "failovers": self._failovers,
            # this pool's own traffic, not the module's STATS
            "cache_hits": self._cache_hits,
            "cache_misses": self._cache_misses,
            "watermarks": len(self._watermarks),
            "per_worker": dict(self._worker_stats),
        }
