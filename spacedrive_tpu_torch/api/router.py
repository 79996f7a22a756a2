"""Typed procedure router: the rspc equivalent.

Counterpart of ``spacedrive_tpu/api/router.py``: a node-scoped router of
queries, mutations and subscriptions, merged from per-domain sub-router
modules; library-scoped procedures resolve their library from the
``library_id`` of the call, and :func:`mount` validates every invalidation
key the domain code emits against the registered queries.

Transports (the server shell, in-process callers, the tests) call
:meth:`Router.resolve` / :meth:`Router.subscribe` with plain JSON-safe
values; :meth:`Router.schema` exports the procedure inventory. ``pool=``
marks a pure library reader, which a reader-pool worker may serve, and
``replica=False`` keeps such a reader off the replica tier: its answer is
node-specific on converged peers (disk figures, tables sync does not copy)
or its argument or answer names this node's row ids, which a replica
numbers otherwise. The reference marks only ``libraries.statistics`` and
lets a replica answer id-bearing pages (ROADMAP Queue 3); here the replica
tier serves the counts, the categories and the preferences, and a count
filtered by a row id (:data:`LOCAL_ID_ARGS`) stays local.
:meth:`Router.resolve` follows the reference's ladder
(:187-260): the ``rspc`` fault seam, admission through
``node.dispatch_budget`` (``telemetry.*`` exempt; a shed dispatch raises
:class:`BusyError`, 429), then for a pool-marked query the device search
engine in process when it will serve it (``prefers_inprocess`` skips both
remote rungs), else a watermark-eligible peer (``node.replica_router``),
else the local reader pool (``node.reader_pool``; ``PoolUnavailable``
falls through), else the handler in this process. A worker or a peer
answers with encoded bytes (:class:`RawJson`), which ``raw=True`` passes
through for the shell to splice. :func:`last_rung` names the rung that
served this thread's last dispatch. Every dispatch, the seam and the
admission included, runs through :func:`.telemetry.requests.observed`
(:256): the ``sd_rspc_*`` and ``sd_rspc_tenant_*`` families by ``{proc,
kind, outcome}`` (``shed`` for a :class:`BusyError`, ``api_error`` for an
:class:`ApiError`, else ``error``) and the slow-request ring
(``SD_SLOW_REQUEST_MS``), which keeps a slow request's span tree with its
``db.query`` spans. A subscription's setup is observed the same way.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import threading
from typing import TYPE_CHECKING, Any, Callable

from .. import faults
from ..telemetry import requests as _requests
from ..telemetry import slo as _slo

if TYPE_CHECKING:
    from ..events import Subscription
    from ..library import Library
    from ..node import Node

QUERY = "query"
MUTATION = "mutation"
SUBSCRIPTION = "subscription"

_last = threading.local()


def last_rung() -> str | None:
    """The rung that served this thread's last dispatch: ``engine`` (the
    handler in process, the device index armed for it), ``replica``,
    ``pool`` or ``in_process``."""
    return getattr(_last, "rung", None)


class ApiError(Exception):
    """A request the procedure refuses; ``code`` is the HTTP-like status."""

    def __init__(self, message: str, code: int = 400) -> None:
        super().__init__(message)
        self.code = code


class BusyError(ApiError):
    """429: admission shed this dispatch. ``retry_after_ms`` is the
    pressure-scaled backoff the client should wait."""

    def __init__(self, message: str, retry_after_ms: int = 0) -> None:
        super().__init__(message, code=429)
        self.retry_after_ms = int(retry_after_ms)


class RawJson:
    """A query result already encoded as wire JSON: a pool worker or a
    replica encodes a page once (``json.dumps(result, default=str)``, the
    shell's own encoder), and the shell splices the bytes into its
    envelope. ``Router.resolve(raw=False)`` decodes it."""

    __slots__ = ("data",)

    def __init__(self, data: bytes) -> None:
        self.data = data

    def decode(self) -> Any:
        return json.loads(self.data)


@dataclasses.dataclass
class Procedure:
    key: str
    kind: str            # query | mutation | subscription
    scope: str           # node | library
    fn: Callable
    doc: str = ""
    #: a pure library reader: a reader-pool worker may serve it
    pool: bool = False
    #: a pool reader a peer's replica may serve; False for a read whose
    #: answer is node-specific even on converged peers (disk figures,
    #: unsynced tables) or whose argument or answer names row ids
    replica: bool = True


#: argument keys of the replica-served queries whose values are row ids of
#: the asking node (``search.pathsCount``'s filters)
LOCAL_ID_ARGS = ("location_id", "tags")


def names_local_ids(arg: Any) -> bool:
    """True when ``arg`` filters by a node-local row id: a replica would
    read the id in its own numbering."""
    return isinstance(arg, dict) and any(arg.get(k) not in (None, [], ()) for k in LOCAL_ID_ARGS)


class Router:
    def __init__(self, node: "Node") -> None:
        self.node = node
        self.procedures: dict[str, Procedure] = {}

    # -- registration -------------------------------------------------------
    def _register(self, key: str, kind: str, scope: str, fn: Callable,
                  pool: bool = False, replica: bool = True) -> Callable:
        if key in self.procedures:
            raise ValueError(f"duplicate procedure key {key!r}")
        if pool and (kind != QUERY or scope != "library"):
            # a worker's page cache is keyed by library: a node-scoped page
            # could never be invalidated
            raise ValueError(f"{key}: only library-scoped queries may be pool-dispatched")
        if not pool and not replica:
            raise ValueError(f"{key}: replica=False is only meaningful on "
                             f"pool-dispatched queries")
        self.procedures[key] = Procedure(key, kind, scope, fn, inspect.getdoc(fn) or "",
                                         pool=pool, replica=replica)
        return fn

    def query(self, key: str, scope: str = "node", pool: bool = False,
              replica: bool = True):
        return lambda fn: self._register(key, QUERY, scope, fn, pool=pool,
                                         replica=replica)

    def mutation(self, key: str, scope: str = "node"):
        return lambda fn: self._register(key, MUTATION, scope, fn)

    def subscription(self, key: str, scope: str = "node"):
        return lambda fn: self._register(key, SUBSCRIPTION, scope, fn)

    def library_query(self, key: str, pool: bool = False, replica: bool = True):
        return self.query(key, scope="library", pool=pool, replica=replica)

    def library_mutation(self, key: str):
        return self.mutation(key, scope="library")

    def library_subscription(self, key: str):
        return self.subscription(key, scope="library")

    # -- resolution ---------------------------------------------------------
    def _proc(self, key: str) -> Procedure:
        proc = self.procedures.get(key)
        if proc is None:
            raise ApiError(f"unknown procedure {key!r}", code=404)
        return proc

    def _library(self, library_id: str | None) -> "Library":
        if not library_id:
            raise ApiError("library_id required for library-scoped procedure")
        try:
            return self.node.libraries.get(library_id)
        except KeyError:
            raise ApiError(f"library {library_id!r} not loaded", code=404) from None

    def resolve(self, key: str, arg: Any = None, library_id: str | None = None,
                *, raw: bool = False) -> Any:
        """Run a query or mutation down the ladder of the module docstring:
        library-scoped handlers receive ``(node, library, arg)``, node-scoped
        ``(node, arg)``. An error of the handler (a kernel's included)
        propagates. A page a worker or a peer encoded comes back as
        :class:`RawJson` when ``raw`` is set, else decoded."""
        proc = self._proc(key)
        if proc.kind == SUBSCRIPTION:
            raise ApiError(f"{key} is a subscription; use subscribe()")
        tenant = _slo.tenant_label(library_id)

        def dispatch() -> Any:
            # inside the observed scope, so an injected stall lands in the
            # histograms and the slow ring like real slowness
            faults.inject("rspc", key=key)
            admission = None
            budget = getattr(self.node, "dispatch_budget", None)
            if budget is not None and not key.startswith("telemetry."):
                from ..sync.admission import Busy

                verdict = budget.try_admit(tenant)
                if isinstance(verdict, Busy):
                    raise BusyError(f"{key}: {verdict.reason}; retry after "
                                    f"{verdict.retry_after_ms} ms",
                                    retry_after_ms=verdict.retry_after_ms)
                admission = verdict
            try:
                return self._dispatch(proc, arg, library_id)
            finally:
                if admission is not None:
                    admission.release()

        result = _requests.observed(key, proc.kind, dispatch, tenant=tenant)
        if isinstance(result, RawJson) and not raw:
            return result.decode()
        return result

    def _dispatch(self, proc: Procedure, arg: Any, library_id: str | None) -> Any:
        library = self._library(library_id) if proc.scope == "library" else None
        engine_local = False
        if proc.pool:
            # the device index answers this query in process: workers and
            # peers have no index, so both remote rungs are skipped
            engine = getattr(self.node, "search_engine", None)
            engine_local = (engine is not None
                            and engine.prefers_inprocess(proc.key, library_id, arg))
        replicas = getattr(self.node, "replica_router", None)
        if proc.pool and proc.replica and not engine_local and replicas is not None \
                and not names_local_ids(arg):
            served = replicas.dispatch(proc.key, arg, library_id)
            if served is not None:
                return self._served("replica", served)
        pool = getattr(self.node, "reader_pool", None)
        if proc.pool and not engine_local and pool is not None:
            from ..server.pool import PoolUnavailable

            try:
                return self._served("pool", pool.dispatch(proc.key, arg, library_id))
            except PoolUnavailable:
                pass  # counted by the pool; served in process below
        rung = "engine" if engine_local else "in_process"
        if library is not None:
            return self._served(rung, proc.fn(self.node, library, arg))
        return self._served(rung, proc.fn(self.node, arg))

    @staticmethod
    def _served(rung: str, result: Any) -> Any:
        _last.rung = rung
        return result

    def subscribe(self, key: str, arg: Any = None,
                  library_id: str | None = None) -> "Subscription":
        proc = self._proc(key)
        if proc.kind != SUBSCRIPTION:
            raise ApiError(f"{key} is not a subscription")

        def dispatch() -> Any:
            # counts the subscription's setup; the stream is the transport's
            if proc.scope == "library":
                return proc.fn(self.node, self._library(library_id), arg)
            return proc.fn(self.node, arg)

        return _requests.observed(key, proc.kind, dispatch)

    # -- schema export --------------------------------------------------------
    def schema(self) -> dict[str, Any]:
        return {
            "version": 1,
            "procedures": [
                {"key": p.key, "kind": p.kind, "scope": p.scope, "doc": p.doc}
                for p in sorted(self.procedures.values(), key=lambda p: p.key)
            ],
        }


def mount(node: "Node") -> Router:
    """Build the router from the ported sub-routers and validate the
    invalidation-key contract."""
    from . import invalidate
    from .routers import (backups, categories, files, jobs, keys, libraries, locations, nodes,
                          notifications, p2p, preferences, root, search, sync, tags, telemetry,
                          volumes)

    router = Router(node)
    for module in (root, libraries, locations, search, files, jobs, tags, volumes, nodes,
                   notifications, preferences, backups, categories, sync, p2p, keys,
                   telemetry):
        module.mount(router)
    invalidate.validate(router)
    return router
