"""Typed procedure router: the rspc equivalent.

Counterpart of ``spacedrive_tpu/api/router.py``: a node-scoped router of
queries, mutations and subscriptions, merged from per-domain sub-router
modules; library-scoped procedures resolve their library from the
``library_id`` of the call, and :func:`mount` validates every invalidation
key the domain code emits against the registered queries.

Transports (the server shell, in-process callers, the tests) call
:meth:`Router.resolve` / :meth:`Router.subscribe` with plain JSON-safe
values; :meth:`Router.schema` exports the procedure inventory. ``pool=``
keeps the reference's mark of a pure library reader. Every procedure
resolves in this process, the reference's own path when it runs no reader
pool (``router.py`` :239-250), and where the device search engine serves.
The ``rspc`` fault seam is kept. Not ported: request telemetry, admission
(``dispatch_budget``), the reader-pool and replica rungs, and with them the
``replica=`` mark.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import TYPE_CHECKING, Any, Callable

from .. import faults

if TYPE_CHECKING:
    from ..events import Subscription
    from ..library import Library
    from ..node import Node

QUERY = "query"
MUTATION = "mutation"
SUBSCRIPTION = "subscription"


class ApiError(Exception):
    """A request the procedure refuses; ``code`` is the HTTP-like status."""

    def __init__(self, message: str, code: int = 400) -> None:
        super().__init__(message)
        self.code = code


@dataclasses.dataclass
class Procedure:
    key: str
    kind: str            # query | mutation | subscription
    scope: str           # node | library
    fn: Callable
    doc: str = ""
    #: a pure library reader (the reference's serve-pool mark)
    pool: bool = False


class Router:
    def __init__(self, node: "Node") -> None:
        self.node = node
        self.procedures: dict[str, Procedure] = {}

    # -- registration -------------------------------------------------------
    def _register(self, key: str, kind: str, scope: str, fn: Callable,
                  pool: bool = False) -> Callable:
        if key in self.procedures:
            raise ValueError(f"duplicate procedure key {key!r}")
        if pool and (kind != QUERY or scope != "library"):
            raise ValueError(f"{key}: only library-scoped queries may be pool-dispatched")
        self.procedures[key] = Procedure(key, kind, scope, fn, inspect.getdoc(fn) or "",
                                         pool=pool)
        return fn

    def query(self, key: str, scope: str = "node", pool: bool = False):
        return lambda fn: self._register(key, QUERY, scope, fn, pool=pool)

    def mutation(self, key: str, scope: str = "node"):
        return lambda fn: self._register(key, MUTATION, scope, fn)

    def subscription(self, key: str, scope: str = "node"):
        return lambda fn: self._register(key, SUBSCRIPTION, scope, fn)

    def library_query(self, key: str, pool: bool = False):
        return self.query(key, scope="library", pool=pool)

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

    def resolve(self, key: str, arg: Any = None, library_id: str | None = None) -> Any:
        """Run a query or mutation: library-scoped procedures receive
        ``(node, library, arg)``, node-scoped ``(node, arg)``. An error of
        the handler (a kernel's included) propagates."""
        proc = self._proc(key)
        if proc.kind == SUBSCRIPTION:
            raise ApiError(f"{key} is a subscription; use subscribe()")
        faults.inject("rspc", key=key)
        if proc.scope == "library":
            return proc.fn(self.node, self._library(library_id), arg)
        return proc.fn(self.node, arg)

    def subscribe(self, key: str, arg: Any = None,
                  library_id: str | None = None) -> "Subscription":
        proc = self._proc(key)
        if proc.kind != SUBSCRIPTION:
            raise ApiError(f"{key} is not a subscription")
        if proc.scope == "library":
            return proc.fn(self.node, self._library(library_id), arg)
        return proc.fn(self.node, arg)

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
                          notifications, p2p, preferences, root, search, sync, tags, volumes)

    router = Router(node)
    for module in (root, libraries, locations, search, files, jobs, tags, volumes, nodes,
                   notifications, preferences, backups, categories, sync, p2p, keys):
        module.mount(router)
    invalidate.validate(router)
    return router
