"""The port's replica tier (``spacedrive_tpu_torch/server/replica.py``) and
admission at dispatch on the CPU, case for case with
``tests/test_replica.py``: the ``H_QUERY`` header, the eligibility rule,
``serve_query``'s gates and fault seam on a two-node pair, the router's
EWMA, cooldowns, busy, backoff and failover, the ladder through
``Router.resolve`` and ``replica=False``. ``replica.STATS`` stands in for
the reference's ``sd_replica_*`` families.

Beyond the reference's cases:

- a port node and a JAX node over loopback TCP, paired into one library,
  each serving the other's ``H_QUERY`` with the bytes of its own local
  answer (and, the libraries converged, of the asker's);
- the port's ``DispatchBudget`` giving the JAX ``DispatchBudget``'s
  verdicts on one seeded script of admits and releases across 5 tenants;
- a shed dispatch answering 429 with ``Retry-After`` over GET, POST and the
  websocket, where the JAX shell answers 400 (ROADMAP Queue 3);
- queries whose answers or arguments name node-local row ids kept off the
  replica tier on both ends, where the reference lets a replica answer
  them with its own ids (ROADMAP Queue 3);
- a replica that runs a pool serving a query its device index will answer
  in its own process, not in the pool (ROADMAP Queue 3);
- the tenant labels, ``SD_TENANT_LABEL_CAP`` included, equal to the
  reference's.
"""

import asyncio
import json
import random

import pytest

from spacedrive_tpu_torch import faults
from spacedrive_tpu_torch.api.router import RawJson, last_rung
from spacedrive_tpu_torch.faults import PeerBusyError
from spacedrive_tpu_torch.models import Object, Tag
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.p2p.proto import H_QUERY, Header
from spacedrive_tpu_torch.server import replica
from spacedrive_tpu_torch.server.replica import ReplicaRouter, covers, encode_reply, serve_query
from spacedrive_tpu_torch.sync.ingest import Ingester
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

# -- wire framing -------------------------------------------------------------


def test_header_query_roundtrip():
    async def main():
        h = Header.query("lib-1", "search.objectsCount", {"take": 5}, {"pub-a": 7, "pub-b": 0})
        reader = asyncio.StreamReader()
        reader.feed_data(h.to_bytes())
        reader.feed_eof()
        back = await Header.from_stream(reader)
        assert back.kind == H_QUERY
        assert back.payload == {"library_id": "lib-1", "key": "search.objectsCount",
                                "arg": {"take": 5}, "require": {"pub-a": 7, "pub-b": 0}}

    asyncio.run(main())


# -- the eligibility rule -----------------------------------------------------


def test_covers_requires_every_positive_floor():
    assert covers({"a": 5, "b": 9}, {"a": 5, "b": 3})
    assert covers({"a": 5}, {"a": 5, "b": 0})   # floor 0: no writes seen
    assert covers({}, {})
    assert not covers({"a": 4}, {"a": 5})       # lagging one origin
    assert not covers({"b": 99}, {"a": 1})      # missing an origin
    assert covers({"a": 1}, {"a": 1, "a2": -3})  # non-positive floors skip


# -- serve_query on a two-node pair --------------------------------------------


def _emit(lib, n, prefix="t"):
    """n (tag, object) create pairs, logged and materialized at once."""
    ops, rows = [], []
    for i in range(n):
        tp, op = f"{prefix}-tag{i}", f"{prefix}-obj{i}"
        ops.append(lib.sync.shared_create(Tag, tp, {"name": tp}))
        ops.append(lib.sync.shared_create(Object, op, {"kind": i % 5}))
        rows.append((tp, op, i % 5))

    def _mat(db, rows=rows):
        for tp, op, kind in rows:
            db.insert(Tag, {"pub_id": tp, "name": tp})
            db.insert(Object, {"pub_id": op, "kind": kind})

    lib.sync.write_ops(ops, _mat)


def _mirror(src_lib, dst_lib):
    ing = Ingester(dst_lib, peer="replica-test-src")
    while True:
        ops, more = src_lib.sync.get_ops(dst_lib.sync.timestamps(), 500)
        if ops:
            with ing.session():
                ing.receive(ops)
        if not more and not ops:
            return


@pytest.fixture()
def pair(tmp_path, monkeypatch):
    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    a = Node(tmp_path / "a", device="cpu", watch_locations=False)
    b = Node(tmp_path / "b", device="cpu", watch_locations=False)
    la = a.libraries.create("replica-src")
    lb = b.libraries.create("replica-dst")
    for lib in (la, lb):
        lib.sync.emit_messages = True
    la.add_remote_instance(lb.instance())
    lb.add_remote_instance(la.instance())
    replica.reset_counts()
    try:
        yield a, la, b, lb
    finally:
        faults.clear()
        a.shutdown()
        b.shutdown()


def test_serve_query_gates_on_watermark_then_serves_identical_bytes(pair):
    a, la, b, lb = pair
    _emit(la, 8)
    require = dict(la.sync.timestamps())
    # the replica has not applied the writes: it refuses, never serving
    # the empty table from before the watermark
    q = {"library_id": lb.id, "key": "search.objectsCount", "arg": {}, "require": require}
    reply = serve_query(b, q)
    assert reply["ok"] is False and reply["kind"] == "not_eligible"
    assert not covers(reply["watermark"], require)
    _mirror(la, lb)
    reply = serve_query(b, q)
    assert reply["ok"] is True
    local = encode_reply(a.router.procedures["search.objectsCount"].fn(a, la, {}))
    assert reply["raw"] == local == b"8"
    assert replica.STATS["serves_not_eligible"] == 1 and replica.STATS["serves_ok"] == 1


def test_serve_query_rejects_non_pool_and_unknown_library(pair):
    a, la, b, lb = pair
    reply = serve_query(b, {"library_id": lb.id, "key": "libraries.list", "arg": None,
                            "require": {}})
    assert reply["ok"] is False and reply["kind"] == "error"
    # replica=False (libraries.statistics) is refused though pool-marked
    reply = serve_query(b, {"library_id": lb.id, "key": "libraries.statistics", "arg": None,
                            "require": {}})
    assert reply["ok"] is False and reply["kind"] == "error"
    reply = serve_query(b, {"library_id": "nope", "key": "search.objectsCount", "arg": None,
                            "require": {}})
    assert reply["ok"] is False and reply["kind"] == "not_eligible"
    assert reply["watermark"] == {}


def test_serve_query_fault_seam(pair):
    a, la, b, lb = pair
    _emit(la, 2)
    _mirror(la, lb)
    q = {"library_id": lb.id, "key": "search.objectsCount", "arg": {},
         "require": dict(la.sync.timestamps())}
    faults.install("replica_serve:eio:once")
    reply = serve_query(b, q)
    assert reply["ok"] is False and reply["kind"] == "error"
    faults.clear()
    faults.install("replica_serve:busy:once")
    reply = serve_query(b, q)
    assert reply["ok"] is False and reply["kind"] == "busy"
    assert reply["retry_after_ms"] > 0
    faults.clear()
    reply = serve_query(b, q)
    assert reply["ok"] is True and reply["raw"] == b"2"
    # every admission was released
    assert b.ingest_budget.status()["ops_in_flight"] == 0


def test_serve_query_through_the_replicas_pool_with_the_seam_inside(pair, monkeypatch):
    """With a reader pool armed on the replica, the pool serves the query
    and the ``replica_serve`` seam fires inside the worker: a kill there
    takes the worker down, never the node, and the client gets an error
    to fall over on."""
    from spacedrive_tpu_torch.server.pool import ReaderPool

    a, la, b, lb = pair
    _emit(la, 3)
    _mirror(la, lb)
    q = {"library_id": lb.id, "key": "search.objectsCount", "arg": {},
         "require": dict(la.sync.timestamps())}
    faults.install("replica_serve:kill:once")
    b.reader_pool = ReaderPool(b, workers=1).start()
    faults.clear()  # this process keeps no plan: only the worker has it
    reply = serve_query(b, q)
    assert reply["ok"] is False and reply["kind"] == "error"
    assert "replica pool unavailable" in reply["error"]
    assert b.reader_pool.status()["restarts"] == 1
    # the respawned worker got the plan anew at its spawn: nothing armed now
    import time

    deadline = time.monotonic() + 10
    while b.reader_pool.status()["alive"] < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    reply = serve_query(b, q)
    assert reply == {"ok": True, "raw": b"3"}


# -- the router's routing policy -------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _router(node, replies, clock=None):
    """A ReplicaRouter over scripted per-peer transports: ``replies`` maps
    peer -> callable() -> reply dict (or raising)."""
    r = ReplicaRouter(node, lambda lib: list(replies),
                      lambda peer, payload, nbytes: replies[peer]())
    if clock is not None:
        r._clock = clock
    return r


def _ok(value=1):
    raw = json.dumps(value).encode()
    return lambda: {"ok": True, "raw": raw}


def test_router_serves_raw_page_and_tracks_ewma(pair):
    a, la, _b, _lb = pair
    r = _router(a, {"p1": _ok(41)}, _Clock())
    got = r.dispatch("search.objectsCount", {}, la.id)
    assert isinstance(got, RawJson) and got.decode() == 41
    st = r.status()
    assert st["dispatches"] == 1
    (peer_stats,) = st["peers"].values()
    assert peer_stats["fails"] == 0
    assert replica.STATS["dispatches_ok"] == 1


def test_router_not_eligible_cooldown_then_recovery(pair):
    a, la, _b, _lb = pair
    clock = _Clock()
    calls = {"n": 0}

    def flappy():
        calls["n"] += 1
        if calls["n"] == 1:
            return {"ok": False, "kind": "not_eligible", "watermark": {}}
        return {"ok": True, "raw": b"7"}

    r = _router(a, {"p1": flappy}, clock)
    assert r.dispatch("k", {}, la.id) is None
    assert replica.STATS["failovers_not_eligible"] == 1
    assert replica.STATS["eligibility_rejections"] == 1
    # inside the cooldown: the peer is not even asked
    assert r.dispatch("k", {}, la.id) is None
    assert calls["n"] == 1
    clock.t += 1.0
    got = r.dispatch("k", {}, la.id)
    assert isinstance(got, RawJson) and got.data == b"7"


def test_router_busy_honors_retry_after(pair):
    a, la, _b, _lb = pair
    clock = _Clock()

    def busy():
        raise PeerBusyError("replica shed", retry_after_ms=2000)

    r = _router(a, {"p1": busy}, clock)
    assert r.dispatch("k", {}, la.id) is None
    assert replica.STATS["dispatches_busy"] == 1
    clock.t += 1.0  # inside retry_after: still cooling
    assert r.dispatch("k", {}, la.id) is None
    assert r.status()["peers"]
    assert replica.STATS["failovers_no_peers"] >= 1
    clock.t += 1.5
    assert r.dispatch("k", {}, la.id) is None
    assert replica.STATS["dispatches_busy"] == 2


def test_router_transport_error_backs_off_exponentially(pair):
    a, la, _b, _lb = pair
    clock = _Clock()
    calls = {"n": 0}

    def dead():
        calls["n"] += 1
        raise ConnectionError("partitioned")

    r = _router(a, {"p1": dead}, clock)
    assert r.dispatch("k", {}, la.id) is None
    assert calls["n"] == 1
    assert r.dispatch("k", {}, la.id) is None  # cooling: not dialed again
    assert calls["n"] == 1
    clock.t += 10.0
    assert r.dispatch("k", {}, la.id) is None
    assert calls["n"] == 2
    (peer_stats,) = r.status()["peers"].values()
    assert peer_stats["fails"] == 2
    # the backoff doubles: 0.2 s, then 0.4 s
    assert peer_stats["cooldown_s"] == pytest.approx(0.4)


def test_router_prefers_faster_peer_and_fails_over_between_them(pair):
    a, la, _b, _lb = pair
    clock = _Clock()
    served = {"fast": 0, "slow": 0}

    def fast():
        clock.t += 0.01
        served["fast"] += 1
        return {"ok": True, "raw": b"1"}

    def slow():
        clock.t += 0.5
        served["slow"] += 1
        return {"ok": True, "raw": b"1"}

    r = _router(a, {"fast": fast, "slow": slow}, clock)
    for _ in range(12):
        assert r.dispatch("k", {}, la.id) is not None
    assert served["fast"] > served["slow"]

    def fast_dead():
        raise ConnectionError("cut")

    # the fast peer dies: the same dispatch fails over to the slow one
    r2 = _router(a, {"fast": fast_dead, "slow": slow}, clock)
    assert isinstance(r2.dispatch("k", {}, la.id), RawJson)


def test_router_silent_when_rung_not_armed(pair):
    a, la, _b, _lb = pair
    r = ReplicaRouter(a, lambda lib: [], lambda *args: None)
    assert r.dispatch("k", {}, la.id) is None
    assert r.dispatch("k", {}, None) is None
    assert not any(k.startswith("failovers_") for k in replica.STATS)


# -- the whole ladder through router.resolve ---------------------------------------


def test_resolve_ladder_replica_then_inprocess(pair):
    a, la, b, lb = pair
    _emit(la, 5)
    _mirror(la, lb)

    def transport(peer, payload, nbytes):
        return serve_query(b, dict(payload, library_id=lb.id), peer="test-client")

    a.replica_router = ReplicaRouter(a, lambda lib: ["peer-b"], transport)
    try:
        assert a.router.resolve("search.objectsCount", {}, library_id=la.id) == 5
        assert last_rung() == "replica"
        assert replica.STATS["dispatches_ok"] == 1
        # a new local write: the replica is not eligible, the ladder goes
        # on and the answer is fresh
        _emit(la, 1, prefix="late")
        assert a.router.resolve("search.objectsCount", {}, library_id=la.id) == 6
        assert last_rung() == "in_process"
        assert replica.STATS["failovers_not_eligible"] == 1
        # non-pool queries never reach the replica rung
        assert isinstance(a.router.resolve("libraries.list", None), list)
        assert replica.STATS["dispatches_ok"] == 1
    finally:
        a.replica_router = None


def test_resolve_replica_false_skips_replica_rung(pair):
    a, la, _b, _lb = pair

    def exploding(peer, payload, nbytes):
        raise AssertionError("the replica rung must not be consulted")

    a.replica_router = ReplicaRouter(a, lambda lib: ["peer-b"], exploding)
    try:
        res = a.router.resolve("libraries.statistics", None, library_id=la.id)
        assert "total_object_count" in res
        assert last_rung() == "in_process"
    finally:
        a.replica_router = None


def test_answers_with_node_local_ids_stay_off_the_replica_tier(pair):
    """Row ids are each node's own: B numbers A's tags after a tag of its
    own, so B's tags.list names other ids than A's. Every pool query whose
    answer or argument names row ids (or reads tables sync does not copy)
    is ``replica=False``: the ladder serves it in process and a replica
    refuses it; a count filtered by a location or tag id stays local too."""
    from spacedrive_tpu_torch.api.router import LOCAL_ID_ARGS, names_local_ids

    a, la, b, lb = pair
    lb.db.insert(Tag, {"pub_id": "b-only", "name": "b-only"})  # B's ids shift
    _emit(la, 3)
    _mirror(la, lb)
    ids = {n: {t["name"]: t["id"] for t in n.router.procedures["tags.list"].fn(n, lib, None)}
           for n, lib in ((a, la), (b, lb))}
    assert ids[a] != {k: v for k, v in ids[b].items() if k in ids[a]}  # the fault itself
    replicable = sorted(k for k, p in a.router.procedures.items() if p.pool and p.replica)
    assert replicable == ["categories.list", "preferences.get", "search.objectsCount",
                          "search.pathsCount"]
    asked: list = []

    def transport(peer, payload, nbytes):
        asked.append(payload["key"])
        return serve_query(b, dict(payload, library_id=lb.id), peer="test-client")

    a.replica_router = ReplicaRouter(a, lambda lib: ["peer-b"], transport)
    try:
        assert a.router.resolve("tags.list", None, la.id) == sorted(
            a.router.procedures["tags.list"].fn(a, la, None), key=lambda t: t["name"])
        assert last_rung() == "in_process"
        for arg in ({"location_id": 1}, {"tags": [1]}):
            assert names_local_ids(arg)
            a.router.resolve("search.pathsCount", arg, la.id)
            assert last_rung() == "in_process"
        assert asked == []
        assert a.router.resolve("search.objectsCount", None, la.id) == 3
        assert last_rung() == "replica" and asked == ["search.objectsCount"]
    finally:
        a.replica_router = None
    require = dict(la.sync.timestamps())
    for key, arg in [("tags.list", None), ("search.paths", {"take": 5}), ("files.get", 1),
                     ("search.pathsCount", {"location_id": 1}),
                     ("search.pathsCount", {"tags": [2]})]:
        reply = serve_query(b, {"library_id": lb.id, "key": key, "arg": arg, "require": require})
        assert reply["ok"] is False and reply["kind"] == "error", (key, arg)
    assert LOCAL_ID_ARGS == ("location_id", "tags")
    assert not names_local_ids({"location_id": None, "tags": [], "search": "x"})


def test_serve_query_prefers_the_device_index_over_the_pool(pair, monkeypatch):
    """A replica that runs a pool serves a query its device index will
    answer in its own process (the index lives there), and the rest in
    its pool; the reference sends both to the pool."""
    from spacedrive_tpu_torch.models import FilePath, Location
    from spacedrive_tpu_torch.search.engine import SearchEngine
    from spacedrive_tpu_torch.server import pool as pool_mod
    from spacedrive_tpu_torch.server.pool import ReaderPool

    a, la, b, lb = pair
    loc = lb.db.insert(Location, {"pub_id": "loc-b", "name": "b", "path": "/b"})
    lb.db.insert_many(FilePath, [
        {"pub_id": f"fp-{i:03d}", "location_id": loc, "materialized_path": "/",
         "name": f"photo-{i:03d}" if i % 2 else f"note-{i:03d}", "extension": "jpg",
         "is_dir": 0, "size_in_bytes": i} for i in range(40)])
    engine = b.search_engine = SearchEngine(b)
    b.reader_pool = ReaderPool(b, workers=1).start()
    try:
        arg = {"search": "photo"}
        engine.prefers_inprocess("search.pathsCount", lb.id, arg)  # first sighting
        engine.refresh_now(lb)
        assert engine.prefers_inprocess("search.pathsCount", lb.id, arg)
        pool_mod.reset_counts()
        served_before = engine.status()["served"]
        q = {"library_id": lb.id, "key": "search.pathsCount", "arg": arg, "require": {}}
        assert serve_query(b, q) == {"ok": True, "raw": b"20"}
        assert engine.status()["served"] == served_before + 1
        assert pool_mod.STATS["requests_ok"] == 0
        q = {"library_id": lb.id, "key": "search.objectsCount", "arg": None, "require": {}}
        assert serve_query(b, q) == {"ok": True, "raw": b"0"}
        assert pool_mod.STATS["requests_ok"] == 1
    finally:
        b.reader_pool.stop()
        b.reader_pool = None
        engine.stop()
        b.search_engine = None


def test_tenant_labels_equal_the_reference(monkeypatch):
    """``tenant_label`` is the reference's: 8 hex characters of blake2s,
    ``local`` without a library, ``other`` once ``SD_TENANT_LABEL_CAP``
    libraries hold a label, and a labelled library keeps its label."""
    from spacedrive_tpu.telemetry import slo
    from spacedrive_tpu_torch.sync import admission

    monkeypatch.setenv("SD_TENANT_LABEL_CAP", "3")
    admission.reset_tenant_labels()
    slo.reset_tenant_labels()
    try:
        script = [None, "lib-a", "lib-b", "lib-a", "lib-c", "lib-d", "", "lib-b", "lib-e"]
        got = [admission.tenant_label(x) for x in script]
        assert got == [slo.tenant_label(x) for x in script]
        assert got[4] != "other" and got[5] == got[8] == "other" and got[0] == got[6] == "local"
    finally:
        admission.reset_tenant_labels()
        slo.reset_tenant_labels()


def test_replica_false_is_only_for_pool_queries(pair):
    a, _la, _b, _lb = pair
    with pytest.raises(ValueError):
        a.router.library_query("x.y", replica=False)(lambda node, lib, arg: None)


# -- a port node and a JAX node over loopback TCP -----------------------------------


def test_a_port_node_and_a_jax_node_serve_each_others_queries(tmp_path, monkeypatch):
    """Paired over the encrypted wire into one library, with tags made on
    the port's side synced to the JAX node: each node's ``H_QUERY`` answer
    is its own local page, byte for byte, and equals the asker's own; the
    port's ``router.resolve`` takes the replica rung to the JAX node."""
    pytest.importorskip("cryptography")
    from spacedrive_tpu.node import Node as JaxNode
    from tests.torch_p2p_cases import wait_for

    monkeypatch.delenv("SD_P2P_DISABLED", raising=False)
    jax = JaxNode(tmp_path / "jax", probe_accelerator=False, watch_locations=False)
    port = Node(tmp_path / "port", device="cpu", watch_locations=False)
    try:
        for node in (jax, port):
            node.router.resolve("toggleFeatureFlag", "syncEmitMessages")
        lib_j = jax.libraries.create("jax-side")
        jax.config.write(p2p_auto_accept_library=lib_j.id)
        port.router.resolve("p2p.pair", {"peer_id": f"127.0.0.1:{jax.p2p.port}"})
        lib_p = wait_for(lambda: next((x for x in port.libraries.list() if x.id == lib_j.id),
                                      None), msg="the port's mirror of the JAX library")
        for name in ("red", "green", "blue"):
            port.router.resolve("tags.create", {"name": name, "color": "#123"}, lib_p.id)
        jax_ident = jax.p2p.remote_identity.encode()
        port_ident = port.p2p.remote_identity.encode()
        wait_for(lambda: len(lib_j.db.query("SELECT id FROM tag")) == 3, timeout=30,
                 msg="the tags on the JAX node")
        wait_for(lambda: covers(lib_j.sync.timestamps(), lib_p.sync.require_watermark())
                 and covers(lib_p.sync.timestamps(), lib_j.sync.require_watermark()),
                 timeout=30, msg="each node eligible for the other")
        assert port.p2p.query_peers(lib_p.id) == [jax_ident]
        assert jax.p2p.query_peers(lib_j.id) == [port_ident]
        cases = [("search.objectsCount", None), ("search.pathsCount", {"search": "e"}),
                 ("categories.list", None), ("preferences.get", None)]
        for key, arg in cases:
            local = {"port": encode_reply(port.router.procedures[key].fn(port, lib_p, arg)),
                     "jax": encode_reply(jax.router.procedures[key].fn(jax, lib_j, arg))}
            assert local["port"] == local["jax"], key
            # the port asks the JAX node, and the JAX node the port
            got = port.p2p.run_coro(port.p2p.request_query(jax_ident, {
                "library_id": lib_p.id, "key": key, "arg": arg,
                "require": lib_p.sync.require_watermark()}), timeout=20)
            assert got == {"ok": True, "raw": local["jax"]}, key
            got = jax.p2p.run_coro(jax.p2p.request_query(port_ident, {
                "library_id": lib_j.id, "key": key, "arg": arg,
                "require": lib_j.sync.require_watermark()}), timeout=20)
            assert got == {"ok": True, "raw": local["port"]}, key
        replica.reset_counts()
        want = json.loads(encode_reply(port.router.procedures["categories.list"].fn(
            port, lib_p, None)))
        assert port.router.resolve("categories.list", None, lib_p.id) == want
        assert last_rung() == "replica" and replica.STATS["dispatches_ok"] == 1
        # a query the JAX node's replica may not answer: refused over the wire
        got = port.p2p.run_coro(port.p2p.request_query(jax_ident, {
            "library_id": lib_p.id, "key": "libraries.statistics", "arg": None,
            "require": {}}), timeout=20)
        assert got["ok"] is False and got["kind"] == "error"
        # the port refuses a page naming its row ids, which the JAX replica
        # serves with its own (ROADMAP Queue 3)
        for key, arg in (("tags.list", None), ("search.paths", {"take": 10})):
            got = jax.p2p.run_coro(jax.p2p.request_query(port_ident, {
                "library_id": lib_j.id, "key": key, "arg": arg,
                "require": lib_j.sync.require_watermark()}), timeout=20)
            assert got["ok"] is False and got["kind"] == "error", key
            got = port.p2p.run_coro(port.p2p.request_query(jax_ident, {
                "library_id": lib_p.id, "key": key, "arg": arg,
                "require": lib_p.sync.require_watermark()}), timeout=20)
            assert got["ok"] is True, key
    finally:
        port.shutdown()
        jax.shutdown()


# -- admission at dispatch --------------------------------------------------------


def test_dispatch_budget_verdicts_equal_jax():
    from spacedrive_tpu.sync.admission import Busy as JaxBusy
    from spacedrive_tpu.sync.admission import DispatchBudget as JaxBudget
    from spacedrive_tpu.telemetry.slo import tenant_label as jax_tenant_label
    from spacedrive_tpu_torch.sync.admission import Busy, DispatchBudget, tenant_label

    tenants = [None] + [f"lib-{i}" for i in range(4)]
    assert [tenant_label(t) for t in tenants] == [jax_tenant_label(t) for t in tenants]
    rng = random.Random(19)
    budgets = {"port": DispatchBudget(6), "jax": JaxBudget(6)}
    held: dict = {"port": [], "jax": []}
    trace: dict = {"port": [], "jax": []}
    for _ in range(400):
        if held["port"] and rng.random() < 0.45:
            i = rng.randrange(len(held["port"]))
            for pkg in budgets:
                held[pkg].pop(i).release()
            continue
        tenant = tenant_label(rng.choice(tenants))
        for pkg, busy_cls in (("port", Busy), ("jax", JaxBusy)):
            v = budgets[pkg].try_admit(tenant)
            if isinstance(v, busy_cls):
                trace[pkg].append(("busy", v.retry_after_ms, v.reason))
            else:
                held[pkg].append(v)
                trace[pkg].append(("admit", tenant))
            trace[pkg].append(budgets[pkg].status())
    assert trace["port"] == trace["jax"]
    assert sum(t[0] == "busy" for t in trace["port"] if isinstance(t, tuple)) > 10
    for pkg in budgets:
        for v in held[pkg]:
            v.release()
        assert budgets[pkg].status()["in_flight"] == 0


def test_a_shed_dispatch_answers_429_on_every_transport(tmp_path, monkeypatch):
    from spacedrive_tpu.faults import clear as jax_faults_clear
    from spacedrive_tpu.faults import install as jax_faults_install
    from spacedrive_tpu.node import Node as JaxNode
    from spacedrive_tpu.server.shell import Server as JaxServer
    from spacedrive_tpu_torch.server import Server
    from tests.torch_serve_client import WsClient, get, post

    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    monkeypatch.setenv("SD_RSPC_RETRY_AFTER_MS", "1500")
    port = Node(tmp_path / "port", device="cpu", watch_locations=False)
    lib = port.libraries.create("busy")
    server = Server(port, "127.0.0.1", 0)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        assert port.dispatch_budget.base_retry_after_ms == 1500
        status, _h, body = get(url, f"/rspc/tags.list?library_id={lib.id}")
        assert status == 200 and json.loads(body) == {"result": []}
        faults.install("rspc_admission:eio")
        status, headers, body = get(url, f"/rspc/tags.list?library_id={lib.id}")
        assert status == 429 and headers["retry-after"] == "2"
        assert json.loads(body)["retry_after_ms"] == 1500
        status, body = post(url, "/rspc/tags.list", {"arg": None, "library_id": lib.id})
        assert status == 429 and json.loads(body)["retry_after_ms"] == 1500
        ws = WsClient("127.0.0.1", server.port)
        try:
            msg = ws.call("query", "tags.list", {"library_id": lib.id, "arg": None})
        finally:
            ws.close()
        assert msg["result"]["type"] == "error"
        assert msg["result"]["data"]["code"] == 429
        assert msg["result"]["data"]["retry_after_ms"] == 1500
        # telemetry.* is exempt from admission (no such procedure here: 404)
        faults.clear()
        status, _h, _b = get(url, f"/rspc/tags.list?library_id={lib.id}")
        assert status == 200
        budget = port.dispatch_budget.status()
        assert budget["in_flight"] == 0 and budget["shed"] == 3
    finally:
        faults.clear()
        server.stop()
        port.shutdown()
    # the reference's shell answers the same shed 400
    jax = JaxNode(tmp_path / "jax", probe_accelerator=False, watch_locations=False)
    jax_lib = jax.libraries.create("busy")
    jax_server = JaxServer(jax, "127.0.0.1", 0)
    jax_server.start()
    try:
        jax_faults_install("rspc_admission:eio")
        status, headers, body = get(f"http://127.0.0.1:{jax_server.port}",
                                    f"/rspc/tags.list?library_id={jax_lib.id}")
        assert status == 400 and "retry-after" not in headers
    finally:
        jax_faults_clear()
        jax_server.stop()
        jax.shutdown()
