"""The port's CRDT sync (spacedrive_tpu_torch/sync) against the JAX
package's, on the CPU.

- The clock and the wire: ``ntp64`` / ``to_unix``, ``HLC.now`` / ``update``
  on one patched wall clock, and ``CRDTOperation.to_wire`` / ``from_wire``
  (malformed wires included) give equal values in both packages, from a
  fixed seed; the instance identity routes (``cryptography`` and the
  pure-Python copy) derive the JAX package's public keys.
- Each behaviour case of ``tests/test_sync.py`` (LWW and stale rejection,
  tombstones, relation ops, poison caps, malformed and absurd ops,
  cross-kind arrival order, the pull Actor) runs on a pair of port
  libraries and on a pair of JAX libraries (two libraries of one node per
  package, paired by hand, emission on through the ``syncEmitMessages``
  feature flag), with equal outcomes.
- Mixed pairs: a JAX library's operations (a scan, tags, a note, a
  favorite, preferences) ingested by a port library, and the reverse, end
  in equal rows (``tests/torch_sync_cases.synced_rows``). The JAX
  package's object creates carry the time of their commit as
  ``date_created``, which no row of the emitting side has, and its tag
  creates leave ``date_modified`` out, so objects and tags are compared
  without those columns in that direction only.
- A scan of one seeded tree by a JAX node and a port node logs the same
  multiset of operations (``op_log``: op ids, HLC timestamps and instances
  dropped, pub_ids mapped to paths, dates to ``<date>``).
- Port only: ``IngestLanes`` at 4 lanes gives the rows of 1 lane; an
  orphan-remover tick planted inside a pull round waits for the round, so
  no ingested object loses its files' links; a ``log_ops`` that raises
  rolls its write back; an Actor whose pull raises keeps the exception and
  stops.
"""

import itertools
import json
import time
import types

import numpy as np
import pytest

import spacedrive_tpu.models as jax_models
import spacedrive_tpu.sync as jax_sync
from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations import scan_location as jax_scan_location
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.objects import tags as jax_tags
from spacedrive_tpu.p2p import identity as jax_identity
from spacedrive_tpu.sync import crdt as jax_crdt
from spacedrive_tpu.sync import hlc as jax_hlc
from spacedrive_tpu import preferences as jax_preferences

import spacedrive_tpu_torch.models as port_models
import spacedrive_tpu_torch.sync as port_sync
from spacedrive_tpu_torch import preferences as port_preferences
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects import tags as port_tags
from spacedrive_tpu_torch.p2p import ed25519_ref
from spacedrive_tpu_torch.p2p import identity as port_identity
from spacedrive_tpu_torch.sync import crdt as port_crdt
from spacedrive_tpu_torch.sync import hlc as port_hlc
from tests.torch_scan_cases import make_tree, one_torch_thread  # noqa: F401
from tests.torch_sync_cases import op_log, pair_libraries, pub_keys, synced_rows

EMIT = "syncEmitMessages"


def _pkg(models, sync, crdt, hlc, create, scan, tags, prefs):
    return types.SimpleNamespace(
        Tag=models.Tag, Object=models.Object, TagOnObject=models.TagOnObject,
        FilePath=models.FilePath, Location=models.Location, Instance=models.Instance,
        SharedOperationRow=models.SharedOperationRow, Ingester=sync.Ingester,
        Actor=sync.Actor, SyncMessage=sync.SyncMessage, ref=crdt.ref, ntp64=hlc.ntp64,
        create_location=create, scan_location=scan, tags=tags, preferences=prefs)


PKGS = {
    "jax": _pkg(jax_models, jax_sync, jax_crdt, jax_hlc, jax_create_location,
                jax_scan_location, jax_tags, jax_preferences),
    "port": _pkg(port_models, port_sync, port_crdt, port_hlc, create_location,
                 scan_location, port_tags, port_preferences),
}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """One node of each package, emission on through the feature flag
    before any library exists."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SD_P2P_DISABLED", "1")
    base = tmp_path_factory.mktemp("sync")
    out = {"jax": JaxNode(base / "jax", probe_accelerator=False, watch_locations=False),
           "port": Node(base / "port", device="cpu", watch_locations=False)}
    try:
        for node in out.values():
            assert node.config.toggle_feature(EMIT) is True
        yield out
    finally:
        out["jax"].shutdown()
        out["port"].shutdown()
        mp.undo()


def fresh_pair(node, name: str):
    """Two paired libraries of ``node``, both emitting."""
    a = node.libraries.create(f"{name}-a")
    b = node.libraries.create(f"{name}-b")
    assert a.sync.emit_messages and b.sync.emit_messages
    pair_libraries(a, b)
    return a, b


def pump(P, src, dst, batch=100):
    """One full pull round: dst pulls everything new from src."""
    ingester = P.Ingester(dst)
    total = 0
    while True:
        ops, has_more = src.sync.get_ops(dst.sync.timestamps(), batch)
        total += ingester.receive(ops)
        if not has_more:
            return total


def tag_row(P, lib, pub):
    row = lib.db.find_one(P.Tag, {"pub_id": pub})
    return None if row is None else (row["name"], row["color"])


def count(lib, table: str) -> int:
    return lib.db.query(f"SELECT COUNT(*) AS n FROM {table}")[0]["n"]


# -- the clock and the wire ----------------------------------------------------


def test_clock_and_wire_match_jax(monkeypatch):
    rng = np.random.default_rng(16)
    seconds = rng.uniform(1.6e9, 2.0e9, 64).tolist() + [0.0, 1.5, 2 ** 31 + 0.25]
    for t in seconds:
        assert port_hlc.ntp64(t) == jax_hlc.ntp64(t)
        assert port_hlc.to_unix(port_hlc.ntp64(t)) == jax_hlc.to_unix(jax_hlc.ntp64(t))
    # both clocks on one patched wall clock: the same stamps, the same
    # verdicts on remote stamps (poisonous ones included)
    now = [1.75e9]
    monkeypatch.setattr(time, "time", lambda: now[0])
    clocks = [m.HLC(int(rng.integers(0, 1 << 62))) for m in (jax_hlc, port_hlc)]
    clocks += [m.HLC() for m in (jax_hlc, port_hlc)]
    remote = [jax_hlc.ntp64(now[0] + d) for d in (-5, 0, 60, 899, 901, 7200)]
    remote += [(1 << 63) - 1, -5, 0, "1e18", None, 1.5, True]
    for j, p in (clocks[0:2], clocks[2:4]):
        for step in range(20):
            now[0] += float(rng.uniform(0, 0.01)) if step % 3 else 0.0
            assert p.now() == j.now()
            r = remote[step % len(remote)]
            assert p.update(r) == j.update(r)
            assert p.last == j.last
    # the wire format, both ways
    for i in range(32):
        kind = ["c", "d", "u:name", "u:object_id"][i % 4]
        data = {"name": f"n{i}", "size_in_bytes": int(rng.integers(0, 1 << 40)),
                "location_id": {"__ref__": ["location", f"loc-{i}"]}} if kind == "c" else (
            None if kind == "d" else f"v{i}")
        ops, ts = [], int(rng.integers(1, 1 << 62))
        for m in (jax_crdt, port_crdt):
            typ = (m.SharedOp("file_path", f"rec-{i}", kind, data) if i % 5 else
                   m.RelationOp("tag_on_object", f"t{i}", f"o{i}", kind, data))
            ops.append(m.CRDTOperation(f"inst-{i % 3}", ts, f"op-{i}", typ))
        assert ops[1].to_wire() == ops[0].to_wire()
        assert port_crdt.CRDTOperation.from_wire(ops[0].to_wire()).to_wire() == ops[0].to_wire()
        assert jax_crdt.CRDTOperation.from_wire(ops[1].to_wire()).to_wire() == ops[1].to_wire()
    good = ops[1].to_wire()
    bad = [{"not": "an op"}, {"typ": {"_t": "mystery"}},
           {**good, "timestamp": "NaN"}, {**good, "timestamp": True}, {**good, "id": 7},
           {**good, "typ": {**good["typ"], "kind": "x"}},
           {**good, "typ": {**good["typ"], "extra": 1}},
           {"instance": "i", "timestamp": 1, "id": "x",
            "typ": {"_t": "shared", "model": 42, "record_id": "r", "kind": "c", "data": {}}}]
    for wire in bad:
        verdicts = []
        for m in (jax_crdt, port_crdt):
            try:
                m.CRDTOperation.from_wire(wire)
                verdicts.append("ok")
            except (ValueError, TypeError, KeyError) as e:
                verdicts.append(type(e).__name__)
        assert verdicts[1] == verdicts[0] and verdicts[0] != "ok", wire


def test_identity_routes_derive_the_jax_keys():
    rng = np.random.default_rng(17)
    for _ in range(4):
        seed = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        want = jax_identity.Identity.from_seed(seed)
        got = port_identity.Identity.from_seed(seed)
        assert ed25519_ref.public_key(seed) == want.to_remote_identity().public_bytes
        assert got.to_remote_identity().encode() == want.to_remote_identity().encode()
        assert port_identity.encode_identity(got) == jax_identity.encode_identity(want)
        assert port_identity.encode_identity(got.to_remote_identity()) == \
            jax_identity.encode_identity(want.to_remote_identity())
    fresh = port_identity.Identity()
    assert jax_identity.decode_identity(port_identity.encode_identity(fresh)).seed() == \
        fresh.seed()
    with pytest.raises(ValueError):
        port_identity.Identity(b"short")
    assert port_identity.ROUTE in ("cryptography", "ed25519_ref")


# -- the behaviour cases of tests/test_sync.py ------------------------------------


def case_shared_create_propagates(P, a, b):
    pub = "11111111-1111-1111-1111-111111111111"
    op = a.sync.shared_create(P.Tag, pub, {"name": "Vacation", "color": "#ff0000"})
    a.sync.write_ops([op], lambda db: db.insert(P.Tag, {
        "pub_id": pub, "name": "Vacation", "color": "#ff0000"}))
    first = pump(P, a, b)
    return [first, tag_row(P, b, pub), pump(P, a, b)]


def case_lww_update_and_stale_rejection(P, a, b):
    pub = "22222222-2222-2222-2222-222222222222"
    a.sync.write_ops([a.sync.shared_create(P.Tag, pub, {"name": "old"})],
                     lambda db: db.insert(P.Tag, {"pub_id": pub, "name": "old"}))
    newer = a.sync.shared_update(P.Tag, pub, "name", "newer")
    a.sync.write_ops([newer], lambda db: db.update(P.Tag, {"pub_id": pub}, {"name": "newer"}))
    out = [pump(P, a, b), tag_row(P, b, pub)]
    stale = a.sync.shared_update(P.Tag, pub, "name", "stale")
    stale.timestamp = newer.timestamp - 10
    out += [P.Ingester(b).receive([stale.to_wire()]), tag_row(P, b, pub)]
    color = a.sync.shared_update(P.Tag, pub, "color", "#00ff00")
    color.timestamp = newer.timestamp - 5
    out += [P.Ingester(b).receive([color.to_wire()]), tag_row(P, b, pub)]
    return out


def case_shared_delete_propagates(P, a, b):
    pub = "33333333-3333-3333-3333-333333333333"
    a.sync.write_ops([a.sync.shared_create(P.Tag, pub, {"name": "gone"})],
                     lambda db: db.insert(P.Tag, {"pub_id": pub, "name": "gone"}))
    out = [pump(P, a, b), tag_row(P, b, pub)]
    a.sync.write_ops([a.sync.shared_delete(P.Tag, pub)],
                     lambda db: db.delete(P.Tag, {"pub_id": pub}))
    return out + [pump(P, a, b), tag_row(P, b, pub)]


def case_relation_ops_propagate(P, a, b):
    tag_pub, obj_pub = "aaaa", "bbbb"
    a.sync.write_ops(
        [a.sync.shared_create(P.Tag, tag_pub, {"name": "t"}),
         a.sync.shared_create(P.Object, obj_pub, {"kind": 5})],
        lambda db: (db.insert(P.Tag, {"pub_id": tag_pub, "name": "t"}),
                    db.insert(P.Object, {"pub_id": obj_pub, "kind": 5})))
    tid = a.db.find_one(P.Tag, {"pub_id": tag_pub})["id"]
    oid = a.db.find_one(P.Object, {"pub_id": obj_pub})["id"]
    a.sync.write_ops([a.sync.relation_create(P.TagOnObject, tag_pub, obj_pub)],
                     lambda db: db.insert(P.TagOnObject, {"tag_id": tid, "object_id": oid}))
    out = [pump(P, a, b), count(b, "tag_on_object"),
           b.db.find_one(P.Object, {"pub_id": obj_pub})["kind"]]
    a.sync.write_ops([a.sync.relation_delete(P.TagOnObject, tag_pub, obj_pub)],
                     lambda db: db.delete(P.TagOnObject, {"tag_id": tid, "object_id": oid}))
    return out + [pump(P, a, b), count(b, "tag_on_object")]


def case_create_after_relayed_update_not_dropped(P, a, b):
    pub = "44444444-4444-4444-4444-444444444444"
    create = a.sync.shared_create(P.Tag, pub, {"name": "orig", "color": "#123456"})
    update = a.sync.shared_update(P.Tag, pub, "name", "renamed")
    return [P.Ingester(b).receive([update.to_wire()]),
            P.Ingester(b).receive([create.to_wire()]), tag_row(P, b, pub)]


def case_unknown_origin_instance_not_poison(P, a, b):
    ghost = "99999999-9999-9999-9999-999999999999"
    op1 = a.sync.shared_create(P.Tag, "t-ghost", {"name": "ghost"})
    op1.instance = ghost
    op2 = a.sync.shared_create(P.Tag, "t-after", {"name": "after"})
    applied = P.Ingester(b).receive([op1.to_wire(), op2.to_wire()])
    row = b.db.find_one(P.Instance, {"pub_id": ghost})
    return [applied, tag_row(P, b, "t-ghost"), tag_row(P, b, "t-after"),
            row is not None and (row["timestamp"] or 0) > 0, row["node_name"]]


def case_get_ops_pagination_and_floor(P, a, b):
    for i in range(25):
        a.sync.write_ops([a.sync.shared_create(P.Tag, f"pg-{i:02d}", {"name": f"t{i}"})],
                         lambda db, p=f"pg-{i:02d}", j=i: db.insert(
                             P.Tag, {"pub_id": p, "name": f"t{j}"}))
    seen, clocks, rounds, sizes = [], b.sync.timestamps(), 0, []
    while True:
        ops, has_more = a.sync.get_ops(clocks, 7)
        ts = [o["timestamp"] for o in ops]
        assert ts == sorted(ts)
        seen += ops
        sizes.append((len(ops), has_more))
        rounds += 1
        if not ops:
            break
        for o in ops:
            clocks[o["instance"]] = max(clocks.get(o["instance"], 0), o["timestamp"])
        if not has_more:
            break
    return [rounds, sizes, len(seen), len({o["id"] for o in seen}),
            [o["typ"]["record_id"] for o in seen], a.sync.ops_pending(b.sync.timestamps()),
            a.sync.ops_pending(clocks)]


def case_delete_tombstone_shadows_older_ops(P, a, b):
    pub = "55555555-5555-5555-5555-555555555555"
    create = a.sync.shared_create(P.Tag, pub, {"name": "t"})
    update = a.sync.shared_update(P.Tag, pub, "name", "renamed")
    delete = a.sync.shared_delete(P.Tag, pub)
    out = [P.Ingester(b).receive([update.to_wire()]), P.Ingester(b).receive([delete.to_wire()])]
    return out + [tag_row(P, b, pub), P.Ingester(b).receive([create.to_wire()]),
                  tag_row(P, b, pub)]


def case_newer_create_survives_stale_delete(P, a, b):
    pub = "66666666-6666-6666-6666-666666666666"
    delete = a.sync.shared_delete(P.Tag, pub)
    create = a.sync.shared_create(P.Tag, pub, {"name": "revived"})
    return [P.Ingester(b).receive([create.to_wire()]),
            P.Ingester(b).receive([delete.to_wire()]), tag_row(P, b, pub)]


def case_cross_kind_arrival_order_converges(P, a, b):
    pub = "77777777-7777-7777-7777-777777777777"
    ops = [a.sync.shared_create(P.Tag, pub, {"name": "v1", "color": "#111111"}),
           a.sync.shared_update(P.Tag, pub, "name", "v2"),
           a.sync.shared_delete(P.Tag, pub),
           a.sync.shared_update(P.Tag, pub, "color", "#222222")]
    results = []
    for perm in itertools.permutations(range(4)):
        lib = a.node.libraries.create("perm")
        lib.add_remote_instance(a.instance())
        ing = P.Ingester(lib)
        applied = [ing.receive([ops[i].to_wire()]) for i in perm]
        results.append([list(perm), applied, tag_row(P, lib, pub)])
    assert len({str(r[2]) for r in results}) == 1
    return results


def case_update_after_delete_rematerializes_everywhere(P, a, b):
    pub = "88888888-8888-8888-8888-888888888888"
    delete = a.sync.shared_delete(P.Tag, pub)
    update = a.sync.shared_update(P.Tag, pub, "name", "kept")
    return [P.Ingester(b).receive([update.to_wire()]),
            P.Ingester(b).receive([delete.to_wire()]), tag_row(P, b, pub)]


def case_malformed_wire_op_skipped_not_wedging(P, a, b):
    pub = "aaaaaaa1-0000-0000-0000-000000000000"
    good1 = a.sync.shared_create(P.Tag, pub, {"name": "first"})
    good2 = a.sync.shared_update(P.Tag, pub, "name", "second")
    batch = [good1.to_wire(),
             {"instance": a.sync.instance_pub_id, "timestamp": "NaN", "id": 7,
              "typ": {"_t": "mystery"}},
             {"not": "even close"}, good2.to_wire()]
    return [P.Ingester(b).receive(batch), tag_row(P, b, pub),
            b.sync.clock.last < P.ntp64(time.time() + 120)]


def case_transient_poison_op_caps_clock_floor(P, a, b):
    pub = "aaaaaaa2-0000-0000-0000-000000000000"
    before = a.sync.shared_create(P.Tag, pub, {"name": "pre"})
    poisoned = a.sync.shared_update(P.Tag, pub, "color", "#123456")
    after = a.sync.shared_update(P.Tag, pub, "name", "post")
    batch = [before.to_wire(), poisoned.to_wire(), after.to_wire()]
    real_log_ops = b.sync.log_ops

    def flaky_log_ops(ops):
        if any(o.id == poisoned.id for o in ops):
            raise RuntimeError("simulated transient DB failure")
        return real_log_ops(ops)

    b.sync.log_ops = flaky_log_ops
    ing = P.Ingester(b)
    try:
        first = ing.receive(batch)
    finally:
        b.sync.log_ops = real_log_ops
    out = [first, tag_row(P, b, pub),
           b.sync.timestamps()[a.sync.instance_pub_id] < poisoned.timestamp]
    return out + [ing.receive(batch), tag_row(P, b, pub),
                  b.sync.timestamps()[a.sync.instance_pub_id] >= after.timestamp]


def case_permanently_malformed_op_does_not_stall_link(P, a, b):
    pub = "aaaaaaa4-0000-0000-0000-000000000000"
    before = a.sync.shared_create(P.Tag, pub, {"name": "pre"})
    garbage_ts = a.sync.clock.now()
    after = a.sync.shared_update(P.Tag, pub, "name", "post")
    batch = [before.to_wire(),
             {"instance": a.sync.instance_pub_id, "timestamp": garbage_ts, "id": "broken",
              "typ": {"_t": "shared", "model": 42, "record_id": pub, "kind": "c", "data": {}}},
             after.to_wire()]
    applied = P.Ingester(b).receive(batch)
    return [applied, tag_row(P, b, pub),
            b.sync.timestamps()[a.sync.instance_pub_id] >= after.timestamp]


def case_absurd_timestamp_rejected_in_ingest(P, a, b):
    bad = a.sync.shared_create(P.Tag, "aaaaaaa3-0000-0000-0000-000000000000", {"name": "evil"})
    wire = bad.to_wire()
    wire["timestamp"] = (1 << 63) - 7
    return [P.Ingester(b).receive([wire]), b.db.find_one(P.Tag, {"name": "evil"}) is None,
            b.sync.clock.last < P.ntp64(time.time() + 120),
            b.sync.timestamps()[a.sync.instance_pub_id] < 1 << 62]


def case_create_blocked_by_foreign_unique_stays_visible(P, a, b):
    a.db.insert(P.Location, {"pub_id": "locX", "name": "l", "path": "/x"})
    loc_b = b.db.insert(P.Location, {"pub_id": "locX", "name": "l", "path": "/x"})
    b.db.insert(P.FilePath, {"pub_id": "b-local", "location_id": loc_b,
                             "materialized_path": "/", "name": "clash", "extension": "txt",
                             "is_dir": False})
    op1 = a.sync.shared_create(P.FilePath, "a-remote", {
        "location_id": P.ref("location", "locX"), "materialized_path": "/", "name": "clash",
        "extension": "txt"})
    op2 = a.sync.shared_create(P.Tag, "tag-after", {"name": "after"})
    a.sync.write_ops([op1, op2], lambda db: None)
    return [pump(P, a, b), b.db.find_one(P.FilePath, {"pub_id": "a-remote"}) is None,
            b.db.find_one(P.FilePath, {"pub_id": "b-local"}) is not None,
            b.db.find_one(P.SharedOperationRow, {"id": op1.id}) is not None,
            tag_row(P, b, "tag-after")]


def case_ingest_actor_pull_loop(P, a, b):
    import threading

    ingested = threading.Event()
    actor = P.Actor(b, transport=lambda clocks, n: a.sync.get_ops(clocks, n), batch=2)
    a.sync.subscribe(lambda msg: actor.notify() if msg == P.SyncMessage.CREATED else None)
    b.sync.subscribe(lambda msg: ingested.set() if msg == P.SyncMessage.INGESTED else None)
    for i in range(5):
        pub = f"tag-{i}"
        a.sync.write_ops([a.sync.shared_create(P.Tag, pub, {"name": f"t{i}"})],
                         lambda db, p=pub, j=i: db.insert(P.Tag, {"pub_id": p, "name": f"t{j}"}))
    assert ingested.wait(15), "the actor never ingested"
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and count(b, "tag") < 5:
        time.sleep(0.02)
    actor.stop()
    inst = b.db.find_one(P.Instance, {"pub_id": a.sync.instance_pub_id})
    return [count(b, "tag"), (inst["timestamp"] or 0) > 0,
            sorted(tag_row(P, b, f"tag-{i}")[0] for i in range(5))]


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_behaviour_matches_jax(nodes, case):
    got = {}
    for pkg in ("jax", "port"):
        a, b = fresh_pair(nodes[pkg], case)
        got[pkg] = CASES[case](PKGS[pkg], a, b)
    assert got["port"] == got["jax"]


# -- mixed pairs and the scan's operations ------------------------------------------


def emitting_session(P, lib, tree):
    """A scan of ``tree`` (preview media off, through an emitted update),
    then tags, a note, a favorite and preferences, all logged."""
    loc = P.create_location(lib, str(tree), hasher="hybrid")
    lib.sync.write_ops(
        [lib.sync.shared_update(P.Location, loc["pub_id"], "generate_preview_media", False)],
        lambda db: db.update(P.Location, {"id": loc["id"]}, {"generate_preview_media": False}))
    P.scan_location(lib, loc["id"])
    assert lib.node.jobs.wait_idle(120)
    red = P.tags.create_tag(lib, "red", "#f00")
    blue = P.tags.create_tag(lib, "blue")
    objs = [r["object_id"] for r in lib.db.query(
        "SELECT object_id FROM file_path WHERE object_id IS NOT NULL ORDER BY "
        "materialized_path, name LIMIT 3")]
    P.tags.assign_tag(lib, red["id"], objs)
    P.tags.assign_tag(lib, blue["id"], objs[:1])
    P.tags.assign_tag(lib, blue["id"], objs[:1], unassign=True)
    P.tags.update_tag(lib, blue["id"], name="navy")
    for field, value in (("note", "seen"), ("favorite", True)):
        obj = lib.db.find_one(P.Object, {"id": objs[1]})
        lib.sync.write_ops([lib.sync.shared_update(P.Object, obj["pub_id"], field, value)],
                           lambda db, f=field, v=value: db.update(P.Object, {"id": objs[1]},
                                                                  {f: v}))
    P.preferences.update_preferences(lib, {"explorer": {"view": "grid", "size": 3}})
    P.preferences.update_preferences(lib, {"explorer": {"size": None}})


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_mixed_pairs_converge(nodes, tmp_path, src, dst):
    tree = make_tree(tmp_path / "tree")
    a = nodes[src].libraries.create(f"mixed-{src}")
    b = nodes[dst].libraries.create(f"mixed-{dst}")
    pair_libraries(a, b)
    emitting_session(PKGS[src], a, tree)
    applied = pump(PKGS[dst], a, b, batch=64)
    assert applied > 0
    # the JAX package's object creates carry the commit's time, and its tag
    # creates no date_modified
    skip = (frozenset({("object", "date_created"), ("tag", "date_modified")}) if src == "jax"
            else frozenset())
    want, got = synced_rows(a.db, skip), synced_rows(b.db, skip)
    assert got == want
    assert sum(t == "file_path" for t, _ in got) == count(a, "file_path") > 80
    assert sum(t == "tag_on_object" for t, _ in got) == 3
    # nothing new the second time, and the receiver's floor covers the sender
    assert pump(PKGS[dst], a, b) == 0
    assert b.sync.timestamps()[a.sync.instance_pub_id] == \
        a.sync.require_watermark()[a.sync.instance_pub_id]


def test_a_scan_logs_the_operations_jax_logs(nodes, tmp_path):
    tree = make_tree(tmp_path / "tree")
    logs, counts = {}, {}
    for pkg in ("jax", "port"):
        lib = nodes[pkg].libraries.create(f"oplog-{pkg}")
        P = PKGS[pkg]
        loc = P.create_location(lib, str(tree), hasher="hybrid")
        lib.db.update(P.Location, {"id": loc["id"]}, {"generate_preview_media": False})
        P.scan_location(lib, loc["id"])
        assert lib.node.jobs.wait_idle(120)
        logs[pkg] = op_log(lib.db, pub_keys(lib.db), roots=(tree,))
        counts[pkg] = tuple(lib.db.query(
            "SELECT COUNT(*), COUNT(cas_id), COUNT(object_id), "
            "(SELECT COUNT(*) FROM object) FROM file_path")[0])
    assert logs["port"] == logs["jax"]
    kinds: dict = {}
    for key, n in logs["port"].items():
        op = json.loads(key)
        if op[0] == "shared":
            kinds[(op[1], op[3])] = kinds.get((op[1], op[3]), 0) + n
    rows_, cas, linked, objects = counts["port"]
    assert counts["jax"] == counts["port"] and linked == 80
    assert kinds[("location", "c")] == 1 and kinds[("file_path", "c")] == rows_
    assert kinds[("file_path", "u:cas_id")] == cas
    assert kinds[("file_path", "u:object_id")] == linked
    assert kinds[("object", "c")] == objects


# -- port only -----------------------------------------------------------------------


def test_lanes_give_the_rows_of_one_lane(nodes, tmp_path, monkeypatch):
    P = PKGS["port"]
    tree = make_tree(tmp_path / "tree")
    a = nodes["port"].libraries.create("lanes-a")
    emitting_session(P, a, tree)
    rows = {}
    for lanes in (1, 4):
        monkeypatch.setenv("SD_SYNC_INGEST_LANES", str(lanes))
        b = nodes["port"].libraries.create(f"lanes-{lanes}")
        pair_libraries(a, b)
        actor = P.Actor(b, transport=lambda clocks, n: a.sync.get_ops(clocks, n), batch=50)
        actor.notify()
        assert actor.wait_idle(60)
        actor.stop()
        rows[lanes] = synced_rows(b.db)
        pool = b.__dict__.get("_ingest_lanes")
        assert (pool is not None and pool.lanes == 4 and sum(pool.ops_by_lane) > 0) \
            == (lanes == 4)
        assert actor.pulled == a.sync.ops_pending({}) and actor.error is None
    assert rows[4] == rows[1] == synced_rows(a.db)


def test_an_orphan_tick_inside_a_pull_round_loses_no_link(nodes, tmp_path, monkeypatch):
    """An orphan-remover tick planted before every pull after the first,
    with one window a session, so that a tick falls between an object's
    create and its files' links: the tick waits for the round to end, and
    every link arrives (the reference's tick deletes the object then;
    ROADMAP Queue 3)."""
    import threading

    from spacedrive_tpu_torch.sync import ingest as port_ingest

    P = PKGS["port"]
    tree = make_tree(tmp_path / "tree")
    a = nodes["port"].libraries.create("gc-race-a")
    b = nodes["port"].libraries.create("gc-race-b")
    pair_libraries(a, b)
    emitting_session(P, a, tree)
    monkeypatch.setattr(port_ingest, "SESSION_FLUSH_OPS", 40)
    ticks = []

    def transport(clocks, n):
        ticks.append(threading.Thread(target=b.orphan_remover.process_clean_up))
        if len(ticks) > 1:
            ticks[-1].start()
            ticks[-1].join(0.05)  # a tick free to run runs now
        return a.sync.get_ops(clocks, n)

    actor = P.Actor(b, transport=transport, batch=40)
    actor.notify()
    assert actor.wait_idle(60)
    actor.stop()
    for tick in ticks[1:]:
        tick.join(10)
    assert len(ticks) > 5 and count(b, "object") == count(a, "object") > 50
    assert synced_rows(b.db) == synced_rows(a.db)


def test_a_failed_log_fails_its_write(nodes, monkeypatch):
    lib = nodes["port"].libraries.create("failed-log")

    def broken(ops):
        raise OSError("log write failed")

    monkeypatch.setattr(lib.sync, "log_ops", broken)
    with pytest.raises(OSError):
        port_tags.create_tag(lib, "lost")
    with pytest.raises(OSError):
        port_preferences.update_preferences(lib, {"theme": "dark"})
    assert count(lib, "tag") == 0 and count(lib, "preference") == 0


def test_an_actor_whose_pull_raises_stops_and_says_why(nodes):
    lib = nodes["port"].libraries.create("broken-transport")
    calls = []

    def transport(clocks, n):
        calls.append(n)
        raise ConnectionError("peer gone")

    actor = PKGS["port"].Actor(lib, transport=transport)
    actor.notify()
    with pytest.raises(RuntimeError) as err:
        actor.wait_idle(10)
    assert isinstance(err.value.__cause__, ConnectionError)
    actor.notify()  # no second round: the loop ended with the error
    time.sleep(0.1)
    assert len(calls) == 1
    with pytest.raises(RuntimeError):
        actor.stop()


def test_an_indexer_update_names_its_row(nodes, tmp_path):
    """A rescan's update step logs its fields under the changed row's own
    pub_id in the port; the JAX package's names the pub_id its walker made
    for the entry, which no row has (ROADMAP Queue 3)."""
    named = {}
    for pkg in ("jax", "port"):
        P = PKGS[pkg]
        tree = make_tree(tmp_path / pkg)
        lib = nodes[pkg].libraries.create(f"update-{pkg}")
        loc = P.create_location(lib, str(tree), hasher="hybrid")
        lib.db.update(P.Location, {"id": loc["id"]}, {"generate_preview_media": False})
        P.scan_location(lib, loc["id"])
        assert lib.node.jobs.wait_idle(120)
        (tree / "d1" / "f03.json").write_bytes(b"changed" * 50)
        row = lib.db.find_one(P.FilePath, {"materialized_path": "/d1/", "name": "f03"})
        P.scan_location(lib, loc["id"])
        assert lib.node.jobs.wait_idle(120)
        updates = lib.db.query("SELECT record_id FROM shared_operation WHERE "
                               "model = 'file_path' AND kind = 'u:size_in_bytes'")
        assert len(updates) == 1
        named[pkg] = updates[0]["record_id"] == row["pub_id"]
    assert named == {"jax": False, "port": True}
