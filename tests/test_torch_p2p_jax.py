"""A port node and a JAX node over loopback TCP, on the CPU: the proof that
the port speaks the reference's wire.

One node of each package (``spacedrive_tpu.node.Node(...,
probe_accelerator=False)`` and ``spacedrive_tpu_torch.node.Node(...,
device="cpu")``), p2p on, discovery off, emission on through the
``syncEmitMessages`` feature flag, ``filesOverP2P`` on, and each node's
accelerator record set to a device so the other's remote hasher picks it.

- The port pairs with a JAX library; each node scans a small tree into it
  through a ``remote`` location, so each node's cas messages are hashed by
  the other's ``H_HASH`` service; the ids equal ``generate_cas_id``, and
  the rows converge both ways over the sync sessions. They are compared as
  ``tests/test_torch_sync.py`` compares a JAX library's operations
  ingested by a port library: the objects the JAX node created carry the
  time of their commit as ``date_created`` on the JAX side only, so those
  objects are compared without that column; every other row whole.
- The JAX node pairs with a port library (the other originator), and tags
  made on either side reach the other.
- The port sends the JAX node a delta spacedrop against a base copy that
  shares about half its chunks: the JAX node rebuilds the file exactly and
  the port ships under 60% of it (counted by the port's delta counters:
  the reference's network model, which the JAX test reads, is not ported).
- A ranged ``request_file`` goes each way.
- Discovery's UDP beacons: the same metadata makes the same datagram in
  both packages, each parses the other's, and the port's manager finds
  and expires a peer from a JAX-built beacon. Datagrams are handed to the
  beacon protocols directly: no UDP port is bound.
"""

import io
import time

import pytest

from spacedrive_tpu.locations import create_location as jax_create_location
from spacedrive_tpu.locations import scan_location as jax_scan_location
from spacedrive_tpu.models import Tag as JaxTag
from spacedrive_tpu.node import Node as JaxNode
from spacedrive_tpu.p2p import discovery as jax_discovery
from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.models import Tag
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects.cas import generate_cas_id
from spacedrive_tpu_torch.objects.hasher import RemoteHasher
from spacedrive_tpu_torch.p2p import delta, discovery, manager
from spacedrive_tpu_torch.p2p.identity import Identity
from spacedrive_tpu_torch.p2p.proto import Range
from tests.torch_p2p_cases import Events, addr_of, blob, count, ident_of, small_tree, wait_for
from tests.torch_scan_cases import one_torch_thread  # noqa: F401
from tests.torch_sync_cases import synced_rows

pytest.importorskip("cryptography")

ACCELERATOR = {"kind": "test-accelerator", "devices": 1, "mesh": [1]}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.delenv("SD_P2P_DISABLED", raising=False)
    mp.delenv("SD_CHUNK_MANIFESTS", raising=False)
    base = tmp_path_factory.mktemp("p2p-jax")
    jax = JaxNode(base / "jax", probe_accelerator=False, watch_locations=False)
    port = Node(base / "port", device="cpu", watch_locations=False)
    try:
        for node in (jax, port):
            assert node.p2p is not None
            for flag in ("syncEmitMessages", "filesOverP2P"):
                node.router.resolve("toggleFeatureFlag", flag)
            node.config.write(accelerator=ACCELERATOR)
        yield {"jax": jax, "port": port, "base": base}
    finally:
        port.shutdown()
        jax.shutdown()
        mp.undo()


def jax_ident(node) -> str:
    return node.p2p.remote_identity.encode()


@pytest.fixture(scope="module")
def scanned(nodes):
    """The port paired into a JAX library, both scanned through each
    other's hasher, converged."""
    jax, port, base = nodes["jax"], nodes["port"], nodes["base"]
    lib_j = jax.libraries.create("jax-side")
    jax.config.write(p2p_auto_accept_library=lib_j.id)
    manager.reset_counts()
    RemoteHasher.reset_counts()
    port.router.resolve("p2p.pair", {"peer_id": f"127.0.0.1:{jax.p2p.port}"})
    lib_p = wait_for(lambda: next((x for x in port.libraries.list() if x.id == lib_j.id), None),
                     msg="the port's mirror of the JAX library")
    wait_for(lambda: RemoteHasher(port)._pick_peer() == jax_ident(jax), msg="the JAX hasher")
    trees = {"jax": small_tree(base / "tree-jax", 1, "j"),
             "port": small_tree(base / "tree-port", 2, "p")}
    loc_p = create_location(lib_p, str(trees["port"]), hasher="remote")
    scan_location(lib_p, loc_p["id"])
    loc_j = jax_create_location(lib_j, str(trees["jax"]), hasher="remote")
    jax_scan_location(lib_j, loc_j["id"])
    assert port.jobs.wait_idle(60) and jax.jobs.wait_idle(60)
    wait_for(lambda: sorted(synced_rows(lib_p.db)) == sorted(synced_rows(lib_j.db)),
             timeout=40, msg="the same rows on both nodes")
    return {"lib_p": lib_p, "lib_j": lib_j, "trees": trees, "loc_j": loc_j, "loc_p": loc_p}


def test_each_node_hashes_through_the_others_service(nodes, scanned):
    for lib in (scanned["lib_p"], scanned["lib_j"]):
        for side, tree in scanned["trees"].items():
            rows = [r for r in lib.db.query(
                "SELECT fp.* FROM file_path fp JOIN location l ON fp.location_id = l.id "
                "WHERE fp.is_dir = 0 AND l.path = ?", [str(tree)])]
            assert len(rows) == 17, side
            for r in rows:
                path = tree / r["materialized_path"].strip("/") / f"{r['name']}.bin"
                assert r["cas_id"] == (generate_cas_id(path) if path.stat().st_size else None)
    # the port's messages went to the JAX node; the JAX node's to the port
    assert manager.STATS["hash_requests"] >= 1 and not RemoteHasher.FALLBACKS
    assert manager.STATS["hash_served"] >= 1
    assert manager.STATS["hash_served_messages"] == 15  # the JAX tree's non-empty files


def test_the_rows_converge_both_ways(scanned):
    lib_p, lib_j = scanned["lib_p"], scanned["lib_j"]
    rows_p, rows_j = synced_rows(lib_p.db), synced_rows(lib_j.db)
    assert rows_p.keys() == rows_j.keys()
    jax_loc = scanned["loc_j"]["pub_id"]
    jax_objects = {r["object_id"] for k, r in rows_j.items()
                   if k[0] == "file_path" and r["location_id"] == jax_loc and r["object_id"]}
    assert len(jax_objects) >= 14  # the copy shares its original's object
    for key, row in rows_j.items():
        if key[0] == "object" and key[1] in jax_objects:
            assert {k: v for k, v in rows_p[key].items() if k != "date_created"} == \
                {k: v for k, v in row.items() if k != "date_created"}, key
        else:
            assert rows_p[key] == row, key


def test_the_jax_node_pairs_with_a_port_library(nodes):
    jax, port = nodes["jax"], nodes["port"]
    lib_p = port.libraries.create("port-side")
    port.config.write(p2p_auto_accept_library=lib_p.id)
    jax.router.resolve("p2p.pair", {"peer_id": addr_of(port)})
    lib_j = wait_for(lambda: next((x for x in jax.libraries.list() if x.id == lib_p.id), None),
                     msg="the JAX mirror of the port library")
    lib_p.sync.write_ops([lib_p.sync.shared_create(Tag, "port-tag", {"name": "from-port"})],
                         lambda db: db.insert(Tag, {"pub_id": "port-tag", "name": "from-port"}))
    lib_j.sync.write_ops([lib_j.sync.shared_create(JaxTag, "jax-tag", {"name": "from-jax"})],
                         lambda db: db.insert(JaxTag, {"pub_id": "jax-tag", "name": "from-jax"}))
    wait_for(lambda: count(lib_p.db, "tag") == count(lib_j.db, "tag") == 2, timeout=30,
             msg="both tags on both nodes")
    names = {side: sorted(r["name"] for r in lib.db.query("SELECT name FROM tag"))
             for side, lib in (("port", lib_p), ("jax", lib_j))}
    assert names == {"port": ["from-jax", "from-port"], "jax": ["from-jax", "from-port"]}


def test_a_delta_spacedrop_from_the_port_to_the_jax_node(nodes):
    jax, port, base = nodes["jax"], nodes["port"], nodes["base"]
    shared = blob(71, 96 * 1024)
    fresh = shared + blob(72, 96 * 1024)
    src = base / "outbox" / "gift.bin"
    src.parent.mkdir()
    src.write_bytes(fresh)
    inbox = base / "inbox"
    inbox.mkdir()
    (inbox / "gift.bin").write_bytes(shared + blob(73, 96 * 1024))
    events_j, events_p = Events(jax), Events(port)
    delta.reset_counts()
    [drop] = port.router.resolve("p2p.spacedropDelta", {"peer_id": ident_of(jax),
                                                         "paths": [str(src)]})
    req = events_j.wait("SpacedropRequest")
    assert req["delta"] is True
    jax.router.resolve("p2p.acceptSpacedrop", {"id": req["id"], "target_dir": str(inbox)})
    done = events_p.wait("SpacedropDone", timeout=60, id=drop)
    assert events_j.wait("SpacedropDone", id=req["id"])["path"] == done["path"]
    with open(done["path"], "rb") as fh:
        assert fh.read() == fresh
    assert done["chunks_reused"] > 0
    assert 0 < delta.BYTES["sent"] < 0.6 * len(fresh)
    assert delta.BYTES["sent"] + delta.BYTES["reused"] == len(fresh)
    assert delta.TRANSFERS == {"sender": 1}


def test_ranged_file_requests_go_both_ways(nodes, scanned):
    jax, port = nodes["jax"], nodes["port"]
    lib_p, lib_j = scanned["lib_p"], scanned["lib_j"]
    for asker, owner, lib, tree, name in ((port, jax, lib_p, "jax", "j17"),
                                          (jax, port, lib_j, "port", "p07")):
        row = lib.db.query("SELECT * FROM file_path WHERE name = ?", [name])[0]
        want = (scanned["trees"][tree] / row["materialized_path"].strip("/")
                / f"{name}.bin").read_bytes()
        sink = io.BytesIO()
        t0 = time.monotonic()
        n = asker.p2p.run_coro(asker.p2p.request_file(
            owner.p2p.remote_identity.encode(), lib.id, row["pub_id"], Range(1000, 9000), sink),
            timeout=30)
        assert (n, sink.getvalue()) == (8000, want[1000:9000])
        assert time.monotonic() - t0 < 30


class SentDatagrams:
    """A datagram transport that keeps what is sent to it."""

    def __init__(self) -> None:
        self.sent: list[tuple[bytes, tuple[str, int]]] = []

    def sendto(self, data: bytes, addr: tuple[str, int]) -> None:
        self.sent.append((data, addr))


def beacon_pair(module, metadata_fn):
    """A ``module.Discovery`` that records what it finds and expires, on a
    :class:`SentDatagrams` transport."""
    seen: dict = {"found": [], "expired": []}
    d = module.Discovery(45_000, metadata_fn,
                         on_peer=lambda peer, new: seen["found"].append((peer, new)),
                         on_expired=lambda peer: seen["expired"].append(peer))
    d._transport = SentDatagrams()
    return d, seen


def test_discovery_beacons_cross_packages(nodes):
    jax, port = nodes["jax"], nodes["port"]
    assert port.p2p.metadata().keys() == jax.p2p.metadata().keys()
    meta = port.p2p.metadata()
    same = [beacon_pair(m, lambda: meta)[0] for m in (discovery, jax_discovery)]
    for d in same:
        d._send_beacon()
    assert same[0]._transport.sent == same[1]._transport.sent
    assert [addr for _, addr in same[0]._transport.sent] == [("255.255.255.255", 45_000),
                                                             ("127.0.0.1", 45_000)]

    ours, ours_seen = beacon_pair(discovery, port.p2p.metadata)
    theirs, theirs_seen = beacon_pair(jax_discovery, jax.p2p.metadata)
    for d in (ours, theirs):
        d._send_beacon()
    for receiver, sender, seen, node, expiry in (
            (ours, theirs, ours_seen, jax, discovery.PEER_EXPIRY),
            (theirs, ours, theirs_seen, port, jax_discovery.PEER_EXPIRY)):
        beacon = sender._transport.sent[0][0]
        receiver._on_beacon(receiver._transport.sent[0][0], ("127.0.0.1", 1))  # its own
        receiver._on_beacon(b"not json", ("127.0.0.1", 1))
        receiver._on_beacon(b'{"sd": 2, "identity": "x"}', ("127.0.0.1", 1))
        assert seen["found"] == []
        for _ in range(2):
            receiver._on_beacon(beacon, ("127.0.0.1", 40_000))
        [(peer, new), (again, new_again)] = seen["found"]
        assert (new, new_again) == (True, False)
        assert (peer.identity, peer.addr) == (node.p2p.remote_identity.encode(),
                                              ("127.0.0.1", node.p2p.port))
        assert peer.metadata == {"sd": 1, **node.p2p.metadata()}
        receiver._expire()
        assert seen["expired"] == []
        again.last_seen -= expiry + 1
        receiver._expire()
        assert seen["expired"] == [again] and receiver.peers == {}


def test_the_port_manager_finds_and_expires_a_peer_from_a_jax_beacon(nodes):
    port = nodes["port"]
    events = Events(port)
    ghost = Identity().to_remote_identity().encode()
    sender, _ = beacon_pair(jax_discovery, lambda: {
        "identity": ghost, "node_id": "ghost", "name": "ghost", "port": 1,
        "operating_system": 0, "instances": {}, "accelerator": {}})
    sender._send_beacon()
    listener = discovery.Discovery(45_000, port.p2p.metadata, port.p2p._on_discovered,
                                   port.p2p._on_expired)
    listener._transport = SentDatagrams()
    protocol = discovery._BeaconProtocol(listener)

    async def heard() -> None:
        protocol.datagram_received(sender._transport.sent[1][0], ("127.0.0.9", 50_000))

    async def forgotten() -> None:
        listener.peers[ghost].last_seen -= discovery.PEER_EXPIRY + 1
        listener._expire()

    port.p2p.run_coro(heard(), timeout=10)
    found = events.wait("DiscoveredPeer", timeout=10)["peer"]
    assert found["identity"] == ghost
    assert port.p2p.peers[ghost].port == 1 and port.p2p.peers[ghost].host == "127.0.0.9"
    assert ghost in {p["identity"] for p in port.router.resolve("p2p.peers", None)}
    port.p2p.run_coro(forgotten(), timeout=10)
    assert events.wait("ExpiredPeer", timeout=10, identity=ghost)
    assert ghost not in port.p2p.peers
