"""Two port nodes over loopback TCP, on the CPU: the cases of
``tests/test_p2p.py`` that the p2p slice covers, on
``spacedrive_tpu_torch``.

Both nodes live in this process (``Node(..., device="cpu")``; the
static-peer path, discovery off). They connect (one authenticated,
multiplexed connection a pair, whichever side dials), pair a library and
converge over sync sessions; a spacedrop is accepted or rejected; a node
outside a library is refused its sync session and its hash batches; a
dial to a known identity is pinned; concurrent exchanges share one
connection; a peer's file and thumbnail reach this node's server shell
over ``H_FILE`` and ``H_THUMBNAIL``; ``broadcast`` and ``ping_all`` reach
the peer; the shared hasher service (``H_HASH``) gives ``generate_cas_id``
for every file, splits wire batches by count and bytes, answers a withheld
payload with a timeout, and sheds a batch over the serving node's budget,
which the ``RemoteHasher`` then hashes on its own node's device (counted
in ``FALLBACKS``); a responder whose budget sheds windows answers BUSY,
and the originator backs off and still converges. Every wait has its own
timeout.
"""

import asyncio
import io
import time
import urllib.error
import urllib.request

import pytest

from spacedrive_tpu_torch.locations import create_location, scan_location
from spacedrive_tpu_torch.models import FilePath, Tag
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.objects.cas import generate_cas_id
from spacedrive_tpu_torch.objects.hasher import RemoteHasher
from spacedrive_tpu_torch.objects.media.thumbnail import thumbnail_path
from spacedrive_tpu_torch.p2p import manager as p2p_manager
from spacedrive_tpu_torch.p2p import nlm
from spacedrive_tpu_torch.p2p.identity import remote_identity_of
from spacedrive_tpu_torch.p2p.proto import Header, Range, read_json
from spacedrive_tpu_torch.server import Server
from spacedrive_tpu_torch.sync.admission import IngestBudget
from tests.torch_p2p_cases import Events, addr_of, count, blob, ident_of, pair, small_tree, wait_for
from tests.torch_scan_cases import one_torch_thread  # noqa: F401
from tests.torch_sync_cases import synced_rows

pytest.importorskip("cryptography")

ACCELERATOR = {"kind": "test-accelerator", "devices": 1, "mesh": [1]}


def boot(path, emit: bool = True) -> Node:
    node = Node(path, device="cpu", watch_locations=False)
    assert node.p2p is not None and node.p2p.port
    if emit and not node.config.has_feature("syncEmitMessages"):
        node.router.resolve("toggleFeatureFlag", "syncEmitMessages")
    return node


@pytest.fixture()
def two_nodes(tmp_path, monkeypatch):
    monkeypatch.delenv("SD_P2P_DISABLED", raising=False)
    a, b = boot(tmp_path / "a"), boot(tmp_path / "b")
    RemoteHasher.reset_counts()
    p2p_manager.reset_counts()
    nlm.reset_counts()
    yield a, b
    a.shutdown()
    b.shutdown()


def add_tags(lib, names: list[str]) -> None:
    ops, rows = [], []
    for name in names:
        pub = f"tag-{lib.id[:4]}-{name}"
        ops.append(lib.sync.shared_create(Tag, pub, {"name": name}))
        rows.append({"pub_id": pub, "name": name})
    lib.sync.write_ops(ops, lambda db: [db.insert(Tag, r) for r in rows])


def test_connect_authenticates_with_one_connection_a_pair(two_nodes):
    a, b = two_nodes
    got = a.router.resolve("p2p.debugConnect", {"addr": addr_of(b)})
    assert got == ident_of(b) == b.router.resolve("p2p.identity", None)["identity"]
    peers = a.router.resolve("p2p.peers", None)
    assert [(p["identity"], p["connected"]) for p in peers] == [(ident_of(b), True)]
    assert peers[0]["accelerator"] == b.config.get()["accelerator"]
    wait_for(lambda: ident_of(a) in b.p2p.peers and b.p2p.peers[ident_of(a)].connected,
             msg="b sees a")
    wait_for(lambda: len(a.p2p._live_muxes) == 1 and len(b.p2p._live_muxes) == 1,
             msg="one session each")
    # an exchange the other way, by identity, reuses the session the dial made
    async def reverse_ping():
        reader, writer, _meta = await b.p2p.open_stream(ident_of(a))
        try:
            writer.write(Header.ping().to_bytes())
            await writer.drain()
            return await asyncio.wait_for(read_json(reader), 10)
        finally:
            writer.close()

    assert b.p2p.run_coro(reverse_ping(), timeout=15)["identity"] == ident_of(a)
    assert len(a.p2p._live_muxes) == 1 and len(b.p2p._live_muxes) == 1


def test_pair_and_sync_both_ways_over_sockets(two_nodes):
    a, b = two_nodes
    lib_a, lib_b = pair(a, b)
    assert lib_a.name == lib_b.name == "shared" and lib_a.sync.emit_messages
    state = a.router.resolve("p2p.nlmState", None)[lib_a.id]["instances"]
    b_instance = remote_identity_of(lib_b.instance()["identity"]).encode()
    assert state[b_instance] == {"state": "Connected", "peer": ident_of(b)}
    add_tags(lib_a, ["red", "green"])
    add_tags(lib_b, ["blue"])
    wait_for(lambda: count(lib_a.db, "tag") == count(lib_b.db, "tag") == 3, msg="tags both ways")
    wait_for(lambda: synced_rows(lib_a.db) == synced_rows(lib_b.db), msg="equal rows")
    assert nlm.STATS["pulled_ops"] >= 3 and nlm.STATS["pushed_sessions"] >= 2


def test_spacedrop_accept_and_reject(two_nodes, tmp_path):
    a, b = two_nodes
    events_a, events_b = Events(a), Events(b)
    src = tmp_path / "gift.bin"
    data = blob(1, 300_000)
    src.write_bytes(data)
    inbox = tmp_path / "inbox"
    inbox.mkdir()
    [drop] = a.router.resolve("p2p.spacedrop", {"peer_id": addr_of(b), "paths": [str(src)]})
    req = events_b.wait("SpacedropRequest")
    assert (req["name"], req["size"]) == ("gift.bin", len(data))
    b.router.resolve("p2p.acceptSpacedrop", {"id": req["id"], "target_dir": str(inbox)})
    assert events_a.wait("SpacedropDone", id=drop)["bytes"] == len(data)
    done = events_b.wait("SpacedropDone", id=req["id"])
    assert (inbox / "gift.bin").read_bytes() == data and done["path"] == str(inbox / "gift.bin")
    # a decline (no target dir) writes nothing
    [drop2] = a.router.resolve("p2p.spacedrop", {"peer_id": ident_of(b), "paths": [str(src)]})
    req2 = wait_for(lambda: [r for r in events_b.of("SpacedropRequest") if r["id"] != req["id"]],
                    msg="the second request")[0]
    b.router.resolve("p2p.acceptSpacedrop", {"id": req2["id"], "target_dir": None})
    events_a.wait("SpacedropRejected", id=drop2)
    assert sorted(p.name for p in inbox.iterdir()) == ["gift.bin"]


def test_a_non_member_is_refused_sync_and_hashing(two_nodes, tmp_path):
    a, b = two_nodes
    lib_b = b.libraries.create("private")
    add_tags(lib_b, ["secret"])
    a.router.resolve("p2p.debugConnect", {"addr": addr_of(b)})

    async def pull():
        reader, writer, _meta = await a.p2p.open_stream(ident_of(b))
        try:
            writer.write(Header.sync(lib_b.id).to_bytes())
            await writer.drain()
            return await asyncio.wait_for(read_json(reader), 10)
        finally:
            writer.close()

    assert a.p2p.run_coro(pull(), timeout=15) == {"req": "done"}
    with pytest.raises(Exception, match="member"):
        a.p2p.run_coro(a.p2p.request_hash_batch(ident_of(b), [b"\x08" + b"x" * 64]),
                       timeout=15)
    assert not p2p_manager.STATS["hash_served"]


def test_a_dial_to_a_known_identity_is_pinned(two_nodes, tmp_path):
    a, b = two_nodes
    c = boot(tmp_path / "c")
    try:
        a.router.resolve("p2p.debugConnect", {"addr": addr_of(b)})
        peer = a.p2p.peers[ident_of(b)]
        # b's identity now points at c's address: the handshake must refuse it
        a.p2p.run_coro(a.p2p._muxes[ident_of(b)].aclose(), timeout=10)
        wait_for(lambda: not peer.connected, msg="the session to b closed")
        peer.host, peer.port = "127.0.0.1", c.p2p.port
        with pytest.raises(Exception, match="mismatch"):
            a.p2p.run_coro(a.p2p.open_stream(ident_of(b)), timeout=15)
    finally:
        c.shutdown()


def test_concurrent_exchanges_share_one_session(two_nodes, tmp_path):
    a, b = two_nodes
    a.config.write(accelerator=ACCELERATOR)
    lib_b, lib_a = pair(b, a)  # b mirrors a's library
    tree = small_tree(tmp_path / "tree", 3)
    scan_location(lib_a, create_location(lib_a, str(tree))["id"])
    assert a.jobs.wait_idle(60)
    wait_for(lambda: count(lib_b.db, "file_path") == count(lib_a.db, "file_path"), msg="rows on b")
    a.router.resolve("toggleFeatureFlag", "filesOverP2P")
    fp = lib_a.db.find_one(FilePath, {"name": "f07"})
    want = (tree / "d0" / "f07.bin").read_bytes()
    messages = [blob(i, 57_352) for i in range(8)]

    async def many():
        sinks = [io.BytesIO() for _ in range(4)]
        results = await asyncio.gather(
            *(b.p2p.request_file(ident_of(a), lib_a.id, fp["pub_id"], Range(), s)
              for s in sinks),
            *(b.p2p.request_hash_batch(ident_of(a), messages[i:i + 2]) for i in range(0, 8, 2)),
            b.p2p.ping_all())
        return sinks, results

    sinks, results = b.p2p.run_coro(many(), timeout=60)
    assert all(s.getvalue() == want for s in sinks)
    ids = [i for r in results[4:8] for i in r]
    assert ids == b.hasher.hash_gathered(messages)
    assert len(a.p2p._live_muxes) == 1 and len(b.p2p._live_muxes) == 1


def test_remote_file_and_thumbnail_through_the_shell(two_nodes, tmp_path):
    a, b = two_nodes
    lib_a, lib_b = pair(a, b)
    tree = small_tree(tmp_path / "tree", 4)
    scan_location(lib_b, create_location(lib_b, str(tree))["id"])
    assert b.jobs.wait_idle(60)
    wait_for(lambda: count(lib_a.db, "file_path") == count(lib_b.db, "file_path"), msg="rows on a")
    row = lib_a.db.find_one(FilePath, {"name": "f17"})
    body = (tree / "d1" / "f17.bin").read_bytes()
    cas = row["cas_id"]
    thumb = thumbnail_path(b.data_dir, cas)
    thumb.parent.mkdir(parents=True, exist_ok=True)
    thumb.write_bytes(b"RIFF-not-really-a-webp" * 10)
    server = Server(a, "127.0.0.1", 0)
    server.start()
    try:
        url = (f"http://127.0.0.1:{server.port}/spacedrive/file/{lib_a.id}/"
               f"{row['location_id']}/{row['id']}")

        def get(u, headers=None):
            try:
                with urllib.request.urlopen(urllib.request.Request(u, headers=headers or {}),
                                            timeout=20) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()

        status, got = get(url)
        assert status == 404 and b"filesOverP2P disabled" in got  # b serves nothing yet
        b.router.resolve("toggleFeatureFlag", "filesOverP2P")
        assert get(url) == (200, body)
        assert get(url, {"Range": "bytes=100-4099"}) == (206, body[100:4100])
        turl = f"http://127.0.0.1:{server.port}/spacedrive/thumbnail/{cas[:2]}/{cas}.webp"
        assert get(turl) == (200, thumb.read_bytes())
        assert thumbnail_path(a.data_dir, cas).read_bytes() == thumb.read_bytes()
        status, _ = get(f"http://127.0.0.1:{server.port}/spacedrive/thumbnail/zz/"
                        f"zz{cas[2:]}.webp")
        assert status == 404
    finally:
        server.stop()


def test_broadcast_and_ping_all(two_nodes):
    a, b = two_nodes
    assert a.p2p.run_coro(a.p2p.broadcast(Header.ping().to_bytes()), timeout=10) == 0
    a.router.resolve("p2p.debugConnect", {"addr": addr_of(b)})
    assert a.p2p.run_coro(a.p2p.broadcast(Header.ping().to_bytes()), timeout=10) == 1
    b.config.write(accelerator=ACCELERATOR)
    b.p2p._metadata_cache = None
    assert a.p2p.run_coro(a.p2p.ping_all(), timeout=10) == 1
    assert a.p2p.peers[ident_of(b)].metadata["accelerator"] == ACCELERATOR


def test_remote_hasher_service(two_nodes, tmp_path):
    a, b = two_nodes
    b.config.write(accelerator=ACCELERATOR)  # b is the card
    lib_a, _lib_b = pair(a, b)
    tree = small_tree(tmp_path / "tree", 5)
    files = sorted(p for p in tree.rglob("*.bin") if p.stat().st_size)
    hasher = RemoteHasher(a)
    assert hasher._pick_peer() == ident_of(b)
    gone = tmp_path / "gone.bin"
    ids = hasher.hash_batch(files + [gone], [p.stat().st_size for p in files] + [64])
    assert ids[:-1] == [generate_cas_id(p) for p in files]
    assert isinstance(ids[-1], Exception)
    assert p2p_manager.STATS["hash_requests"] == 1 and not RemoteHasher.FALLBACKS
    assert p2p_manager.STATS["hash_served_messages"] == len(files)
    # a location hashed "remote" scans through b, to the same cas_ids
    loc = create_location(lib_a, str(tree), hasher="remote")
    scan_location(lib_a, loc["id"])
    assert a.jobs.wait_idle(60)
    rows = lib_a.db.query("SELECT * FROM file_path WHERE is_dir = 0 AND location_id = ?",
                          [loc["id"]])
    assert rows and all(r["cas_id"] == (generate_cas_id(
        tree / r["materialized_path"].strip("/") / f"{r['name']}.bin") if r["size_in_bytes"]
        else None) for r in rows)
    assert p2p_manager.STATS["hash_requests"] >= 2 and not RemoteHasher.FALLBACKS
    # no peer with an accelerator: this node's own device, counted
    b.config.write(accelerator={"kind": None, "devices": 0, "mesh": []})
    b.p2p._metadata_cache = None
    a.p2p.run_coro(a.p2p.ping_all(), timeout=10)
    assert hasher.hash_batch(files, [p.stat().st_size for p in files]) == ids[:-1]
    assert RemoteHasher.FALLBACKS == {"no_peer": len(files)}


def test_remote_hasher_splits_wire_batches(two_nodes):
    a, b = two_nodes
    b.config.write(accelerator=ACCELERATOR)
    pair(a, b)
    hasher = RemoteHasher(a)
    messages = [blob(i, 57_352) for i in range(40)]
    hasher.WIRE_BATCH_BYTES = 1 << 20  # 18 messages a batch
    assert [len(x) for x in hasher._wire_batches(list(range(40)), messages)] == [18, 18, 4]
    hasher.WIRE_BATCH = 7
    assert [len(x) for x in hasher._wire_batches(list(range(40)), messages)] == [7] * 5 + [5]
    assert hasher.hash_gathered(messages) == a.hasher.hash_gathered(messages)
    assert p2p_manager.STATS["hash_requests"] == 6
    assert p2p_manager.STATS["hash_request_bytes"] == 40 * 57_352


def test_hash_serve_times_out_on_a_withheld_payload(two_nodes, monkeypatch):
    monkeypatch.setattr(p2p_manager, "HASH_PAYLOAD_TIMEOUT", 1.0)
    a, b = two_nodes
    pair(a, b)

    async def withhold():
        reader, writer, _meta = await a.p2p.open_stream(ident_of(b))
        try:
            writer.write(Header.hash_batch([1024, 2048]).to_bytes())
            writer.write(b"x" * 500)
            await writer.drain()
            return await asyncio.wait_for(read_json(reader), 20)
        finally:
            writer.close()

    t0 = time.monotonic()
    reply = a.p2p.run_coro(withhold(), timeout=30)
    assert reply == {"ok": False, "error": "payload read timed out"}
    assert time.monotonic() - t0 < 10


def test_a_busy_hash_service_falls_back_to_this_nodes_device(two_nodes):
    a, b = two_nodes
    b.config.write(accelerator=ACCELERATOR)
    pair(a, b)
    # b's budget holds another peer's work and cannot take a's batch
    b.ingest_budget = IngestBudget(max_ops=4, max_bytes=1 << 20)
    held = b.ingest_budget.try_admit("another-peer", 1, 1)
    messages = [blob(100 + i, 4000) for i in range(6)]
    try:
        assert RemoteHasher(a).hash_gathered(messages) == a.hasher.hash_gathered(messages)
    finally:
        held.release()
    assert RemoteHasher.FALLBACKS == {"busy": 6}
    assert p2p_manager.STATS["hash_busy_sent"] == 1
    assert b.ingest_budget.status()["shed_windows"] == 1


def test_a_responder_over_its_budget_sheds_and_the_originator_converges(two_nodes, monkeypatch):
    monkeypatch.setenv("SD_SYNC_RETRY_AFTER_MS", "50")
    a, b = two_nodes
    lib_a, lib_b = pair(a, b)
    wait_for(lambda: synced_rows(lib_a.db) == synced_rows(lib_b.db), msg="the paired start")
    b.ingest_budget = IngestBudget(max_ops=100, max_bytes=1 << 30)
    held = b.ingest_budget.try_admit("another-peer", 60, 1)
    add_tags(lib_a, [f"t{i}" for i in range(300)])
    wait_for(lambda: b.ingest_budget.status()["shed_windows"] >= 1, msg="a shed window")
    held.release()
    wait_for(lambda: count(lib_b.db, "tag") == 300, timeout=40, msg="the tags on b")
    assert synced_rows(lib_a.db) == synced_rows(lib_b.db)
    assert nlm.STATS["busy_sent"] >= 1 and nlm.STATS["busy_received"] >= 1
    # the window's admission ends once its apply returns to the loop
    wait_for(lambda: b.ingest_budget.status()["ops_in_flight"] == 0, msg="released")


def test_back_to_back_batches_over_half_the_budget_are_not_shed(two_nodes):
    """Wire batches each over half the serving node's byte budget, sent back
    to back, are all hashed on the peer: none is shed (each batch's
    admission ends when it is hashed, before its reply)."""
    a, b = two_nodes
    b.config.write(accelerator=ACCELERATOR)
    pair(a, b)
    b.ingest_budget = IngestBudget(max_ops=4000, max_bytes=3 << 20)
    hasher = RemoteHasher(a)
    hasher.WIRE_BATCH_BYTES = 2 << 20
    messages = [blob(200 + i, 57_352) for i in range(144)]
    assert hasher.hash_gathered(messages) == a.hasher.hash_gathered(messages)
    assert not RemoteHasher.FALLBACKS and p2p_manager.STATS["hash_requests"] == 4
    assert b.ingest_budget.status()["shed_windows"] == 0


def test_busy_answers_past_the_retry_attempts_still_converge(two_nodes, monkeypatch):
    """A responder that answers BUSY for longer than five retries' backoff:
    the originator keeps coming back (BUSY does not count as a failed
    attempt) and delivers every operation once the budget frees."""
    monkeypatch.setenv("SD_SYNC_RETRY_AFTER_MS", "50")
    a, b = two_nodes
    lib_a, lib_b = pair(a, b)
    wait_for(lambda: synced_rows(lib_a.db) == synced_rows(lib_b.db), msg="the paired start")
    b.ingest_budget = IngestBudget(max_ops=100, max_bytes=1 << 30)
    held = b.ingest_budget.try_admit("another-peer", 60, 1)
    add_tags(lib_a, [f"t{i}" for i in range(300)])
    wait_for(lambda: nlm.STATS["busy_received"] >= 6, timeout=30, msg="six BUSY answers")
    held.release()
    wait_for(lambda: count(lib_b.db, "tag") == 300, timeout=40, msg="the tags on b")
    assert synced_rows(lib_a.db) == synced_rows(lib_b.db)


def test_created_waits_for_the_outermost_commit(tmp_path):
    """A page's ops logged in a block joined to a commit group become
    visible at the group's COMMIT: the CREATED that wakes a peer's pull
    waits for it, and a rolled-back group sends none."""
    node = Node(tmp_path / "n", device="cpu", watch_locations=False)
    try:
        node.router.resolve("toggleFeatureFlag", "syncEmitMessages")
        lib = node.libraries.create("x")
        seen = []
        lib.sync.subscribe(seen.append)
        with lib.db.transaction():
            with lib.db.transaction():  # a page joined to its group
                op = lib.sync.shared_create(Tag, "t-1", {"name": "n"})
                lib.sync.log_ops([op])
            lib.sync.created()
            assert seen == []
        assert seen == ["created"]
        assert [o["id"] for o in lib.sync.get_ops({}, 10)[0]] == [op.id]
        with pytest.raises(RuntimeError):
            with lib.db.transaction():
                lib.sync.log_ops([lib.sync.shared_create(Tag, "t-2", {"name": "n"})])
                lib.sync.created()
                raise RuntimeError("roll the group back")
        assert seen == ["created"]
        add_tags(lib, ["after"])  # write_ops outside a transaction: at once
        assert seen == ["created", "created"]
    finally:
        node.shutdown()
