"""The port's p2p wire (spacedrive_tpu_torch/p2p) against the JAX
package's, byte for byte, on the CPU, with no node.

The same values go through both packages and what each writes must be the
same bytes: every ``Header`` kind, the sync-session and spaceblock
messages, ``block_size_for``, the handshake transcript, the session keys
from fixed X25519 keys and a record sealed by one package's
``SecureWriter`` and opened by the other's ``SecureReader``, and the mux
frames of one scripted exchange. Signatures cross both ways (a JAX
``Identity`` signs, a port ``RemoteIdentity`` verifies, and the reverse)
on both of the port's identity routes. The two ``IngestBudget``s give the
same verdicts and ``retry_after_ms`` for the same call sequence. The mux's
own cases (interleaving, half-close, reset, the buffer cap) run on the
port's ``MuxConn`` over an in-memory pipe.
"""

import asyncio
import os

import numpy as np
import pytest

from spacedrive_tpu.p2p import identity as jax_identity
from spacedrive_tpu.p2p import mux as jax_mux
from spacedrive_tpu.p2p import proto as jax_proto
from spacedrive_tpu.p2p import secure as jax_secure
from spacedrive_tpu.sync import admission as jax_admission
from spacedrive_tpu_torch import faults
from spacedrive_tpu_torch.p2p import identity, mux, proto, secure
from spacedrive_tpu_torch.sync import admission
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

X25519 = pytest.importorskip("cryptography.hazmat.primitives.asymmetric.x25519")


def headers(p):
    """One of every Header kind, built by package ``p``'s proto."""
    req = p.SpaceblockRequest("a.bin", 1234, 1024, p.Range(10, None))
    return [
        p.Header.spacedrop(req), p.Header.ping(), p.Header.pair(), p.Header.sync("lib-uuid"),
        p.Header.file("lib", "fp-pub", p.Range(10, 20)), p.Header.connected(["a", "b"]),
        p.Header.thumbnail("lib", "0123456789abcdef"),
        p.Header.hash_batch([1, 57352, 1024]),
        p.Header.delta("t-1", "gift.bin", 999, [["ab" * 16, 500], ["cd" * 16, 499]]),
        p.Header.query("lib", "search.paths", {"take": 5}, {"inst": 7}),
    ]


def test_every_header_kind_is_the_same_bytes():
    ours, theirs = headers(proto), headers(jax_proto)
    assert [h.kind for h in ours] == list(range(10))
    for a, b in zip(ours, theirs):
        assert a.to_bytes() == b.to_bytes(), a.kind

    async def roundtrip():
        for h in ours:
            reader = asyncio.StreamReader()
            reader.feed_data(h.to_bytes())
            reader.feed_eof()
            back = await jax_proto.Header.from_stream(reader)
            assert back.kind == h.kind and back.to_bytes() == h.to_bytes()

    asyncio.run(roundtrip())


def test_sync_and_block_messages_are_the_same_bytes():
    clocks = {"inst-a": 7, "inst-b": 1 << 60}
    ops = [{"id": "op-1", "typ": {"kind": "c"}, "timestamp": 12}]
    data = bytes(range(256)) * 3
    for name, args in (("main_request_get_operations", (clocks, 1000)),
                       ("main_request_done", ()),
                       ("main_request_busy", (250, clocks)),
                       ("operations_frame", (ops, True)),
                       ("block_msg", (1 << 33, data)), ("cancel_msg", ()),
                       ("json_frame", ({"ok": True, "ids": ["x"]},))):
        assert getattr(proto, name)(*args) == getattr(jax_proto, name)(*args), name
    assert proto.SYNC_NEW_OPERATIONS == jax_proto.SYNC_NEW_OPERATIONS


@pytest.mark.parametrize("size", [0, 1, 1024, 256 * 1024, 256 * 1024 + 1, 64 << 20,
                                  (1 << 27) * 256, 1 << 45])
def test_block_size_for(size):
    assert proto.block_size_for(size) == jax_proto.block_size_for(size)


def test_transcript_keys_and_sealed_records_cross_packages():
    a = X25519.X25519PrivateKey.from_private_bytes(bytes(range(32)))
    b = X25519.X25519PrivateKey.from_private_bytes(bytes(range(32, 64)))
    e_i, e_r = a.public_key().public_bytes_raw(), b.public_key().public_bytes_raw()
    assert secure.transcript("init", e_i, e_r, "id-i", "id-r") == \
        jax_secure.transcript("init", e_i, e_r, "id-i", "id-r")
    keys = secure.derive_session_keys(a, e_r, e_i, e_r)
    assert keys == jax_secure.derive_session_keys(a, e_r, e_i, e_r)
    assert keys == secure.derive_session_keys(b, e_i, e_i, e_r)  # both ends agree
    payload = np.random.default_rng(3).integers(0, 256, secure.RECORD_MAX * 2 + 777,
                                                dtype=np.uint8).tobytes()

    class Sink:
        def __init__(self):
            self.buf = bytearray()

        def write(self, b):
            self.buf += b

    async def seal_open(writer_mod, reader_mod) -> bytes:
        sink = Sink()
        writer_mod.SecureWriter(sink, keys[0]).write(payload)
        reader = asyncio.StreamReader()
        reader.feed_data(bytes(sink.buf))
        reader.feed_eof()
        assert await reader_mod.SecureReader(reader, keys[0]).readexactly(len(payload)) \
            == payload
        return bytes(sink.buf)

    ours = asyncio.run(seal_open(secure, jax_secure))
    theirs = asyncio.run(seal_open(jax_secure, secure))
    assert ours == theirs and payload not in ours

    async def tampered():
        bad = bytearray(ours)
        bad[10] ^= 1
        reader = asyncio.StreamReader()
        reader.feed_data(bytes(bad))
        reader.feed_eof()
        with pytest.raises(proto.ProtocolError):
            await secure.SecureReader(reader, keys[0]).readexactly(len(payload))

    asyncio.run(tampered())


@pytest.fixture(params=["cryptography", "ed25519_ref"])
def route(request, monkeypatch):
    assert identity.HAVE_CRYPTOGRAPHY or request.param != "cryptography"
    monkeypatch.setattr(identity, "ROUTE", request.param)
    return request.param


def test_signatures_cross_packages(route):
    message = b"SDP3-AKE1|init|" + bytes(64) + b"|a|b"
    theirs = jax_identity.Identity()
    ours = identity.Identity()
    their_pub = identity.RemoteIdentity.decode(theirs.to_remote_identity().encode())
    our_pub = jax_identity.RemoteIdentity.decode(ours.to_remote_identity().encode())
    assert their_pub.verify(theirs.sign(message), message)
    assert our_pub.verify(ours.sign(message), message)
    assert not their_pub.verify(theirs.sign(message), message + b"!")
    sig = ours.sign(message)
    assert not our_pub.verify(sig[:-1] + bytes([sig[-1] ^ 1]), message)
    # the same seed signs to the same bytes in both packages
    seed = bytes(range(32))
    assert identity.Identity(seed).sign(message) == \
        jax_identity.Identity.from_seed(seed).sign(message)
    enc = jax_identity.encode_identity(theirs)
    assert identity.remote_identity_of(enc).encode() == theirs.to_remote_identity().encode()
    assert identity.decode_identity(enc).seed() == theirs.seed()
    assert identity.encode_identity(identity.decode_identity(enc)) == enc


#: (peer, ops, bytes, release index or None) — the call sequence both
#: budgets see; a release frees the admission made at that index
ADMIT_SEQUENCE = [
    ("p1", 1500, 10_000, None), ("p2", 1500, 10_000, None), ("p3", 500, 1000, None),
    ("p1", 1500, 10_000, None), ("p3", 100, 100, None), ("p4", 900, 50, None),
    ("p2", 10, 10, 0), ("p1", 1500, 10_000, None), ("p5", 6000, 10, 1),
    ("p5", 6000, 10, 2), ("p6", 10, 10 << 20, None), ("p6", 10, 30 << 20, None),
]


def run_admissions(budget, busy_type):
    out, tokens = [], []
    for peer, ops, nbytes, release in ADMIT_SEQUENCE:
        if release is not None and tokens[release] is not None:
            tokens[release].release()
        verdict = budget.try_admit(peer, ops, nbytes)
        busy = isinstance(verdict, busy_type)
        tokens.append(None if busy else verdict)
        out.append(("busy", verdict.retry_after_ms) if busy else ("admitted",))
    return out, budget.status()


def test_admission_verdicts_match(monkeypatch):
    for name in ("SD_SYNC_INGEST_BUDGET_OPS", "SD_SYNC_INGEST_BUDGET_BYTES",
                 "SD_SYNC_RETRY_AFTER_MS"):
        monkeypatch.delenv(name, raising=False)
    ours = run_admissions(admission.IngestBudget(4000, 32 << 20), admission.Busy)
    theirs = run_admissions(jax_admission.IngestBudget(4000, 32 << 20), jax_admission.Busy)
    assert ours == theirs
    assert any(v[0] == "busy" for v in ours[0]) and any(v[0] == "admitted" for v in ours[0])


def test_admission_options_and_the_fault_seam(monkeypatch):
    monkeypatch.setenv("SD_SYNC_INGEST_BUDGET_OPS", "10")
    monkeypatch.setenv("SD_SYNC_RETRY_AFTER_MS", "40")
    budget = admission.IngestBudget()
    assert budget.max_ops == 10 and budget.max_bytes == 32 << 20
    first = budget.try_admit("a", 8)
    assert isinstance(first, admission.Admission)
    assert isinstance(budget.try_admit("a", 8), admission.Busy)
    first.release()
    faults.install("sync_ingest:overload:once")
    try:
        shed = budget.try_admit("a", 1)
        assert isinstance(shed, admission.Busy) and shed.reason == "injected overload"
        assert shed.retry_after_ms == 40
        assert isinstance(budget.try_admit("a", 1), admission.Admission)
    finally:
        faults.clear()
    assert budget.status()["shed_windows"] == 2 and budget.status()["shed_ops"] == 9


# -- the mux ---------------------------------------------------------------


class Pipe:
    """In-memory duplex: two (reader, writer) pairs wired crosswise; each
    writer keeps the bytes it wrote."""

    class W:
        def __init__(self, peer_reader):
            self._peer = peer_reader
            self.closed = False
            self.wire = bytearray()

        def write(self, data: bytes) -> None:
            if not self.closed:
                self.wire += data
                self._peer.feed_data(data)

        async def drain(self) -> None:
            pass

        def close(self) -> None:
            if not self.closed:
                self.closed = True
                self._peer.feed_eof()

        async def wait_closed(self) -> None:
            pass

        def get_extra_info(self, name, default=None):
            return default

    @classmethod
    def make(cls):
        a_r, b_r = asyncio.StreamReader(), asyncio.StreamReader()
        return (a_r, cls.W(b_r)), (b_r, cls.W(a_r))


def scripted_exchange(m):
    """One scripted exchange on package ``m``'s mux: the bytes each side wrote."""

    async def main():
        (ar, aw), (br, bw) = Pipe.make()

        async def echo(sub):
            data = await sub.read(-1)
            sub.write(b"re:" + data)
            await sub.drain()
            sub.close()

        client = m.MuxConn(ar, aw, initiator=True, on_inbound=lambda s: asyncio.sleep(0))
        server = m.MuxConn(br, bw, initiator=False, on_inbound=echo)
        subs = [client.open_substream() for _ in range(3)]
        for i, sub in enumerate(subs):
            sub.write(bytes([i]) * (m.FRAME_MAX + 100 * i))
            await sub.drain()
            sub.close()
        replies = [await asyncio.wait_for(sub.read(-1), 10) for sub in subs]
        late = client.open_substream()
        late.write(b"x")
        await late.drain()
        late.reset()
        await asyncio.sleep(0.05)
        await client.aclose()
        await server.aclose()
        return replies, bytes(aw.wire), bytes(bw.wire)

    return asyncio.run(main())


def test_mux_frames_are_the_same_bytes():
    ours, theirs = scripted_exchange(mux), scripted_exchange(jax_mux)
    assert ours == theirs
    replies = ours[0]
    assert replies[2] == b"re:" + bytes([2]) * (mux.FRAME_MAX + 200)


def test_substreams_interleave_on_one_connection():
    async def main():
        (ar, aw), (br, bw) = Pipe.make()

        async def echo(sub):
            while True:
                try:
                    n = int.from_bytes(await sub.readexactly(4), "big")
                except asyncio.IncompleteReadError:
                    break
                sub.write(n.to_bytes(4, "big") + await sub.readexactly(n))
                await sub.drain()
            sub.close()

        client = mux.MuxConn(ar, aw, initiator=True, on_inbound=lambda s: asyncio.sleep(0))
        server = mux.MuxConn(br, bw, initiator=False, on_inbound=echo)

        async def talk(i):
            sub = client.open_substream()
            payload = os.urandom(mux.FRAME_MAX * 2 + i)
            sub.write(len(payload).to_bytes(4, "big") + payload)
            await sub.drain()
            n = int.from_bytes(await sub.readexactly(4), "big")
            got = await sub.readexactly(n)
            sub.close()
            return got == payload, sub.stream_id

        results = await asyncio.wait_for(asyncio.gather(*(talk(i) for i in range(6))), 20)
        assert all(ok for ok, _ in results)
        assert sorted(sid for _, sid in results) == [1, 3, 5, 7, 9, 11]  # odd: initiator
        await client.aclose()
        await server.aclose()

    asyncio.run(main())


def test_half_close_keeps_the_reverse_direction():
    async def main():
        (ar, aw), (br, bw) = Pipe.make()

        async def responder(sub):
            data = await sub.read(-1)
            sub.write(b"got:" + data)
            sub.close()

        client = mux.MuxConn(ar, aw, initiator=True, on_inbound=lambda s: asyncio.sleep(0))
        server = mux.MuxConn(br, bw, initiator=False, on_inbound=responder)
        sub = client.open_substream()
        sub.write(b"payload")
        sub.close()
        assert await asyncio.wait_for(sub.read(-1), 10) == b"got:payload"
        with pytest.raises(mux.MuxError):
            sub.write(b"more")
        await client.aclose()
        await server.aclose()

    asyncio.run(main())


def test_reset_ends_the_remote_read():
    async def main():
        (ar, aw), (br, bw) = Pipe.make()
        inbound = []

        async def hold(sub):
            inbound.append(sub)
            await asyncio.sleep(3600)

        client = mux.MuxConn(ar, aw, initiator=True, on_inbound=lambda s: asyncio.sleep(0))
        server = mux.MuxConn(br, bw, initiator=False, on_inbound=hold)
        sub = client.open_substream()
        sub.write(b"x")
        await sub.drain()
        await asyncio.sleep(0.05)
        sub.reset()
        await asyncio.sleep(0.05)
        assert await asyncio.wait_for(inbound[0].read(-1), 5) == b"x"
        assert inbound[0].at_eof()
        with pytest.raises(mux.MuxError):
            sub.write(b"y")
        await client.aclose()
        await server.aclose()

    asyncio.run(main())


def test_buffer_cap_resets_a_flooding_stream(monkeypatch):
    monkeypatch.setattr(mux, "BUFFER_CAP", 64 * 1024)

    async def main():
        (ar, aw), (br, bw) = Pipe.make()

        async def never_reads(sub):
            await asyncio.sleep(3600)

        client = mux.MuxConn(ar, aw, initiator=True, on_inbound=lambda s: asyncio.sleep(0))
        server = mux.MuxConn(br, bw, initiator=False, on_inbound=never_reads)
        sub = client.open_substream()
        reset_seen = False
        for _ in range(10):
            try:
                sub.write(b"z" * 16 * 1024)
                await sub.drain()
            except mux.MuxError:
                reset_seen = True
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.1)
        if not reset_seen:
            with pytest.raises(mux.MuxError):
                sub.write(b"more")
        assert server.alive  # only the stream died
        await client.aclose()
        await server.aclose()

    asyncio.run(main())


def test_an_open_from_the_wrong_half_is_reset():
    async def main():
        (ar, aw), (br, bw) = Pipe.make()
        opened = []
        server = mux.MuxConn(br, bw, initiator=False,
                             on_inbound=lambda s: asyncio.sleep(0, opened.append(s)))
        # an even id is the responder's own half: the initiator may not use it
        aw.write(mux._HDR.pack(mux.T_OPEN, 2, 0))
        await asyncio.sleep(0.05)
        assert not opened
        assert bytes(bw.wire) == mux._HDR.pack(mux.T_RESET, 2, 0)
        await server.aclose()

    asyncio.run(main())
