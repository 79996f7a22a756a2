"""The port's delta spacedrop (spacedrive_tpu_torch/p2p/delta.py), on the
CPU: the cases of ``tests/test_delta_transfer.py``.

The protocol runs wire-less: the sender's and the receiver's coroutines
talk over paired ``asyncio.StreamReader``s through a stand-in for the
manager, so the accounting, the admission (BUSY, a sleep, the same window
offered again, acknowledged windows never sent twice) and the rebuild are
exercised without sockets; one case runs over sockets between two port
nodes. The reference's gate reads the bytes on the wire from its network
fault model (``NetModel.bytes_by_link``), which the port does not have yet:
here the shipped bytes are the port's delta counters
(``delta.BYTES["sent"]``, payload bytes of the chunks that crossed). Every
test file's manifest on the port (``ops.cdc.build_manifest``, the plain
Gear and BLAKE3 on the CPU, the path both ends take) equals the JAX
package's ``ops.cdc.build_manifest``.
"""

import asyncio
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from spacedrive_tpu.ops import cdc as jax_cdc
from spacedrive_tpu_torch import faults
from spacedrive_tpu_torch.node import Node
from spacedrive_tpu_torch.ops import cdc
from spacedrive_tpu_torch.p2p import delta
from spacedrive_tpu_torch.p2p.proto import H_DELTA, Header
from spacedrive_tpu_torch.sync.admission import IngestBudget
from tests.torch_p2p_cases import Events, blob, ident_of
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh():
    delta.reset_counts()
    yield
    faults.clear()


class PipeWriter:
    """A writer feeding a StreamReader: the three methods the protocol uses."""

    def __init__(self, reader: asyncio.StreamReader) -> None:
        self._reader = reader

    def write(self, b: bytes) -> None:
        self._reader.feed_data(bytes(b))

    async def drain(self) -> None:
        pass

    def close(self) -> None:
        if not self._reader.at_eof():
            self._reader.feed_eof()


class FakeMgr:
    """What delta.py touches of the manager."""

    def __init__(self, loop, budget=None) -> None:
        self._loop = loop
        self._spacedrop_in = {}
        self._spacedrop_cancel = {}
        self.events = []
        self.node = SimpleNamespace(ingest_budget=budget or IngestBudget(1 << 30, 1 << 40),
                                    device=CPU)
        self.streams = {}

    def emit(self, ev: dict) -> None:
        self.events.append(ev)

    async def open_stream(self, peer_id: str):
        r, w = self.streams[peer_id]
        return r, w, {}


async def _accept_when_asked(mgr: FakeMgr, target_dir: Path | None) -> None:
    for _ in range(4000):
        if mgr._spacedrop_in:
            entry = next(iter(mgr._spacedrop_in.values()))
            if not entry["future"].done():
                entry["future"].set_result(None if target_dir is None else str(target_dir))
            return
        await asyncio.sleep(0.005)
    raise AssertionError("the receiver never surfaced the delta request")


async def run_delta(tmp_path: Path, src_data: bytes, base_data: bytes | None = None,
                    budget=None, accept: bool = True):
    loop = asyncio.get_running_loop()
    to_recv, to_send = asyncio.StreamReader(), asyncio.StreamReader()
    sender, receiver = FakeMgr(loop), FakeMgr(loop, budget=budget)
    sender.streams["receiver"] = (to_send, PipeWriter(to_recv))
    recv_writer = PipeWriter(to_send)
    src = tmp_path / "gift.bin"
    src.write_bytes(src_data)
    inbox = tmp_path / "inbox"
    inbox.mkdir(exist_ok=True)
    if base_data is not None:
        (inbox / "gift.bin").write_bytes(base_data)

    async def dispatch() -> None:
        hdr = await Header.from_stream(to_recv)
        assert hdr.kind == H_DELTA
        try:
            await delta.serve_delta(receiver, to_recv, recv_writer, hdr.payload,
                                    SimpleNamespace(identity="sender-ident"))
        except Exception:
            recv_writer.close()  # the manager's dispatcher resets the substream
            raise

    recv_task = asyncio.create_task(dispatch())
    accept_task = asyncio.create_task(_accept_when_asked(receiver, inbox if accept else None))
    await asyncio.wait_for(delta.send_delta(sender, "drop-1", "receiver", src), 60)
    await asyncio.wait_for(accept_task, 10)
    if accept:
        await asyncio.wait_for(recv_task, 30)
    else:
        recv_task.cancel()
    return sender, receiver, inbox


def done_event(mgr: FakeMgr) -> dict:
    ev = next((e for e in mgr.events if e["type"] == "SpacedropDone"), None)
    failed = next((e for e in mgr.events if e["type"] == "SpacedropFailed"), None)
    assert ev is not None, f"no SpacedropDone (failed: {failed})"
    return ev


def same_manifest(*datas: bytes) -> None:
    for data in datas:
        assert cdc.build_manifest(data, device=CPU) == jax_cdc.build_manifest(data,
                                                                              kernel="numpy")


def test_half_shared_ships_under_60_percent(tmp_path):
    shared = blob(1, 256 * 1024)
    base = shared + blob(2, 256 * 1024)
    fresh = shared + blob(3, 256 * 1024)
    same_manifest(base, fresh)
    sender, receiver, _inbox = asyncio.run(run_delta(tmp_path, fresh, base_data=base))
    ev = done_event(sender)
    assert ev["delta"] is True and ev["chunks_reused"] > 0
    assert Path(done_event(receiver)["path"]).read_bytes() == fresh
    assert 0 < delta.BYTES["sent"] < 0.6 * len(fresh)
    assert ev["bytes"] == delta.BYTES["sent"]
    assert delta.BYTES["sent"] + delta.BYTES["reused"] == len(fresh)
    assert delta.TRANSFERS == {"sender": 1, "receiver": 1}
    assert delta.CHUNKS["sent"] == ev["chunks_sent"] and delta.CHUNKS["reused"] > 0


def test_an_identical_base_ships_no_chunks(tmp_path):
    data = blob(11, 150 * 1024)
    sender, receiver, _inbox = asyncio.run(run_delta(tmp_path, data, base_data=data))
    ev = done_event(sender)
    assert ev["chunks_sent"] == 0 and ev["bytes"] == 0 and delta.BYTES["sent"] == 0
    assert Path(done_event(receiver)["path"]).read_bytes() == data


def test_a_cold_receiver_gets_every_chunk(tmp_path):
    data = blob(21, 150 * 1024)
    same_manifest(data)
    sender, receiver, _inbox = asyncio.run(run_delta(tmp_path, data))
    ev = done_event(sender)
    assert ev["chunks_reused"] == 0 and ev["bytes"] == len(data)
    assert Path(done_event(receiver)["path"]).read_bytes() == data


def test_a_rejected_delta_writes_nothing(tmp_path):
    sender, _receiver, inbox = asyncio.run(run_delta(tmp_path, blob(31, 64 * 1024),
                                                     accept=False))
    assert any(e["type"] == "SpacedropRejected" for e in sender.events)
    assert not any(e["type"] == "SpacedropDone" for e in sender.events)
    assert list(inbox.iterdir()) == []


def test_busy_resumes_without_resending_acknowledged_windows(tmp_path, monkeypatch):
    monkeypatch.setattr(delta, "WINDOW", 4)
    sent_blocks = []
    real_block_msg = delta.block_msg
    monkeypatch.setattr(delta, "block_msg",
                        lambda off, data: sent_blocks.append(off) or real_block_msg(off, data))
    monkeypatch.setenv("SD_SYNC_RETRY_AFTER_MS", "200")
    faults.install("sync_ingest:overload:once")
    data = blob(41, 160 * 1024)
    t0 = time.monotonic()
    sender, receiver, _inbox = asyncio.run(
        run_delta(tmp_path, data, budget=IngestBudget(1 << 30, 1 << 40)))
    elapsed = time.monotonic() - t0
    ev = done_event(sender)
    assert Path(done_event(receiver)["path"]).read_bytes() == data
    assert delta.BUSY == {"windows": 1}
    assert elapsed >= 0.2
    assert len(sent_blocks) == len(set(sent_blocks)) == ev["chunks_sent"]
    assert ev["chunks_sent"] > delta.WINDOW


def test_a_corrupt_chunk_fails_closed(tmp_path, monkeypatch):
    real_block_msg = delta.block_msg

    def corrupting(off, data):
        return real_block_msg(off, (b"\xff" + data[1:]) if off == 0 else data)

    monkeypatch.setattr(delta, "block_msg", corrupting)

    async def run():
        try:
            await run_delta(tmp_path, blob(51, 64 * 1024))
        except Exception:
            pass

    t0 = time.monotonic()
    asyncio.run(run())
    assert time.monotonic() - t0 < 30  # the reset reaches the sender at once
    inbox = tmp_path / "inbox"
    assert not (inbox / "gift.bin").exists() and not list(inbox.glob("*.sdpart"))


def test_a_delta_spacedrop_over_sockets(tmp_path, monkeypatch):
    pytest.importorskip("cryptography")
    monkeypatch.delenv("SD_P2P_DISABLED", raising=False)
    a = Node(tmp_path / "a", device="cpu", watch_locations=False)
    b = Node(tmp_path / "b", device="cpu", watch_locations=False)
    try:
        shared = blob(61, 256 * 1024)
        base = shared + blob(62, 256 * 1024)
        fresh = shared + blob(63, 256 * 1024)
        src = tmp_path / "gift.bin"
        src.write_bytes(fresh)
        inbox = tmp_path / "inbox"
        inbox.mkdir()
        (inbox / "gift.bin").write_bytes(base)
        events_a, events_b = Events(a), Events(b)
        b.router.resolve("p2p.debugConnect", {"addr": f"127.0.0.1:{a.p2p.port}"})
        [drop] = a.router.resolve("p2p.spacedropDelta", {"peer_id": ident_of(b),
                                                          "paths": [str(src)]})
        req = events_b.wait("SpacedropRequest")
        assert req["delta"] is True and req["size"] == len(fresh)
        b.router.resolve("p2p.acceptSpacedrop", {"id": req["id"], "target_dir": str(inbox)})
        done = events_a.wait("SpacedropDone", timeout=60, id=drop)
        assert Path(done["path"]).read_bytes() == fresh
        assert Path(done["path"]).name == "gift (2).bin"
        assert 0 < delta.BYTES["sent"] < 0.6 * len(fresh)
    finally:
        a.shutdown()
        b.shutdown()
