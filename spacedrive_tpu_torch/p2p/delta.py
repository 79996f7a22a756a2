"""Delta spacedrop: ship only the chunks the peer lacks.

A copy of ``spacedrive_tpu/p2p/delta.py``, on the same wire:

1. the sender chunks the file (:func:`..ops.cdc.build_manifest`: Gear cut
   candidates and BLAKE3 chunk ids on the node's device) and sends an
   ``H_DELTA`` header carrying the manifest (``[[chunk_id, length], ...]``
   in file order);
2. the receiver, after the accept decision a plain drop asks for, chunks
   its own copy of the same-named file in the chosen directory the same
   way and answers with the chunk ids it already holds;
3. the sender streams each missing chunk once, as spaceblock block
   messages, in windows of :data:`WINDOW` chunks; the receiver admits each
   window through the node's ingest budget, and a BUSY answer makes the
   sender sleep the advised wait and offer the same window again (windows
   already acknowledged are never sent twice);
4. the receiver re-hashes every received chunk (one BLAKE3 batch a
   window), rebuilds the file from its base copy and the received chunks,
   writes a ``.sdpart`` sibling and renames it into place.

Both ends' Gear and BLAKE3 launches run on the node that does the work;
:data:`TRANSFERS`, :data:`CHUNKS`, :data:`BYTES` and :data:`BUSY` keep, as
plain counters with the same labels (``role``; ``kind`` = ``sent`` /
``reused``), the counts of the reference's families, which are recorded
too: ``sd_delta_transfers_total{role}``, ``sd_delta_chunks_total{kind}``,
``sd_delta_bytes_total{kind}``, ``sd_delta_busy_total``. The reference's
network fault model is not ported.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import uuid
from pathlib import Path
from typing import Any

from .. import faults, telemetry
from ..ops import _kernels, cdc
from ..telemetry import mesh
from .proto import (Header, ProtocolError, block_msg, json_frame, read_block_msg, read_exact,
                    read_json)

logger = logging.getLogger(__name__)

#: chunks per admission window
WINDOW = 64

#: the accept decision's and each reply's deadline
DELTA_TIMEOUT = 60.0

#: bound on a declared manifest
MAX_CHUNKS = 1 << 20

#: transfers completed, by ``role`` (sender / receiver)
TRANSFERS: collections.Counter = collections.Counter()
#: sender-side chunks, by ``kind``: ``sent`` over the wire or ``reused``
CHUNKS: collections.Counter = collections.Counter()
#: sender-side payload bytes, by ``kind``: ``sent`` or ``reused``
BYTES: collections.Counter = collections.Counter()
#: windows the receiver's budget shed (each a sleep and a re-offer)
BUSY: collections.Counter = collections.Counter()


_TRANSFERS = telemetry.counter(
    "sd_delta_transfers_total", "delta spacedrop transfers completed",
    labels=("role",))
_CHUNKS = telemetry.counter(
    "sd_delta_chunks_total",
    "sender-side chunk outcomes: shipped over the wire vs reused from "
    "the receiver's base copy", labels=("kind",))
_BYTES = telemetry.counter(
    "sd_delta_bytes_total",
    "sender-side payload bytes: shipped over the wire vs avoided because "
    "the receiver already held the chunk", labels=("kind",))
_BUSY = telemetry.counter(
    "sd_delta_busy_total",
    "delta windows shed by the receiver's admission budget (each one is "
    "a sleep-and-re-offer, never a restart)")


def reset_counts() -> None:
    for counter in (TRANSFERS, CHUNKS, BYTES, BUSY):
        counter.clear()


def _manifest_offsets(manifest: list[tuple[str, int]]) -> list[int]:
    offsets, off = [], 0
    for _h, ln in manifest:
        offsets.append(off)
        off += ln
    return offsets


def _chunk_file(node, data: bytes) -> list[tuple[str, int]]:
    """The file's manifest on ``node``'s device, launches counted under
    the ``delta`` origin."""
    with _kernels.origin("delta"):
        return cdc.build_manifest(data, device=node.device)


def _verify_ids(node, datas: list[bytes]) -> list[str]:
    """Chunk ids of already-cut chunks (one whole-buffer chunk each)."""
    with _kernels.origin("delta"):
        ids = cdc.chunk_ids(datas, [[(0, len(d))] for d in datas], device=node.device)
    return [i[0] for i in ids]


# -- sender -------------------------------------------------------------------

async def send_delta(mgr: Any, drop_id: str, peer_id: str, path: Path) -> None:
    """Runs on the p2p loop. Emits the plain drop's Spacedrop{Rejected,
    Done, Failed, Progress} events, with the delta's accounting in Done."""
    cancel = asyncio.Event()
    mgr._spacedrop_cancel[drop_id] = cancel
    loop = asyncio.get_running_loop()
    try:
        data = await loop.run_in_executor(None, path.read_bytes)
        manifest = await loop.run_in_executor(None, _chunk_file, mgr.node, data)
        offsets = _manifest_offsets(manifest)
        faults.inject("p2p_send", key=peer_id)
        reader, writer, _meta = await mgr.open_stream(peer_id)
        try:
            writer.write(Header.delta(drop_id, path.name, len(data),
                                      [[h, ln] for h, ln in manifest]).to_bytes())
            await writer.drain()
            decision = await asyncio.wait_for(read_exact(reader, 1), DELTA_TIMEOUT)
            if decision != b"\x01":
                mgr.emit({"type": "SpacedropRejected", "id": drop_id})
                return
            reply = await asyncio.wait_for(read_json(reader), DELTA_TIMEOUT)
            if not reply.get("ok"):
                raise ProtocolError(reply.get("error", "delta refused"))
            have = set(reply.get("have") or [])
            # one copy per distinct missing id: the receiver rebuilds by id
            seen: set[str] = set()
            send_idx: list[int] = []
            for i, (h, _ln) in enumerate(manifest):
                if h in have or h in seen:
                    continue
                seen.add(h)
                send_idx.append(i)
            sent_bytes = 0
            total_send = sum(manifest[i][1] for i in send_idx) or 1
            windows = [send_idx[i:i + WINDOW] for i in range(0, len(send_idx), WINDOW)]
            for w, idxs in enumerate(windows):
                while True:
                    if cancel.is_set():
                        raise ProtocolError("cancelled")
                    writer.write(json_frame({"window": w, "count": len(idxs),
                                             "nbytes": sum(manifest[i][1] for i in idxs)}))
                    await writer.drain()
                    grant = await asyncio.wait_for(read_json(reader), DELTA_TIMEOUT)
                    if grant.get("busy"):
                        # shed: sleep the advised wait, offer this window again
                        _kernels.count(BUSY, "windows")
                        _BUSY.inc()
                        await asyncio.sleep(max(0, int(grant.get("retry_after_ms") or 0))
                                            / 1000.0)
                        continue
                    if not grant.get("go"):
                        raise ProtocolError("delta window refused")
                    for i in idxs:
                        off, ln = offsets[i], manifest[i][1]
                        writer.write(block_msg(off, data[off:off + ln]))
                    await writer.drain()
                    ack = await asyncio.wait_for(read_json(reader), DELTA_TIMEOUT)
                    if ack.get("ack") != w:
                        raise ProtocolError(f"bad delta ack: {ack!r}")
                    sent_bytes += sum(manifest[i][1] for i in idxs)
                    mgr.emit({"type": "SpacedropProgress", "id": drop_id,
                              "percent": int(sent_bytes * 100 / total_send)})
                    break
            writer.write(json_frame({"done": True}))
            await writer.drain()
            final = await asyncio.wait_for(read_json(reader), DELTA_TIMEOUT)
            if not final.get("ok"):
                raise ProtocolError(final.get("error", "delta assembly failed"))
            reused = len(manifest) - len(send_idx)
            _kernels.count(TRANSFERS, "sender")
            _kernels.count(CHUNKS, "sent", len(send_idx))
            _kernels.count(CHUNKS, "reused", reused)
            _kernels.count(BYTES, "sent", sent_bytes)
            _kernels.count(BYTES, "reused", len(data) - sent_bytes)
            _TRANSFERS.inc(role="sender")
            _CHUNKS.inc(len(send_idx), kind="sent")
            _CHUNKS.inc(reused, kind="reused")
            _BYTES.inc(sent_bytes, kind="sent")
            _BYTES.inc(len(data) - sent_bytes, kind="reused")
            mgr.emit({"type": "SpacedropDone", "id": drop_id, "bytes": sent_bytes,
                      "delta": True, "chunks_sent": len(send_idx), "chunks_reused": reused,
                      "path": final.get("path")})
        finally:
            writer.close()
    except (OSError, asyncio.TimeoutError, ProtocolError) as e:
        mgr.emit({"type": "SpacedropFailed", "id": drop_id, "error": str(e)})
    finally:
        mgr._spacedrop_cancel.pop(drop_id, None)


# -- receiver -----------------------------------------------------------------

def _parse_manifest(payload: dict) -> tuple[str, int, list[tuple[str, int]]]:
    name = str(payload.get("name") or "received.bin")
    size = int(payload.get("size") or 0)
    raw = payload.get("chunks") or []
    if not isinstance(raw, list) or len(raw) > MAX_CHUNKS:
        raise ProtocolError("bad delta manifest shape")
    chunks: list[tuple[str, int]] = []
    for entry in raw:
        h, ln = str(entry[0]), int(entry[1])
        if ln <= 0 or len(h) != cdc.CHUNK_ID_HEX:
            raise ProtocolError("bad delta manifest entry")
        chunks.append((h, ln))
    if sum(ln for _h, ln in chunks) != size:
        raise ProtocolError("delta manifest does not cover the file")
    return name, size, chunks


async def serve_delta(mgr: Any, reader, writer, payload: dict, peer) -> None:
    """The ``H_DELTA`` responder. A protocol violation raises into the
    dispatcher, which resets the substream."""
    from ..sync.admission import Busy

    name, size, chunks = _parse_manifest(payload)
    loop = asyncio.get_running_loop()
    drop_id = str(uuid.uuid4())
    fut: asyncio.Future = mgr._loop.create_future()
    mgr._spacedrop_in[drop_id] = {"future": fut, "req": payload, "peer": peer.identity}
    mgr.emit({"type": "SpacedropRequest", "id": drop_id, "identity": peer.identity,
              "name": name, "size": size, "delta": True, "chunks": len(chunks)})
    try:
        target_dir = await asyncio.wait_for(fut, DELTA_TIMEOUT)
    except asyncio.TimeoutError:
        target_dir = None
    finally:
        mgr._spacedrop_in.pop(drop_id, None)
    if target_dir is None:
        writer.write(b"\x00")
        await writer.drain()
        mgr.emit({"type": "SpacedropRejected", "id": drop_id})
        return
    writer.write(b"\x01")
    await writer.drain()

    # the offered name is the peer's: basename only
    safe_name = Path(name).name or "received.bin"
    base_path = Path(target_dir) / safe_name
    base_data = b""
    have: dict[str, tuple[int, int]] = {}  # id -> (offset, length) in the base
    if base_path.is_file():
        base_data = await loop.run_in_executor(None, base_path.read_bytes)
        base_manifest = await loop.run_in_executor(None, _chunk_file, mgr.node, base_data)
        off = 0
        for h, ln in base_manifest:
            have.setdefault(h, (off, ln))
            off += ln
    # advertise only the ids the sender needs, with matching lengths
    needed = {h: ln for h, ln in chunks}
    usable = sorted(h for h, (_o, ln) in have.items() if needed.get(h) == ln)
    writer.write(json_frame({"ok": True, "have": usable}))
    await writer.drain()

    offset_of = {off: i for i, off in enumerate(_manifest_offsets(chunks))}
    received: dict[str, bytes] = {}
    budget = mgr.node.ingest_budget
    while True:
        msg = await asyncio.wait_for(read_json(reader), DELTA_TIMEOUT)
        if msg.get("done"):
            break
        w = int(msg.get("window", -1))
        count = int(msg.get("count", 0))
        nbytes = int(msg.get("nbytes", 0))
        if count <= 0 or count > WINDOW or nbytes < 0:
            raise ProtocolError("bad delta window offer")
        verdict = budget.try_admit(mesh.peer_label(peer.identity), count, nbytes)
        if isinstance(verdict, Busy):
            mesh.record_busy_sent(mesh.peer_label(peer.identity))
            writer.write(json_frame({"busy": True, "retry_after_ms": verdict.retry_after_ms}))
            await writer.drain()
            continue
        try:
            writer.write(json_frame({"go": True}))
            await writer.drain()
            blocks: list[tuple[int, bytes]] = []
            for _ in range(count):
                blk = await asyncio.wait_for(read_block_msg(reader), DELTA_TIMEOUT)
                if blk is None:
                    raise ProtocolError("delta transfer cancelled")
                blocks.append(blk)
            # every received chunk is re-hashed against its manifest entry
            ids = await loop.run_in_executor(None, _verify_ids, mgr.node,
                                             [d for _o, d in blocks])
            for (off, data_b), cid in zip(blocks, ids):
                idx = offset_of.get(off)
                if idx is None:
                    raise ProtocolError(f"block at unknown offset {off}")
                h, ln = chunks[idx]
                if len(data_b) != ln or cid != h:
                    raise ProtocolError(f"chunk hash mismatch at {off}")
                received[h] = data_b
            writer.write(json_frame({"ack": w}))
            await writer.drain()
        finally:
            verdict.release()

    parts: list[bytes] = []
    for h, ln in chunks:
        if h in received:
            parts.append(received[h])
        elif h in have and have[h][1] == ln:
            off = have[h][0]
            parts.append(base_data[off:off + ln])
        else:
            raise ProtocolError(f"chunk {h} never arrived")
    blob = b"".join(parts)
    if len(blob) != size:
        raise ProtocolError("reassembled size mismatch")
    from ..objects.fs import find_available_name

    target = find_available_name(Path(target_dir) / safe_name)
    part = target.with_name(target.name + ".sdpart")

    def _persist() -> None:
        part.write_bytes(blob)
        os.replace(part, target)

    await loop.run_in_executor(None, _persist)
    writer.write(json_frame({"ok": True, "path": str(target)}))
    await writer.drain()
    _kernels.count(TRANSFERS, "receiver")
    _TRANSFERS.inc(role="receiver")
    mgr.emit({"type": "SpacedropDone", "id": drop_id, "path": str(target), "delta": True,
              "chunks_received": len(received), "chunks_reused": len(chunks) - len(received)})
