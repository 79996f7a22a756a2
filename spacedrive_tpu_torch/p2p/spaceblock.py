"""Spaceblock: block-based file transfer with progress + cancellation.

A copy of ``spacedrive_tpu/p2p/spaceblock.py``. Parity with crates/p2p/src/spaceblock/mod.rs (BEP-inspired `Transfer`):
files move as fixed-size blocks over an authenticated stream, the receiver
assembles into a temp file then renames, either side can cancel, and a
progress callback fires per block (fed to the UI as P2PEvent progress).
"""

from __future__ import annotations

import asyncio
import logging
import os
from pathlib import Path
from typing import Awaitable, Callable

from .proto import (ProtocolError, Range, SpaceblockRequest, block_msg,  # noqa: F401
                    cancel_msg, read_block_msg)

logger = logging.getLogger(__name__)

Progress = Callable[[int, int], None]  # (bytes_done, bytes_total)
#: sender-side hook awaited with each frame's wire length before the write
#: (the reference's network fault model rides it; the port passes none)
Link = Callable[[int], Awaitable[None]]


async def send_file(writer: asyncio.StreamWriter, path: Path,
                    req: SpaceblockRequest,
                    progress: Progress | None = None,
                    cancelled: asyncio.Event | None = None,
                    link: Link | None = None) -> int:
    """Stream ``path``'s requested range as blocks; returns bytes sent."""
    loop = asyncio.get_running_loop()
    rng = req.range
    end = req.size if rng.end is None else min(rng.end, req.size)
    sent, offset = 0, rng.start
    with open(path, "rb") as fh:
        fh.seek(offset)
        while offset < end:
            if cancelled is not None and cancelled.is_set():
                msg = cancel_msg()
                if link is not None:
                    await link(len(msg))
                writer.write(msg)
                await writer.drain()
                return sent
            # disk reads go through the executor — a 128MiB block read inline
            # would stall every other session on the p2p loop
            data = await loop.run_in_executor(
                None, fh.read, min(req.block_size, end - offset))
            if not data:
                break
            msg = block_msg(offset, data)
            if link is not None:
                await link(len(msg))
            writer.write(msg)
            await writer.drain()
            offset += len(data)
            sent += len(data)
            if progress:
                progress(sent, end - rng.start)
    return sent


async def receive_file(reader: asyncio.StreamReader, target: Path,
                       req: SpaceblockRequest,
                       progress: Progress | None = None,
                       cancelled: asyncio.Event | None = None) -> bool:
    """Assemble blocks into ``target`` (temp-file + rename). Returns False if
    the sender cancelled or we did."""
    rng = req.range
    end = req.size if rng.end is None else min(rng.end, req.size)
    total = end - rng.start
    loop = asyncio.get_running_loop()
    tmp = target.with_name(target.name + ".sdpart")
    got = 0
    try:
        with open(tmp, "wb") as fh:
            if total > 0:
                await loop.run_in_executor(None, fh.truncate, total)
            while got < total:
                if cancelled is not None and cancelled.is_set():
                    return False
                msg = await read_block_msg(reader)
                if msg is None:  # sender cancelled
                    return False
                offset, data = msg
                rel = offset - rng.start
                if rel < 0 or rel + len(data) > total:
                    raise ProtocolError(f"block out of range: {offset}+{len(data)}")
                fh.seek(rel)
                await loop.run_in_executor(None, fh.write, data)
                got += len(data)
                if progress:
                    progress(got, total)
        os.replace(tmp, target)
        return True
    finally:
        tmp.unlink(missing_ok=True)
