"""The device hasher: cas messages → cas_ids on the node's device.

Counterpart of ``spacedrive_tpu/objects/hasher.py``'s ``TpuHasher`` and its
bucketing (``SMALL_BUCKETS``, ``_bucketed_hash``, ``_hash_gathered_messages``).
The port has one hasher, bound to the node's device: messages bucket by
chunk count into the same capacities (1/4/16/32/64/101 chunks; the 57,352-byte
sampled message lands in the 64-chunk bucket) and each bucket goes to
:func:`..ops.blake3.blake3_batch_hex`, padded to the same batch tiers — so the
kernels see the shapes the JAX hasher sends the TPU.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import torch

from ..ops import _kernels
from ..ops.blake3 import blake3_batch_hex
from .cas import read_sampled_batch

#: chunk capacities of the message buckets (1 chunk = 1024 B); 101 covers the
#: longest whole-file message (100 KiB + the 8-byte size prefix)
SMALL_BUCKETS = (1, 4, 16, 32, 64, 101)


def bucketed_hash(messages: list[bytes],
                  hash_bucket: Callable[[list[bytes], int], list[str]]) -> list[str]:
    """Bucket cas messages by chunk count, hash each bucket through
    ``hash_bucket(msgs, cap)``; returns 16-hex cas_ids in input order."""
    out: list[str | None] = [None] * len(messages)
    buckets: dict[int, list[int]] = {}
    for j, msg in enumerate(messages):
        chunks = max(1, (len(msg) + 1023) // 1024)
        cap = next((b for b in SMALL_BUCKETS if b >= chunks), chunks)
        buckets.setdefault(cap, []).append(j)
    for cap, js in sorted(buckets.items()):
        hexes = hash_bucket([messages[j] for j in js], cap)
        for j, h in zip(js, hexes):
            out[j] = h[:16]
    return out  # type: ignore[return-value]


class DeviceHasher:
    """Batched cas_id hashing on one device: the CUDA kernels on ``cuda``,
    their plain PyTorch versions on ``cpu``."""

    def __init__(self, device: torch.device) -> None:
        self.device = device

    def _hash_bucket(self, msgs: list[bytes], cap: int) -> list[str]:
        with _kernels.tagged("cas"):
            return blake3_batch_hex(msgs, max_chunks=cap, device=self.device)

    def hash_gathered(self, messages: list[bytes | Exception]) -> list[str | Exception]:
        """Pre-gathered cas messages → cas_ids; Exception entries (gather
        failures) pass through in place."""
        out: list[str | Exception] = list(messages)  # type: ignore[arg-type]
        ok = [j for j, m in enumerate(messages) if not isinstance(m, Exception)]
        ids = bucketed_hash([messages[j] for j in ok], self._hash_bucket)  # type: ignore[misc]
        for j, cid in zip(ok, ids):
            out[j] = cid
        return out

    def hash_batch(self, paths: list[str | Path],
                   sizes: list[int]) -> list[str | Exception]:
        return self.hash_gathered(read_sampled_batch(paths, sizes))
