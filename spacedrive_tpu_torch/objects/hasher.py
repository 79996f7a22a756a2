"""The device hasher: cas messages → cas_ids on the node's device.

Counterpart of ``spacedrive_tpu/objects/hasher.py``'s ``TpuHasher`` and its
bucketing (``SMALL_BUCKETS``, ``_bucketed_hash``, ``_hash_gathered_messages``).
The port has one hasher, bound to the node's device, with the reference's
two paths:

- :meth:`DeviceHasher.hash_batch` (paths in) is the fused sampled path
  (``TpuHasher.hash_batch``, ``_hash_sampled``, ``_hash_small``, reference
  :245-339): files over 100 KiB gather natively, ``PIPELINE_BATCH`` at a
  time, straight into rows of ``SAMPLED_CHUNKS`` chunks padded to a batch
  tier, in pinned host memory on the card; the rows cross with
  ``non_blocking`` copies and hash through ``blake3_batch_rows``, double
  buffered: batch k+1 gathers and stages while batch k's kernels run and
  batch k-1's digests come back. Smaller files take the bucketed path.
- :meth:`DeviceHasher.hash_gathered` (messages in) buckets messages by chunk
  count into the same capacities (1/4/16/32/64/101 chunks; the 57,352-byte
  sampled message lands in the 64-chunk bucket) and sends each bucket to
  :func:`..ops.blake3.blake3_batch_hex`, padded to the same batch tiers. The
  identify pipeline hashes its gathered messages this way, as the
  reference's ``pipeline_process`` does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import torch

from ..native import cas_native
from ..ops import _kernels
from ..ops.blake3 import _pad_to_tier, blake3_batch_hex, blake3_batch_rows, digests_to_hex
from .cas import MINIMUM_FILE_SIZE, SAMPLED_MESSAGE_LEN, read_sampled_batch

#: chunk capacities of the message buckets (1 chunk = 1024 B); 101 covers the
#: longest whole-file message (100 KiB + the 8-byte size prefix)
SMALL_BUCKETS = (1, 4, 16, 32, 64, 101)
#: chunks of a sampled message's row in the fused path
SAMPLED_CHUNKS = (SAMPLED_MESSAGE_LEN + 1023) // 1024  # 57
#: files per device sub-batch of the fused sampled path
PIPELINE_BATCH = 2048


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

    def hash_batch(self, paths: list[str | Path],
                   sizes: list[int]) -> list[str | Exception]:
        """cas_ids of files; a file that cannot be read comes back as its
        exception, in place."""
        out: list[str | Exception] = [None] * len(paths)  # type: ignore[list-item]
        sampled = [i for i, s in enumerate(sizes) if s > MINIMUM_FILE_SIZE]
        small = [i for i, s in enumerate(sizes) if s <= MINIMUM_FILE_SIZE]
        if sampled:
            self._hash_sampled(paths, sizes, sampled, out)
        if small:
            self._hash_small(paths, sizes, small, out)
        return out

    # -- sampled (fixed-shape) pipeline --------------------------------------
    def _stage(self, paths, sizes, idxs: list[int]) -> tuple:
        """Gather one sub-batch into fresh rows (pinned on the card) and
        start their copy to the device. The host tensors stay referenced
        until the batch's digests are read, so no gather writes a buffer
        whose copy may still be in flight."""
        tier = _pad_to_tier(len(idxs))
        pin = self.device.type == "cuda"
        rows = torch.zeros((tier, SAMPLED_CHUNKS * 1024), dtype=torch.uint8, pin_memory=pin)
        lengths = torch.zeros(tier, dtype=torch.int32, pin_memory=pin)
        cas_native.gather_batch([paths[i] for i in idxs], [sizes[i] for i in idxs],
                                rows.numpy(), lengths.numpy())
        words = rows.view(torch.int32)  # (tier, 57 * 256) u32 words
        dev_rows = words.to(self.device, non_blocking=True)
        dev_lengths = lengths.to(self.device, non_blocking=True)
        return dev_rows, dev_lengths, (rows, lengths), idxs

    def _hash_sampled(self, paths, sizes, indices: list[int], out: list) -> None:
        """Fused gather → hash, double buffered: batch k's kernels are
        enqueued, then batch k+1 gathers and stages, and only then batch
        k-1's digests come back."""

        def collect(item) -> None:
            digest, (_rows, lengths), idxs = item
            hexes = digests_to_hex(digest)
            lens = lengths.numpy()
            for j, i in enumerate(idxs):
                out[i] = (OSError(f"cas gather failed for {paths[i]}") if lens[j] == 0
                          else hexes[j][:16])

        batches = [indices[s : s + PIPELINE_BATCH]
                   for s in range(0, len(indices), PIPELINE_BATCH)]
        staged = self._stage(paths, sizes, batches[0])
        pending = None
        for nxt in batches[1:] + [None]:
            dev_rows, dev_lengths, host, idxs = staged
            with _kernels.tagged("cas"):
                digest = blake3_batch_rows(dev_rows, dev_lengths)
            staged = self._stage(paths, sizes, nxt) if nxt is not None else None
            if pending is not None:
                collect(pending)
            pending = (digest, host, idxs)
        collect(pending)

    # -- small files (variable size, bucketed) -------------------------------
    def _hash_small(self, paths, sizes, indices: list[int], out: list) -> None:
        messages = read_sampled_batch([paths[i] for i in indices],
                                      [sizes[i] for i in indices])
        for i, cid in zip(indices, self.hash_gathered(messages)):
            out[i] = cid

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
