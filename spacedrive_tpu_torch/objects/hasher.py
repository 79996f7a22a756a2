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

:class:`ShardedHasher` (reference :849-889) is the same two paths over a
device mesh (:mod:`..parallel.mesh`): lanes padded to a multiple of the
data axis, the fused rows through ``sharded_row_hasher``, the buckets
through ``sharded_hasher``.

:class:`RemoteHasher` (reference :1020-1124) is the shared hasher service
of BASELINE config 5: the files are sampled locally, and only their cas
messages travel, in wire batches of at most ``WIRE_BATCH`` messages and
``WIRE_BATCH_BYTES`` (16 MiB), over ``H_HASH`` to a connected peer that advertises
an accelerator and shares a library with this node; the peer hashes them
with :func:`hash_messages` on its own device hasher. When no such peer is
connected, or a batch fails (the peer went away, answered BUSY or failed a
launch), the rest of the batch hashes on this node's own device hasher,
and :data:`RemoteHasher.FALLBACKS` counts every message hashed so (by
reason: ``no_peer``, ``busy``, ``failed``).

:func:`get_hasher` picks by a location's ``hasher``: ``"tpu-sharded"``
gets the node's sharded hasher, ``"remote"`` a :class:`RemoteHasher` of the
node (one a call, as the reference's is never cached), every other name
the node's device hasher (the reference's CPU and hybrid backends are not
ported: no hybrid router, no CPU re-dispatch).

Telemetry, as the reference's (:54-72, :127-165): each batch a hasher's
entry point completes counts once, under the entry point's ``name``
(``cuda`` or ``cpu`` for the device hasher, ``tpu-sharded``, ``remote``),
in ``sd_hash_batches_total``, ``sd_hash_files_total``,
``sd_hash_bytes_total`` and ``sd_hash_batch_seconds``, and sets
``sd_hash_files_per_sec``, ``sd_hash_bytes_per_sec`` and ``sd_hash_mfu``
(the rate against the card's INT32 roofline, :mod:`..ops.roofline`; not
set on a CPU device). A batch ends when its digests are on the host (the
``.cpu()`` of :func:`..ops.blake3.digests_to_hex`), so the batch time is
the card's work and its copies, and the accounting adds no
synchronization of its own. :class:`RemoteHasher` sends the calling
thread's trace context with each wire batch (:mod:`..telemetry.mesh`), so
the serving peer's spans stitch under the caller's job trace.
"""

from __future__ import annotations

import collections
import functools
import logging
import threading
import time
from pathlib import Path
from typing import Callable

import torch

from .. import telemetry
from ..native import cas_native
from ..ops import _kernels
from ..ops.blake3 import (_pad_to_tier, blake3_batch_hex, blake3_batch_rows, digests_to_hex,
                          pack_messages)
from .cas import MINIMUM_FILE_SIZE, SAMPLED_MESSAGE_LEN, read_sampled_batch

logger = logging.getLogger(__name__)

#: chunk capacities of the message buckets (1 chunk = 1024 B); 101 covers the
#: longest whole-file message (100 KiB + the 8-byte size prefix)
SMALL_BUCKETS = (1, 4, 16, 32, 64, 101)
#: chunks of a sampled message's row in the fused path
SAMPLED_CHUNKS = (SAMPLED_MESSAGE_LEN + 1023) // 1024  # 57
#: files per device sub-batch of the fused sampled path
PIPELINE_BATCH = 2048

_HASH_BATCHES = telemetry.counter(
    "sd_hash_batches_total", "hash batches dispatched per backend",
    labels=("backend",))
_HASH_FILES = telemetry.counter(
    "sd_hash_files_total", "files hashed per backend", labels=("backend",))
_HASH_BYTES = telemetry.counter(
    "sd_hash_bytes_total", "cas-message payload bytes hashed per backend",
    labels=("backend",))
_HASH_SECONDS = telemetry.histogram(
    "sd_hash_batch_seconds", "hash batch latency per backend",
    labels=("backend",))
_HASH_RATE = telemetry.gauge(
    "sd_hash_files_per_sec", "files/s of the last hash batch")
_HASH_BPS = telemetry.gauge(
    "sd_hash_bytes_per_sec", "payload bytes/s of the last hash batch")
_HASH_MFU = telemetry.gauge(
    "sd_hash_mfu",
    "u32-VPU model-op-utilization of the last hash batch "
    "(ops/roofline.py model)")


class _OutermostGuard:
    """Process-wide depth of instrumented hasher calls: a composed call
    (the remote hasher's local fallback, the small files of a fused batch)
    counts once, under its entry point."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._depth = 0

    def enter(self) -> bool:
        with self._lock:
            self._depth += 1
            return self._depth == 1

    def leave(self) -> None:
        with self._lock:
            self._depth -= 1


_HASH_OUTERMOST = _OutermostGuard()


def _message_len(size: int) -> int:
    """Bytes of the cas message hashed for a file of ``size``."""
    return SAMPLED_MESSAGE_LEN if size > MINIMUM_FILE_SIZE else size + 8


def _record_hash(hasher, files: int, nbytes: int, seconds: float) -> None:
    backend = hasher.name
    _HASH_BATCHES.inc(backend=backend)
    _HASH_FILES.inc(files, backend=backend)
    _HASH_BYTES.inc(nbytes, backend=backend)
    _HASH_SECONDS.observe(seconds, backend=backend)
    if seconds > 0:
        from ..ops import roofline

        bps = nbytes / seconds
        _HASH_RATE.set(round(files / seconds, 1))
        _HASH_BPS.set(round(bps, 1))
        device = getattr(hasher, "device", None)
        share = roofline.mfu(bps, device) if device is not None else None
        if share is not None:
            _HASH_MFU.set(round(share, 6))


def _instrumented(bytes_of: Callable[[tuple], int]):
    """Per-batch accounting of a ``hash_batch`` / ``hash_gathered`` method,
    outermost call only; ``bytes_of(args)`` is the batch's payload."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args):
            if not telemetry.enabled():
                return fn(self, *args)
            outermost = _HASH_OUTERMOST.enter()
            t0 = time.perf_counter()
            try:
                result = fn(self, *args)
            finally:
                _HASH_OUTERMOST.leave()
            # completed batches only: an aborted one hashed nothing
            if outermost:
                _record_hash(self, len(args[0]), bytes_of(args), time.perf_counter() - t0)
            return result
        return wrapper
    return deco


def _paths_bytes(args: tuple) -> int:
    return sum(_message_len(s) for s in args[1])


def _messages_bytes(args: tuple) -> int:
    return sum(len(m) for m in args[0] if not isinstance(m, Exception))


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
        #: the ``backend`` label of this hasher's batches
        self.name = device.type

    @_instrumented(_paths_bytes)
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
        tier = self._pad_lanes(_pad_to_tier(len(idxs)))
        pin = self.device.type == "cuda"
        rows = torch.zeros((tier, SAMPLED_CHUNKS * 1024), dtype=torch.uint8, pin_memory=pin)
        lengths = torch.zeros(tier, dtype=torch.int32, pin_memory=pin)
        cas_native.gather_batch([paths[i] for i in idxs], [sizes[i] for i in idxs],
                                rows.numpy(), lengths.numpy())
        words = rows.view(torch.int32)  # (tier, 57 * 256) u32 words
        return self._to_device(words), self._to_device(lengths), (rows, lengths), idxs

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
                digest = self._hash_rows(dev_rows, dev_lengths)
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

    @_instrumented(_messages_bytes)
    def hash_gathered(self, messages: list[bytes | Exception]) -> list[str | Exception]:
        """Pre-gathered cas messages → cas_ids; Exception entries (gather
        failures) pass through in place."""
        out: list[str | Exception] = list(messages)  # type: ignore[arg-type]
        ok = [j for j, m in enumerate(messages) if not isinstance(m, Exception)]
        ids = bucketed_hash([messages[j] for j in ok], self._hash_bucket)  # type: ignore[misc]
        for j, cid in zip(ok, ids):
            out[j] = cid
        return out

    # hooks the sharded hasher overrides
    def _pad_lanes(self, n: int) -> int:
        return n

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """Start a staged host tensor's copy to the device."""
        return t.to(self.device, non_blocking=True)

    def _hash_rows(self, rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        return blake3_batch_rows(rows, lengths)


class ShardedHasher(DeviceHasher):
    """The device hasher over a mesh's data axis (reference ``ShardedHasher``
    :849): ``make_mesh()`` (every visible card) unless given ``devices``."""

    def __init__(self, devices=None) -> None:
        from ..parallel.mesh import make_mesh

        self.mesh = make_mesh(devices=devices)
        super().__init__(self.mesh.first)
        self.name = "tpu-sharded"

    def _pad_lanes(self, n: int) -> int:
        from ..parallel.mesh import pad_batch_for_mesh

        return pad_batch_for_mesh(n, self.mesh)

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        return t  # the sharded program places each shard itself

    def _hash_rows(self, rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        from ..parallel.mesh import sharded_row_hasher

        return sharded_row_hasher(self.mesh)(rows, lengths)

    def _hash_bucket(self, msgs: list[bytes], cap: int) -> list[str]:
        from ..parallel.mesh import sharded_hasher

        B = len(msgs)
        target = self._pad_lanes(_pad_to_tier(B))
        words, lengths = pack_messages(msgs + [b""] * (target - B), cap)
        with _kernels.tagged("cas"):
            digest = sharded_hasher(self.mesh)(words, lengths)
        return digests_to_hex(digest)[:B]


def hash_messages(node, messages: list[bytes]) -> list[str]:
    """cas_ids of pre-gathered cas messages on ``node``'s device hasher: the
    compute side of the shared hasher service (``H_HASH``). On the card a
    failed launch raises; nothing answers from a plain version."""
    out = node.hasher.hash_gathered(list(messages))
    bad = next((r for r in out if isinstance(r, Exception)), None)
    if bad is not None:
        raise bad
    return out  # type: ignore[return-value]


class RemoteHasher:
    """Route cas messages to a paired node's device (see the module
    docstring)."""

    name = "remote"

    #: per-request caps: they bound the peer's memory and sit well under the
    #: mux's 64 MiB per-substream buffer. The bytes are half the serving
    #: node's default ingest budget (the reference's 32 MiB is all of it):
    #: a batch and the sync window this node has in flight on the peer
    #: must fit at once, or the peer sheds one of them
    WIRE_BATCH = 1024
    WIRE_BATCH_BYTES = 16 * 1024 * 1024
    #: how long one wire batch may take, round trip included
    WIRE_TIMEOUT_S = 120.0

    #: messages hashed on this node's own device instead, by reason (the
    #: batches the peers answered are counted in ``p2p.manager.STATS``)
    FALLBACKS: collections.Counter = collections.Counter()

    def __init__(self, node) -> None:
        self._node = node

    @classmethod
    def reset_counts(cls) -> None:
        cls.FALLBACKS.clear()

    def _pick_peer(self) -> str | None:
        """A connected peer that advertises an accelerator and shares a
        library with this node (the server refuses non-members)."""
        p2p = getattr(self._node, "p2p", None)
        if p2p is None:
            return None
        members: set[str] = set()
        for library in self._node.libraries.list():
            members |= p2p.nlm.member_nodes(library)
        for peer in p2p.peer_list():
            accel = peer.get("accelerator") or {}
            if peer.get("connected") and accel.get("devices") and peer["identity"] in members:
                return peer["identity"]
        return None

    def _wire_batches(self, todo: list[int], messages) -> list[list[int]]:
        """Split by count and by cumulative bytes."""
        batches: list[list[int]] = []
        cur: list[int] = []
        cur_bytes = 0
        for i in todo:
            n = len(messages[i])
            if cur and (len(cur) >= self.WIRE_BATCH or cur_bytes + n > self.WIRE_BATCH_BYTES):
                batches.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += n
        if cur:
            batches.append(cur)
        return batches

    @_instrumented(_paths_bytes)
    def hash_batch(self, paths: list[str | Path], sizes: list[int]) -> list[str | Exception]:
        return self.hash_gathered(read_sampled_batch(paths, sizes))

    @_instrumented(_messages_bytes)
    def hash_gathered(self, messages: list[bytes | Exception]) -> list[str | Exception]:
        """Pre-gathered cas messages → cas_ids; Exception entries pass through."""
        from ..faults import PeerBusyError
        from ..telemetry import mesh

        out: list[str | Exception | None] = [None] * len(messages)
        todo: list[int] = []
        for i, msg in enumerate(messages):
            if isinstance(msg, Exception):
                out[i] = msg
            else:
                todo.append(i)
        peer_id = self._pick_peer() if todo else None
        failed: list[int] = []
        reason = "no_peer"
        if peer_id is None:
            failed = todo
        else:
            p2p = self._node.p2p
            # captured here, on the thread that holds the job's open span:
            # the p2p loop that runs the request has none
            ctx = mesh.outbound_context(origin=str(self._node.config.get().get("id") or ""))
            batches = self._wire_batches(todo, messages)
            for bi, idxs in enumerate(batches):
                batch = [messages[i] for i in idxs]
                try:
                    ids = p2p.run_coro(p2p.request_hash_batch(peer_id, batch, ctx=ctx),
                                       timeout=self.WIRE_TIMEOUT_S)
                except Exception as e:  # noqa: BLE001 — the rest hashes here
                    reason = "busy" if isinstance(e, PeerBusyError) else "failed"
                    logger.warning("remote hash batch via %s failed (%s); hashing on "
                                   "this node's device", peer_id[:8], e)
                    for rest in batches[bi:]:
                        failed.extend(rest)
                    break
                for i, cid in zip(idxs, ids):
                    out[i] = cid
        if failed:
            _kernels.count(self.FALLBACKS, reason, len(failed))
            local = self._node.hasher.hash_gathered([messages[i] for i in failed])
            for i, r in zip(failed, local):
                out[i] = r
        return out  # type: ignore[return-value]


_SHARDED_LOCK = threading.Lock()


def get_hasher(name: str | None, node) -> DeviceHasher | RemoteHasher:
    """A location's hasher by its ``hasher`` column: the node's
    :class:`ShardedHasher` for ``"tpu-sharded"`` (one a node, over
    ``node.mesh_devices``, by default every visible card, or the node's own
    device on a CPU node), a :class:`RemoteHasher` for ``"remote"``, the
    node's device hasher for every other name."""
    if name == "remote":
        return RemoteHasher(node)
    if name != "tpu-sharded":
        return node.hasher
    with _SHARDED_LOCK:
        if node.sharded_hasher is None:
            devices = node.mesh_devices
            if devices is None and node.device.type != "cuda":
                devices = [node.device]
            node.sharded_hasher = ShardedHasher(devices)
        return node.sharded_hasher
