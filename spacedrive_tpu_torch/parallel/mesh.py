"""Device mesh and sharded identity hashing.

Counterpart of ``spacedrive_tpu/parallel/mesh.py``. A mesh is a (data, seq)
grid of ``torch.device``s. The ``data`` axis shards a batch of independent
messages (or images) across devices; the ``seq`` axis shards the chunks of
each message: every seq shard hashes its contiguous chunk range as a window
(the BLAKE3 chunk kernel with chunk offsets), and the batch shard's first
device merges the chaining values. Where the reference lets XLA place the
shards and insert the collectives, here each program moves its shards
explicitly and gathers the results on the mesh's first device; on one
device every program gives the bytes of the one-device call.

Multi-process: :func:`init_multihost` wraps
``torch.distributed.init_process_group`` (gloo for CPU meshes, NCCL for the
card). A mesh made after it spans the processes: each rank's mesh holds its
own devices, each rank passes its own slice of the batch and gets its
slice's digests back, and :func:`identify_step` all-gathers the cas
prefixes, so that its duplicate flags are global, as the reference's XLA
all-gather makes them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..ops import blake3 as b3

DATA_AXIS = "data"
SEQ_AXIS = "seq"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[i][j]``: the device of data shard i, seq shard j.
    ``processes`` is the world size of the process group the mesh spans (1
    without one)."""

    devices: tuple[tuple[torch.device, ...], ...]
    processes: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), SEQ_AXIS: len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]


def _device(d) -> torch.device:
    from .. import resolve_device

    dev = resolve_device(d)
    return torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev


def make_mesh(n_devices: int | None = None, seq: int = 1, devices=None) -> Mesh:
    """A (data, seq) mesh over the first ``n_devices`` devices: every
    visible card by default (raises without one), else the given device
    list, which may repeat a device. ``seq`` devices cooperate on each
    message's chunks; the rest of the factor shards the batch."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass devices=[...] to make a mesh "
                               "over the CPU")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [_device(d) for d in devices]
    n = len(devs) if n_devices is None else n_devices
    if n > len(devs):
        raise ValueError(f"asked for {n} devices, have {len(devs)}")
    if n % seq != 0:
        raise ValueError(f"n_devices {n} not divisible by seq {seq}")
    grid = tuple(tuple(devs[i * seq : (i + 1) * seq]) for i in range(n // seq))
    dist = torch.distributed
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return Mesh(grid, world)


def pad_batch_for_mesh(n: int, mesh: Mesh) -> int:
    """Smallest batch size >= n divisible by the data-axis size."""
    d = mesh.shape[DATA_AXIS]
    return max(d, math.ceil(n / d) * d)


def _tensor(x, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy or torch input as a tensor; u32 words travel as int32."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t if dtype is None else t.to(dtype)


def _shards(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} of {n} does not divide over {parts} shards")
    return n // parts


@functools.lru_cache(maxsize=None)
def sharded_hasher(mesh: Mesh):
    """``blake3_batch`` with the batch axis sharded on ``data`` and the chunk
    axis on ``seq``: ``(16, 16, C, B)`` words and ``(B,)`` lengths →
    ``(8, B)`` digest words on the mesh's first device."""
    d, s = mesh.shape[DATA_AXIS], mesh.shape[SEQ_AXIS]

    def run(words, lengths) -> torch.Tensor:
        words, lengths = _tensor(words), _tensor(lengths, torch.int32)
        _, _, C, B = words.shape
        Bd, Cs = _shards(B, d, "a batch"), _shards(C, s, "a chunk axis")
        out = []
        for i, row in enumerate(mesh.devices):
            home = row[0]
            lens = lengths[i * Bd : (i + 1) * Bd]
            parts = []
            for j, dev in enumerate(row):
                part = words[:, :, j * Cs : (j + 1) * Cs, i * Bd : (i + 1) * Bd].to(dev)
                rows = part.permute(3, 2, 0, 1).reshape(Bd, Cs * b3.WORDS_PER_CHUNK).contiguous()
                ln = lens.to(dev)
                if s == 1:
                    parts.append(b3.chunk_cvs(rows, ln))
                    continue
                # chunks j*Cs... of each message: a window with offsets
                base = torch.full((Bd,), j * Cs, dtype=torch.int64, device=dev)
                total = ln.to(torch.int64).clamp(0, C * b3.CHUNK_LEN)
                parts.append(b3.chunk_cvs(rows, ln, base, total).to(home))
            cvs = parts[0] if s == 1 else torch.cat(parts, dim=1)
            out.append(b3.merge(cvs, lens.to(home)).to(mesh.first))
        return torch.cat(out, dim=1)

    return run


@functools.lru_cache(maxsize=None)
def sharded_row_hasher(mesh: Mesh):
    """Row-major entry (the native gather's layout, ``(B, C*256)`` words)
    with the batch axis sharded on ``data``; each shard hashes on its first
    seq device."""
    d = mesh.shape[DATA_AXIS]

    def run(rows, lengths) -> torch.Tensor:
        rows, lengths = _tensor(rows), _tensor(lengths, torch.int32)
        Bd = _shards(rows.shape[0], d, "a batch")
        out = []
        for i, row in enumerate(mesh.devices):
            dev = row[0]
            part = rows[i * Bd : (i + 1) * Bd].to(dev).contiguous()
            out.append(b3.blake3_batch_rows(part, lengths[i * Bd : (i + 1) * Bd].to(dev))
                       .to(mesh.first))
        return torch.cat(out, dim=1)

    return run


def dup_flags(prefix: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``dup[i]``: lane i is valid and a valid lower lane has its prefix."""
    n = prefix.numel()
    idx = torch.arange(n, device=prefix.device)
    dup = torch.zeros(n, dtype=torch.bool, device=prefix.device)
    if bool(valid.any()):
        keys, inverse = torch.unique(prefix[valid], return_inverse=True)
        first = torch.full((keys.numel(),), n, dtype=torch.int64, device=prefix.device)
        first.scatter_reduce_(0, inverse, idx[valid], reduce="amin")
        dup[valid] = idx[valid] != first[inverse]
    return dup


@functools.lru_cache(maxsize=None)
def identify_step(mesh: Mesh):
    """Sharded hash plus cross-device dedup: ``(digests (8, B), dup (B,)
    bool)``, where ``dup[i]`` marks a lane whose 64-bit cas prefix (digest
    words 0-1) occurred at a lower lane on any shard, on any rank of a
    multi-process mesh (the prefixes are all-gathered). Zero-length lanes
    are padding: never dup sources nor targets."""
    hasher = sharded_hasher(mesh)

    def run(words, lengths):
        digests = hasher(words, lengths)
        lengths = _tensor(lengths, torch.int32).to(mesh.first)
        prefix = (b3.u32(digests[0]) << 32) | b3.u32(digests[1])
        mine = torch.stack([prefix, (lengths > 0).to(torch.int64)])
        offset = 0
        if mesh.processes > 1:
            dist = torch.distributed
            every = [torch.empty_like(mine) for _ in range(mesh.processes)]
            dist.all_gather(every, mine)
            offset = dist.get_rank() * mine.shape[1]
            mine = torch.cat(every, dim=1)
        dup = dup_flags(mine[0], mine[1].bool())
        return digests, dup[offset : offset + lengths.shape[0]]

    return run


@functools.lru_cache(maxsize=None)
def sharded_resizer(mesh: Mesh):
    """Batched thumbnail resize (``ops.resize.resize_batch``) with the image
    batch sharded on ``data``: each shard resizes on its own device, no
    collectives; the result comes back on the mesh's first device."""
    from ..ops.resize import resize_batch

    d = mesh.shape[DATA_AXIS]

    def run(images, src_hw, tgt_hw) -> torch.Tensor:
        images, src_hw, tgt_hw = _tensor(images), _tensor(src_hw), _tensor(tgt_hw)
        Bd = _shards(images.shape[0], d, "an image batch")
        out = []
        for i, row in enumerate(mesh.devices):
            dev, sl = row[0], slice(i * Bd, (i + 1) * Bd)
            out.append(resize_batch(images[sl].to(dev), src_hw[sl].to(dev),
                                    tgt_hw[sl].to(dev)).to(mesh.first))
        return torch.cat(out)

    return run


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, device=None) -> None:
    """Join a process group (``coordinator`` is ``host:port`` of rank 0):
    NCCL on the card (the default device), gloo for ``device="cpu"``. A
    no-op for one process."""
    if num_processes in (None, 1):
        return
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    torch.distributed.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                         init_method=init, world_size=num_processes,
                                         rank=process_id)
