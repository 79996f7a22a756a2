"""Batched Gear content-defined chunking — the rolling-hash half of the
identifier's manifest stage, on the card.

Counterpart of ``spacedrive_tpu/ops/cdc.py``. Gear CDC slides a 32-byte
window: ``h_i = ((h_{i-1} << 1) + G[b_i]) mod 2^32``, cutting where
``h & mask == 0``; the left shift expires a byte after 32 steps, so the
recurrence is the windowed sum ``h_i = sum_{k<32} G[b_{i-k}] << k`` — no
carried state, every position independent.

:func:`gear_candidates` turns a (B, L) u8 plane into the (B, L) candidate
bitmap: the ``gear_candidates`` CUDA kernel (``csrc/cdc.cu``) on a CUDA
tensor, the plain version below (``_candidates_numpy``'s algebra on tensors)
on a CPU tensor. The clamp to min/max chunk sizes (:func:`resolve_cuts`)
stays on the host, as in the JAX module, so every device agrees on the
boundaries by construction. Chunk ids hash each chunk with the port's BLAKE3
(:mod:`.blake3`), cut to 32 hex characters.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib

import numpy as np
import torch

from . import _kernels
from .blake3 import blake3_batch_hex

#: rolling window width implied by the u32 left-shift recurrence
WINDOW = 32

#: truncated per-chunk BLAKE3 id length (hex chars; 128 bits)
CHUNK_ID_HEX = 32

MASK = 0xFFFFFFFF


def gear_table() -> list[int]:
    """The 256-entry u32 gear table, derived entry by entry from SHA-256 of a
    versioned label (the same derivation as the JAX module, so chunk ids —
    durable manifest data — agree across packages and library versions)."""
    return [int.from_bytes(hashlib.sha256(b"sd-cdc-gear-v1:%d" % i).digest()[:4],
                           "little") for i in range(256)]


#: the gear table as int64 values in [0, 2**32)
GEAR = torch.tensor(gear_table(), dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class ChunkParams:
    """Clamp geometry. ``avg_size`` must be a power of two (it becomes the
    boundary mask); a cut candidate at position ``c`` (exclusive end offset)
    is accepted only when ``cur + min_size <= c <= min(cur + max_size, n)``,
    else the chunk is force-cut at that upper bound."""

    min_size: int = 2048
    avg_size: int = 8192
    max_size: int = 65536

    def __post_init__(self) -> None:
        if self.avg_size & (self.avg_size - 1):
            raise ValueError("avg_size must be a power of two")
        if not (0 < self.min_size <= self.avg_size <= self.max_size):
            raise ValueError("need 0 < min <= avg <= max")

    @property
    def mask(self) -> int:
        return self.avg_size - 1


DEFAULT_PARAMS = ChunkParams()


# --------------------------------------------------------------------------
# pure-Python oracle (per-byte recurrence)
# --------------------------------------------------------------------------

_GEAR_LIST = gear_table()


def chunk_boundaries_ref(data: bytes, params: ChunkParams = DEFAULT_PARAMS) -> list[int]:
    """Cut positions (exclusive end offsets) for one file, one byte at a time."""
    mask = params.mask
    h = 0
    candidates = []
    for i, byte in enumerate(data):
        h = ((h << 1) + _GEAR_LIST[byte]) & MASK
        if (h & mask) == 0:
            candidates.append(i + 1)
    return resolve_cuts(candidates, len(data), params)


# --------------------------------------------------------------------------
# clamp resolver (host side, shared by every device)
# --------------------------------------------------------------------------


def resolve_cuts(candidates, n: int, params: ChunkParams = DEFAULT_PARAMS) -> list[int]:
    """Apply min/max clamps to ascending candidate positions: a forward scan
    that jumps to the first candidate inside the current chunk's admissible
    window, force-cutting at ``min(cur + max_size, n)`` when none lands.
    An empty file yields no chunks."""
    cuts: list[int] = []
    cur = 0
    ci = 0
    m = len(candidates)
    while cur < n:
        lo = cur + params.min_size
        hi = min(cur + params.max_size, n)
        cut = hi
        while ci < m and candidates[ci] <= hi:
            c = int(candidates[ci])
            ci += 1
            if c >= lo:
                cut = c
                break
        cuts.append(cut)
        cur = cut
    return cuts


def cuts_to_chunks(cuts: list[int]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    prev = 0
    for c in cuts:
        out.append((prev, c - prev))
        prev = c
    return out


# --------------------------------------------------------------------------
# the candidate bitmap: plain version and kernel wrapper
# --------------------------------------------------------------------------


def gear_candidates_plain(plane: torch.Tensor, lengths: torch.Tensor,
                          mask: int) -> torch.Tensor:
    """(B, L) u8 plane → (B, L) u8 candidate bitmap (bit i ⇒ cut at i+1):
    32 shifted adds of the gear-mapped plane in int64, masked to 32 bits.
    Positions before the file start contribute 0."""
    if plane.is_cuda:
        _kernels.PLAIN_ON_CUDA["gear_candidates"] += 1
    B, L = plane.shape
    g = GEAR.to(plane.device)[plane.long()]
    h = torch.zeros((B, L), dtype=torch.int64, device=plane.device)
    for k in range(min(WINDOW, L)):
        h[:, k:] += (g[:, : L - k] << k) & MASK
    cand = (h & mask) == 0
    cand &= torch.arange(L, device=plane.device)[None, :] < lengths.to(torch.int64)[:, None]
    return cand.to(torch.uint8)


_gear_on_device: dict[torch.device, torch.Tensor] = {}


def _device_gear(device: torch.device) -> torch.Tensor:
    table = _gear_on_device.get(device)
    if table is None:
        table = GEAR.to(torch.int32).to(device)  # u32 bits in an int32 carrier
        _gear_on_device[device] = table
    return table


def gear_candidates(plane: torch.Tensor, lengths: torch.Tensor,
                    mask: int) -> torch.Tensor:
    """The candidate bitmap of a (B, L) u8 plane with (B,) int32 lengths: the
    ``gear_candidates`` kernel on a CUDA tensor, the plain version on CPU."""
    if plane.dim() != 2 or lengths.shape != (plane.shape[0],):
        raise ValueError("plane must be (B, L) and lengths (B,)")
    if not 0 <= mask <= MASK:
        raise ValueError("mask must fit in 32 bits")
    if not plane.is_cuda:
        return gear_candidates_plain(plane, lengths, mask)
    if plane.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError("kernel takes a uint8 plane and int32 lengths")
    if not (plane.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("kernel takes a contiguous plane and lengths")
    if lengths.device != plane.device:
        raise ValueError("plane and lengths must share a device")
    B, L = plane.shape
    out = torch.empty_like(plane)
    _kernels.launch("cdc", "gear_candidates", plane.data_ptr(),
                    lengths.data_ptr(), _device_gear(plane.device).data_ptr(),
                    mask, out.data_ptr(), B, L, plane.device.index or 0,
                    _kernels.stream_of(plane.device), shape=(B, L))
    return out


# --------------------------------------------------------------------------
# batched entry points
# --------------------------------------------------------------------------

#: length tiers (padded plane width), so the kernel sees a handful of shapes
_LEN_TIER_MIN = 256
#: batch-size tiers (padded lane count)
_BATCH_TIERS = (8, 32, 128, 512)
#: per-call padded-cell ceiling; larger groups split into several calls
_CELL_BUDGET = 1 << 23


def _len_tier(n: int) -> int:
    return max(_LEN_TIER_MIN, 1 << max(0, (n - 1)).bit_length())


def _batch_tier(b: int) -> int:
    for t in _BATCH_TIERS:
        if t >= b:
            return t
    return -(-b // _BATCH_TIERS[-1]) * _BATCH_TIERS[-1]


def _plane(datas: list[bytes], device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-padded (batch tier, length tier) u8 plane and int32 lengths."""
    Lp = _len_tier(max((len(d) for d in datas), default=1) or 1)
    Bp = _batch_tier(len(datas))
    plane = np.zeros((Bp, Lp), np.uint8)
    lengths = np.zeros(Bp, np.int32)
    for i, d in enumerate(datas):
        plane[i, : len(d)] = np.frombuffer(d, np.uint8)
        lengths[i] = len(d)
    return torch.from_numpy(plane).to(device), torch.from_numpy(lengths).to(device)


def candidate_bitmaps(datas: list[bytes], params: ChunkParams,
                      device: str | torch.device | None = None) -> list[np.ndarray]:
    """Per-file boolean candidate bitmaps (bit i ⇒ cut at i+1), one call."""
    from .. import resolve_device

    plane, lengths = _plane(datas, resolve_device(device))
    cand = gear_candidates(plane, lengths, params.mask).cpu().numpy().astype(bool)
    return [cand[i, : len(d)] for i, d in enumerate(datas)]


def _candidate_positions(datas: list[bytes], params: ChunkParams,
                         device: torch.device) -> list[np.ndarray]:
    """Per-file ascending candidate cut positions (exclusive end offsets).
    Only the set bits leave the device, not the whole bitmap."""
    plane, lengths = _plane(datas, device)
    nz = torch.nonzero(gear_candidates(plane, lengths, params.mask)).cpu().numpy()
    bounds = np.searchsorted(nz[:, 0], np.arange(len(datas) + 1))
    return [nz[bounds[i] : bounds[i + 1], 1] + 1 for i in range(len(datas))]


def chunk_batch(datas: list[bytes], params: ChunkParams = DEFAULT_PARAMS,
                device: str | torch.device | None = None) -> list[list[tuple[int, int]]]:
    """Chunk B files at once: per-file ``(offset, length)`` lists, in input
    order. Files group by padded-length tier under a cell budget."""
    from .. import resolve_device

    dev = resolve_device(device)
    results: list[list[tuple[int, int]] | None] = [None] * len(datas)
    groups: dict[int, list[int]] = {}
    for i, d in enumerate(datas):
        groups.setdefault(_len_tier(len(d)), []).append(i)
    for tier, idxs in sorted(groups.items()):
        per_call = max(1, _CELL_BUDGET // tier)
        for s in range(0, len(idxs), per_call):
            part = idxs[s : s + per_call]
            positions = _candidate_positions([datas[i] for i in part], params, dev)
            for i, pos in zip(part, positions):
                results[i] = cuts_to_chunks(resolve_cuts(pos, len(datas[i]), params))
    return results  # type: ignore[return-value]


@functools.lru_cache(maxsize=8)
def _b3_max_chunks(max_size: int) -> int:
    return max(1, -(-max_size // 1024))


def chunk_ids(datas: list[bytes], chunk_lists: list[list[tuple[int, int]]],
              params: ChunkParams = DEFAULT_PARAMS,
              device: str | torch.device | None = None) -> list[list[str]]:
    """Per-file ordered chunk-id lists: every chunk of every file flattens
    into one :func:`blake3_batch_hex` call (ids cut to CHUNK_ID_HEX chars)."""
    msgs: list[bytes] = []
    spans: list[int] = []
    for data, chunks in zip(datas, chunk_lists):
        spans.append(len(chunks))
        for off, ln in chunks:
            msgs.append(data[off : off + ln])
    with _kernels.tagged("chunk-ids"):
        hexes = blake3_batch_hex(msgs, max_chunks=_b3_max_chunks(params.max_size),
                                 device=device)
    out: list[list[str]] = []
    pos = 0
    for n in spans:
        out.append([h[:CHUNK_ID_HEX] for h in hexes[pos : pos + n]])
        pos += n
    return out


def build_manifest(data: bytes, params: ChunkParams = DEFAULT_PARAMS,
                   device: str | torch.device | None = None) -> list[tuple[str, int]]:
    """One file → ordered ``(chunk_id, length)`` pairs — the manifest rows."""
    chunks = chunk_batch([data], params, device)[0]
    ids = chunk_ids([data], [chunks], params, device)[0]
    return [(cid, ln) for cid, (_, ln) in zip(ids, chunks)]
