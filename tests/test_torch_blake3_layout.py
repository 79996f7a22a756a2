"""The index arithmetic of the BLAKE3 kernels (spacedrive_tpu_torch/csrc/
blake3.cu), emulated in numpy and held to the port's plain versions and to
the JAX package.

The CUDA kernels cannot run here, so these tests replay what each thread
of them computes: ``chunk_cvs_kernel``'s prefix of chunk counts built from
per-thread runs, its lanes numbered over real chunks and dealt to warps in
32-lane units, and its zero fill; ``merge_kernel``'s message groups, the
per-level list of pairs packed across a group's messages, the rounds of
``blockDim`` items with every read before any in-place write, ROOT and the
promoted odd tail. The compressions are the port's plain ``compress``.
Digests are bytes, so every comparison is exact (tolerance zero).
"""

import functools

import numpy as np
import pytest
import torch

from spacedrive_tpu.ops import blake3_jax
from spacedrive_tpu_torch.ops import blake3 as b3
from tests.torch_scan_cases import one_torch_thread  # noqa: F401

# the kernels' launch constants (csrc/blake3.cu)
CHUNK_THREADS, RUN = 512, 16
CHUNK_MAX_BATCH = CHUNK_THREADS * RUN
MERGE_THREADS, MERGE_MAX_GROUP, MERGE_GROUP_BYTES = 256, 32, 64 * 1024
SENTINEL = 0xDEADBEEF  # what torch.empty may hold: every slot must be written

EDGE_LENGTHS = (0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 2049, 57352, 102408)


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def owner_of(first, n: int, x: int) -> int:
    """The kernels' binary search: the largest i in [0, n) with first[i] <= x."""
    lo, hi = 0, n
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        lo, hi = (mid, hi) if first[mid] <= x else (lo, mid)
    return lo


def n_chunks(lengths: np.ndarray, C: int) -> np.ndarray:
    lens = np.clip(lengths.astype(np.int64), 0, C * 1024)
    return np.maximum(1, (lens + 1023) // 1024)


def chunk_prefix(counts: np.ndarray) -> np.ndarray:
    """The chunk kernel's prefix: thread t sums the counts of its run
    [t*per, t*per + per), the run sums are scanned, each run is rewritten as
    exclusive starts; first[B] is the total."""
    B = len(counts)
    per = -(-B // CHUNK_THREADS)
    assert per <= RUN
    first = np.full(B + 1, -1, np.int64)
    start = 0
    for t in range(CHUNK_THREADS):
        lo = min(B, t * per)
        for b in range(lo, min(B, lo + per)):
            first[b] = start
            start += counts[b]
    first[B] = start
    assert (first >= 0).all()
    return first


def lane_cvs(rows: torch.Tensor, lengths: np.ndarray, C: int, bs, cs) -> np.ndarray:
    """The chunk loop of lanes (bs[k], cs[k]), vectorized: every lane
    compresses its chunk's blocks with counter = its chunk index, the
    flags from its length, ROOT on a one-chunk message's final block."""
    bs, cs = torch.as_tensor(bs), torch.as_tensor(cs)
    words = b3.u32(rows).reshape(rows.shape[0], C, b3.BLOCKS_PER_CHUNK, 16)[bs, cs]
    lens = torch.as_tensor(np.clip(lengths.astype(np.int64), 0, C * 1024))[bs]
    single = torch.as_tensor(n_chunks(lengths, C))[bs] == 1
    chunk_len = torch.minimum(lens - cs * 1024, torch.tensor(1024))
    n_blocks = ((chunk_len + 63) // 64).clamp_min(1)
    cv = [torch.full(bs.shape, b3.IV[w], dtype=torch.int64) for w in range(8)]
    for j in range(b3.BLOCKS_PER_CHUNK):
        block_len = (chunk_len - 64 * j).clamp(0, 64)
        final = n_blocks == j + 1
        flags = (final.long() * b3.CHUNK_END + (final & single).long() * b3.ROOT
                 + (b3.CHUNK_START if j == 0 else 0))
        out = b3.compress(cv, [words[:, j, w] for w in range(16)], cs, block_len, flags)
        cv = [torch.where(j < n_blocks, out[w], cv[w]) for w in range(8)]
    return torch.stack(cv, dim=-1).numpy()


def emulate_chunk_cvs(rows: torch.Tensor, lengths: np.ndarray, sms: int) -> np.ndarray:
    """``blake3_chunk_cvs`` as the launcher slices it and each thread of
    ``chunk_cvs_kernel`` computes it; asserts that every output slot is
    written exactly once."""
    B, C = rows.shape[0], rows.shape[1] // b3.WORDS_PER_CHUNK
    out = np.full((B, C, 8), SENTINEL, np.uint64)
    writes = np.zeros((B, C), np.int64)
    lanes_b, lanes_c = [], []
    for s in range(0, B, CHUNK_MAX_BATCH):
        Bs = min(CHUNK_MAX_BATCH, B - s)
        first = chunk_prefix(n_chunks(lengths[s : s + Bs], C))
        blocks = min(sms, -(-Bs * C // CHUNK_THREADS))
        n_warps = blocks * (CHUNK_THREADS // 32)
        total = int(first[Bs])
        for warp in range(CHUNK_THREADS // 32):
            for block in range(blocks):
                gwarp = warp * blocks + block
                for b in range(gwarp, Bs, n_warps):  # the zero fill
                    n = int(first[b + 1] - first[b])
                    out[s + b, n:] = 0
                    writes[s + b, n:] += 1
                unit = gwarp
                while unit * 32 < total:
                    for i in range(unit * 32, min(unit * 32 + 32, total)):
                        b = owner_of(first, Bs, i)
                        lanes_b.append(s + b)
                        lanes_c.append(i - int(first[b]))
                    unit += n_warps
    out[lanes_b, lanes_c] = lane_cvs(rows, lengths, C, lanes_b, lanes_c)
    np.add.at(writes, (lanes_b, lanes_c), 1)
    assert (writes == 1).all(), "a CV slot was written twice or never"
    return out


def merge_group(B: int, C: int, sms: int) -> int:
    """The launcher's group size: one group an SM, at most 32 messages, the
    group's CVs within the shared-memory budget."""
    return max(1, min(-(-B // sms), MERGE_MAX_GROUP, MERGE_GROUP_BYTES // (C * 32)))


def emulate_merge(cvs: np.ndarray, lengths: np.ndarray, sms: int) -> np.ndarray:
    """``blake3_merge``: the launcher's group size, then every block of
    ``merge_kernel`` in lockstep (blocks are independent, so the order
    between them cannot matter): its real CVs loaded by the flat index, and
    per level the items of all its messages in rounds of MERGE_THREADS,
    every child read before any parent is written in place."""
    B, C, _ = cvs.shape
    group = merge_group(B, C, sms)
    counts = n_chunks(lengths, C)
    blocks = []
    for b0 in range(0, B, group):
        n = counts[b0 : b0 + group]
        first = np.concatenate([[0], np.cumsum(n)])
        nodes = np.full((len(n), C, 8), SENTINEL, np.uint64)
        for i in range(int(first[-1]) * 2):
            g = owner_of(first, len(n), i >> 1)
            c = (i >> 1) - int(first[g])
            half = slice(4 * (i & 1), 4 * (i & 1) + 4)
            nodes[g, c, half] = cvs[b0 + g, c, half]
        levels = max(int(k - 1).bit_length() for k in n)
        blocks.append({"b0": b0, "rem": n.copy(), "nodes": nodes, "levels": levels})
    for level in range(max(blk["levels"] for blk in blocks)):
        live = [blk for blk in blocks if level < blk["levels"]]
        for blk in live:
            items = np.where(blk["rem"] > 1, (blk["rem"] + 1) // 2, 0)
            blk["first"] = np.concatenate([[0], np.cumsum(items)])
        for base in range(0, max(int(blk["first"][-1]) for blk in live), MERGE_THREADS):
            pairs, copies = [], []  # (block, g, p)
            for blk in live:
                first, g_n = blk["first"], len(blk["rem"])
                for i in range(base, min(base + MERGE_THREADS, int(first[-1]))):
                    g = owner_of(first, g_n, i)
                    p = i - int(first[g])
                    (pairs if 2 * p + 1 < blk["rem"][g] else copies).append((blk, g, p))
            # reads: both children of every pair, the left node of every copy
            outs = [blk["nodes"][g, 2 * p].copy() for blk, g, p in copies]
            if pairs:
                left = np.stack([blk["nodes"][g, 2 * p] for blk, g, p in pairs]).astype(np.int64)
                right = np.stack([blk["nodes"][g, 2 * p + 1] for blk, g, p in pairs]).astype(np.int64)
                root = torch.tensor([blk["rem"][g] == 2 for blk, g, _ in pairs])
                zero = torch.zeros(len(pairs), dtype=torch.int64)
                m = [torch.from_numpy(left[:, w]) for w in range(8)] + \
                    [torch.from_numpy(right[:, w]) for w in range(8)]
                parent = b3.compress([zero + b3.IV[w] for w in range(8)], m, zero,
                                     zero + b3.BLOCK_LEN, b3.PARENT + root.long() * b3.ROOT)
                outs += list(torch.stack(parent, dim=-1).numpy().astype(np.uint64))
            # then the writes, in place at slot p of the message
            for (blk, g, p), value in zip(copies + pairs, outs):
                blk["nodes"][g, p] = value
        for blk in live:
            blk["rem"] = (blk["rem"] + 1) // 2
    digests = np.full((8, B), SENTINEL, np.uint64)
    for blk in blocks:
        for g in range(len(blk["rem"])):
            digests[:, blk["b0"] + g] = blk["nodes"][g, 0]
    return digests


def case_messages(name: str) -> tuple[list[bytes], int]:
    """(messages, C) for each case."""
    if name == "edge-lengths-padded-to-tier":
        # 12 edge lengths padded with empty messages to the 64 tier; the
        # 101-chunk message sits in a group beside one-chunk ones
        msgs = [blob(100 + i, n) for i, n in enumerate(EDGE_LENGTHS)]
        return msgs + [b""] * (b3._pad_to_tier(len(msgs)) - len(msgs)), 101
    if name == "chunk-ids-B45":
        rng = np.random.default_rng(45)
        lens = [2048, 2049, 4096, 65535, 65536, 1] + [
            int(rng.integers(1, 2048)) if rng.random() < 0.1
            else min(65536, 2048 + int(rng.exponential(6144))) for _ in range(39)]
        return [blob(200 + i, n) for i, n in enumerate(lens)], 64
    if name == "C4-tier8":
        return [blob(300 + i, n) for i, n in enumerate((4096, 0, 3000, 1, 1025))] + [b""] * 3, 4
    if name == "C1-two-slices":
        # past the chunk kernel's 8192 messages a launch: two slices
        rng = np.random.default_rng(1)
        return [blob(400 + i, int(n)) for i, n in
                enumerate(rng.integers(0, 1025, size=CHUNK_MAX_BATCH + 8))], 1
    raise KeyError(name)


CASES = ("edge-lengths-padded-to-tier", "chunk-ids-B45", "C4-tier8", "C1-two-slices")


@functools.lru_cache(maxsize=None)
def batch(name: str) -> dict:
    """A case's rows and lengths, the plain CVs and digests, and the JAX
    package's digests (XLA rung); made once per process, when first asked
    for, so a worker compiles only the shapes of the cases it runs."""
    msgs, C = case_messages(name)
    rows, lengths = b3.pack_rows(msgs, C)
    t_rows, t_lengths = torch.from_numpy(rows), torch.from_numpy(lengths)
    plain_cvs = b3.chunk_cvs_plain(t_rows, t_lengths)
    return {"rows": t_rows, "lengths": lengths, "plain_cvs": plain_cvs.numpy(),
            "plain_digests": b3.merge_plain(plain_cvs, t_lengths).numpy(),
            "jax_digests": np.asarray(blake3_jax.blake3_batch_rows(
                rows.view(np.uint32), lengths, kernel="xla")).astype(np.int64)}


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("name", CASES)
def test_chunk_lane_map_matches_plain_and_jax(name, sms):
    """Lanes over real chunks, dealt to one block per SM (132, and 3 so
    that each warp takes many units), cover every (message, chunk) slot
    once; the CVs equal the plain version's, and merged by the plain merge
    give the JAX digests."""
    case = batch(name)
    got = emulate_chunk_cvs(case["rows"], case["lengths"], sms).astype(np.int64)
    assert np.array_equal(got, case["plain_cvs"])
    digests = b3.merge_plain(torch.from_numpy(got), torch.from_numpy(case["lengths"]))
    assert np.array_equal(digests.numpy(), case["jax_digests"])


@pytest.mark.parametrize("sms", [132, 3, 2])
@pytest.mark.parametrize("name", CASES)
def test_merge_schedule_matches_plain_and_jax(name, sms):
    """The merge's groups at a card's 132 SMs (one message a group at these
    batch sizes but 8200, in groups of 32) and at 3 and 2 SMs (64 messages
    in groups of 22 and 32, the 101-chunk message beside one-chunk ones; 45
    in groups of 15 and 23), fed the plain CVs: the digests equal the plain
    merge's and the JAX package's."""
    case = batch(name)
    got = emulate_merge(case["plain_cvs"].astype(np.uint64), case["lengths"], sms)
    assert np.array_equal(got.astype(np.int64), case["plain_digests"])
    assert np.array_equal(got.astype(np.int64), case["jax_digests"])
