#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA card and check it.

Run from the repository root with no arguments (``--seed`` picks the data):

    python3 chip_smoke.py

``--kernels`` runs phases 1-3 only and prints the card and the
``{"kernels": [...]}`` line (launches null: no main path ran), never the
``{"ok": true, ...}`` line. Use it to iterate on a kernel; run with no flags
to prove the port.

Phases, each raising on failure (the script then exits non-zero and prints
no result line):

1. build the CUDA kernels from ``spacedrive_tpu_torch/csrc/`` with nvcc, and
   the native cas gather (``spacedrive_tpu_torch/native/cas_gather.cc``)
   with g++ beside them;
2. hold every kernel against its plain PyTorch version on the card, exactly
   (the outputs are integers and bits), at the main paths' shapes (cas
   messages, a full batch of chunk ids, every Gear plane tier the tree
   fills, the 1,000,000-row search index's name, path, extension and date
   columns, the exact-match columns with their key columns and the date
   column with its prefix column) and at edge cases (for the search
   kernels: needle lengths 1-5 and 48, a common first gram with no match,
   matches only at offset 0 or W-L, rows where every offset is a candidate,
   bytes >= 0x80, two different rows with one key; date rows that tie with
   the bound's 8-byte prefix, first bytes >= 0x80, bounds of 0-41 bytes),
   and BLAKE3 digests against the pure-Python oracle; the BLAKE3 kernels
   also at the fused cas path's (tier, 57 chunks) rows at every tier it
   sends (8-2048); and the MinHash device programs (``minhash_rows``,
   ``similar_pairs_count``, PyTorch ops of the reference's XLA programs) on
   the card against the same functions on the CPU, on edge rows (lengths
   0-15, words >= 2**31, an N that is not a multiple of BLOCK); and the
   thumbnailer's ``resize_batch`` (PyTorch, two gathered taps a pass in
   fp32) on a full (32,
   1024, 1024, 3) sub-batch and a mixed batch (below the canvas, 1x1, a
   reduced panorama, padding lanes) against the CPU and a float64 bilinear
   at max |diff| <= 1, then again under
   ``torch.set_float32_matmul_precision("high")``, which must give the same
   pixels;
3. time each kernel and its plain version at those shapes (CUDA events, or
   the profiler's device time where a wrapper call takes longer to issue
   than the kernel runs; where the profiler loses launches, CUDA events
   around each call behind a spin kernel, logged as such, which are also
   logged beside the profiler's time for the BLAKE3 chunk and search
   kernels), beside the least time the card could take, and
   count the SASS instructions per block of the BLAKE3 chunk kernel
   (cuobjdump); time the resize on the full sub-batch beside the work's
   bound (its bytes), the time the reference's dense form would need for
   its fp32 operations, and a loop of ``F.interpolate`` calls;
4. the scan path: write a seeded tree of 16,384 files shaped like BASELINE
   config 2 (mixed media), boot ``Node`` on the card with chunk manifests and
   the search engine on, ``create_location`` → ``scan_location`` →
   ``wait_idle`` with the identify job on the streaming pipeline at its
   defaults (sharded gather, group commit, adaptive pages), log its stage
   busy times, check cas_ids and a sample of manifests against the oracles,
   and show through the launch counters that the scan went through every
   scan kernel and never through a plain version, and through the native
   gather's counters that every identify gather was native (its path,
   ring or pread threads, logged) and no file was re-read through Python;
   the tree's locations have preview media off (its images are random
   bytes; phase 6 drives the media processor);
   check the chained near-duplicate job (every planted copy over 100 KiB
   persisted at similarity 1.0, ``search.nearDuplicates`` equal to the
   persisted groups), run it once more with ``method="all_pairs"``, hold the
   MinHash programs on 2,048 gathered rows of the tree against their CPU
   runs and time them; hash the tree's files through the fused
   ``node.hasher.hash_batch`` (its cas_ids must equal the scan's); scan the
   tree into a third library under ``SD_PIPELINE=0`` (the sequential step
   loop), whose rows must equal the pipelined scan's, and print both
   identify rates; then scan the tree again, pipelined, under
   torch.profiler for the device's busy share;
5. the search path: serve ``search.paths`` / ``search.pathsCount`` from the
   device index of the scanned library and of a 1,000,000-row library built
   with the search benchmark's corpus recipe (plus 1,024 files of 2-64 GiB),
   byte-identical to the SQL path for every query; time engine and SQLite,
   and each key column's host build, upload and patch; rename and add 1,000
   rows each and show the refresh patched the index incrementally; show
   through the launch counters that the search went through all three
   search kernels and never through a plain version; then hold the exact
   and range kernels against their plain versions on the patched path and
   date columns;
6. the media path: write a seeded photo library shaped like BASELINE
   config 3 (256 files: 12 MP camera frames, phone portraits, screenshots,
   web images, panoramas and 8 corrupt .jpg files; JPEGs with EXIF and a
   GPS fix where PIL exists), report which host codecs exist, scan it with
   preview media on, and check every thumbnail (a WebP whose header gives
   ``target_dims`` of the reduced source), the ``new_thumbnail`` events, one
   error and no thumbnail a corrupt file, the per-file retries, the resize
   calls (all on the card), the ``media_data`` rows (dimensions, EXIF, plus
   code) and that a rescan makes no thumbnail; hold one call of each shape
   against the CPU, time each shape beside its bounds and the
   ``F.interpolate`` loop, and replay each call under the profiler for its
   device and H2D time;
7. print the ``{"device_programs": [...]}`` line (the MinHash programs' and
   the resize's times, calls on the path, CUDA kernels a call, and bounds),
   the card, the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
   line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

#: HBM rate of the H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: bytes written between timed calls to clear the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20
#: u32 operations per BLAKE3 compression as the card issues them: 7 rounds
#: x 8 G, each G four adds (``a + b + m`` is one three-input IADD3), four
#: xors and four rotates (one SHF or PRMT each), then the 8 feed-forward
#: xors of a chaining value: 7 * 8 * 12 + 8 = 680 per 64-byte block (two-input
#: operations would count 800)
OPS_PER_COMPRESSION = 680
#: u32 operations per Gear position as the function needs them, the
#: recurrence h = (h << 1) + GEAR[b]: shift, add, table lookup, mask test,
#: length test
OPS_PER_GEAR_POSITION = 5
#: Gear planes (length tier, files) as the scan fills them: small files by
#: octave (about half of them 256 B or less, in batch tier 128; 15 an octave
#: above, in tier 32), 100-128 KiB files 48 to a (128, 128 KiB) plane, 32 to
#: a (32, 256 KiB) plane, 16 to a (32, 512 KiB) plane; and 4 MiB, the
#: largest file a manifest takes
GEAR_TIERS = ((256, 120), (4 << 10, 15), (128 << 10, 48), (256 << 10, 32), (512 << 10, 16),
              (4 << 20, 2))
#: lengths at the Gear kernel's edges: its 16-position lanes, 32-byte halo
#: and 512-position units (L - 1 and L added per plane)
GEAR_EDGES = (0, 1, 15, 16, 17, 30, 31, 32, 33, 511, 512, 513, 1023, 1024, 1025)
#: plane widths for the edges: a row shorter than a unit, two unit-crossing
#: tiers, and a width that is not a multiple of 16 (the byte path)
GEAR_EDGE_WIDTHS = (256, 4096, 128 << 10, 1000)
#: every mask reads a different reach of the window (8191 is the default);
#: 0 flags every position
GEAR_MASKS = (0, 255, 8191, 0xFF000000)
#: timings some kernels add beside "ms": the wrapper call's time where "ms"
#: is device time, every row read whole (search), the device time with the
#: L2 cleared before each call (BLAKE3, Gear), the merge's levels times one
#: level's device time, the device time from CUDA events behind a spin
#: kernel (``event_ms``, the fallback of ``device_ms``; BLAKE3 chunks, search)
EXTRA_TIMES = ("call_ms", "full_row_bound_ms", "cold_ms", "latency_floor_ms", "event_ms")
#: BLAKE3 rotates per compression (7 rounds x 8 G x 4), used to find how many
#: compressions the compiler put in one pass of the chunk loop
ROTATES_PER_COMPRESSION = 224

EDGE_LENGTHS = (0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 2049, 57352, 102408)

#: the batch tiers of the fused cas path's sub-batches (at most 2048 files)
FUSED_TIERS = (8, 64, 512, 1024, 2048)
#: u32 operations per shingle and hash of ``minhash_rows`` in the
#: reference's u32 form as the card issues them: two multiply-adds (IMAD) to
#: mix the shingle, three shifts, three xors and two multiplies of the
#: finalizer, the validity select and the min
OPS_PER_SHINGLE_HASH = 12
#: u32 operations per signature component and pair of
#: ``similar_pairs_count``: the compare and the add of the match count
OPS_PER_COMPONENT_PAIR = 2

#: BASELINE config 2 (mixed media) has 100,000 files; the smoke test cuts
#: the count to stay well inside its time limit, keeping the size mix
N_SMALL, N_MEDIUM, N_LARGE, N_EMPTY, N_COPIES, N_DIRS = 4096, 11264, 1024, 64, 512, 64
EXTS = ("jpg", "png", "mp4", "mov", "mp3", "pdf", "txt", "zip", "bin", "json")

#: the search library: the search benchmark's corpus (bench.py bench_search,
#: BENCH_search.json corpus_rows), the size large Spacedrive libraries reach
N_SEARCH_ROWS = 1_000_000
#: files of 2-64 GiB (disk images, raw video) appended to it, so sizes past
#: 2**31 are scored on the card
N_BIG_ROWS = 1024
SEARCH_WORDS = ["report", "photo", "invoice", "backup", "video", "track", "draft", "final",
                "holiday", "scan", "render", "notes", "meeting", "budget", "design", "export",
                "raw", "edit"]
SEARCH_EXTS = ["pdf", "jpg", "png", "mov", "mp4", "txt", "doc", "zip", "flac", "dng", None]
SEARCH_DIRS = ["/"] + [f"/{a}/{b}/" for a in SEARCH_WORDS[:8] for b in SEARCH_WORDS[8:]]
BIG_EXTS = ["iso", "dmg", "img", "mov", "mxf", "r3d"]

#: the search benchmark's ten queries (bench.py bench_search) and two past
#: 2**31 bytes: (label, procedure, arg)
SEARCH_MATRIX = [
    ("substring_rare", "search.paths", {"search": "holiday-budget-00", "take": 100}),
    ("substring_word", "search.pathsCount", {"search": "invoice"}),
    ("substring_cold", "search.paths", {"search": "zq-never-written", "take": 100}),
    ("prefix_dir", "search.paths",
     {"materialized_path": SEARCH_DIRS[3], "search": "design", "take": 200}),
    ("extension", "search.pathsCount", {"extensions": ["flac", ".DNG"]}),
    ("filters_kind_fav", "search.pathsCount", {"kinds": [2, 3], "favorite": True}),
    ("date_range", "search.pathsCount",
     {"date_range": ["2026-06-01T00:00:00+00:00", "2026-06-30T23:59:59+00:00"],
      "search": "render"}),
    ("size_range", "search.pathsCount", {"size_range": [1 << 28, None], "search": "raw-"}),
    ("paginate_cursor", "search.paths", {"search": "photo-track", "take": 50}),
    ("paginate_offset", "search.paths", {"search": "meeting", "take": 50, "skip": 100}),
    ("size_2gib", "search.paths", {"size_range": [2 ** 31, None], "take": 100}),
    ("size_8_32gib", "search.paths", {"size_range": [2 ** 33, 2 ** 35], "take": 100}),
]
#: the queries served after 1,000 renames and 1,000 inserts
AFTER_REFRESH = [
    ("renamed", "search.paths", {"search": "renamed-0", "take": 200, "include_hidden": True}),
    ("added", "search.pathsCount", {"search": "added-", "include_hidden": True}),
    ("size_2gib_after", "search.paths", {"size_range": [2 ** 31, None], "take": 100}),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` back-to-back calls, between
    two CUDA events after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float, int32_ops_per_s: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int32_ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def canon(value) -> str:
    return json.dumps(value, sort_keys=True, default=str)


def sass_instructions(library: Path, function: str) -> list | None:
    """(address, opcode, branch target or None) of each SASS instruction of
    the first function in ``library`` whose name contains ``function``,
    read with cuobjdump; None where cuobjdump or the function is missing."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    dump = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True)
    if dump.returncode != 0:
        return None
    body = next((part for part in dump.stdout.split("Function : ")[1:]
                 if function in part.splitlines()[0]), None)
    if body is None:
        return None
    instrs, labels, pending = [], {}, []
    for line in body.splitlines():
        line = line.strip()
        label = re.match(r"^(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        ins = re.match(r"^/\*([0-9a-f]+)\*/\s+(.*?)\s*;", line)
        if not ins:
            continue
        addr = int(ins.group(1), 16)
        labels.update((name, addr) for name in pending)
        pending = []
        words = [w for w in ins.group(2).split() if not w.startswith("@")]
        # a branch names its target by label or by address, as versions differ
        target = re.search(r"\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\s*$", ins.group(2))
        if target and target.group(2):
            target = int(target.group(2), 16)
        elif target:
            target = labels.get(target.group(1))
        instrs.append((addr, words[0], target))
    return instrs


def sass_opcodes(library: Path, function: str) -> dict | None:
    """Opcode counts of one function's SASS (static: each instruction once)."""
    import collections

    instrs = sass_instructions(library, function)
    if instrs is None:
        return None
    ops = collections.Counter(op.split(".")[0] for _a, op, _t in instrs if op != "NOP")
    return dict(ops.most_common())


def sass_chunk_loop() -> dict | None:
    """SASS instructions per 64-byte block in ``blake3_chunk_cvs``'s chunk
    loop, read with cuobjdump from the built library: the shortest backward
    branch of the kernel whose span holds a compression bounds the loop, and
    its rotates (SHF + PRMT) say how many compressions one pass holds. None
    where cuobjdump is missing or the loop cannot be found."""
    import collections

    from spacedrive_tpu_torch.ops import _kernels

    instrs = sass_instructions(_kernels._target("blake3"), "chunk_cvs_kernel")
    if instrs is None:
        return None
    loops = [(t, a) for a, op, t in instrs
             if op.startswith("BRA") and t is not None and t < a]

    def opcodes(span):
        return collections.Counter(op.split(".")[0] for a, op, _ in instrs
                                   if span[0] <= a <= span[1] and op != "NOP")

    def compressions_in(ops):
        return round((ops["SHF"] + ops["PRMT"]) / ROTATES_PER_COMPRESSION)

    # the chunk loop is the innermost loop that holds a compression (a loop
    # around it, over lanes, holds one too and more besides)
    loops = [span for span in loops if compressions_in(opcodes(span)) >= 1]
    if not loops:
        return None
    ops = opcodes(min(loops, key=lambda span: span[1] - span[0]))
    compressions = compressions_in(ops)
    return {"per_block": sum(ops.values()) / compressions,
            "imad_per_block": ops["IMAD"] / compressions, "compressions": compressions,
            "by_opcode": dict(ops.most_common())}


# --------------------------------------------------------------------------
# phase 2: parity on the card
# --------------------------------------------------------------------------


def blake3_inputs(messages: list[bytes], cap: int):
    import torch

    from spacedrive_tpu_torch.ops import blake3 as b3

    rows, lengths = b3.pack_rows(messages, cap)
    return torch.from_numpy(rows).cuda(), torch.from_numpy(lengths).cuda()


def chunk_id_messages(rng: random.Random, n: int = 4096) -> list[bytes]:
    """A batch of chunk-id messages as the manifest stage sends them (4096
    is a full batch): CDC chunks (mostly 2 KiB plus a geometric tail, capped
    at 64 KiB; one in ten a short final chunk of a file), with the edge
    lengths pinned."""
    lens = [2048, 2049, 4096, 65535, 65536, 1]
    while len(lens) < n:
        lens.append(rng.randint(1, 2047) if rng.random() < 0.1
                    else min(65536, 2048 + int(rng.expovariate(1 / 6144))))
    return [rng.randbytes(n) for n in lens]


def blake3_edge_batches(rng: random.Random) -> list[tuple[str, list[bytes], int]]:
    """(name, messages, C) of batches at the BLAKE3 kernels' edges: 512
    messages of 0-1024 B in 1-chunk rows (the hasher's smallest bucket),
    8193 messages of 0-4 KiB in 4-chunk rows (two chunk-kernel launches, merge
    groups of 31), and 4096 messages in 101-chunk rows where one of every 15
    (the merge group at this size) is 102,408 B and the rest one chunk or
    empty."""
    small = [rng.randbytes(rng.randint(0, 1024)) for _ in range(512)]
    slices = [rng.randbytes(rng.randint(0, 4096)) for _ in range(8193)]
    mixed = [rng.randbytes(102408 if i % 15 == 7 else rng.choice((0, 1, 1024, rng.randint(2, 1023))))
             for i in range(4096)]
    return [("512 messages of 0-1024 B, C = 1", small, 1),
            ("8193 messages of 0-4 KiB, C = 4", slices, 4),
            ("4096 messages, one 101-chunk message per merge group, C = 101", mixed, 101)]


def check_blake3(rows, lengths, name: str) -> int:
    """Kernel vs plain version on the card, both phases; returns the max
    absolute difference of the u32 words (0 or raise)."""
    import torch

    from spacedrive_tpu_torch.ops import blake3 as b3

    kc = b3.chunk_cvs(rows, lengths)
    pc = b3.chunk_cvs_plain(rows, lengths)
    km = b3.merge(kc, lengths)
    pm = b3.merge_plain(pc, lengths)
    torch.cuda.synchronize()
    err = max(int((b3.u32(kc) - pc).abs().max()), int((b3.u32(km) - pm).abs().max()))
    if err:
        fail(f"blake3 kernels disagree with the plain version on {name} (max err {err})")
    return err


def parity_phase(rng: random.Random, cols: dict) -> dict:
    import torch

    from spacedrive_tpu_torch.objects.blake3_ref import blake3 as oracle
    from spacedrive_tpu_torch.objects.cas import SAMPLED_MESSAGE_LEN
    from spacedrive_tpu_torch.objects.hasher import SAMPLED_CHUNKS
    from spacedrive_tpu_torch.ops import blake3 as b3
    from spacedrive_tpu_torch.ops import cdc

    # edge geometry in the 101-chunk bucket (a non-power-of-two chunk count)
    edge = [rng.randbytes(n) for n in EDGE_LENGTHS]
    rows, lengths = blake3_inputs(edge + [b""] * (8 - len(edge) % 8), 101)
    err_edge = check_blake3(rows, lengths, "edge lengths")
    got = b3.digests_to_hex(b3.blake3_batch_rows(rows, lengths))[: len(edge)]
    if got != [oracle(m).hex() for m in edge]:
        fail("blake3 kernel digests differ from the Python oracle at the edge lengths")
    log(f"parity: blake3 edge lengths {list(EDGE_LENGTHS)} match plain and oracle "
        "exactly (tolerance 0)")

    # a full device batch of sampled messages in the 64-chunk bucket
    sampled = [rng.randbytes(SAMPLED_MESSAGE_LEN) for _ in range(1024)]
    rows, lengths = blake3_inputs(sampled, 64)
    err_sampled = check_blake3(rows, lengths, "1024 sampled messages")
    got = b3.digests_to_hex(b3.blake3_batch_rows(rows, lengths))
    for i in (0, 511, 1023):
        if got[i] != oracle(sampled[i]).hex():
            fail(f"blake3 digest {i} of the sampled batch differs from the oracle")
    log("parity: blake3 on 1024 x 57,352-byte sampled messages (64-chunk bucket) "
        "matches plain exactly (tolerance 0); 3 digests match the oracle")

    # the chunk-id job: 4096 CDC chunks of mixed lengths in 64-chunk rows
    chunks = chunk_id_messages(rng)
    rows, lengths = blake3_inputs(chunks, 64)
    err_ids = check_blake3(rows, lengths, "4096 chunk-id messages")
    got = b3.digests_to_hex(b3.blake3_batch_rows(rows, lengths))
    for i in (0, 4, 5, 6, 4095):
        if got[i] != oracle(chunks[i]).hex():
            fail(f"blake3 digest {i} ({len(chunks[i])} B) of the chunk-id batch differs "
                 "from the oracle")
    log(f"parity: blake3 on {len(chunks)} chunk-id messages of 1 B-64 KiB "
        f"({sum(map(len, chunks)) / 1e6:.1f} MB, rows {tuple(rows.shape)}) matches plain "
        "exactly (tolerance 0); 5 digests match the oracle")

    # the new edges of the lane map and the merge groups: C = 1 (no merge
    # level), B past the chunk kernel's 8192 messages a launch, and at
    # C = 101 a 101-chunk message in every merge group beside one-chunk ones
    errs = []
    for name, msgs, C in blake3_edge_batches(rng):
        rows, lengths = blake3_inputs(msgs, C)
        errs.append(check_blake3(rows, lengths, name))
        got = b3.digests_to_hex(b3.blake3_batch_rows(rows, lengths))
        for i in (0, 7, len(msgs) - 1):
            if got[i] != oracle(msgs[i]).hex():
                fail(f"blake3 digest {i} ({len(msgs[i])} B) of the {name} batch differs from "
                     "the oracle")
        log(f"parity: blake3 on {name} (rows {tuple(rows.shape)}) matches plain exactly "
            "(tolerance 0); 3 digests match the oracle")

    # the fused cas path's rows: sampled messages in 57-chunk rows at every
    # tier a sub-batch pads to, the last three rows empty (padding)
    fused = [rng.randbytes(SAMPLED_MESSAGE_LEN) for _ in range(FUSED_TIERS[-1])]
    for tier in FUSED_TIERS:
        msgs = fused[: tier - 3] + [b""] * 3
        rows, lengths = blake3_inputs(msgs, SAMPLED_CHUNKS)
        errs.append(check_blake3(rows, lengths, f"{tier} rows of 57 chunks"))
        got = b3.digests_to_hex(b3.blake3_batch_rows(rows, lengths))
        for i in (0, tier - 4, tier - 1):
            if got[i] != oracle(msgs[i]).hex():
                fail(f"blake3 digest {i} of the ({tier}, 57) batch differs from the oracle")
    del fused
    log(f"parity: blake3 on sampled messages in 57-chunk rows (the fused cas path) at tiers "
        f"{list(FUSED_TIERS)} matches plain exactly (tolerance 0); 3 digests a tier match the "
        "oracle")
    err_groups = max(errs)

    # Gear candidate bitmaps at every plane tier the scan fills, and at the
    # kernel's edges with random bytes past every length and in the padding
    shapes = []
    for tier, n_files in GEAR_TIERS:
        datas = [rng.randbytes(rng.randint(tier // 2 + 1, tier)) for _ in range(n_files)]
        plane, lens = cdc._plane(datas, torch.device("cuda"))
        found = check_gear(plane, lens, cdc.DEFAULT_PARAMS.mask, f"{n_files} files")
        shapes.append(f"{tuple(plane.shape)} {n_files} files {found} candidates")
    log(f"parity: gear_candidates matches plain exactly (tolerance 0) at {'; '.join(shapes)}")
    for width in GEAR_EDGE_WIDTHS:
        plane, lens = gear_edge_plane(width, rng.randrange(1 << 30))
        for mask in GEAR_MASKS:
            check_gear(plane, lens, mask, f"edge lengths, mask {mask:#x}")
    # a plane that starts one byte into its buffer takes the byte path
    buf = torch.empty(plane.numel() + 1, dtype=torch.uint8, device="cuda")
    shifted = buf[1:].view(plane.shape)
    shifted.copy_(plane)
    check_gear(shifted, lens, cdc.DEFAULT_PARAMS.mask, "a plane 1 byte off alignment")
    log(f"parity: gear_candidates matches plain exactly (tolerance 0) at lengths "
        f"{list(GEAR_EDGES)} + L-1, L in planes of widths {list(GEAR_EDGE_WIDTHS)} padded to "
        f"their batch tier, masks {[hex(m) for m in GEAR_MASKS]}, and on a "
        "plane off 16-byte alignment")
    err_b3 = max(err_edge, err_sampled, err_ids, err_groups)
    return {"blake3_chunk_cvs": err_b3, "blake3_merge": err_b3, "gear_candidates": 0,
            **search_parity(cols), **minhash_edge_parity(rng)}


def check_minhash(rows, lengths, what: str) -> dict:
    """``minhash_rows`` and ``similar_pairs_count`` (thresholds 51 and 64 of
    64, the rows padded to BLOCK) on the card against the same functions on
    the CPU, on ``rows`` (B, W) int32 words and ``lengths`` held on the
    host. Returns the max absolute difference of each (0, or fail)."""
    import torch

    from spacedrive_tpu_torch.ops import minhash

    got = minhash.minhash_rows(rows.cuda(), lengths.cuda()).cpu()
    want = minhash.minhash_rows(rows, lengths)
    err_sigs = int((got - want).abs().max())
    if err_sigs:
        fail(f"minhash_rows on the card differs from the CPU on {what} (max err {err_sigs})")
    sigs, valid = minhash.pad_for_blocks(want.numpy())
    err_pairs = 0
    found = []
    for thr in (51, 64):
        total, dup = minhash.similar_pairs_count(torch.from_numpy(sigs).cuda(),
                                                 torch.from_numpy(valid).cuda(), thr)
        ctotal, cdup = minhash.similar_pairs_count(torch.from_numpy(sigs),
                                                   torch.from_numpy(valid), thr)
        err_pairs = max(err_pairs, abs(int(total) - int(ctotal)), int((dup.cpu() != cdup).sum()))
        found.append(int(ctotal))
    if err_pairs:
        fail(f"similar_pairs_count on the card differs from the CPU on {what} (max err {err_pairs})")
    log(f"parity: minhash_rows and similar_pairs_count on {what} (rows {tuple(rows.shape)}, "
        f"compared as ({sigs.shape[0]}, 64)) match the CPU exactly (tolerance 0); similar pairs "
        f"at 51 / 64 of 64: {found[0]} / {found[1]}")
    return {"minhash_rows": err_sigs, "similar_pairs_count": err_pairs}


def minhash_edge_rows(rng: random.Random, n: int = 1000):
    """(n, 14592) int32 rows of random words (about half >= 2**31) with
    lengths 0-15 on the first 16 rows and random ones up to the row after;
    rows 100-109 copy row 99, and row 201 is row 200 with 4 KiB of its
    bytes changed (similar pairs to find). n = 1000 is not a multiple of
    BLOCK."""
    import numpy as np
    import torch

    gen = np.random.default_rng(rng.randrange(1 << 30))
    rows = gen.integers(0, 1 << 32, (n, 14592), dtype=np.uint64).astype(np.uint32)
    lengths = gen.integers(0, 58369, n).astype(np.int32)
    lengths[:16] = np.arange(16)
    lengths[99:110] = 57352
    rows[100:110] = rows[99]
    lengths[200:202] = 57352
    rows[201] = rows[200]
    rows[201, 1000:2024] = gen.integers(0, 1 << 32, 1024, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(rows.view(np.int32)), torch.from_numpy(lengths)


def minhash_edge_parity(rng: random.Random) -> dict:
    rows, lengths = minhash_edge_rows(rng)
    return check_minhash(rows, lengths, "edge rows (lengths 0-15, words >= 2**31, copies, "
                         "an edited copy, N = 1000)")


def gear_edge_plane(width: int, seed: int):
    """A (batch tier, width) plane on the card with one row per edge length
    (those <= width, plus width - 1 and width) and rows of length 0 to the
    batch tier; every byte is random, past the lengths and in padding rows
    too, and one row starts with 600 equal bytes."""
    import numpy as np
    import torch

    from spacedrive_tpu_torch.ops import cdc

    lens = sorted({n for n in GEAR_EDGES + (width - 1, width) if n <= width})
    g = np.random.default_rng(seed)
    plane = g.integers(0, 256, size=(cdc._batch_tier(len(lens)), width), dtype=np.uint8)
    plane[1, :600] = 0
    lengths = np.zeros(plane.shape[0], np.int32)
    lengths[: len(lens)] = lens
    return torch.from_numpy(plane).cuda(), torch.from_numpy(lengths).cuda()


def check_gear(plane, lens, mask: int, what: str) -> int:
    """The Gear kernel against its plain version on the card, exactly;
    returns the number of candidates."""
    import torch

    from spacedrive_tpu_torch.ops import cdc

    kb = cdc.gear_candidates(plane, lens, mask)
    pb = cdc.gear_candidates_plain(plane, lens, mask)
    torch.cuda.synchronize()
    err = int((kb.int() - pb.int()).abs().max())
    if err:
        fail(f"gear_candidates disagrees with the plain version at {tuple(plane.shape)}, "
             f"{what} (max err {err})")
    return int(kb.sum())


def search_corpus() -> list[tuple]:
    """The search benchmark's corpus recipe (bench.py bench_search:
    random.Random(15), the same words, extensions and 81 directories, 1% of
    rows sharing objects with kind/favorite, sizes 1 B-1 GiB, ISO dates),
    then N_BIG_ROWS files of 2-64 GiB. A row is (pub_id, materialized_path,
    name, extension, hidden, size, object slot or None, date_created)."""
    rng = random.Random(15)
    n_objects = max(1, N_SEARCH_ROWS // 100)
    rows = []
    for i in range(N_SEARCH_ROWS):
        name = (f"{rng.choice(SEARCH_WORDS)}-{rng.choice(SEARCH_WORDS)}"
                f"-{i:07d}.{rng.choice(SEARCH_EXTS[:-1])}")
        rows.append((f"fp-{i:07d}", rng.choice(SEARCH_DIRS), name, rng.choice(SEARCH_EXTS),
                     rng.choice((None, 0, 0, 0, 1)), rng.randrange(1, 1 << 30),
                     i % n_objects if i % 2 else None,
                     f"2026-{1 + i % 12:02d}-{1 + i % 28:02d}T"
                     f"{i % 24:02d}:{i % 60:02d}:00+00:00"))
    big = random.Random(16)
    for i in range(N_BIG_ROWS):
        ext = big.choice(BIG_EXTS)
        rows.append((f"fp-big-{i:04d}", big.choice(SEARCH_DIRS),
                     f"{big.choice(SEARCH_WORDS)}-image-{i:04d}.{ext}", ext, 0,
                     big.randrange(2 << 30, (64 << 30) + 1), None,
                     f"2026-{1 + i % 12:02d}-{1 + i % 28:02d}T12:00:00+00:00"))
    return rows


def corpus_columns(corpus: list[tuple]) -> dict:
    """The index's byte columns of the corpus as the device mirror holds
    them: row-major (CAP, W) u8 on the card, zero-padded, names folded; and
    the key columns of the path and extension rows and the prefix column of
    the date rows."""
    import numpy as np
    import torch

    from spacedrive_tpu_torch.search.kernels import date_prefix_of, fold, pad_cap, row_keys

    cap = pad_cap(len(corpus))

    def rows(values: list[bytes], width: int):
        out = np.zeros((cap, width), dtype=np.uint8)
        out[: len(values)] = np.array(values, dtype=f"S{width}").view(np.uint8).reshape(
            len(values), width)
        return out

    path = rows([r[1].encode() for r in corpus], 96)
    ext = rows([(r[3] or "").encode() for r in corpus], 12)
    date = rows([r[7].encode() for r in corpus], 40)
    cols = {"name": rows([fold(r[2].encode()) for r in corpus], 64), "path": path, "ext": ext,
            "date": date, "path_key": row_keys(path), "ext_key": row_keys(ext),
            "date_prefix": date_prefix_of(date)}
    return {k: torch.from_numpy(v).cuda() for k, v in cols.items()}


def edge_rows(seed: int, width: int, n: int = 4096 + 77):
    """Rows over a small alphabet (many partial matches), empty rows, and
    every seventh row exactly W bytes long, on the card."""
    import numpy as np
    import torch

    g = np.random.default_rng(seed)
    rows = g.choice(np.frombuffer(b"abc.-\xc3", dtype=np.uint8), size=(n, width))
    lens = g.integers(0, width + 1, size=n)
    lens[::7] = width
    rows[np.arange(width)[None, :] >= lens[:, None]] = 0
    return torch.from_numpy(rows).cuda()


def keys_of(rows):
    """The key column of (CAP, W) rows on the card (kernels.row_keys)."""
    import torch

    from spacedrive_tpu_torch.search.kernels import row_keys

    return torch.from_numpy(row_keys(rows.cpu().numpy())).to(rows.device)


def prefix_of(rows):
    """The prefix column of (CAP, 40) date rows on the card
    (kernels.date_prefix_of)."""
    import torch

    from spacedrive_tpu_torch.search.kernels import date_prefix_of

    return torch.from_numpy(date_prefix_of(rows.cpu().numpy())).to(rows.device)


def search_parity(cols: dict) -> dict:
    """Each search kernel against its plain version on the card, exactly, at
    the 1,000,000-row index's shapes and at edge cases. Returns the max
    absolute difference per kernel (0 or raise)."""
    import torch

    from spacedrive_tpu_torch.search import kernels as K
    from tests.torch_search_cases import (LEX_BOUND, LEX_BOUNDS, birthday_pair, lex_rows,
                                          substring_cases)

    pairs = {"search_substring": (K.substring, K.substring_plain),
             "search_exact": (K.exact, K.exact_plain),
             "search_lex": (K.lex_cmp, K.lex_cmp_plain)}
    # on the index's names: L = 1-5 and 48, a first gram common in the names
    # ("phot") with no match, bytes >= 0x80
    cases = [("search_substring", cols["name"], nd, None)
             for nd in (b"e", b"in", b"inv", b"invo", b"invoi", b"holiday-budget-00",
                        b"zq-never-written", b"holiday-" * 6, b"photo-zz", b"\xc3\xa9t\xc3")]
    cases += [("search_exact", cols["path"], nd, cols["path_key"])
              for nd in (SEARCH_DIRS[3].encode(), b"/", b"")]
    cases += [("search_exact", cols["ext"], nd, cols["ext_key"]) for nd in (b"flac", b"dng", b"")]
    # the date column with its prefixes: bounds of 0, 7, 8, 9, 25 and 45
    # bytes (the last clipped to 40)
    cases += [("search_lex", cols["date"], nd, cols["date_prefix"])
              for nd in (LEX_BOUND, b"2026-06-30T23:59:59+00:00", b"", LEX_BOUND[:7],
                         LEX_BOUND[:8], LEX_BOUND[:9], b"2026-12-28T23:59:00+00:00" + b"Z" * 20)]
    # and with tests/torch_search_cases.py's date rows planted through it:
    # rows that tie with the bound's prefix and differ at byte 8, 9 or 39 or
    # nowhere, first bytes >= 0x80, zero rows
    planted = cols["date"].clone()
    edge = torch.from_numpy(lex_rows(0)).cuda()
    planted[torch.arange(len(edge), device=planted.device) * (len(planted) // len(edge))] = edge
    planted_prefix = prefix_of(planted)
    cases += [("search_lex", planted, nd, planted_prefix) for nd in LEX_BOUNDS]
    for nd in LEX_BOUNDS:
        rows = torch.from_numpy(lex_rows(len(nd))).cuda()
        cases.append(("search_lex", rows, nd, prefix_of(rows)))
    # edge cases: L = 1, 17, 48 with the needle planted at the last offset
    # of a W-length row; W-length rows against W-length, empty, short and
    # longer-than-W needles and bounds
    names = edge_rows(1, 64)
    for length in (1, 17, 48):
        needle = bytes(names[3, 64 - length:].tolist()) if length > 1 else b"a"
        names[5, 64 - length:] = torch.tensor(list(needle), dtype=torch.uint8)
        cases.append(("search_substring", names.clone(), needle, None))
    # the gram filter's and the verify's edges (tests/torch_search_cases.py):
    # L = 1-5 and 48, a common first gram with no match, matches only at
    # offset 0 and W-L, rows where every offset is a candidate, bytes >=
    # 0x80, NULs in the needle, 779 rows
    cases += [("search_substring", torch.from_numpy(rows).cuda(), nd, None)
              for _label, rows, nd in substring_cases()]
    for width in (96, 12):
        rows = edge_rows(width, width)
        cases += [("search_exact", rows, nd, keys_of(rows))
                  for nd in (bytes(rows[7].tolist()), b"", b"a", b"x" * (width + 1))]
        # two different rows with one key: one planted in the column, the
        # other beside it and used as the needle
        a, b = birthday_pair(width, width)
        for where in (rows.clone(), cols["path" if width == 96 else "ext"].clone()):
            where[17] = torch.from_numpy(a).cuda()
            where[len(where) // 2] = torch.from_numpy(b).cuda()
            keys = keys_of(where)
            if int(keys[17]) != int(keys[len(where) // 2]):
                fail(f"the planted rows of width {width} do not share a key")
            cases.append(("search_exact", where, bytes(b.tolist()), keys))
    dates = edge_rows(40, 40)
    row7 = bytes(dates[7].tolist())
    cases += [("search_lex", dates, nd, prefix_of(dates))
              for nd in (b"", b"b", b"abc", b"\xc3", row7, row7[:7], row7[:8], row7[:9],
                         b"c" * 41)]
    errs = {name: 0 for name in pairs}
    for name, rows, needle, keys in cases:
        kernel, plain = pairs[name]
        got = kernel(rows, needle) if keys is None else kernel(rows, needle, keys)
        want = plain(rows, needle)
        torch.cuda.synchronize()
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
        if err:
            fail(f"{name} disagrees with its plain version on rows {tuple(rows.shape)}, "
                 f"needle {needle!r} (max err {err})")
        errs[name] = max(errs[name], err)
    log(f"parity: search kernels on {len(cases)} cases (the 1,000,000-row index's name "
        f"{tuple(cols['name'].shape)}, path, extension and date columns, path and extension "
        "keyed; substring L = 1-5, 17, 48, a common first gram with no match, matches only at "
        "offset 0 and W-L, every offset a candidate, bytes >= 0x80, NULs; exact with two "
        "different rows of one key planted; lex with its prefix column, rows tied with the "
        "bound's 8-byte prefix, first bytes >= 0x80, bounds of 0-41 bytes; W-length rows; "
        "empty, short and over-long needles and bounds) match plain exactly (tolerance 0)")
    return errs


def search_work(rows, needle: bytes, substring: bool) -> tuple[int, int]:
    """(bytes read, byte compares) the function needs on these rows, its
    flag per row written included in the bytes. Substring compares, at each
    offset j <= W-L, until the first mismatch, so it reads positions 0..W-L
    and the ones a partial match reaches; exact and lex read each row up to
    its first byte that differs from the needle."""
    import torch

    cap, width = rows.shape
    if substring:
        offsets = width - len(needle) + 1
        touched = torch.zeros_like(rows, dtype=torch.bool)
        touched[:, :offsets] = True
        compares = cap * offsets
        live = rows[:, :offsets] == needle[0]
        for k in range(1, len(needle)):
            compares += int(live.sum())
            touched[:, k : k + offsets] |= live
            live &= rows[:, k : k + offsets] == needle[k]
        return int(touched.sum()) + cap, compares
    padded = torch.zeros(width, dtype=torch.uint8, device=rows.device)
    clipped = needle[:width]
    padded[: len(clipped)] = torch.tensor(list(clipped), dtype=torch.uint8)
    differs = rows != padded
    first = torch.where(differs.any(1), differs.to(torch.uint8).argmax(1) + 1,
                        torch.full((cap,), width, device=rows.device))
    compares = int(first.sum())
    return compares + cap, compares


#: the CUDA function of each search kernel, as the profiler names it
SEARCH_SYMBOLS = {"search_substring": "::substring_kernel<", "search_exact": "::exact_kernel<",
                  "search_lex": "::lex_kernel<"}


#: cycles of the spin kernel that ``event_ms`` queues before each call:
#: about 0.5 ms at the H100's clock, far longer than the host takes to
#: issue the call and its two events
SPIN_CYCLES = 1_000_000


def event_ms(fn, reps: int, between=None) -> float:
    """Mean device time per call of ``fn`` from two CUDA events around each
    call, queued behind a spin kernel: the card reaches the first event only
    after the host has issued the call and the second event, so the
    interval is the call's device work and not the host's time to issue it.
    ``between``, if given, runs before each spin and is not timed."""
    import torch

    pairs = []
    for _ in range(reps):
        if between is not None:
            between()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / reps


def device_ms(fn, kernel: str, reps: int = 50, between=None) -> float:
    """Mean device time per launch of the CUDA kernel whose name contains
    ``kernel`` over ``reps`` calls of ``fn``, from torch.profiler: the
    kernel alone, without the host's time to issue the call. ``between``,
    if given, runs before each call and is not timed.

    The profiler now and then reports fewer launches than were made (none,
    or 46 of 50), so a window counts only if it saw each launch once. After
    three windows without one, the time comes from ``event_ms`` and the log
    says so. More records than launches fail: ``kernel`` then names another
    kernel too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        count = sum(e.count for e in events)
        if count == reps:
            return sum(e.self_device_time_total for e in events) / reps / 1e3
        if count > reps:
            fail(f"the profiler saw {count} launches of {kernel}, not {reps}")
        seen.append(count)
    ms = event_ms(fn, reps, between)
    log(f"time: the profiler saw {seen} of {reps} launches of {kernel} in {len(seen)} windows; "
        f"{ms:.4f} ms per call from CUDA events behind a spin kernel instead")
    return ms


def search_timing(cols: dict, int32_ops_per_s: float, flush) -> dict:
    """Each search kernel on the 1,000,000-row index's columns: its device
    time per launch (profiler), L2-warm and with ``flush`` written before
    each launch to clear the L2, the time of a call of its wrapper and of
    its plain version (CUDA events over back-to-back calls; a call costs the
    host ~15 us to issue, more than some of these kernels take). The exact
    kernel is given the key columns, the range kernel the prefix column. The
    bound counts the bytes this data needs read (see search_work) and each
    result written once, and each byte compare it needs as one INT32
    operation, whatever columns the kernel reads; ``full_row_bound_ms``
    reads every row's W bytes."""
    from spacedrive_tpu_torch.search import kernels as K

    # every needle the search phase sends to the large library (folded, as
    # the engine sends it), so the launches counted by needle length each
    # have a time
    needles = sorted({K.fold(arg["search"].encode()) for _l, _p, arg in SEARCH_MATRIX + AFTER_REFRESH
                      if "search" in arg} | {b"inv"}, key=lambda nd: (len(nd), nd))
    jobs = tuple((f"search_substring@L{len(nd)}" + ("" if len(nd) in (3, 17) else f"-{nd.decode()}"),
                  K.substring, K.substring_plain, cols["name"], nd, ()) for nd in needles)
    jobs += (("search_exact@path", K.exact, K.exact_plain, cols["path"],
              SEARCH_DIRS[3].encode(), (cols["path_key"],)),
             ("search_exact@ext", K.exact, K.exact_plain, cols["ext"], b"flac",
              (cols["ext_key"],)),
             ("search_lex@date", K.lex_cmp, K.lex_cmp_plain, cols["date"],
              b"2026-06-01T00:00:00+00:00", (cols["date_prefix"],)),
             # a bound whose prefix no row shares: no row is read past its
             # prefix, so beside the bench bound it shows what the tied
             # rows' reads cost
             ("search_lex@date-no-tie", K.lex_cmp, K.lex_cmp_plain, cols["date"],
              b"2027-01-01T00:00:00+00:00", (cols["date_prefix"],)))
    out = {}
    for name, kernel, plain, rows, needle, keys in jobs:
        cap, width = rows.shape
        nbytes, ops = search_work(rows, needle, kernel is K.substring)
        ties = ("" if kernel is not K.lex_cmp else
                f", {int((keys[0] == K.bound_prefix(needle, width)).sum())} rows tie on "
                f"the bound's prefix")
        symbol = SEARCH_SYMBOLS[name.split("@")[0]]
        out[name] = {
            "ms": device_ms(lambda: kernel(rows, needle, *keys), symbol),
            "cold_ms": device_ms(lambda: kernel(rows, needle, *keys), symbol,
                                 between=flush.zero_),
            "event_ms": event_ms(lambda: kernel(rows, needle, *keys), 50),
            "call_ms": time_ms(lambda: kernel(rows, needle, *keys), 50),
            "plain_ms": time_ms(lambda: plain(rows, needle), 3, warmup=1),
            "bound": bound_ms(nbytes, ops, int32_ops_per_s),
            "full_row_bound_ms": cap * (width + 1) / HBM_BYTES_PER_S * 1e3,
            "shape": f"rows ({cap}, {width}) u8, needle {len(needle)} B, "
                     f"{nbytes / cap:.1f} B and {ops / cap:.1f} compares per row needed{ties}"}
    return out


# --------------------------------------------------------------------------
# phase 3: times on the card
# --------------------------------------------------------------------------


def merge_level_ms(b3) -> float:
    """Device time of one level of ``blake3_merge``: a single message of 64
    chunks (6 levels) against one of 2 chunks (1 level), each alone in a
    launch, so the difference is five levels of one compression's dependent
    chain plus the level's shared-memory round trip and barriers."""
    import torch

    t = {}
    for n in (2, 64):
        rows, lengths = blake3_inputs([bytes(n * 1024)], 64)
        cvs = b3.chunk_cvs(rows, lengths)
        t[n] = device_ms(lambda: b3.merge(cvs, lengths), "merge_kernel")
    del rows, lengths, cvs
    torch.cuda.empty_cache()
    level_ms = (t[64] - t[2]) / 5
    log(f"time: blake3_merge of one message alone: 2 chunks (1 level) {t[2]:.4f} ms, 64 chunks "
        f"(6 levels) {t[64]:.4f} ms; one level {level_ms:.5f} ms (device time)")
    return level_ms


def blake3_timing(rng: random.Random, int32_ops_per_s: float, flush) -> dict:
    """Both BLAKE3 kernels at the shapes the scan launches them: 1024
    sampled cas messages and full (4096) and half (2048) batches of chunk ids,
    all in 64-chunk rows; and a full sub-batch (2048) of the fused cas path in
    57-chunk rows. Device time per launch (profiler), L2-warm and with
    the L2 cleared before each call, beside the wrapper call's time; the
    merge also against its latency floor, the batch's levels times one
    level's device time (``merge_level_ms``)."""
    from spacedrive_tpu_torch.objects.cas import SAMPLED_MESSAGE_LEN
    from spacedrive_tpu_torch.ops import blake3 as b3

    level_ms = merge_level_ms(b3)
    out = {}
    jobs = (("", [rng.randbytes(SAMPLED_MESSAGE_LEN) for _ in range(1024)],
             f"{SAMPLED_MESSAGE_LEN}-byte messages", 64),
            ("@chunk-ids", chunk_id_messages(rng), "chunk-id messages of 1 B-64 KiB", 64),
            ("@chunk-ids-2048", chunk_id_messages(rng, 2048),
             "2048 chunk-id messages of 1 B-64 KiB", 64),
            ("@fused-2048", [rng.randbytes(SAMPLED_MESSAGE_LEN) for _ in range(2048)],
             f"{SAMPLED_MESSAGE_LEN}-byte messages of the fused cas path", 57))
    for suffix, messages, what, C in jobs:
        rows, lengths = blake3_inputs(messages, C)
        B, C = rows.shape[0], rows.shape[1] // 256
        lens = [len(m) for m in messages]
        n_chunks = [max(1, -(-n // 1024)) for n in lens]
        blocks = sum(max(1, -(-min(n - c * 1024, 1024) // 64))
                     for n, k in zip(lens, n_chunks) for c in range(k))
        cvs = b3.chunk_cvs(rows, lengths)
        pcvs = b3.chunk_cvs_plain(rows, lengths)
        nbytes = blocks * 64 + B * 4 + B * C * 32
        out["blake3_chunk_cvs" + suffix] = {
            "ms": device_ms(lambda: b3.chunk_cvs(rows, lengths), "chunk_cvs_kernel"),
            "cold_ms": device_ms(lambda: b3.chunk_cvs(rows, lengths), "chunk_cvs_kernel",
                                 between=flush.zero_),
            "event_ms": event_ms(lambda: b3.chunk_cvs(rows, lengths), 50),
            "call_ms": time_ms(lambda: b3.chunk_cvs(rows, lengths), 50),
            "plain_ms": time_ms(lambda: b3.chunk_cvs_plain(rows, lengths), 3, warmup=1),
            "bound": bound_ms(nbytes, blocks * OPS_PER_COMPRESSION, int32_ops_per_s),
            "blocks": blocks,
            "shape": f"rows ({B}, {C}*256) u32, {what}, {sum(n_chunks)} chunks"}
        parents = sum(k - 1 for k in n_chunks)
        levels = (max(n_chunks) - 1).bit_length()
        nbytes = sum(n_chunks) * 32 + B * 4 + B * 32
        out["blake3_merge" + suffix] = {
            "ms": device_ms(lambda: b3.merge(cvs, lengths), "merge_kernel"),
            "cold_ms": device_ms(lambda: b3.merge(cvs, lengths), "merge_kernel",
                                 between=flush.zero_),
            "call_ms": time_ms(lambda: b3.merge(cvs, lengths), 50),
            "plain_ms": time_ms(lambda: b3.merge_plain(pcvs, lengths), 3, warmup=1),
            "bound": bound_ms(nbytes, parents * OPS_PER_COMPRESSION, int32_ops_per_s),
            "latency_floor_ms": levels * level_ms,
            "shape": f"cvs ({B}, {C}, 8) u32, {what}, {parents} parents, {levels} levels"}
    return out


def timing_phase(rng: random.Random, int32_ops_per_s: float, cols: dict) -> dict:
    import torch

    from spacedrive_tpu_torch.ops import _kernels, cdc

    # back-to-back calls on one input find it and their output in the 50 MB
    # L2, which the HBM-priced bound does not; writing this between calls
    # evicts both
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    out = blake3_timing(rng, int32_ops_per_s, flush)
    for tier, n_files in GEAR_TIERS[1:]:
        datas = [rng.randbytes(rng.randint(tier // 2 + 1, tier)) for _ in range(n_files)]
        plane, plens = cdc._plane(datas, torch.device("cuda"))
        mask = cdc.DEFAULT_PARAMS.mask
        Bp, L = plane.shape
        positions = sum(len(d) for d in datas)
        # the bytes the function needs: the files' bytes and the lengths
        # read, the table read once, the whole plane of flags written
        nbytes = positions + Bp * 4 + 256 * 4 + Bp * L
        out[f"gear_candidates@{tier >> 10}KiB"] = {
            "ms": device_ms(lambda: cdc.gear_candidates(plane, plens, mask),
                            "gear_candidates_kernel"),
            "cold_ms": device_ms(lambda: cdc.gear_candidates(plane, plens, mask),
                                 "gear_candidates_kernel", between=flush.zero_),
            "call_ms": time_ms(lambda: cdc.gear_candidates(plane, plens, mask), 50),
            "plain_ms": time_ms(lambda: cdc.gear_candidates_plain(plane, plens, mask), 3,
                                warmup=1),
            "bound": bound_ms(nbytes, positions * OPS_PER_GEAR_POSITION, int32_ops_per_s),
            "shape": f"plane ({Bp}, {L}) u8, {n_files} files, {positions} B"}
    out.update(search_timing(cols, int32_ops_per_s, flush))
    for name, t in out.items():
        b, by = t["bound"]
        full = t.get("full_row_bound_ms")
        call = "" if "call_ms" not in t else f" (device time; a wrapper call {t['call_ms']:.4f} ms)"
        cold = ("" if "cold_ms" not in t else f"; with the L2 cleared before each call "
                f"{t['cold_ms']:.4f} ms, {100 * b / t['cold_ms']:.1f}% of bound")
        events = ("" if "event_ms" not in t else
                  f"; CUDA events behind a spin kernel {t['event_ms']:.4f} ms")
        floor = t.get("latency_floor_ms")
        floor = "" if floor is None else (f"; latency floor {floor:.4f} ms, kernel at "
                                          f"{100 * floor / t['ms']:.1f}% of it")
        log(f"time: {name} [{t['shape']}]: kernel {t['ms']:.4f} ms{call}, "
            f"plain {t['plain_ms']:.4f} ms, bound {b:.4f} ms ({by}), kernel at "
            f"{100 * b / t['ms']:.1f}% of bound{cold}{events}{floor}"
            + ("" if full is None else f"; reading every row whole {full:.4f} ms, kernel at "
               f"{100 * full / t['ms']:.1f}% of that"))

    # the bound above prices the fewest instructions a block needs; also
    # price the instructions the compiler emitted, at the same 64 per SM per
    # clock
    sass = sass_chunk_loop()
    for name in ("blake3_chunk_cvs", "blake3_chunk_cvs@chunk-ids",
                 "blake3_chunk_cvs@chunk-ids-2048", "blake3_chunk_cvs@fused-2048"):
        t = out[name]
        t["sass"] = None if sass is None else {
            "per_block": sass["per_block"],
            "bound_ms": t["blocks"] * sass["per_block"] / int32_ops_per_s * 1e3}
    if sass is None:
        log("sass: instructions per block of blake3_chunk_cvs not measured "
            "(no cuobjdump, or its chunk loop not found)")
    else:
        t = out["blake3_chunk_cvs"]
        # IMAD issues on the FMA pipe, beside the integer ALU pipe
        alu_ms = (t["blocks"] * (sass["per_block"] - sass["imad_per_block"])
                  / int32_ops_per_s * 1e3)
        log(f"sass: blake3_chunk_cvs issues {sass['per_block']:.1f} instructions per 64-byte "
            f"block ({sass['compressions']} compression(s) per pass of its chunk loop; "
            f"{sass['by_opcode']}); at 64 per SM per clock that bounds the sampled batch at "
            f"{t['sass']['bound_ms']:.4f} ms, kernel at "
            f"{100 * t['sass']['bound_ms'] / t['ms']:.1f}% of it; without the "
            f"{sass['imad_per_block']:.0f} IMADs per block {alu_ms:.4f} ms, kernel at "
            f"{100 * alu_ms / t['ms']:.1f}%")
    # the substring kernel, unrolled over its 64 offsets: its static SASS
    # is about what a row issues (the filter) plus the verify's loops
    for kernel in ("substring_kernel", "lex_kernel"):
        ops = sass_opcodes(_kernels._target("search"), kernel)
        log(f"sass: {kernel}: " + ("not measured (no cuobjdump, or the kernel not found)"
                                   if ops is None else
                                   f"{sum(ops.values())} instructions (static) {ops}"))
    return out


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------


class RandomBytes:
    """Seeded random bytes made in bulk on the card and consumed in order."""

    def __init__(self, seed: int, block: int = 256 << 20) -> None:
        import torch

        self.gen = torch.Generator(device="cuda")
        self.gen.manual_seed(seed)
        self.block = block
        self.buf = b""
        self.pos = 0

    def take(self, n: int) -> bytes:
        import torch

        if self.pos + n > len(self.buf):
            size = max(self.block, n)
            self.buf = self.buf[self.pos:] + torch.randint(
                0, 256, (size,), dtype=torch.uint8, device="cuda",
                generator=self.gen).cpu().numpy().tobytes()
            self.pos = 0
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out


def write_tree(root: Path, seed: int) -> dict:
    """The BASELINE config 2 shape at 16,384 files in 64 directories: small
    files 1 B-100 KiB log-uniform (64 empty), medium 100 KiB+1-512 KiB fully
    random, large 16-256 MiB sparse (only the header, the four sample regions
    and the footer written), and 512 byte-identical copies planted among the
    small and medium files; synced to disk before it returns."""
    from spacedrive_tpu_torch.objects.cas import sample_offsets

    rng = random.Random(seed)
    sizes = [0] * N_EMPTY + [max(1, int(math.exp(rng.uniform(0, math.log(100 << 10)))))
                             for _ in range(N_SMALL - N_EMPTY)]
    sizes += [rng.randint((100 << 10) + 1, 512 << 10) for _ in range(N_MEDIUM)]
    n_sm = len(sizes)
    sizes += [rng.randint(16 << 20, 256 << 20) for _ in range(N_LARGE)]
    picks = rng.sample(range(N_EMPTY, n_sm), 2 * N_COPIES)
    copy_of = dict(zip(picks[N_COPIES:], picks[:N_COPIES]))  # copy -> original
    for dst, src in copy_of.items():
        sizes[dst] = sizes[src]
    paths = [root / f"d{i % N_DIRS:02d}" / f"f{i:05d}.{EXTS[i % len(EXTS)]}"
             for i in range(len(sizes))]
    for d in range(N_DIRS):
        (root / f"d{d:02d}").mkdir(parents=True)
    data = RandomBytes(seed)
    originals = set(copy_of.values())
    content: dict[int, bytes] = {}
    written = 0
    for i in range(n_sm):
        if i in copy_of:
            continue
        blob = data.take(sizes[i])
        paths[i].write_bytes(blob)
        written += len(blob)
        if i in originals:
            content[i] = blob
    for dst, src in copy_of.items():
        paths[dst].write_bytes(content[src])
        written += sizes[dst]
    for i in range(n_sm, len(sizes)):
        with open(paths[i], "wb") as fh:
            fh.truncate(sizes[i])
            for off, ln in sample_offsets(sizes[i]):
                fh.seek(off)
                fh.write(data.take(ln))
                written += ln
    # the scans that follow read this tree: flush its dirty pages now, so
    # that the first scan does not share the disk with their writeback
    t0 = time.perf_counter()
    os.sync()
    return {"paths": paths, "sizes": sizes, "copy_of": copy_of, "bytes_written": written,
            "sync_s": time.perf_counter() - t0}


#: the CUDA functions of the scan's kernels, as the profiler names them
SCAN_KERNEL_SYMBOLS = ("::chunk_cvs_kernel(", "::merge_kernel(", "::gear_candidates_kernel<")


def identify_location(lib, tree_dir: Path) -> dict:
    """A location over phase 4's tree with preview media off: its .jpg and
    .png files are random bytes, not images, and the identify, rescan and
    busy-share numbers stay comparable with those of the runs before the
    media processor joined the scan (phase 6 drives it)."""
    from spacedrive_tpu_torch.locations import create_location
    from spacedrive_tpu_torch.models import Location

    loc = create_location(lib, tree_dir)
    lib.db.update(Location, {"id": loc["id"]}, {"generate_preview_media": False})
    return loc


def profiled_scan(node, tree_dir: Path) -> None:
    """Scan the tree again into a second library under torch.profiler
    (CUDA activity only) and print the device's busy share of the scan and
    its time by kernel. The end-to-end numbers come from the unprofiled scan
    before it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spacedrive_tpu_torch.locations import scan_location

    lib = node.libraries.create("chip-smoke-profiled")
    loc = identify_location(lib, tree_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scan_location(lib, loc["id"])
        if not node.jobs.wait_idle(900):
            fail("profiled scan did not finish within 900 s")
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                 if e.self_device_time_total > 0}
    busy_s = sum(device_us.values()) / 1e6
    ranked = sorted(device_us.items(), key=lambda kv: -kv[1])
    # the eight largest, and the port's scan kernels wherever they rank
    top = [kv for i, kv in enumerate(ranked)
           if i < 8 or any(k in kv[0] for k in SCAN_KERNEL_SYMBOLS)]
    _job, meta, _seconds = identify_job(lib.db)
    log(f"main path (profiled pipelined rescan into a second library): wall {wall_s:.2f} s, "
        f"device busy {busy_s:.3f} s = {100 * busy_s / wall_s:.2f}% (idle "
        f"{100 - 100 * busy_s / wall_s:.2f}%); pipeline {pipeline_line(meta)}; "
        "device time by activity: " + "; ".join(f"{k[:60]} {v / 1e3:.1f} ms" for k, v in top))


def scan_rows(db) -> tuple:
    """What two scans of one tree must agree on: cas_id per path, the
    grouping of paths into objects (object ids differ by schedule) and the
    manifest rows per cas_id."""
    paths, groups = {}, {}
    for r in db.query("SELECT materialized_path, name, extension, cas_id, object_id "
                      "FROM file_path WHERE is_dir = 0"):
        key = (r["materialized_path"], r["name"], r["extension"])
        paths[key] = r["cas_id"]
        if r["object_id"] is not None:
            groups.setdefault(r["object_id"], []).append(key)
    manifests: dict = {}
    for r in db.query("SELECT DISTINCT fp.cas_id, cm.seq, cm.chunk_hash, cm.length "
                      "FROM chunk_manifest cm JOIN file_path fp ON fp.object_id = cm.object_id "
                      "ORDER BY fp.cas_id, cm.seq"):
        manifests.setdefault(r["cas_id"], []).append((r["seq"], r["chunk_hash"], r["length"]))
    return paths, sorted(sorted(g) for g in groups.values()), manifests


def identify_job(db) -> tuple[dict, dict, float]:
    """(job row, metadata, seconds from start to end) of the identify job."""
    from datetime import datetime

    row = dict(db.query("SELECT * FROM job WHERE name = 'file_identifier'")[0])
    meta = json.loads(row["metadata"])
    seconds = (datetime.fromisoformat(row["date_completed"])
               - datetime.fromisoformat(row["date_started"])).total_seconds()
    return row, meta, seconds


def pipeline_line(meta: dict) -> str:
    """The pipeline's stage busy times and their shares of its wall."""
    wall = meta["pipeline_wall_s"]
    return (f"page {meta['pipeline_page_s']:.2f} s ({100 * meta['pipeline_page_s'] / wall:.1f}%), "
            f"hash {meta['pipeline_hash_s']:.2f} s ({100 * meta['pipeline_hash_s'] / wall:.1f}%), "
            f"commit {meta['pipeline_commit_s']:.2f} s "
            f"({100 * meta['pipeline_commit_s'] / wall:.1f}%) of wall {wall:.2f} s; "
            f"{meta['pipeline_batches']} batches in {meta['commit_txns']} transactions, "
            f"{meta['pipeline_shards']} gather shards; gather {meta['gather_s']:.2f} s")


def sequential_scan(node, tree_dir: Path, pipelined: tuple, n: int) -> float:
    """Scan the tree into a third library with the pipeline off; its rows
    must equal the pipelined scan's. Returns the identify job's seconds."""
    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import scan_location

    lib = node.libraries.create("chip-smoke-sequential")
    loc = identify_location(lib, tree_dir)
    os.environ["SD_PIPELINE"] = "0"
    try:
        scan_location(lib, loc["id"])
        if not node.jobs.wait_idle(900):
            fail("sequential scan did not finish within 900 s")
    finally:
        del os.environ["SD_PIPELINE"]
    job, meta, seconds = identify_job(lib.db)
    if job["status"] != JobStatus.COMPLETED or "pipeline_batches" in meta:
        fail(f"sequential identify job ended {job['status']} with {meta}")
    rows = scan_rows(lib.db)
    for what, a, b in zip(("cas_ids", "object grouping", "manifests"), rows, pipelined):
        if a != b:
            fail(f"the sequential scan's {what} differ from the pipelined scan's")
    log(f"main path: the sequential scan (SD_PIPELINE=0) gives the pipelined scan's rows: "
        f"cas_ids of {len(rows[0])} paths, {len(rows[1])} objects, {len(rows[2])} manifests equal; "
        f"identify job {seconds:.2f} s = {n / seconds:.1f} files/s; process stage "
        f"{meta['hash_time']:.2f} s, gather {meta['gather_s']:.2f} s")
    return seconds


def check_manifests(db, tree: dict, row_of, seed: int, n_files: int = 16) -> int:
    """Hold the scan's manifests of ``n_files`` seeded files against the
    oracles: cuts from the per-byte Gear recurrence, ids from the pure-Python
    BLAKE3 of each chunk's bytes. Returns the number of chunks checked."""
    from spacedrive_tpu_torch.objects.blake3_ref import blake3 as oracle
    from spacedrive_tpu_torch.objects.manifest import payload_cap
    from spacedrive_tpu_torch.ops.cdc import CHUNK_ID_HEX, chunk_boundaries_ref, cuts_to_chunks

    rng = random.Random(seed + 2)
    chunkable = [i for i, s in enumerate(tree["sizes"]) if 0 < s <= payload_cap()]
    checked = 0
    for i in rng.sample(chunkable, n_files):
        path = tree["paths"][i]
        data = path.read_bytes()
        want = [(oracle(data[off : off + ln]).hex()[:CHUNK_ID_HEX], ln)
                for off, ln in cuts_to_chunks(chunk_boundaries_ref(data))]
        got = [(r["chunk_hash"], r["length"]) for r in db.query(
            "SELECT chunk_hash, length FROM chunk_manifest WHERE object_id = ? ORDER BY seq",
            [row_of(path)["object_id"]])]
        if got != want:
            fail(f"manifest of {path} ({len(data)} B) differs from the oracles: "
                 f"{len(got)} rows, oracle {len(want)} chunks")
        checked += len(want)
    return checked


def gather_line() -> str:
    """The native gather's batches by path, its EWMA cost per file and the
    threads it would take for a 1,024-file slice."""
    from spacedrive_tpu_torch.native import cas_native

    us = cas_native.gather_us_per_file()
    return (f"batches by path {dict(cas_native.GATHER_BATCHES)}, EWMA "
            f"{'not measured' if us is None else f'{us:.1f} us/file'} (serial-equivalent), "
            f"{cas_native._default_gather_threads(1024)} threads for a 1,024-file slice")


def job_seconds(row) -> float:
    from datetime import datetime

    return (datetime.fromisoformat(row["date_completed"])
            - datetime.fromisoformat(row["date_started"])).total_seconds()


def dedup_checks(node, lib, loc_id: int, tree: dict, id_of) -> dict:
    """The chained near-duplicate job of the scan: it completed, every
    planted copy over 100 KiB is persisted with its original at similarity
    1.0 and both share a persisted group, and ``search.nearDuplicates``
    serves the persisted groups. Then the same detection once more with
    ``method="all_pairs"`` (the scan's tree is past ALL_PAIRS_LIMIT, so the
    job took the banded path), whose copy pairs inside its window must be
    found too."""
    import torch

    from spacedrive_tpu_torch.api.routers import search as router
    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.objects.cas import MINIMUM_FILE_SIZE
    from spacedrive_tpu_torch.objects.dedup import (ALL_PAIRS_LIMIT, find_near_duplicates,
                                                    persisted_near_duplicate_groups)
    from spacedrive_tpu_torch.ops import minhash

    db = lib.db
    job = dict(db.query("SELECT * FROM job WHERE name = 'dedup_detector'")[0])
    if job["status"] != JobStatus.COMPLETED:
        fail(f"dedup_detector job ended {job}")
    meta = json.loads(job["metadata"])
    near = {(r["file_path_a_id"], r["file_path_b_id"]): r["similarity"]
            for r in db.query("SELECT * FROM near_duplicate")}
    persisted = persisted_near_duplicate_groups(db, limit=5000)
    group_of = {row["id"]: k for k, group in enumerate(persisted["groups"]) for row in group}
    planted = [tuple(sorted((id_of(tree["paths"][dst]), id_of(tree["paths"][src]))))
               for dst, src in tree["copy_of"].items() if tree["sizes"][src] > MINIMUM_FILE_SIZE]
    for a, b in planted:
        if near.get((a, b)) != 1.0 or a not in group_of or group_of[a] != group_of.get(b):
            fail(f"planted copy pair of file_path ids {a}, {b} is not persisted at similarity "
                 f"1.0 in one group (row: {near.get((a, b))})")
    served = router.near_duplicates(node, lib, {})
    if served != persisted_near_duplicate_groups(db):
        fail("search.nearDuplicates differs from persisted_near_duplicate_groups")
    log(f"main path: dedup_detector {JobStatus.NAMES[job['status']]} in {job_seconds(job):.2f} s, "
        f"method {meta.get('method')}, {meta['scanned']} files over 100 KiB, "
        f"{len(near)} near_duplicate rows in {len(persisted['groups'])} groups; all "
        f"{len(planted)} planted copy pairs over 100 KiB persisted at similarity 1.0 in one "
        "group each; search.nearDuplicates equals the persisted groups")

    calls = dict(minhash.DEVICE_CALLS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = find_near_duplicates(lib, loc_id, method="all_pairs")
    torch.cuda.synchronize()
    all_pairs_s = time.perf_counter() - t0
    found = {tuple(sorted((p["a"]["id"], p["b"]["id"]))): p["similarity"]
             for p in result["pairs"]}
    window = {r["id"] for group in result["groups"] for r in group}
    last = db.query("SELECT MAX(id) AS id FROM (SELECT id FROM file_path WHERE is_dir = 0 "
                    "AND size_in_bytes > ? AND location_id = ? ORDER BY id LIMIT ?)",
                    [MINIMUM_FILE_SIZE, loc_id, ALL_PAIRS_LIMIT])[0]["id"]
    inside = [(a, b) for a, b in planted if b <= last]
    missing = [ab for ab in inside if found.get(ab) != 1.0 or ab[0] not in window]
    if missing or result["method"] != "all_pairs" or result["errors"]:
        fail(f"find_near_duplicates(method='all_pairs') missed {len(missing)} of {len(inside)} "
             f"planted pairs in its window ({result['method']}, {result['errors'][:3]})")
    all_pairs_calls = {k: v - calls.get(k, 0) for k, v in minhash.DEVICE_CALLS.items()}
    log(f"main path: find_near_duplicates(method='all_pairs') over the first "
        f"{result['scanned']} files in {all_pairs_s:.2f} s: {len(result['pairs'])} pairs, all "
        f"{len(inside)} planted copy pairs of its window at 1.0; device calls {all_pairs_calls}")
    return {"seconds": job_seconds(job), "method": meta.get("method"),
            "all_pairs_s": all_pairs_s, "all_pairs_calls": all_pairs_calls}


def fused_hash(node, tree: dict, row_of) -> dict:
    """``node.hasher.hash_batch`` over the tree's files (sampled files
    through the fused native gather into pinned 57-chunk rows, small files
    bucketed); its cas_ids must equal the scan's. The launch counters are
    set to 0 just before and read just after."""
    import torch

    from spacedrive_tpu_torch.native import cas_native
    from spacedrive_tpu_torch.ops import _kernels

    paths = [str(p) for p in tree["paths"]]
    torch.cuda.synchronize()
    _kernels.reset_counts()
    cas_native.reset_counts()
    t0 = time.perf_counter()
    got = node.hasher.hash_batch(paths, tree["sizes"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    by_shape = shape_counts(_kernels.LAUNCHES_BY_SHAPE)
    launches = dict(_kernels.LAUNCHES)
    wrong = [p for p, s, cid in zip(tree["paths"], tree["sizes"], got)
             if s > 0 and cid != row_of(p)["cas_id"]]
    if wrong:
        fail(f"the fused hash_batch gives {len(wrong)} cas_ids unlike the scan's, e.g. {wrong[0]}")
    if any(_kernels.PLAIN_ON_CUDA.values()):
        fail(f"the fused hash_batch called plain versions on the card: {dict(_kernels.PLAIN_ON_CUDA)}")
    log(f"main path: fused hash_batch of {len(paths)} files in {seconds:.2f} s = "
        f"{len(paths) / seconds:.1f} files/s; cas_ids of every non-empty file equal the scan's; "
        f"gather {gather_line()}; launches {launches}; blake3_chunk_cvs by shape "
        f"{by_shape.get('blake3_chunk_cvs', {})}")
    return {"seconds": seconds, "launches": launches, "by_shape": by_shape}


def kernels_per_call(fn) -> int:
    """CUDA kernels one call of ``fn`` launches, from torch.profiler's device
    records (copies and memsets left out): the most of three windows, as the
    profiler now and then loses records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                          and not e.name.startswith(("Memcpy", "Memset"))))
    return max(counts)


def minhash_tree_phase(tree: dict, int32_ops_per_s: float) -> dict:
    """The MinHash programs on the scanned tree's rows: 8,192 sampled files
    gathered natively into pinned rows (a full SIG_BATCH); the first 2,048
    held on the card against the CPU; then both programs timed on the card
    (CUDA events) at the dedup job's shapes beside their bounds, and the
    CUDA kernels one call of each launches counted (profiler)."""
    import numpy as np
    import torch

    from spacedrive_tpu_torch.native import cas_native
    from spacedrive_tpu_torch.objects.cas import MINIMUM_FILE_SIZE
    from spacedrive_tpu_torch.objects.dedup import SAMPLED_STRIDE, SIG_BATCH
    from spacedrive_tpu_torch.ops import minhash

    picks = [i for i, s in enumerate(tree["sizes"]) if s > MINIMUM_FILE_SIZE][:SIG_BATCH]
    rows = torch.zeros((len(picks), SAMPLED_STRIDE), dtype=torch.uint8, pin_memory=True)
    lengths = torch.zeros(len(picks), dtype=torch.int32, pin_memory=True)
    cas_native.gather_batch([tree["paths"][i] for i in picks], [tree["sizes"][i] for i in picks],
                            rows.numpy(), lengths.numpy())
    words = rows.view(torch.int32)
    errs = check_minhash(words[:2048].clone(), lengths[:2048].clone(),
                         "2,048 gathered rows of the scanned tree")
    B, W = words.shape
    dev_rows, dev_lengths = words.cuda(), lengths.cuda()
    ms = time_ms(lambda: minhash.minhash_rows(dev_rows, dev_lengths), 3, warmup=1)
    per_call = kernels_per_call(lambda: minhash.minhash_rows(dev_rows, dev_lengths))
    sigs = minhash.minhash_rows(dev_rows, dev_lengths)
    del dev_rows
    Np = -(-B // minhash.BLOCK) * minhash.BLOCK  # B itself on the scan's tree
    sigs = torch.cat([sigs, sigs.new_zeros((Np - B, minhash.K))])
    valid = torch.arange(Np, device=sigs.device) < B
    ms_pairs = time_ms(lambda: minhash.similar_pairs_count(sigs, valid, 51), 3, warmup=1)
    per_call_pairs = kernels_per_call(lambda: minhash.similar_pairs_count(sigs, valid, 51))
    shingles = int(np.maximum(1, lengths.numpy() // 8).sum())
    out = {
        "minhash_rows": {
            "ms": ms, "max_abs_err": errs["minhash_rows"],
            "bound": bound_ms(B * W * 4 + B * 4 + B * minhash.K * 4,
                              shingles * minhash.K * OPS_PER_SHINGLE_HASH, int32_ops_per_s),
            "kernels_per_call": per_call,
            "shape": f"rows ({B}, {W}) u32 -> ({B}, 64), {shingles} valid shingles"},
        "similar_pairs_count": {
            "ms": ms_pairs, "max_abs_err": errs["similar_pairs_count"],
            "bound": bound_ms(B * minhash.K * 4 + B + B,
                              B * (B - 1) // 2 * minhash.K * OPS_PER_COMPONENT_PAIR,
                              int32_ops_per_s),
            "kernels_per_call": per_call_pairs,
            "shape": f"signatures ({B}, 64), threshold 51"}}
    for name, t in out.items():
        b, by = t["bound"]
        log(f"time: {name} [{t['shape']}] on the card {t['ms']:.3f} ms (CUDA events, mean of 3), "
            f"bound {b:.4f} ms ({by}), {100 * b / t['ms']:.2f}% of bound; "
            f"{t['kernels_per_call']} CUDA kernels a call (profiler)")
    return out


def main_path_phase(seed: int, card: str, corpus: list[tuple], int32_ops_per_s: float) -> dict:
    import torch

    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import scan_location
    from spacedrive_tpu_torch.native import cas_native
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects import cas
    from spacedrive_tpu_torch.objects.cas import (MINIMUM_FILE_SIZE, SAMPLED_MESSAGE_LEN,
                                                  generate_cas_id)
    from spacedrive_tpu_torch.objects.dedup import SIG_BATCH
    from spacedrive_tpu_torch.objects.manifest import payload_cap
    from spacedrive_tpu_torch.ops import _kernels, minhash

    tree_dir, data_dir = WORK / "tree", WORK / "data"
    t0 = time.perf_counter()
    tree = write_tree(tree_dir, seed)
    n = len(tree["sizes"])
    log(f"main path: wrote {n} files ({tree['bytes_written'] / 1e9:.3f} GB of content) "
        f"in {time.perf_counter() - t0:.1f} s ({tree['sync_s']:.1f} s of it syncing); reduced from BASELINE config 2's 100,000 files "
        f"to {n} to stay inside the time limit")

    os.environ["SD_CHUNK_MANIFESTS"] = "1"
    os.environ["SD_SEARCH_ENGINE"] = "device"
    # the identify job at the pipeline's defaults
    for knob in ("SD_PIPELINE", "SD_PIPELINE_DEPTH", "SD_SCAN_SHARDS", "SD_COMMIT_GROUP",
                 "SD_SCAN_BATCH", "SD_SCAN_ADAPT"):
        os.environ.pop(knob, None)
    node = Node(data_dir)
    try:
        lib = node.libraries.create("chip-smoke")
        loc = identify_location(lib, tree_dir)
        log("main path: the tree's three locations are created with generate_preview_media "
            "False (its .jpg and .png files are random bytes), so the media processor skips "
            "them and the identify, rescan and busy-share numbers stay comparable with PR 9's; "
            "phase 6 drives the media processor")
        # the search index of this library exists before the scan, so the
        # commits of the scan's job steps and exits must move its watermark
        node.search_engine.refresh_now(lib)
        pending0 = node.search_engine.status()["libraries"][lib.id]["pending"]
        torch.cuda.synchronize()
        _kernels.reset_counts()
        cas_native.reset_counts()
        cas.PYTHON_ROUTES.clear()
        minhash.DEVICE_CALLS.clear()
        t0 = time.perf_counter()
        scan_location(lib, loc["id"])
        if not node.jobs.wait_idle(900):
            fail("scan did not finish within 900 s")
        scan_s = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        by_shape = shape_counts(_kernels.LAUNCHES_BY_SHAPE)
        plain_on_card = dict(_kernels.PLAIN_ON_CUDA)
        gather_batches = dict(cas_native.GATHER_BATCHES)
        python_routes = dict(cas.PYTHON_ROUTES)
        program_calls = dict(minhash.DEVICE_CALLS)
        scan_gather = gather_line()
        db = lib.db
        jobs = {r["name"]: r for r in db.query("SELECT * FROM job")}
        for name in ("indexer", "file_identifier", "dedup_detector"):
            job = jobs.get(name)
            if job is None or job["status"] != JobStatus.COMPLETED:
                fail(f"{name} job ended {dict(job) if job else 'missing'}")
        _ident, meta, ident_s = identify_job(db)
        if not meta.get("pipeline_batches"):
            fail(f"the identify job did not run on the pipeline: {meta}")

        rows = {(r["materialized_path"], r["name"], r["extension"]): dict(r) for r in db.query(
            "SELECT id, materialized_path, name, extension, size_in_bytes, cas_id, object_id "
            "FROM file_path WHERE is_dir = 0")}
        if len(rows) != n:
            fail(f"indexed {len(rows)} files, wrote {n}")

        def row_of(path: Path) -> dict:
            rel = path.relative_to(tree_dir)
            return rows[(f"/{rel.parent}/", path.stem, path.suffix.lstrip("."))]

        missing = [k for k, r in rows.items() if r["size_in_bytes"] > 0 and not r["cas_id"]]
        if missing:
            fail(f"{len(missing)} non-empty files have no cas_id, e.g. {missing[0]}")
        rng = random.Random(seed + 1)
        for i in rng.sample(range(n), 64):
            path = tree["paths"][i]
            want = generate_cas_id(path) if tree["sizes"][i] else None
            if row_of(path)["cas_id"] != want:
                fail(f"cas_id of {path} is {row_of(path)['cas_id']}, oracle says {want}")
        for dst, src in tree["copy_of"].items():
            a, b = row_of(tree["paths"][dst]), row_of(tree["paths"][src])
            if a["object_id"] is None or a["object_id"] != b["object_id"]:
                fail(f"planted copy {tree['paths'][dst]} does not share its original's object")
        n_objects = db.query("SELECT COUNT(*) AS c FROM object")[0]["c"]
        n_cas = db.query("SELECT COUNT(DISTINCT cas_id) AS c FROM file_path "
                         "WHERE cas_id IS NOT NULL")[0]["c"]
        n_empty = sum(1 for s in tree["sizes"] if s == 0)
        if n_objects != n_cas + n_empty:
            fail(f"{n_objects} objects != {n_cas} distinct cas_ids + {n_empty} empty files")
        bad = db.query(
            "SELECT fp.name, fp.size_in_bytes AS s, (SELECT SUM(cm.length) FROM chunk_manifest cm "
            "WHERE cm.object_id = fp.object_id) AS t FROM file_path fp WHERE fp.is_dir = 0 "
            "AND fp.size_in_bytes > 0 AND fp.size_in_bytes <= ?", [payload_cap()])
        bad = [dict(r) for r in bad if r["t"] != r["s"]]
        if bad:
            fail(f"{len(bad)} files <= {payload_cap()} B lack a manifest summing to their size, e.g. {bad[0]}")
        t0 = time.perf_counter()
        oracle_chunks = check_manifests(db, tree, row_of, seed)
        log(f"main path: manifests of 16 seeded files ({oracle_chunks} chunks) equal the "
            f"per-byte Gear cuts and the pure-Python BLAKE3 ids "
            f"({time.perf_counter() - t0:.1f} s)")
        for kernel in ("blake3_chunk_cvs", "blake3_merge", "gear_candidates"):
            if launches.get(kernel, 0) <= 0:
                fail(f"the scan never launched {kernel}")
        if any(plain_on_card.values()):
            fail(f"the scan called plain versions on the card: {plain_on_card}")
        # the identify gathers and the dedup job's signature gathers (one
        # batch per SIG_BATCH files) all go through the native gather
        dedup_meta = json.loads(jobs["dedup_detector"]["metadata"])
        dedup_batches = -(-dedup_meta["scanned"] // SIG_BATCH)
        identify_batches = sum(gather_batches.values()) - dedup_batches
        if identify_batches <= 0:
            fail(f"the scan's identify gather was served by no native batch: {gather_batches}")
        if any(python_routes.values()):
            fail(f"the scan's gather went through the Python path without a fault: {python_routes}")
        log(f"main path: native gather of the scan (identify and dedup): {scan_gather}; "
            f"{identify_batches} identify batches; Python detours {python_routes}")
        if program_calls.get("minhash_rows", 0) != dedup_batches:
            fail(f"the dedup job's signatures ran {program_calls} on the card, not "
                 f"{dedup_batches} minhash_rows passes")
        dedup = dedup_checks(node, lib, loc["id"], tree, lambda p: row_of(p)["id"])
        fused = fused_hash(node, tree, row_of)
        programs = minhash_tree_phase(tree, int32_ops_per_s)
        torch.cuda.empty_cache()
        n_chunks = db.query("SELECT COUNT(*) AS c FROM chunk_manifest")[0]["c"]
        pending = node.search_engine.status()["libraries"][lib.id]["pending"]
        if pending < pending0 + 2:
            fail(f"the scan's job commits did not move the search watermark "
                 f"({pending0} -> {pending})")
        pipelined_rows = scan_rows(db)
        seq_s = sequential_scan(node, tree_dir, pipelined_rows, n)
        del pipelined_rows
        profiled_scan(node, tree_dir)
        search = search_phase(node, lib, corpus, card)
    finally:
        node.shutdown()

    hashable = [s for s in tree["sizes"] if s > 0]
    cas_bytes = sum(SAMPLED_MESSAGE_LEN if s > MINIMUM_FILE_SIZE else s + 8 for s in hashable)
    cdc_bytes = sum(s for s in hashable if s <= payload_cap())
    pages = meta["pipeline_batches"]
    log(f"main path on {card}: scan {scan_s:.2f} s; identify job {ident_s:.2f} s for "
        f"{meta['total_orphan_paths']} "
        f"files = {meta['total_orphan_paths'] / ident_s:.1f} files/s, cas messages "
        f"{cas_bytes / 1e9:.3f} GB = {cas_bytes / ident_s / 1e9:.3f} GB/s, CDC payload "
        f"{cdc_bytes / 1e9:.3f} GB = {cdc_bytes / ident_s / 1e9:.3f} GB/s; device hash+chunk "
        f"stage {meta['hash_time']:.2f} s, gather {meta['gather_s']:.2f} s")
    log(f"main path: identify pipelined {meta['total_orphan_paths'] / ident_s:.1f} files/s "
        f"({ident_s:.2f} s), sequential {n / seq_s:.1f} files/s ({seq_s:.2f} s); pipeline "
        f"{pipeline_line(meta)}")
    log(f"main path: {n_objects} objects, {n_cas} distinct cas_ids, {n_empty} empty files, "
        f"{len(tree['copy_of'])} planted copies share their originals' objects, "
        f"{meta['chunked_files']} manifests / {n_chunks} chunks; launches {launches} "
        f"over {pages} pages; plain versions on the card: {sum(plain_on_card.values())}")
    for kernel, shapes in by_shape.items():
        log(f"main path: {kernel} launches by shape: {shapes}")
    return {"launches": launches, "by_shape": by_shape, "pages": pages, "search": search,
            "programs": programs, "program_calls": program_calls, "dedup": dedup,
            "fused": fused}


def shape_counts(counter) -> dict:
    """``LAUNCHES_BY_SHAPE`` as kernel -> {"tag (d0, d1)": launches}, most
    launched first."""
    out: dict = {}
    for (kernel, tag, shape), n in sorted(counter.items(), key=lambda kv: -kv[1]):
        out.setdefault(kernel, {})[f"{tag + ' ' if tag else ''}{shape}"] = n
    return out


# --------------------------------------------------------------------------
# phase 5: the search path
# --------------------------------------------------------------------------


def serve_queries(node, lib, matrix: list, repeats: int = 0) -> dict:
    """Serve every (label, procedure, arg) through both search procedures
    with the engine on and off, and fail unless the JSON is byte-identical
    (for a paths answer with a cursor, the next page too), or unless the
    engine served every engine-on call whose filters it can answer (a stale
    index would hand them all to SQL and the comparison would test nothing).
    With ``repeats``, time the named procedure that many times on each side;
    returns label -> p50 ms of the engine and of SQLite, and the count."""
    import statistics

    from spacedrive_tpu_torch.api.routers.search import paths, paths_count
    from spacedrive_tpu_torch.search.columnar import parse_predicate

    engine = node.search_engine
    procs = {"search.paths": paths, "search.pathsCount": paths_count}
    out = {}
    served0, eligible = engine.status()["served"], 0
    for label, proc, arg in matrix:
        args = [arg]
        for page in range(2):
            got = {}
            for enabled in (True, False):
                engine.set_enabled(enabled)
                got[enabled] = [canon(fn(node, lib, args[page])) for fn in procs.values()]
            if parse_predicate(args[page])[0] is not None:
                eligible += len(procs)
            if got[True] != got[False]:
                fail(f"search {label} (page {page + 1}): engine and SQL answers differ for "
                     f"{args[page]}")
            cursor = json.loads(got[False][0])["cursor"]
            if cursor is None or arg.get("dirs_first"):
                break  # dirs_first pages by offset only
            args.append({**{k: v for k, v in arg.items() if k != "skip"}, "cursor": cursor})
        row = {"count": json.loads(got[False][1])}
        for enabled in (True, False) if repeats else ():
            engine.set_enabled(enabled)
            lat = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                procs[proc](node, lib, arg)
                lat.append((time.perf_counter() - t0) * 1e3)
            row["engine_ms" if enabled else "sqlite_ms"] = statistics.median(lat)
            if enabled and parse_predicate(arg)[0] is not None:
                eligible += repeats
        out[label] = row
    engine.set_enabled(True)
    served = engine.status()["served"] - served0
    if served < eligible:
        fail(f"the engine served {served} of {eligible} engine-on calls it can answer")
    return out


def key_build_times(state) -> dict:
    """Per key column (path and extension keys, the date prefix): seconds
    it takes to build on the host from its rows (as ``ColumnarIndex.build``
    does) and to upload (as the mirror's first sync does), and its bytes."""
    import torch

    idx, dev = state.index, state.mirror.device
    out = {}
    for key, (attr, build) in idx.KEYS.items():
        t0 = time.perf_counter()
        col = build(getattr(idx, attr)[: idx.n])
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(col).to(dev)
        torch.cuda.synchronize()
        out[key] = {"host_s": host_s, "h2d_s": time.perf_counter() - t0, "bytes": col.nbytes}
    return out


def key_patch_times(state, slots: list[int]) -> dict:
    """Seconds the key columns' share of an incremental refresh takes for
    ``slots``: one ``refresh_keys`` pass on the host over every key column
    (as the mirror's delta feed runs it after upserts), then one
    ``index_copy_`` per key column on the card (as the mirror's patch does),
    each with its bytes. It rewrites the values they already hold."""
    import numpy as np
    import torch

    with state.lock:
        idx, mirror = state.index, state.mirror
        t0 = time.perf_counter()
        idx._stale_keys.extend(slots)
        idx.refresh_keys()
        host_s = time.perf_counter() - t0
        at_np = np.unique(np.asarray(slots, dtype=np.int64))
        at = torch.from_numpy(at_np).to(mirror.device)
        columns = {}
        for key in idx.KEYS:
            values = getattr(idx, key)[at_np]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mirror.arrays[key].index_copy_(0, at, torch.from_numpy(values).to(mirror.device))
            torch.cuda.synchronize()
            columns[key] = {"patch_s": time.perf_counter() - t0, "bytes": values.nbytes}
        return {"host_s": host_s, "slots": len(at_np), "columns": columns}


def check_patched_columns(state) -> int:
    """The exact and range kernels against their plain versions on the
    mirror's path and date columns after the incremental refresh, with their
    patched key and prefix columns, which must equal row_keys and
    date_prefix_of of the mirrored rows. Returns the cases checked."""
    import torch

    from spacedrive_tpu_torch.search import kernels as K

    with state.lock:
        rows, keys = state.mirror.arrays["path"], state.mirror.arrays["path_key"]
        if not torch.equal(keys, keys_of(rows)):
            fail("the mirror's path keys differ from row_keys of its rows after the patch")
        needles = (b"/new/", SEARCH_DIRS[3].encode(), b"/")
        for needle in needles:
            got, want = K.exact(rows, needle, keys), K.exact_plain(rows, needle)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"search_exact disagrees with its plain version on the patched path "
                     f"column, needle {needle!r}")
        if int(K.exact(rows, b"/new/", keys).sum()) != 1000:
            fail("the patched path column does not hold the 1,000 inserted rows")
        dates, prefix = state.mirror.arrays["date"], state.mirror.arrays["date_prefix"]
        if not torch.equal(prefix, prefix_of(dates)):
            fail("the mirror's date prefixes differ from date_prefix_of its rows after the patch")
        added = b"2026-07-01T00:00:00+00:00"  # the inserted rows' date, no corpus row's
        bounds = (added, b"2026-06-01T00:00:00+00:00", added[:7], added[:8])
        for bound in bounds:
            got, want = K.lex_cmp(dates, bound, prefix), K.lex_cmp_plain(dates, bound)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"search_lex disagrees with its plain version on the patched date "
                     f"column, bound {bound!r}")
        if int((K.lex_cmp(dates, added, prefix) == 0).sum()) != 1000:
            fail("the patched date column does not hold the 1,000 inserted rows")
    return len(needles) + len(bounds)


def search_phase(node, scan_lib, corpus: list[tuple], card: str) -> dict:
    """The search path on the scanned library and on the 1,000,000-row
    library, with the launch counters zeroed before it and read after."""
    import torch

    from spacedrive_tpu_torch.models import FilePath, Location
    from spacedrive_tpu_torch.ops import _kernels

    engine = node.search_engine
    torch.cuda.synchronize()
    _kernels.reset_counts()
    t_phase = time.perf_counter()

    # the scanned library: stale after the scan, fresh after refresh_now
    engine.refresh_now(scan_lib)
    state = engine.status()["libraries"][scan_lib.id]
    n_fp = scan_lib.db.query("SELECT COUNT(*) AS c FROM file_path")[0]["c"]
    if not state["fresh"] or state["rows"] != n_fp:
        fail(f"the scanned library's index is not fresh after refresh_now: {state}, "
             f"{n_fp} file_path rows")
    dates = [r["d"] for r in scan_lib.db.query(
        "SELECT date_created AS d FROM file_path WHERE is_dir = 0 ORDER BY d")]
    scan_matrix = [
        ("scan_name", "search.paths", {"search": "f0012", "take": 50}),
        ("scan_name_by_size", "search.paths",
         {"search": "F00", "take": 20, "order_by": "size_in_bytes", "order_desc": True}),
        ("scan_extension", "search.pathsCount", {"extensions": ["MP4", ".json"]}),
        ("scan_dir", "search.paths", {"materialized_path": "/d07/", "dirs_first": True}),
        ("scan_large", "search.paths", {"size_range": [16 << 20, None], "take": 100}),
        ("scan_dates", "search.pathsCount",
         {"date_range": [dates[len(dates) // 8], dates[len(dates) // 2]], "search": "f0"}),
        ("scan_offset", "search.paths", {"search": "f01", "skip": 10, "take": 5}),
    ] + SEARCH_MATRIX
    served0 = engine.status()["served"]
    scan_counts = serve_queries(node, scan_lib, scan_matrix)
    served_scan = engine.status()["served"] - served0
    log(f"search (scanned library, {n_fp} rows): {len(scan_matrix)} queries x 2 procedures "
        f"byte-identical to SQL, {served_scan} served by the engine; counts "
        + ", ".join(f"{k} {v['count']}" for k, v in scan_counts.items()))

    # the realistic library
    lib = node.libraries.create("chip-smoke-search")
    db = lib.db
    loc_id = db.insert(Location, {"pub_id": "loc-search", "name": "search", "path": "/search"})
    t0 = time.perf_counter()
    n_objects = max(1, N_SEARCH_ROWS // 100)
    db.executemany("INSERT INTO object (pub_id, kind, favorite) VALUES (?, ?, ?)",
                   [(f"ob-{i}", i % 8, int(i % 5 == 0)) for i in range(n_objects)])
    first_obj = db.query("SELECT MIN(id) m FROM object")[0]["m"]
    db.executemany(
        "INSERT INTO file_path (pub_id, location_id, materialized_path, name, extension, "
        "is_dir, hidden, size_in_bytes, object_id, date_created) VALUES (?,?,?,?,?,?,?,?,?,?)",
        [(r[0], loc_id, r[1], r[2], r[3], 0, r[4], r[5],
          None if r[6] is None else first_obj + r[6], r[7]) for r in corpus])
    corpus_s = time.perf_counter() - t0
    node.emit("db.commit", None, lib.id)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.refresh_now(lib)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    state = engine.status()["libraries"][lib.id]
    if not state["fresh"] or state["rows"] != len(corpus) or state["mirror_uploads"] != 1:
        fail(f"the 1,000,000-row index is not built: {state}")
    mirror_bytes, cap = state["mirror_bytes"], state["mirror_cap"]
    log(f"search: library of {len(corpus)} rows ({N_SEARCH_ROWS} corpus + {N_BIG_ROWS} of "
        f"2-64 GiB) inserted in {corpus_s:.1f} s, index built and mirrored in {build_s:.2f} s; "
        f"device mirror {mirror_bytes / 1e6:.1f} MB at CAP {cap} "
        f"({mirror_bytes / cap:.0f} B/row); torch.cuda.memory_allocated "
        f"{torch.cuda.memory_allocated() / 1e6:.1f} MB; "
        f"{state['overflow_rows']} overflow rows")
    for key, t in key_build_times(engine._states[lib.id]).items():
        log(f"search: key column {key}: {t['bytes'] / 1e6:.3f} MB "
            f"({t['bytes'] / len(corpus):.0f} B/row) of the mirror; host build "
            f"{t['host_s'] * 1e3:.1f} ms, upload {t['h2d_s'] * 1e3:.2f} ms, inside the index "
            f"build above")
    served0 = engine.status()["served"]
    times = serve_queries(node, lib, SEARCH_MATRIX, repeats=5)
    # one more engine pass of the matrix under torch.profiler: its launches
    # and the device's busy share of its wall time
    from torch.profiler import ProfilerActivity, profile

    from spacedrive_tpu_torch.api.routers.search import paths, paths_count

    before = dict(_kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _label, proc, arg in SEARCH_MATRIX:
            (paths if proc == "search.paths" else paths_count)(node, lib, arg)
        torch.cuda.synchronize()
    pass_s = time.perf_counter() - t0
    per_pass = {k: v - before.get(k, 0) for k, v in _kernels.LAUNCHES.items()
                if k.startswith("search_")}
    device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                 if e.self_device_time_total > 0}
    busy_s = sum(device_us.values()) / 1e6
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    kernel_ms = {kernel: sum(us for key, us in device_us.items() if symbol in key) / 1e3
                 for kernel, symbol in SEARCH_SYMBOLS.items()}
    served = engine.status()["served"] - served0
    for label, t in times.items():
        log(f"search: {label}: count {t['count']}, p50 engine {t['engine_ms']:.3f} ms, "
            f"p50 SQLite {t['sqlite_ms']:.3f} ms (5 repeats each) on {card}")
    if times["size_2gib"]["count"] != N_BIG_ROWS or times["size_8_32gib"]["count"] <= 0:
        fail(f"size queries past 2**31 counted {times['size_2gib']['count']} and "
             f"{times['size_8_32gib']['count']} rows")
    p50 = {side: sorted(t[side] for t in times.values())[len(times) // 2]
           for side in ("engine_ms", "sqlite_ms")}
    log(f"search: matrix of {len(SEARCH_MATRIX)} queries byte-identical to SQL (both procedures, "
        f"next pages too), {served} engine serves; p50 over the matrix's p50s: engine "
        f"{p50['engine_ms']:.3f} ms, SQLite {p50['sqlite_ms']:.3f} ms; launches per matrix "
        f"pass {per_pass}")
    log(f"search: one engine pass of the matrix (profiled): wall {pass_s * 1e3:.1f} ms, device "
        f"busy {busy_s * 1e3:.3f} ms = {100 * busy_s / pass_s:.2f}% (idle "
        f"{100 - 100 * busy_s / pass_s:.2f}%); device time by activity: "
        + "; ".join(f"{k[:60]} {v / 1e3:.3f} ms" for k, v in top)
        + f"; search kernels {json.dumps(kernel_ms)} ms; {len(device_us)} device activities")

    # the incremental path: 1,000 renames through db.update (noted in the
    # row journal) and 1,000 inserts through insert_many (the append scan)
    rng = random.Random(17)
    renamed = sorted(rng.sample(range(1, N_SEARCH_ROWS + 1), 1000))
    before = engine.status()  # the refresher may catch up before refresh_now
    t0 = time.perf_counter()
    for k, row_id in enumerate(renamed):
        db.update(FilePath, {"id": row_id}, {"name": f"renamed-{k:04d}.txt"})
    db.insert_many(FilePath, [{
        "pub_id": f"fp-new-{k:04d}", "location_id": loc_id, "materialized_path": "/new/",
        "name": f"added-{k:04d}.txt", "extension": "txt", "is_dir": 0, "hidden": 0,
        "size_in_bytes": (3 << 30) + k, "date_created": "2026-07-01T00:00:00+00:00"}
        for k in range(1000)])
    write_s = time.perf_counter() - t0
    node.emit("db.commit", None, lib.id)
    t0 = time.perf_counter()
    engine.refresh_now(lib)
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    after = engine.status()
    st0, st1 = before["libraries"][lib.id], after["libraries"][lib.id]
    if (after["refreshes"]["full"] != before["refreshes"]["full"]
            or after["refreshes"]["incremental"] <= before["refreshes"]["incremental"]
            or st1["mirror_uploads"] != st0["mirror_uploads"]
            or st1["mirror_patches"] <= st0["mirror_patches"]
            or st1["rows"] != len(corpus) + 1000 or not st1["fresh"]):
        fail(f"the refresh after 1,000 renames and 1,000 inserts was not incremental: "
             f"{before} -> {after}")
    lib_state = engine._states[lib.id]
    patch = key_patch_times(lib_state, [lib_state.index.slot_of(i) for i in renamed]
                            + list(range(lib_state.index.n - 1000, lib_state.index.n)))
    inc = serve_queries(node, lib, AFTER_REFRESH)
    if (inc["renamed"]["count"] != 1000 or inc["added"]["count"] != 1000
            or inc["size_2gib_after"]["count"] != N_BIG_ROWS + 1000):
        fail(f"after the incremental refresh: {inc}")
    log(f"search: 1,000 renames + 1,000 inserts written in {write_s:.2f} s, incremental refresh "
        f"{refresh_s * 1e3:.1f} ms (mirror patched in place: uploads {st1['mirror_uploads']}, "
        f"patches {st0['mirror_patches']} -> {st1['mirror_patches']}); 3 queries "
        "byte-identical to SQL after it")
    log(f"search: the key columns' share of that refresh, {patch['slots']} slots: "
        f"refresh_keys on the host {patch['host_s'] * 1e3:.2f} ms (every key column, one pass); "
        "patch on the card " + ", ".join(
            f"{key} {t['patch_s'] * 1e3:.2f} ms ({t['bytes']} B)"
            for key, t in patch["columns"].items()))

    launches = {k: v for k, v in _kernels.LAUNCHES.items() if k.startswith("search_")}
    plain_on_card = {k: v for k, v in _kernels.PLAIN_ON_CUDA.items() if v}
    for kernel in ("search_substring", "search_exact", "search_lex"):
        if launches.get(kernel, 0) <= 0:
            fail(f"the search path never launched {kernel}")
    if plain_on_card:
        fail(f"the search path called plain versions on the card: {plain_on_card}")
    by_shape = shape_counts(_kernels.LAUNCHES_BY_SHAPE)
    log(f"search path: {time.perf_counter() - t_phase:.1f} s; launches {launches}; plain "
        f"versions on the card: 0")
    for kernel in ("search_substring", "search_exact", "search_lex"):
        log(f"search path: {kernel} launches by (rows, width, needle length): "
            f"{by_shape.get(kernel, {})}")
    # after the counts are read: these launches compare a kernel with its
    # plain version
    checked = check_patched_columns(lib_state)
    log(f"parity: search_exact on the path column and search_lex on the date column after "
        f"1,000 renames and 1,000 inserts (keys and prefixes patched, equal to row_keys and "
        f"date_prefix_of the rows) match plain exactly on {checked} needles and bounds")
    return {"launches": launches, "per_pass": per_pass, "by_shape": by_shape}


# --------------------------------------------------------------------------
# the resize: parity on the card (phase 2) and its times and bounds
# --------------------------------------------------------------------------


def bilinear_ref(img, th: int, tw: int):
    """Exact 4-tap bilinear in float64 numpy, the resize's specification
    (a copy of tests/test_resize.py's ``_bilinear_ref``)."""
    import numpy as np

    h, w, _ = img.shape
    ys = np.clip((np.arange(th) + 0.5) * (h / th) - 0.5, 0, h - 1)
    xs = np.clip((np.arange(tw) + 0.5) * (w / tw) - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    f = img.astype(np.float64)
    val = (f[y0][:, x0] * (1 - wy) * (1 - wx) + f[y0][:, x1] * (1 - wy) * wx
           + f[y1][:, x0] * wy * (1 - wx) + f[y1][:, x1] * wy * wx)
    return np.clip(np.round(val), 0, 255).astype(np.uint8)


def resize_inputs(seed: int, shapes: list, h_in: int, w_in: int, pad_lanes: int = 0):
    """A padded (B, h_in, w_in, 3) u8 batch with one random image of each
    (h, w) in ``shapes`` and ``pad_lanes`` padding lanes (1x1 source and
    target, random bytes behind them, as the reference pads), with its
    (B, 2) source and target sizes; made on the card from ``seed``."""
    import torch

    from spacedrive_tpu_torch.ops.resize import target_dims

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    B = len(shapes) + pad_lanes
    images = torch.randint(0, 256, (B, h_in, w_in, 3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    for i, (h, w) in enumerate(shapes):
        images[i, h:] = 0
        images[i, :, w:] = 0
    src = torch.ones((B, 2), dtype=torch.int32)
    tgt = torch.ones((B, 2), dtype=torch.int32)
    for i, (h, w) in enumerate(shapes):
        src[i] = torch.tensor((h, w))
        tgt[i] = torch.tensor(target_dims(w, h))
    return images, src.cuda(), tgt.cuda()


def check_resize(images, src, tgt, lanes: list, what: str):
    """The resize on the card against the same function on the CPU (on
    ``lanes``: lanes are independent) and against the float64 bilinear on
    each of those lanes' own region; max |diff| <= 1 for both, the canvas
    outside each target zero. Returns (card output, max |diff|)."""
    import numpy as np
    import torch

    from spacedrive_tpu_torch.ops import resize

    card = resize.resize_batch(images, src, tgt)
    torch.cuda.synchronize()
    if not card.is_cuda:
        fail(f"the resize of {what} did not run on the card")
    host_src, host_tgt = src.cpu(), tgt.cpu()
    cpu = resize.resize_batch(images[lanes].cpu(), host_src[lanes], host_tgt[lanes])
    diff = (card[lanes].cpu().to(torch.int16) - cpu.to(torch.int16)).abs()
    err_cpu, n_cpu = int(diff.max()), int((diff != 0).sum())
    err_ref, n_ref = 0, 0
    for i in lanes:
        (h, w), (th, tw) = host_src[i].tolist(), host_tgt[i].tolist()
        got = card[i].cpu().numpy()
        ref = bilinear_ref(images[i, :h, :w].cpu().numpy(), th, tw)
        d = np.abs(got[:th, :tw].astype(np.int16) - ref.astype(np.int16))
        err_ref, n_ref = max(err_ref, int(d.max())), n_ref + int((d != 0).sum())
        if got[th:].any() or got[:, tw:].any():
            fail(f"the resize of {what} left pixels outside lane {i}'s target")
    if err_cpu > 1 or err_ref > 1:
        fail(f"the resize of {what} on the card differs from the CPU by {err_cpu} and from the "
             f"float64 bilinear by {err_ref} (tolerance 1)")
    log(f"parity: resize_batch on {what} (batch {tuple(images.shape)}, lanes {lanes} checked): "
        f"card vs CPU max |diff| {err_cpu} ({n_cpu} values differ), card vs float64 bilinear "
        f"max |diff| {err_ref} ({n_ref} values differ); tolerance 1 (an fp32 sum rounds the "
        "other way from another order's or float64's at a tie)")
    return card, max(err_cpu, err_ref)


def resize_parity(seed: int) -> tuple:
    """Phase 2's resize: a full (32, 1024, 1024, 3) sub-batch (lane 0 the
    whole canvas, lanes 1-2 landscape and portrait, the rest 600-1024 px),
    and a mixed batch (above and below the canvas, 1x1, a 8000x200
    panorama after the host's 8x reduce, a reduced phone portrait, the
    canvas' own size, two padding lanes); then the full sub-batch again
    under ``torch.set_float32_matmul_precision("high")``, which must give
    the same pixels. Returns (max |diff|, the full sub-batch on the card
    as (images, src, tgt), its output)."""
    import torch

    from spacedrive_tpu_torch.ops import resize

    rng = random.Random(seed)
    shapes = [(1024, 1024), (768, 1024), (1024, 768)] + [
        (rng.randint(600, 1024), rng.randint(600, 1024)) for _ in range(29)]
    full = resize_inputs(seed, shapes, 1024, 1024)
    out, err_full = check_resize(*full, [0, 1, 2, 31], "a full sub-batch (32, 1024, 1024, 3)")
    mixed = resize_inputs(seed + 1, [(600, 800), (200, 300), (1, 1), (25, 1000), (1008, 756),
                                     (512, 512)], 1008, 1000, pad_lanes=2)
    _out, err_mixed = check_resize(*mixed, list(range(8)), "a mixed batch with padding lanes")
    caller = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        if not torch.backends.cuda.matmul.allow_tf32:
            fail("set_float32_matmul_precision('high') did not turn TF32 on")
        again = resize.resize_batch(*full)
        if torch.get_float32_matmul_precision() != "high":
            fail("the resize changed the caller's matmul precision")
    finally:
        torch.set_float32_matmul_precision(caller)
    if not torch.equal(again, out):
        n = int((again != out).sum())
        fail(f"with TF32 allowed by the caller the resize changed {n} values")
    log("parity: the full sub-batch under set_float32_matmul_precision('high') gives the same "
        "pixels (no matrix product runs; the resize reads and sets no precision)")
    return max(err_full, err_mixed), full, out


def resize_bounds(B: int, h_in: int, w_in: int, fp32_ops_per_s: float) -> dict:
    """The resize's bound at (B, h_in, w_in, 3): the work's (each u8 input
    read once, each u8 output written once, at the HBM rate; its two-tap
    arithmetic is far below that); beside it, the time the reference's
    dense form (two fp32 matrix products) would need for its operations at
    the card's fp32 rate outside the tensor cores."""
    nbytes = B * h_in * w_in * 3 + B * 512 * 512 * 3 + 2 * B * 2 * 4
    taps = 2 * 2 * (B * 512 * w_in * 3 + B * 512 * 512 * 3)  # two taps, multiply and add
    flops = 2 * B * 512 * h_in * w_in * 3 + 2 * B * 512 * 512 * w_in * 3
    return {"bound": bound_ms(nbytes, taps, fp32_ops_per_s),
            "dense_bound_ms": flops / fp32_ops_per_s * 1e3, "flops": flops, "bytes": nbytes}


def program_profile(fn, reps: int = 3) -> dict:
    """Device time per call of ``fn`` from torch.profiler (its kernels,
    copies and memsets apart) and the kernels a call launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if not e.key.startswith(("Memcpy", "Memset")))
    kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    return {"ms": kernel_us / reps / 1e3, "kernels_per_call": kernels // reps}


def interpolate_loop(images, src, tgt):
    """The library yardstick: one ``F.interpolate`` (bilinear,
    align_corners=False, no antialias) per image at its own target size,
    on float NCHW copies of the lanes made beforehand. Returns (the timed
    loop, a function giving its max |diff| against ``out``)."""
    import torch
    import torch.nn.functional as F

    lanes = []
    for i in range(images.shape[0]):
        (h, w), (th, tw) = src[i].tolist(), tgt[i].tolist()
        lanes.append((images[i, :h, :w].permute(2, 0, 1)[None].float(), (th, tw)))

    def loop():
        return [F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                              antialias=False) for x, size in lanes]

    def max_diff(out) -> int:
        err = 0
        for i, y in enumerate(loop()):
            th, tw = lanes[i][1]
            y8 = y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.int16)
            err = max(err, int((y8 - out[i, :th, :tw].to(torch.int16)).abs().max()))
        return err

    return loop, max_diff


def resize_timing(images, src, tgt, out, fp32_ops_per_s: float, what: str) -> dict:
    """The resize's device time (profiler) at one shape, beside its bound,
    the dense form's operation time and the F.interpolate loop's time (CUDA
    events) and max |diff|."""
    from spacedrive_tpu_torch.ops import resize

    B, h_in, w_in, _ = images.shape
    prof = program_profile(lambda: resize.resize_batch(images, src, tgt))
    loop, max_diff = interpolate_loop(images, src, tgt)
    t = {**prof, **resize_bounds(B, h_in, w_in, fp32_ops_per_s),
         "library_ms": time_ms(loop, 3, warmup=1), "library_max_abs_err": max_diff(out),
         "shape": f"({B}, {h_in}, {w_in}, 3) u8 -> ({B}, 512, 512, 3)"}
    b, by = t["bound"]
    log(f"time: resize_batch [{t['shape']}, {what}] on the card {t['ms']:.3f} ms (profiler, "
        f"{t['kernels_per_call']} CUDA kernels a call); the work's bound {b:.4f} ms ({by}, "
        f"{t['bytes'] / 1e6:.2f} MB) {100 * b / t['ms']:.2f}%; the reference's dense form "
        f"would need {t['dense_bound_ms']:.3f} ms ({t['flops'] / 1e9:.1f} GFLOP fp32); "
        f"F.interpolate loop {t['library_ms']:.3f} ms "
        f"(max |diff| {t['library_max_abs_err']} against the port)")
    return t


# --------------------------------------------------------------------------
# phase 6: the media processor on a photo library
# --------------------------------------------------------------------------

#: BASELINE config 3 (a 1M-file, 500 GB photo library) cut to 256 files:
#: (directory, width, height, format, count, with EXIF)
PHOTO_MIX = (
    ("DCIM/100CANON", 4000, 3000, "jpg", 64, True),     # 12 MP camera frames
    ("DCIM/Camera", 3024, 4032, "jpg", 48, True),       # phone portraits
    ("Screenshots", 1920, 1080, "png", 32, False),
    ("Screenshots/phone", 1080, 1920, "png", 16, False),
    ("Web", 640, 480, "jpg", 40, False),
    ("Web/small", 300, 200, "png", 40, False),          # below the canvas
    ("Panoramas", 8000, 1000, "jpg", 6, True),
    ("Panoramas/tall", 1000, 8000, "jpg", 2, True),
)
N_CORRUPT_PHOTOS = 8
CAMERAS = (("Canon", "EOS R5"), ("Apple", "iPhone 15 Pro"), ("SONY", "ILCE-7M4"))


def photo_pixels(gen, h: int, w: int):
    """A smooth seeded field with light noise, made on the card, so that
    PNG and JPEG sizes stay near a photo's."""
    import torch

    p = torch.rand(9, generator=gen, device="cuda")
    y = torch.arange(h, device="cuda", dtype=torch.float32)[:, None, None]
    x = torch.arange(w, device="cuda", dtype=torch.float32)[None, :, None]
    field = 127.5 + 90 * torch.sin(x * (0.001 + 0.006 * p[0:3]) + y * (0.001 + 0.006 * p[3:6])
                                   + 6.283 * p[6:9])
    field += 2 * torch.randn((h, w, 3), device="cuda", generator=gen)
    return field.clamp_(0, 255).to(torch.uint8).cpu().numpy()


def write_png_stdlib(path: Path, pixels) -> None:
    """An 8-bit RGB PNG with zlib and struct only (for a host without PIL)."""
    import struct
    import zlib

    import numpy as np

    h, w, _ = pixels.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def write_photo(photo: dict, pixels, have_pil: bool) -> None:
    path = photo["path"]
    if photo["fmt"] == "png" and not have_pil:
        write_png_stdlib(path, pixels)
        return
    from PIL import Image, TiffImagePlugin

    img = Image.fromarray(pixels)
    if photo["fmt"] == "png":
        img.save(path)
        return
    exif = Image.Exif()
    if photo["exif"]:
        e = photo["exif"]
        exif[271], exif[272], exif[306], exif[274] = e["make"], e["model"], e["date"], e["orientation"]
        exif[0x8769] = {33434: TiffImagePlugin.IFDRational(1, 250),
                        33437: TiffImagePlugin.IFDRational(28, 10), 34855: 400}
        exif[0x8825] = {1: e["lat_ref"], 2: e["lat"], 3: e["lon_ref"], 4: e["lon"]}
    img.save(path, quality=90, exif=exif)


def write_photos(root: Path, seed: int, have_pil: bool) -> dict:
    """The photo tree: ``PHOTO_MIX`` (every file PNG where PIL is missing)
    plus ``N_CORRUPT_PHOTOS`` .jpg files of random bytes; pixels made on the
    card, files written by 8 threads (the encoders release the interpreter
    lock); synced to disk before it returns."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    rng = random.Random(seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    photos = []
    for folder, w, h, fmt, count, with_exif in PHOTO_MIX:
        (root / folder).mkdir(parents=True, exist_ok=True)
        fmt = fmt if have_pil else "png"
        for i in range(count):
            exif = None
            if with_exif and fmt == "jpg":
                make, model = CAMERAS[rng.randrange(len(CAMERAS))]
                lat = (float(rng.randrange(90)), float(rng.randrange(60)), rng.randrange(6000) / 100)
                lon = (float(rng.randrange(180)), float(rng.randrange(60)), rng.randrange(6000) / 100)
                exif = {"make": make, "model": model, "orientation": rng.choice((1, 6, 8)),
                        "date": f"2024:{rng.randint(1, 12):02d}:{rng.randint(1, 28):02d} "
                                f"{rng.randint(0, 23):02d}:{rng.randint(0, 59):02d}:00",
                        "lat_ref": rng.choice("NS"), "lat": lat, "lon_ref": rng.choice("EW"),
                        "lon": lon}
            photos.append({"path": root / folder / f"IMG_{len(photos):04d}.{fmt}", "w": w, "h": h,
                           "fmt": fmt, "exif": exif})
    corrupt = []
    for i in range(N_CORRUPT_PHOTOS):
        path = root / "DCIM" / "100CANON" / f"BROKEN_{i:02d}.jpg"
        path.write_bytes(rng.randbytes(rng.randint(2000, 200_000)))
        corrupt.append(path)
    with ThreadPoolExecutor(8) as pool:
        for start in range(0, len(photos), 16):
            batch = photos[start : start + 16]
            pixels = [photo_pixels(gen, p["h"], p["w"]) for p in batch]
            list(pool.map(lambda pp: write_photo(pp[0], pp[1], have_pil), zip(batch, pixels)))
    os.sync()
    return {"photos": photos, "corrupt": corrupt,
            "bytes": sum(p["path"].stat().st_size for p in photos)}


def reduced_dims(photo: dict, native: bool, max_edge: int) -> tuple[int, int]:
    """(h, w) of a photo after the thumbnailer's decode and host reduce:
    the native route scales a JPEG in DCT space by n/8 (the largest n whose
    next step down still covers max_edge, sizes rounded up) and box-reduces
    by whole factors, dropping the remainder; PIL's ``reduce`` keeps a
    partial last box (sizes rounded up)."""
    w, h = photo["w"], photo["h"]
    if native and photo["fmt"] == "jpg":
        edge = max(w, h)
        num = 8
        while num > 1 and (edge * (num - 1)) // 8 >= max_edge:
            num -= 1
        w, h = -(-w * num // 8), -(-h * num // 8)
    edge = max(w, h)
    if edge <= max_edge:
        return h, w
    k = -(-edge // max_edge)
    return (h // k, w // k) if native else (-(-h // k), -(-w // k))


def webp_dims(data: bytes) -> tuple[int, int] | None:
    """(width, height) from a WebP file's VP8, VP8L or VP8X header; None
    when it is not one."""
    import struct

    if len(data) < 30 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        return None
    chunk = data[12:16]
    if chunk == b"VP8 " and data[23:26] == b"\x9d\x01\x2a":
        w, h = struct.unpack("<HH", data[26:30])
        return w & 0x3FFF, h & 0x3FFF
    if chunk == b"VP8L" and data[20] == 0x2F:
        bits = int.from_bytes(data[21:25], "little")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if chunk == b"VP8X":
        return int.from_bytes(data[24:27], "little") + 1, int.from_bytes(data[27:30], "little") + 1
    return None


def media_job(db) -> tuple[dict, dict, float]:
    row = dict(db.query("SELECT * FROM job WHERE name = 'media_processor' "
                        "ORDER BY date_created DESC LIMIT 1")[0])
    return row, json.loads(row["metadata"] or "{}"), job_seconds(row)


def media_phase(seed: int, card: str, fp32_ops_per_s: float) -> dict:
    """Phase 6: scan a seeded photo library with preview media on; check
    every thumbnail, event, error and ``media_data`` row; hold one
    sub-batch of each shape the job resized against the CPU; time the
    resize at those shapes beside its bounds and the F.interpolate loop."""
    import numpy as np
    import torch

    from spacedrive_tpu_torch import retry
    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects.media import processor, thumbnail
    from spacedrive_tpu_torch.objects.media.metadata import encode_pluscode
    from spacedrive_tpu_torch.ops import resize

    t_phase = time.perf_counter()
    try:
        import PIL
        from PIL import features

        have_pil = True
        log(f"media: PIL {PIL.__version__} (WebP {features.check('webp')}, JPEG "
            f"{features.check('jpg')}, PNG {features.check('zlib')})")
    except ImportError:
        have_pil = False
    native = thumbnail._native_images() is not None
    log(f"media: host codecs: native helper (libjpeg, libpng, libwebp) "
        f"{'built' if native else 'unavailable (the reason is logged above)'}; PIL "
        f"{'present' if have_pil else 'missing'}")
    if not (native or have_pil):
        log("media: MISSING: libjpeg, libpng and libwebp headers for the native helper, and PIL: "
            "no image decoder and no WebP encoder on this host")
    tree_dir, data_dir = WORK / "photos", WORK / "media-data"
    tree_dir.mkdir(parents=True)
    tree_dir = tree_dir.resolve()
    t0 = time.perf_counter()
    tree = write_photos(tree_dir, seed, have_pil)
    photos, corrupt = tree["photos"], tree["corrupt"]
    by_fmt = {f: sum(1 for p in photos if p["fmt"] == f) for f in ("jpg", "png")}
    log(f"media: wrote {len(photos)} photos ({by_fmt['jpg']} JPEG, {by_fmt['png']} PNG, "
        f"{sum(1 for p in photos if p['exif'])} with EXIF and a GPS fix; "
        f"{tree['bytes'] / 1e6:.1f} MB) and {len(corrupt)} corrupt .jpg files in "
        f"{time.perf_counter() - t0:.1f} s; BASELINE config 3's 1M-file library cut to "
        f"{len(photos) + len(corrupt)} files, its shapes kept")

    for knob in ("SD_SEARCH_ENGINE", "SD_CHUNK_MANIFESTS", "SD_PIPELINE"):
        os.environ.pop(knob, None)
    calls: list = []  # (arrays, thumbnails) of each resize the job made
    decoded: dict = {}  # source path -> decoded and reduced shape
    real_resize, real_decode = thumbnail.resize_images, thumbnail._decode_for_device

    def recorded_resize(arrays, device):
        out = real_resize(arrays, device)
        calls.append((arrays, out))
        return out

    def recorded_decode(source):
        arr = real_decode(source)
        decoded[str(source)] = arr.shape
        return arr

    thumbnail.resize_images, thumbnail._decode_for_device = recorded_resize, recorded_decode
    node = Node(data_dir)
    try:
        lib = node.libraries.create("chip-smoke-photos")
        loc = create_location(lib, tree_dir)
        events: list = []
        node.events.on(lambda e: events.append(e.payload["cas_id"])
                       if e.kind == "new_thumbnail" else None)
        for reset in (resize.reset_counts, thumbnail.reset_counts,
                      processor.SCALAR_RETRIES.clear, retry.DISK_FULL.clear):
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan_location(lib, loc["id"])
        if not node.jobs.wait_idle(600):
            fail("the photo scan did not finish within 600 s")
        scan_s = time.perf_counter() - t0
        db = lib.db
        jobs = {r["name"]: dict(r) for r in db.query("SELECT * FROM job")}
        for name in ("indexer", "file_identifier", "dedup_detector"):
            if jobs.get(name, {}).get("status") != JobStatus.COMPLETED:
                fail(f"photo scan: {name} ended {jobs.get(name)}")
        job, meta, media_s = media_job(db)
        cas = {str(tree_dir / r["materialized_path"].lstrip("/") / f"{r['name']}.{r['extension']}"):
               r["cas_id"] for r in db.query(
                   "SELECT materialized_path, name, extension, cas_id FROM file_path "
                   "WHERE is_dir = 0")}
        image_cas = {cas[str(p["path"])] for p in photos}
        # thumbnails: one a decodable photo, none for a corrupt file
        codecs = native or have_pil
        made = 0
        for p in photos:
            out = thumbnail.thumbnail_path(data_dir, cas[str(p["path"])])
            if not codecs:
                if out.exists():
                    fail(f"{p['path']} has a thumbnail on a host with no codecs")
                continue
            dims = webp_dims(out.read_bytes()) if out.exists() else None
            if dims is None:
                fail(f"{p['path']} has no WebP thumbnail at {out}")
            shape = decoded.get(str(p["path"]))
            want_hw = reduced_dims(p, native, thumbnail.MAX_INPUT_EDGE)
            if shape is None or tuple(shape[:2]) != want_hw:
                fail(f"{p['path']} decoded and reduced to {shape}, expected {want_hw}")
            th, tw = resize.target_dims(want_hw[1], want_hw[0])
            if dims != (tw, th):
                fail(f"the thumbnail of {p['path']} is {dims}, target_dims says {(tw, th)}")
            made += 1
        want_errors = sorted(f"{c}: thumbnail failed (batched + scalar retry)" for c in corrupt)
        if not codecs:
            want_errors = sorted(want_errors + [f"{p['path']}: thumbnail failed (batched + scalar "
                                                "retry)" for p in photos])
        got_errors = sorted((job["errors_text"] or "").split("\n\n"))
        if job["status"] != JobStatus.COMPLETED_WITH_ERRORS or got_errors != want_errors:
            fail(f"media job ended {job['status']} with errors {got_errors[:3]}..., expected "
                 f"{want_errors[:3]}...")
        for c in corrupt:
            if thumbnail.thumbnail_path(data_dir, cas[str(c)]).exists():
                fail(f"corrupt {c} has a thumbnail")
        if sorted(events) != sorted(image_cas if made else []) or meta["thumbnails_created"] != made:
            fail(f"{len(events)} new_thumbnail events and {meta['thumbnails_created']} created, "
                 f"{made} thumbnails made")
        routes = (dict(thumbnail.DECODES), dict(thumbnail.ENCODES),
                  dict(processor.SCALAR_RETRIES))
        if retry.DISK_FULL:
            fail(f"the media job absorbed a full disk: {dict(retry.DISK_FULL)}")
        retried = sum(processor.SCALAR_RETRIES.values())
        if retried != len(corrupt) + (0 if made else len(photos)):
            fail(f"{retried} files retried alone ({dict(processor.SCALAR_RETRIES)}), "
                 f"{len(corrupt)} corrupt")
        call_counts = dict(resize.CALLS)
        if not calls and codecs:
            fail("the media job made no resize call")
        if any(dev != "cuda" for dev, _shape in call_counts) or \
                sum(call_counts.values()) != len(calls):
            fail(f"the resize ran {call_counts}, not only on the card")
        # media_data: one row an image where PIL reads EXIF, none without it
        rows = {r["cas_id"]: r for r in db.query(
            "SELECT fp.cas_id, md.dimensions, md.media_date, md.camera_data, md.media_location "
            "FROM media_data md JOIN file_path fp ON fp.object_id = md.object_id")}
        if not have_pil:
            if rows:
                fail(f"{len(rows)} media_data rows on a host without PIL (the reference writes none)")
            log("media: PIL is missing: no media_data row was written, as the reference does")
        else:
            if set(rows) != image_cas:
                fail(f"media_data has {len(rows)} rows for {len(image_cas)} images")
            for p in photos:
                r = rows[cas[str(p["path"])]]
                if json.loads(r["dimensions"]) != {"width": p["w"], "height": p["h"]}:
                    fail(f"media_data of {p['path']}: dimensions {r['dimensions']}")
                e = p["exif"]
                if e is None:
                    continue
                camera = json.loads(r["camera_data"] or "{}")
                where = json.loads(r["media_location"] or "{}")

                def deg(v, ref, neg):
                    return (v[0] + v[1] / 60 + v[2] / 3600) * (-1 if ref == neg else 1)

                want_code = encode_pluscode(deg(e["lat"], e["lat_ref"], "S"),
                                            deg(e["lon"], e["lon_ref"], "W"))
                if (camera.get("camera_make"), camera.get("camera_model"),
                        camera.get("orientation"), r["media_date"], where.get("pluscode")) != (
                        e["make"], e["model"], e["orientation"], e["date"], want_code):
                    fail(f"media_data of {p['path']}: {dict(r)} against the EXIF written {e}")
            log(f"media: media_data has one row for each of the {len(rows)} images, with the "
                f"written dimensions; {sum(1 for p in photos if p['exif'])} rows carry the EXIF "
                "make, model, date, orientation and the GPS fix's plus code")

        # a rescan of the library makes no new thumbnail
        stamps = {p: p.stat().st_mtime_ns for p in data_dir.glob("thumbnails/*/*.webp")}
        n_calls = len(calls)
        scan_location(lib, loc["id"])
        if not node.jobs.wait_idle(600):
            fail("the photo rescan did not finish within 600 s")
        after = {p: p.stat().st_mtime_ns for p in data_dir.glob("thumbnails/*/*.webp")}
        if after != stamps or len(calls) != n_calls:
            fail(f"the rescan made thumbnails: {len(after)} files (was {len(stamps)}), "
                 f"{len(calls) - n_calls} resize calls")
        rescan_job, _rescan_meta, rescan_s = media_job(db)
        log(f"media: a rescan makes no new thumbnail ({len(after)} files unchanged, no resize "
            f"call; media job {rescan_s:.2f} s, status {rescan_job['status']})")
    finally:
        thumbnail.resize_images, thumbnail._decode_for_device = real_resize, real_decode
        node.shutdown()

    if not calls:
        # no decoder here: drive the resize on the card on arrays made here
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        arrays = [photo_pixels(gen, h, w) for h, w in ((750, 1000), (1008, 756), (200, 300))]
        calls.append((arrays, thumbnail.resize_images(arrays, torch.device("cuda"))))
        log("media: no thumbnail has been made on the card (no codecs); the resize ran on "
            f"{len(arrays)} arrays made here")
    mp = sum(p["w"] * p["h"] for p in photos if str(p["path"]) in decoded) / 1e6
    log(f"media job on {card}: {media_s:.2f} s for {len(photos) + len(corrupt)} files, "
        f"{made} thumbnails = {made / media_s:.1f} images/s, {mp:.1f} MP decoded = "
        f"{mp / media_s:.1f} MP/s; scan {scan_s:.2f} s; media job pipeline: page "
        f"{meta['pipeline_page_s']:.2f} s ({100 * meta['pipeline_page_s'] / meta['pipeline_wall_s']:.1f}%), "
        f"process {meta['pipeline_hash_s']:.2f} s "
        f"({100 * meta['pipeline_hash_s'] / meta['pipeline_wall_s']:.1f}%), commit "
        f"{meta['pipeline_commit_s']:.2f} s "
        f"({100 * meta['pipeline_commit_s'] / meta['pipeline_wall_s']:.1f}%) of wall "
        f"{meta['pipeline_wall_s']:.2f} s, {meta['pipeline_batches']} batches")
    log(f"media: decodes by route {routes[0]}, encodes by route {routes[1]}; files retried "
        f"alone {routes[2]}; resize calls by shape {call_counts}")

    # each call replayed: the resize's device time (profiler) and the copy
    # of its pinned u8 batch to the card (CUDA events); one call of each
    # shape held against the CPU (four of its lanes) and timed beside its
    # bounds and F.interpolate
    cuda = torch.device("cuda")
    per_call, by_shape, err = [], {}, 0
    for arrays, thumbs in calls:
        shape = (len(arrays), max(a.shape[0] for a in arrays), max(a.shape[1] for a in arrays))
        pinned = torch.zeros((*shape, 3), dtype=torch.uint8, pin_memory=True)
        staged = pinned.numpy()
        for i, a in enumerate(arrays):
            staged[i, : a.shape[0], : a.shape[1]] = a
        src = torch.tensor([a.shape[:2] for a in arrays], dtype=torch.int32, device=cuda)
        tgt = torch.tensor([resize.target_dims(a.shape[1], a.shape[0]) for a in arrays],
                           dtype=torch.int32, device=cuda)
        images = pinned.to(cuda)
        per_call.append({
            "ms": program_profile(lambda: resize.resize_batch(images, src, tgt))["ms"],
            "h2d_ms": time_ms(lambda: pinned.to(cuda, non_blocking=True), 3, warmup=1),
            "h2d_bytes": pinned.nbytes + 16 * shape[0]})
        if shape in by_shape:
            continue
        lanes = sorted({0, 1, len(arrays) // 2, len(arrays) - 1})
        want = resize.resize_batch_host([arrays[i] for i in lanes], torch.device("cpu"))
        for i, w in zip(lanes, want):
            if thumbs[i].shape != w.shape:
                fail(f"resize call at {shape}: lane {i} is {thumbs[i].shape}, the CPU's {w.shape}")
            err = max(err, int(np.abs(thumbs[i].astype(np.int16) - w.astype(np.int16)).max()))
        if err > 1:
            fail(f"a resize call of the media job at {shape} differs from the CPU by {err}")
        out = resize.resize_batch(images, src, tgt)
        by_shape[shape] = resize_timing(images, src, tgt, out, fp32_ops_per_s,
                                        f"a media job call, {shape[0]} images")
    log(f"media: the job's resize calls held against the CPU (4 lanes of one call a shape): "
        f"max |diff| {err} (tolerance 1)")
    for i, c in enumerate(per_call):
        log(f"media: resize call {i}: device {c['ms']:.3f} ms (profiler), H2D of "
            f"{c['h2d_bytes'] / 1e6:.2f} MB pinned {c['h2d_ms']:.3f} ms (CUDA events, "
            f"{c['h2d_bytes'] / c['h2d_ms'] / 1e6:.1f} GB/s)")
    device_s = sum(c["ms"] + c["h2d_ms"] for c in per_call) / 1e3
    log(f"media: resize device time and H2D {device_s * 1e3:.2f} ms in all = "
        f"{100 * device_s / media_s:.3f}% of the media job's {media_s:.2f} s; phase 6 "
        f"{time.perf_counter() - t_phase:.1f} s")
    counts = {shape: n for (_dev, shape), n in call_counts.items()}
    for shape, t in by_shape.items():
        t["calls"] = counts.get(shape, 0)
    return {"calls": sum(call_counts.values()), "call_counts": counts, "by_shape": by_shape,
            "max_abs_err": err, "per_call": per_call, "media_s": media_s, "images": made}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of all generated data")
    parser.add_argument("--kernels", action="store_true",
                        help="build, parity and timing only; no main path, no ok line")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not (ROOT / "spacedrive_tpu_torch" / "csrc").is_dir():
        fail(f"the port's package is not beside {Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(ROOT))
    from spacedrive_tpu_torch.native import cas_native
    from spacedrive_tpu_torch.ops import _kernels

    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_ops_per_s = sms * 64 * clock_mhz * 1e6
    # 128 fp32 lanes an SM, an FMA two operations: the rate without the
    # tensor cores
    fp32_ops_per_s = sms * 128 * 2 * clock_mhz * 1e6
    log(f"card: {card}; {sms} SMs, max SM clock {clock_mhz:.0f} MHz, INT32 issue "
        f"{int32_ops_per_s / 1e12:.2f}e12 ops/s, fp32 {fp32_ops_per_s / 1e12:.2f}e12 FLOP/s; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    # g++ builds the native gather on a thread beside the nvcc processes
    gather_build: dict = {}

    def build_gather() -> None:
        try:
            cas_native.library()
            gather_build["s"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — reported after the join
            gather_build["error"] = e

    gxx = threading.Thread(target=build_gather)
    gxx.start()
    seconds = _kernels.build()
    gxx.join()
    if "error" in gather_build:
        fail(f"the native gather did not build: {gather_build['error']}")
    log(f"build: {json.dumps(seconds)}; native gather (g++) {gather_build['s']:.2f} s; "
        f"{time.perf_counter() - t0:.2f} s wall (nvcc and g++ in parallel)")
    for name, text in _kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                log(f"build: {name}.cu: {line.strip()}")

    rng = random.Random(args.seed)
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        corpus = search_corpus()
        cols = corpus_columns(corpus)
        log(f"search corpus: {len(corpus)} rows made in {time.perf_counter() - t0:.1f} s")
        errs = parity_phase(rng, cols)
        errs["resize_batch"], full, full_out = resize_parity(args.seed + 7)
        times = timing_phase(rng, int32_ops_per_s, cols)
        resize_example = resize_timing(*full, full_out, fp32_ops_per_s,
                                       "phase 2's full sub-batch")
        del cols, full, full_out
        torch.cuda.empty_cache()
        main = (None if args.kernels
                else main_path_phase(args.seed, card, corpus, int32_ops_per_s))
        media = None if args.kernels else media_phase(args.seed, card, fp32_ops_per_s)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)

    timed = {"blake3_chunk_cvs": "blake3_chunk_cvs", "blake3_merge": "blake3_merge",
             "gear_candidates": "gear_candidates@256KiB",
             "search_substring": "search_substring@L17", "search_exact": "search_exact@path",
             "search_lex": "search_lex@date"}
    replaces = {"blake3_chunk_cvs": "spacedrive_tpu/ops/blake3_pallas.py:84",
                "blake3_merge": "spacedrive_tpu/ops/blake3_pallas.py:84",
                "gear_candidates": "spacedrive_tpu/ops/cdc.py:236",
                "search_substring": "spacedrive_tpu/search/kernels.py:233",
                "search_exact": "spacedrive_tpu/search/kernels.py:274",
                "search_lex": "spacedrive_tpu/search/kernels.py:308"}
    sources = {"blake3_chunk_cvs": "spacedrive_tpu_torch/csrc/blake3.cu",
               "blake3_merge": "spacedrive_tpu_torch/csrc/blake3.cu",
               "gear_candidates": "spacedrive_tpu_torch/csrc/cdc.cu",
               "search_substring": "spacedrive_tpu_torch/csrc/search.cu",
               "search_exact": "spacedrive_tpu_torch/csrc/search.cu",
               "search_lex": "spacedrive_tpu_torch/csrc/search.cu"}
    kernels = []
    for name, key in timed.items():
        t = times[key]
        search = name.startswith("search_")
        launches = None if main is None else (
            main["search"]["launches"] if search else main["launches"]).get(name, 0)
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches,
            "max_abs_err": errs[name], "parity": errs[name] == 0,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": None, "shape": t["shape"]})
        kernels[-1].update({f: t[f] for f in EXTRA_TIMES if f in t})
        kernels[-1]["other_shapes"] = {
            k: {"ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound"][0],
                "bound_by": v["bound"][1], "shape": v["shape"],
                **{f: v[f] for f in EXTRA_TIMES if f in v}}
            for k, v in times.items() if k.startswith(name + "@") and k != key}
        if main is not None and search:
            kernels[-1]["launches_per_matrix_pass"] = main["search"]["per_pass"].get(name, 0)
            kernels[-1]["launches_by_shape"] = main["search"]["by_shape"].get(name, {})
        elif main is not None:
            kernels[-1]["launches_per_page"] = launches / main["pages"]
            kernels[-1]["launches_by_shape"] = main["by_shape"].get(name, {})
            if name.startswith("blake3_"):
                # the fused hash_batch over the tree, counted in its own window
                kernels[-1]["launches_fused_hash"] = main["fused"]["launches"].get(name, 0)
                kernels[-1]["launches_by_shape_fused_hash"] = main["fused"]["by_shape"].get(name, {})
        if "sass" in t:
            sass = t["sass"] or {}
            kernels[-1]["sass_instructions_per_block"] = sass.get("per_block")
            kernels[-1]["sass_bound_ms"] = sass.get("bound_ms")
    if main is not None:
        # the reference's XLA programs of this path that are not Pallas
        # kernels: PyTorch ops on the card, held against their CPU runs
        sources = {"minhash_rows": "spacedrive_tpu/ops/minhash.py:54",
                   "similar_pairs_count": "spacedrive_tpu/ops/minhash.py:81"}
        programs = []
        for name, t in main["programs"].items():
            programs.append({
                "name": name, "route": "pytorch", "source": "spacedrive_tpu_torch/ops/minhash.py",
                "replaces": sources[name], "calls": main["program_calls"].get(name, 0),
                "calls_all_pairs_call": main["dedup"]["all_pairs_calls"].get(name, 0),
                "kernel_launches_per_call": t["kernels_per_call"],
                "max_abs_err": max(t["max_abs_err"], errs[name]), "ms": t["ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1], "library_ms": None,
                "shape": t["shape"]})
        # the thumbnailer's resize, at the shape the media job launched most
        shapes = sorted(media["by_shape"].items(),
                        key=lambda kv: -media["call_counts"].get(kv[0], 0))
        _shape, t = shapes[0]

        def resize_row(t: dict) -> dict:
            return {"ms": t["ms"], "calls_at_shape": t.get("calls"), "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                    "reference_dense_form_ms": t["dense_bound_ms"],
                    "library_ms": t["library_ms"], "library_max_abs_err": t["library_max_abs_err"],
                    "kernel_launches_per_call": t["kernels_per_call"], "shape": t["shape"]}

        programs.append({
            "name": "resize_batch", "route": "pytorch", "source": "spacedrive_tpu_torch/ops/resize.py",
            "replaces": "spacedrive_tpu/ops/resize_jax.py:63", "calls": media["calls"],
            "max_abs_err": max(errs["resize_batch"], media["max_abs_err"]), **resize_row(t),
            "other_shapes": {s["shape"]: resize_row(s) for _k, s in shapes[1:]},
            "example_full_sub_batch": resize_row(resize_example)})
        print(json.dumps({"device_programs": programs}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.kernels:
        return 0
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
