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

1. build the CUDA kernels from ``spacedrive_tpu_torch/csrc/`` with nvcc;
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
   and BLAKE3 digests against the pure-Python oracle;
3. time each kernel and its plain version at those shapes (CUDA events, or
   the profiler's device time where a wrapper call takes longer to issue
   than the kernel runs), beside the least time the card could take, and
   count the SASS instructions per block of the BLAKE3 chunk kernel
   (cuobjdump);
4. the scan path: write a seeded tree of 16,384 files shaped like BASELINE
   config 2 (mixed media), boot ``Node`` on the card with chunk manifests and
   the search engine on, ``create_location`` → ``scan_location`` →
   ``wait_idle``, check cas_ids and a sample of manifests against the
   oracles, and show through the launch counters that the scan went through
   every scan kernel and never through a plain version; then scan the tree
   again under torch.profiler for the device's busy share;
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
6. print the card, the ``{"kernels": [...]}`` line, then the
   ``{"ok": true, ...}`` line.
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
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

#: HBM rate of the H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: bytes written between timed calls to clear the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20
#: u32 operations per BLAKE3 compression (ops/roofline.py's model: 7 rounds
#: x 8 G x 14 + 8 feed-forward xors, ~800 per 64-byte block)
OPS_PER_COMPRESSION = 800
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
#: level's device time
EXTRA_TIMES = ("call_ms", "full_row_bound_ms", "cold_ms", "latency_floor_ms")
#: BLAKE3 rotates per compression (7 rounds x 8 G x 4), used to find how many
#: compressions the compiler put in one pass of the chunk loop
ROTATES_PER_COMPRESSION = 224

EDGE_LENGTHS = (0, 1, 63, 64, 65, 1023, 1024, 1025, 2048, 2049, 57352, 102408)

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
            **search_parity(cols)}


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


def device_ms(fn, kernel: str, reps: int = 50, between=None) -> float:
    """Mean device time per launch of the CUDA kernel whose name contains
    ``kernel`` over ``reps`` calls of ``fn``, from torch.profiler: the
    kernel alone, without the host's time to issue the call. ``between``,
    if given, runs before each call and is not timed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):  # the profiler now and then returns no events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel in e.key]
        if sum(e.count for e in events) == reps:
            return sum(e.self_device_time_total for e in events) / reps / 1e3
    fail(f"the profiler saw {sum(e.count for e in events)} launches of {kernel}, not {reps}")


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
    all in 64-chunk rows. Device time per launch (profiler), L2-warm and with
    the L2 cleared before each call, beside the wrapper call's time; the
    merge also against its latency floor, the batch's levels times one
    level's device time (``merge_level_ms``)."""
    from spacedrive_tpu_torch.objects.cas import SAMPLED_MESSAGE_LEN
    from spacedrive_tpu_torch.ops import blake3 as b3

    level_ms = merge_level_ms(b3)
    out = {}
    jobs = (("", [rng.randbytes(SAMPLED_MESSAGE_LEN) for _ in range(1024)],
             f"{SAMPLED_MESSAGE_LEN}-byte messages"),
            ("@chunk-ids", chunk_id_messages(rng), "chunk-id messages of 1 B-64 KiB"),
            ("@chunk-ids-2048", chunk_id_messages(rng, 2048),
             "2048 chunk-id messages of 1 B-64 KiB"))
    for suffix, messages, what in jobs:
        rows, lengths = blake3_inputs(messages, 64)
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
        floor = t.get("latency_floor_ms")
        floor = "" if floor is None else (f"; latency floor {floor:.4f} ms, kernel at "
                                          f"{100 * floor / t['ms']:.1f}% of it")
        log(f"time: {name} [{t['shape']}]: kernel {t['ms']:.4f} ms{call}, "
            f"plain {t['plain_ms']:.4f} ms, bound {b:.4f} ms ({by}), kernel at "
            f"{100 * b / t['ms']:.1f}% of bound{cold}{floor}"
            + ("" if full is None else f"; reading every row whole {full:.4f} ms, kernel at "
               f"{100 * full / t['ms']:.1f}% of that"))

    # the bound above prices ops/roofline.py's 800 operations per block; the
    # compiler fuses some of them (three-input adds), so also price the
    # instructions it emitted, at the same 64 per SM per clock
    sass = sass_chunk_loop()
    for name in ("blake3_chunk_cvs", "blake3_chunk_cvs@chunk-ids",
                 "blake3_chunk_cvs@chunk-ids-2048"):
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
    small and medium files."""
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
    return {"paths": paths, "sizes": sizes, "copy_of": copy_of, "bytes_written": written}


#: the CUDA functions of the scan's kernels, as the profiler names them
SCAN_KERNEL_SYMBOLS = ("::chunk_cvs_kernel(", "::merge_kernel(", "::gear_candidates_kernel<")


def profiled_scan(node, tree_dir: Path) -> None:
    """Scan the tree again into a second library under torch.profiler
    (CUDA activity only) and print the device's busy share of the scan and
    its time by kernel. The end-to-end numbers come from the unprofiled scan
    before it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spacedrive_tpu_torch.locations import create_location, scan_location

    lib = node.libraries.create("chip-smoke-profiled")
    loc = create_location(lib, tree_dir)
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
    log(f"main path (profiled rescan into a second library): wall {wall_s:.2f} s, device busy "
        f"{busy_s:.3f} s = {100 * busy_s / wall_s:.2f}% (idle {100 - 100 * busy_s / wall_s:.2f}%); "
        "device time by activity: " + "; ".join(f"{k[:60]} {v / 1e3:.1f} ms" for k, v in top))


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


def main_path_phase(seed: int, card: str, corpus: list[tuple]) -> dict:
    import torch

    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects.cas import (MINIMUM_FILE_SIZE, SAMPLED_MESSAGE_LEN,
                                                  generate_cas_id)
    from spacedrive_tpu_torch.objects.manifest import payload_cap
    from spacedrive_tpu_torch.ops import _kernels

    tree_dir, data_dir = WORK / "tree", WORK / "data"
    t0 = time.perf_counter()
    tree = write_tree(tree_dir, seed)
    n = len(tree["sizes"])
    log(f"main path: wrote {n} files ({tree['bytes_written'] / 1e9:.3f} GB of content) "
        f"in {time.perf_counter() - t0:.1f} s; reduced from BASELINE config 2's 100,000 files "
        f"to {n} to stay inside the time limit")

    os.environ["SD_CHUNK_MANIFESTS"] = "1"
    os.environ["SD_SEARCH_ENGINE"] = "device"
    node = Node(data_dir)
    try:
        lib = node.libraries.create("chip-smoke")
        loc = create_location(lib, tree_dir)
        # the search index of this library exists before the scan, so the
        # commits of the scan's job steps and exits must move its watermark
        node.search_engine.refresh_now(lib)
        pending0 = node.search_engine.status()["libraries"][lib.id]["pending"]
        torch.cuda.synchronize()
        _kernels.reset_counts()
        t0 = time.perf_counter()
        scan_location(lib, loc["id"])
        if not node.jobs.wait_idle(900):
            fail("scan did not finish within 900 s")
        scan_s = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        by_shape = shape_counts(_kernels.LAUNCHES_BY_SHAPE)
        plain_on_card = dict(_kernels.PLAIN_ON_CUDA)
        db = lib.db
        jobs = {r["name"]: r for r in db.query("SELECT * FROM job")}
        for name in ("indexer", "file_identifier"):
            job = jobs.get(name)
            if job is None or job["status"] != JobStatus.COMPLETED:
                fail(f"{name} job ended {dict(job) if job else 'missing'}")
        ident = jobs["file_identifier"]
        meta = json.loads(ident["metadata"])
        from datetime import datetime

        ident_s = (datetime.fromisoformat(ident["date_completed"])
                   - datetime.fromisoformat(ident["date_started"])).total_seconds()

        rows = {(r["materialized_path"], r["name"], r["extension"]): dict(r) for r in db.query(
            "SELECT materialized_path, name, extension, size_in_bytes, cas_id, object_id "
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
        n_chunks = db.query("SELECT COUNT(*) AS c FROM chunk_manifest")[0]["c"]
        pending = node.search_engine.status()["libraries"][lib.id]["pending"]
        if pending < pending0 + 2:
            fail(f"the scan's job commits did not move the search watermark "
                 f"({pending0} -> {pending})")
        profiled_scan(node, tree_dir)
        search = search_phase(node, lib, corpus, card)
    finally:
        node.shutdown()

    hashable = [s for s in tree["sizes"] if s > 0]
    cas_bytes = sum(SAMPLED_MESSAGE_LEN if s > MINIMUM_FILE_SIZE else s + 8 for s in hashable)
    cdc_bytes = sum(s for s in hashable if s <= payload_cap())
    pages = -(-n // 1024)
    log(f"main path on {card}: scan {scan_s:.2f} s; identify job {ident_s:.2f} s for "
        f"{meta['total_orphan_paths']} "
        f"files = {meta['total_orphan_paths'] / ident_s:.1f} files/s, cas messages "
        f"{cas_bytes / 1e9:.3f} GB = {cas_bytes / ident_s / 1e9:.3f} GB/s, CDC payload "
        f"{cdc_bytes / 1e9:.3f} GB = {cdc_bytes / ident_s / 1e9:.3f} GB/s; device hash+chunk "
        f"stage {meta['hash_time']:.2f} s, gather {meta['gather_s']:.2f} s")
    log(f"main path: {n_objects} objects, {n_cas} distinct cas_ids, {n_empty} empty files, "
        f"{len(tree['copy_of'])} planted copies share their originals' objects, "
        f"{meta['chunked_files']} manifests / {n_chunks} chunks; launches {launches} "
        f"over {pages} pages; plain versions on the card: {sum(plain_on_card.values())}")
    for kernel, shapes in by_shape.items():
        log(f"main path: {kernel} launches by shape: {shapes}")
    return {"launches": launches, "by_shape": by_shape, "pages": pages, "search": search}


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
    from spacedrive_tpu_torch.ops import _kernels

    card = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int32_ops_per_s = sms * 64 * clock_mhz * 1e6
    log(f"card: {card}; {sms} SMs, max SM clock {clock_mhz:.0f} MHz, INT32 issue "
        f"{int32_ops_per_s / 1e12:.2f}e12 ops/s; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    seconds = _kernels.build()
    log(f"build: {json.dumps(seconds)}; {time.perf_counter() - t0:.2f} s wall (nvcc in parallel)")
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
        times = timing_phase(rng, int32_ops_per_s, cols)
        del cols
        torch.cuda.empty_cache()
        main = None if args.kernels else main_path_phase(args.seed, card, corpus)
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
        if "sass" in t:
            sass = t["sass"] or {}
            kernels[-1]["sass_instructions_per_block"] = sass.get("per_block")
            kernels[-1]["sass_bound_ms"] = sass.get("bound_ms")
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
