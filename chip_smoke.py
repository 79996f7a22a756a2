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
   ``node.hasher.hash_batch`` (its cas_ids must equal the scan's); scan
   the tree's first ``RESCAN_DIRS`` directories (4,096 files, hard links)
   into a third library under ``SD_PIPELINE=0`` (the sequential step
   loop), whose rows must equal the pipelined scan's rows of those files,
   and print both identify rates; then scan them again, pipelined, under
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
6. the media path: probe the host codecs of HEIF and video first (build
   ``native/sd_heif.cc`` and ``native/sd_ffmpeg.cc`` from the checkout,
   load libheif, look for its encoder, the libav headers and the
   ``ffmpeg`` / ``ffprobe`` CLIs) and print what the reference's gates then
   allow; write a seeded photo library shaped like BASELINE config 3 (256
   files: 12 MP camera frames, phone portraits, screenshots, web images,
   panoramas and 8 corrupt .jpg files; JPEGs with EXIF and a GPS fix where
   PIL exists), plus 24 phone HEICs where libheif can encode them, 8 videos
   (.mp4 at 1920x1080 and 1280x720, .mkv) where a video route exists, and
   4 files of random bytes for each of .heic and .mp4 whose route is
   absent; report which host codecs exist, scan it with preview media on,
   and check every thumbnail (a WebP whose header gives ``target_dims`` of
   the reduced source; for a video the frame's size, its shape and the
   test encoder's gradient), the ``new_thumbnail`` events, one error and no
   thumbnail a corrupt file, nothing for a file the gates skip, the
   per-file retries, the resize calls (all on the card; every HEIF image
   among them), the ``media_data`` rows (dimensions, EXIF, plus code;
   streams and duration of a video) and that a rescan makes no thumbnail;
   read 8 WAVs through ``extract_media_data``; print files, thumbnails and
   rows by format and the host time of each format's decode; hold one
   sub-batch with HEIF images whole against the CPU (0 values may differ)
   and one call of each shape on four lanes, time each shape beside its
   bounds and the ``F.interpolate`` loop, and replay each call under the
   profiler for its device and H2D time;
7. the object validator, the mesh and the ``tpu-sharded`` hasher, on phase
   4's node after phase 5: validate the scan's location on the card
   (``jobs.objectValidator``, every file's full-file BLAKE3 in 2 MiB windows
   through both BLAKE3 kernels, then the levels above them; 16,320 files,
   140 GB, mostly sparse), log files/s, GB/s, the seconds of reads, H2D and
   kernels and the launches by shape; hold the stored checksums of 4 large
   files against the long route's plain version on the card and 8 small
   ones against the Python oracle, and the route against its plain version
   on an edge set of lengths at 4-chunk windows merged 4 at a time (and
   against the oracle) and at the default window, up to two sparse files
   past FAN_IN x WINDOW_CHUNKS chunks; run the four mesh programs over
   every visible card and over ``["cuda:0"] * 2`` (also with seq = 2), each
   equal to the one-device call, and time them; scan 4 of the tree's
   directories (hard links) into a ``tpu-sharded`` location over a
   two-shard mesh, whose cas_ids must equal phase 4's; then change one byte
   of a small and one in a middle window of a large file of one directory
   and revalidate that ``sub_path``, which must report exactly those two
   with the reference's text; time both kernels at the validator's window
   shapes;
8. job control, on phase 4's node after phase 7: a new location over 16 of
   the tree's 64 directories (hard links, 4,096 files; the directory phase 7
   changed is left out) with 256-file pages, one a transaction. (a) Pause
   the scan's identify job after a committed page: the row is Paused, its
   checkpoint's step matches the committed files at a page boundary, no
   kernel launches for 2 s; resume it to phase 4's cas_ids and manifests
   through both scan kernels and no plain version. (b) Cancel it after a
   committed page: it and its chain end Canceled with whole pages
   committed. (c) A child process (``chip_smoke.py --kill-child``) boots a
   Node on the card on its own data dir, plants a ``*.sd-tmp`` file in its
   thumbnail cache and scans until ``commit:kill:skip7`` SIGKILLs it at its
   fourth page; a Node booted here on that data dir sweeps the file and
   cold-resumes the Running identify job, whose chain finishes with phase
   4's cas_ids. Phase 6's photo scan runs warm-start media-lane jobs beside
   identify; it logs how many started before identify ended;
9. the serving path, through the rspc router and the server shell: (a) on
   phase 5's node after phase 8, a ``Server`` in process, whose start forks
   the default reader pool (4 workers, from a forkserver) beside the node,
   serves phase 5's queries on the 1,000,000-row library over HTTP GET,
   HTTP POST and the websocket, each answer byte-identical to the in-process
   ``router.resolve`` answer and to the engine-off SQL answer (which the
   pool now serves), each call growing the three search kernels' launches
   by what the in-process call launched, with the p50 of each transport
   beside the in-process p50 and the rung that served each query (engine in
   process, pool or in process); the workers serve pool-marked queries the
   engine does not (``search.objects``, ``objectsCount``, ``duplicates``,
   ``tags.list``, ``files.get``, ``locations.get``, a wildcard
   ``search.paths``) byte-identical to the in-process answer, the pool's
   p50 beside the in-process p50; a worker SIGKILLed during a dispatch: the
   request answers right in process and the supervisor respawns the slot;
   nvidia-smi lists one compute app (this process) and no worker holds a
   ``/dev/nvidia*`` file; (b)
   after phase 6, a new node on the card behind a ``Server``:
   ``libraries.create``, ``locations.create`` over 4 of phase 4's
   directories and 8 of phase 6's photos (hard links), then
   ``locations.fullRescan``, all over HTTP, followed on a ``jobs.progress``
   websocket subscription; ``invalidation.listen`` sees ``search.paths``;
   the cas_ids equal phase 4's through both scan kernels and Gear; a
   thumbnail fetched with a ``Range`` header answers 206 with the file's
   bytes; ``search.paths`` over HTTP equals SQL; (c) ``python -m
   spacedrive_tpu_torch.server`` in a child process on the card
   (``SD_SEARCH_ENGINE=device``): ``LISTENING``, ``/health``,
   ``buildInfo``, a library, a location of one of those directories,
   ``fullRescan``, one ``search.paths`` equal to the in-process answer for
   the same tree, and an exit 0 within 10 s of SIGTERM;
10. the live library, after phase 9, on a new node on the card with the
   watcher on (it logs which backend ran, inotify or polling): a seeded
   location of 1,024 files in 16 directories (phase 4's small and medium
   mix, manifests on, preview media off) is scanned, then a burst (512
   files of 100-512 KiB imported into 4 new directories, 128 appended to, a
   directory of 64 renamed, one of 128 moved in from outside, 64
   deleted, one of 32 moved out) settles, bounded at 60 s; its rows (each
   file's path, name, extension, size and cas_id, the directories, the
   files sharing an object) must equal a fresh scan's on a second node on
   the card, and both BLAKE3 kernels must have launched from the watcher
   thread; then ``files.copyFiles``, ``cutFiles``, ``duplicateFiles``,
   ``renameFile``, ``createDirectory``, ``createFile``, ``deleteFiles`` and
   ``eraseFiles`` through the router, each followed by the watcher, and
   again a fresh scan's rows; then ``backups.backup``, the node shut down,
   pages of its database overwritten: the next boot's gate quarantines the
   file and restores the backup (its rows come back, a notification is
   pushed), and without a backup starts a fresh database;
11. CRDT sync, after phase 10, on two new nodes on the card in one process
   with the ``syncEmitMessages`` feature flag on (``toggleFeatureFlag``):
   (a) each scans its own 8 of phase 4's directories (hard links, 2,048
   files, manifests on, preview media off) at the same time while an
   ``Actor`` on each pulls the other's operations at 1 lane; the rows of
   both libraries must be equal, every cas_id phase 4's, and both BLAKE3
   kernels and Gear must have launched for each scan (counted by origin);
   every library's orphan remover ticks every ``SYNC_GC_TICK_S`` all
   phase long, so ticks fall inside the pull rounds, which they must wait
   for; (b) two fresh libraries pull the whole log, one at 1 lane and one
   at 4 (``SD_SYNC_INGEST_LANES``), to the same rows, each timed; (c)
   concurrent edits (a note on both, a tag
   against a delete, a rename against a favorite) end equal on both, the
   note the HLC's last write; (d) each node's ``search.paths`` on rows the
   other scanned equals the SQL answer and launches the three search
   kernels; the phase fails past 90 s;
12. p2p, after phase 11, between two processes on the card: node A here
   and node B in a child (``tests/torch_p2p_peer.py``, JSON commands on
   stdin), each with 4,096 of phase 4's files (16 directories, hard links,
   manifests on, preview media off), emission and ``filesOverP2P`` on. A
   connects to B over loopback TCP (``p2p.debugConnect``; ``p2p.peers``
   lists B's card), pairs B's library (``p2p.pair``), and both scan at
   once, A's location ``hasher="remote"``: A's cas messages are hashed on
   B's card over ``H_HASH`` (no fallback, A's own cas launches none, B's
   BLAKE3 launches counted under ``hash-serve``); the sync sessions bring
   both libraries to equal rows with every cas_id phase 4's; A sends B a
   64 MiB file by delta against a base copy sharing every other 1 MiB
   block (under 60% shipped, rebuilt exactly, Gear and BLAKE3 in both
   processes), again once B holds it (nothing shipped), and by a plain
   spacedrop; B's server answers a ranged GET of one of A's files over
   ``H_FILE``; Gear is timed on the delta plane; it prints a ``{"p2p":
   ...}`` line and fails past 120 s;
13. crypto, after phase 12, on a new node on the card (it fails without a
   key manager and logs the ``cryptography`` and OpenSSL versions): a
   location of 22 of phase 4's files (8 under 100 KiB, 8 from 100 KiB to 1
   MiB, its 6 smallest large files) and 3 of random bytes (2 MiB, 2 MiB +
   17 B, 64 MiB), manifests on, preview media off, is scanned and
   validated; ``keys.setup``, ``add``, ``mount``, ``setDefault`` and the
   automount flag through the router; ``files.encryptFiles`` seals 13 files
   with the stored key (XChaCha20-Poly1305, the sealed metadata) and 12
   with a password (AES-256-GCM), erasing the originals; a rescan gives
   every ``.bytes`` file a cas_id on the card, none a plaintext's, and each
   header's metadata opens to its source's first cas_id; a wrong password
   and a copy with its last byte flipped each end in a job error with no
   plaintext left; ``keys.lockKeyManager`` then ``unlockKeyManager``
   mounts the automount key again; ``keys.enableAutoUnlock`` reports the
   keyring store taken (then disabled); ``files.decryptFiles`` with the
   same keys and a rescan give every file its first cas_id, and the
   validator gives each its first full-file checksum (the 64 MiB file in
   windows). The phase's identify batches and validator steps launch under
   the origin ``crypto``: both BLAKE3 kernels and Gear must have launched
   there, and no plain version on the card. It prints a ``{"crypto":
   ...}`` line (seconds of each step, MB/s of the 64 MiB file's encrypt
   and decrypt streams, Argon2id ms a hash) and fails past 90 s;
14. the serving tier across two nodes, run right after phase 12: (b) on
   phase 12's converged pair before B quits, B's child running the search
   engine (``SD_SEARCH_ENGINE=device``) beside its server's default reader
   pool (the desktop with the card) and A none (a laptop): A's
   ``router.resolve`` of ``search.pathsCount`` by a name substring, a
   directory, an extension and a date range is served by B over
   ``H_QUERY`` (the replica rung) from B's device index, not its pool, each
   answer byte-identical to B's local answer and to A's in-process SQL
   answer; B's launches under origin ``replica-serve`` grow for all three
   search kernels; ``search.objectsCount`` is served by B's pool (pages
   naming row ids never go to a replica); A marks an object favorite with
   its push held back: the favorite count is served in A's process (B not
   eligible), then by B once it has pulled; a fault armed on B fails its
   next serve, then B quits (exit 0, phase 12's check), and both times
   the query answers right in A's process within
   ``SD_REPLICA_TIMEOUT_S``; (a) after
   it, a node on the card behind the shell with ``SD_RSPC_BUDGET=4`` takes
   64 concurrent GETs of one search over 50,000 rows: each the page or a
   429 with ``Retry-After``, at least one 429, the budget back at 0
   in flight, the same GET then 200; the phase fails past 90 s;
15. telemetry's cost on the card (budget 60 s): four pipelined rescans of
   phase 4's first 16 directories (4,096 files, fixed 1,024-file pages) in
   the order off, on, on, off, each timed (seconds, files/s); the kernel
   launches and the synchronizing CUDA calls counted under
   ``torch.cuda.set_sync_debug_mode("warn")`` must be equal off and on
   (the instrumentation adds no device synchronization); one more rescan
   of 4 directories with ``SD_PROFILE_HZ`` set must attribute profiler
   samples to the ``pipeline.*`` spans, and the ``sd_proc_*`` gauges must
   be set;
16. print the ``{"device_programs": [...]}`` line (the MinHash programs' and
   the resize's times, calls on the path, CUDA kernels a call, and bounds),
   the ``{"p2p": ...}``, ``{"crypto": ...}`` and ``{"serving": ...}`` lines
   (every query's rung, the pool's and the in-process p50s, the 429s, A's
   replica p50 beside B's local p50, the seconds, the card), the card, the
   ``{"kernels": [...]}`` line (each kernel's ``launches_serving`` counted
   in phase 9, the BLAKE3 and Gear kernels' ``launches_watcher`` from the
   watcher thread in phase 10, every kernel's ``launches_sync`` in phase
   11, ``launches_p2p`` in phase 12, by origin, ``launches_crypto`` in
   phase 13, and each search kernel's ``launches_replica`` in phase 14 (b)),
   then the ``{"ok": true, ...}`` line.

``--live`` builds the kernels and runs phase 10 alone: it prints the card
and a ``{"live_library": {...}}`` line, never the ``{"ok": true, ...}``
line. ``--sync`` builds them, writes phase 4's tree, scans it once for its
cas_ids and runs phase 11 alone: it prints the card and a ``{"sync":
{...}}`` line, never the ok line. ``--p2p`` does the same for phase 12 and
prints a ``{"p2p": {...}}`` line. ``--crypto`` builds them, writes phase
4's tree (no scan) and runs phase 13 alone: it prints the card and a
``{"crypto": {...}}`` line, never the ok line. ``--serving`` writes and
scans phase 4's tree, then runs phase 12 (whose pair phase 14 (b) reuses)
and phase 14: it prints the card, the ``{"p2p": ...}`` and the
``{"serving": {...}}`` lines, never the ok line. ``--telemetry`` builds
the kernels, writes phase 4's tree (no scan) and runs phase 15 alone: it
prints the card and the ``{"telemetry": {...}}`` line, never the ok line.

Telemetry is on in every phase, as it is by default. Phase 4 also reads the
identify job's span tree through ``telemetry.jobTrace`` (one
``pipeline.run``; pages = hashes = ``pipeline_batches``; commits =
``commit_txns``; every page holds its gather; each stage's span sum within
5% of the report's) and checks ``sd_hash_files_total`` and ``sd_hash_mfu``
against the card's roofline (:mod:`spacedrive_tpu_torch.ops.roofline`).
Phase 9 holds ``sd_rspc_requests_total`` to its own count of requests by
outcome, parses ``GET /metrics``, finds a slow ``search.paths`` in the
ring with its ``db.query`` spans, tails ``/telemetry/stream`` through 9b's
scan (its ``job.status`` events) and reads the pool's dispatches in the
``sd_serve_*`` families of the node's process. Phase 12 stitches A's and
B's exported traces of one sync session by ``trace_id``, waits for
``sd_sync_peer_lag_ops`` to return to 0 on both sides, and holds
``sd_p2p_hash_*`` to the remote hasher's batches on both sides.
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
#: kernel (``event_ms``, the fallback of ``device_ms``; BLAKE3 chunks, search),
#: the bound of the padded plane Gear runs over for one delta file
EXTRA_TIMES = ("call_ms", "full_row_bound_ms", "cold_ms", "latency_floor_ms", "event_ms",
               "padded_bound_ms")
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


def spans_named(node: dict, name: str, out: list | None = None) -> list[dict]:
    """Every span called ``name`` in a ``telemetry.jobTrace`` tree."""
    out = [] if out is None else out
    if node["name"] == name:
        out.append(node)
    for child in node.get("children", []):
        spans_named(child, name, out)
    return out


def series(name: str) -> dict:
    """{label values: value} of a port counter or gauge family."""
    from spacedrive_tpu_torch import telemetry

    return {tuple(sorted(lbl.items())): v for lbl, v in telemetry.series_values(name)}


def series_delta(name: str, before: dict, key: str) -> dict:
    """Growth of a family since ``before`` (a :func:`series` read), summed
    by one label."""
    out: dict = {}
    for lbls, v in series(name).items():
        d = v - before.get(lbls, 0.0)
        if d:
            label = dict(lbls)[key]
            out[label] = out.get(label, 0.0) + d
    return out


#: one sample line of the Prometheus text exposition
PROM_SAMPLE = (r'^sd_[a-z0-9_]+(\{[a-z_]+="(?:[^"\\]|\\.)*"(,[a-z_]+="(?:[^"\\]|\\.)*")*\})?'
               r' (-?[0-9.e+-]+|\+Inf|-Inf|NaN)$')


def parse_metrics(text: str) -> dict:
    """``GET /metrics`` read line by line: every line a HELP, a TYPE or a
    sample of a typed family; {family: type}."""
    import re

    sample = re.compile(PROM_SAMPLE)
    typed: dict = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _h, _t, name, kind = line.split(" ")
            if kind not in ("counter", "gauge", "histogram"):
                fail(f"/metrics: {line!r}")
            typed[name] = kind
            continue
        base = line.split("{")[0].split(" ")[0]
        if not sample.match(line) or (base not in typed and
                                      re.sub(r"_(bucket|sum|count)$", "", base) not in typed):
            fail(f"/metrics: an unparsable line {line!r}")
    return typed


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


#: directories of phase 4's tree (4,096 files) that the sequential and the
#: profiled rescans read: two more scans of the whole tree took 130 s of a
#: run that came within 120 s of the script's limit
RESCAN_DIRS = 16


def rescan_tree(tree_dir: Path) -> Path:
    """Hard links to the first :data:`RESCAN_DIRS` directories of phase
    4's tree, under the same names."""
    root = WORK / "rescan"
    for d in range(RESCAN_DIRS):
        (root / f"d{d:02d}").mkdir(parents=True)
        for p in (tree_dir / f"d{d:02d}").iterdir():
            os.link(p, root / f"d{d:02d}" / p.name)
    return root


def rows_under(rows: tuple, paths: set) -> tuple:
    """:func:`scan_rows` of a scan restricted to ``paths``: their cas_ids,
    their grouping into objects, and the manifests of their cas_ids."""
    cas, groups, manifests = rows
    cas = {k: v for k, v in cas.items() if k in paths}
    groups = sorted(g for g in ([k for k in group if k in paths] for group in groups) if g)
    return cas, groups, {c: m for c, m in manifests.items() if c in set(cas.values())}


def profiled_scan(node, tree_dir: Path) -> None:
    """Scan ``tree_dir`` into a second library under torch.profiler
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
    log(f"main path (profiled pipelined rescan of {RESCAN_DIRS} directories into a second "
        f"library): wall {wall_s:.2f} s, "
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


def sequential_scan(node, tree_dir: Path, pipelined: tuple) -> tuple[float, int]:
    """Scan ``tree_dir`` into a third library with the pipeline off; its
    rows must equal the pipelined scan's rows of the same files. Returns
    the identify job's seconds and its files."""
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
    n = len(rows[0])
    for what, a, b in zip(("cas_ids", "object grouping", "manifests"), rows,
                          rows_under(pipelined, set(rows[0]))):
        if a != b:
            fail(f"the sequential scan's {what} differ from the pipelined scan's")
    log(f"main path: the sequential scan (SD_PIPELINE=0) gives the pipelined scan's rows: "
        f"cas_ids of {len(rows[0])} paths, {len(rows[1])} objects, {len(rows[2])} manifests equal; "
        f"identify job {seconds:.2f} s = {n / seconds:.1f} files/s; process stage "
        f"{meta['hash_time']:.2f} s, gather {meta['gather_s']:.2f} s")
    return seconds, n


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
    node = Node(data_dir, watch_locations=False)
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
        hash_files0 = series("sd_hash_files_total")
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
        ident, meta, ident_s = identify_job(db)
        if not meta.get("pipeline_batches"):
            fail(f"the identify job did not run on the pipeline: {meta}")
        n_hashed = sum(1 for s in tree["sizes"] if s > 0)
        traced = scan_trace_checks(node, ident, meta, n_hashed, hash_files0, card,
                                   int32_ops_per_s)

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
        rescan_dir = rescan_tree(tree_dir)
        seq_s, n_seq = sequential_scan(node, rescan_dir, pipelined_rows)
        del pipelined_rows
        profiled_scan(node, rescan_dir)
        search = search_phase(node, lib, corpus, card)
        validated = validator_phase(node, lib, loc, tree, tree_dir, rows, seed, int32_ops_per_s)
        jobs = job_control_phase(node, tree_dir, db, rows, validated["tampered_dir"])
        serving = serve_search_phase(node, node.libraries.get(search["library_id"]), card)
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
        f"({ident_s:.2f} s), sequential {n_seq / seq_s:.1f} files/s ({seq_s:.2f} s, {n_seq} files); pipeline "
        f"{pipeline_line(meta)}")
    log(f"main path: {n_objects} objects, {n_cas} distinct cas_ids, {n_empty} empty files, "
        f"{len(tree['copy_of'])} planted copies share their originals' objects, "
        f"{meta['chunked_files']} manifests / {n_chunks} chunks; launches {launches} "
        f"over {pages} pages; plain versions on the card: {sum(plain_on_card.values())}")
    for kernel, shapes in by_shape.items():
        log(f"main path: {kernel} launches by shape: {shapes}")
    return {"launches": launches, "by_shape": by_shape, "pages": pages, "search": search,
            "programs": programs, "program_calls": program_calls, "dedup": dedup,
            "fused": fused, "validator": validated, "jobs": jobs, "serving": serving,
            "rows": rows, "tampered_dir": validated["tampered_dir"], "trace": traced}


def scan_trace_checks(node, ident: dict, meta: dict, n_hashed: int, hash_files0: dict,
                      card: str, int32_ops_per_s: float) -> dict:
    """Phase 4's identify job as telemetry shows it: its span tree through
    ``telemetry.jobTrace`` on the router, its hash families and its MFU
    against the card's roofline."""
    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.ops import roofline

    tree = node.router.resolve("telemetry.jobTrace", ident["id"])
    if tree is None:
        fail("phase 4: telemetry.jobTrace has no tree for the identify job")
    runs = spans_named(tree, "pipeline.run")
    pages = spans_named(tree, "pipeline.page")
    full = [p for p in pages if not (p.get("attrs") or {}).get("empty")]
    hashes = spans_named(tree, "pipeline.hash")
    commits = spans_named(tree, "pipeline.commit")
    if len(runs) != 1 or not len(full) == len(hashes) == meta["pipeline_batches"] or \
            len(commits) != meta["commit_txns"]:
        fail(f"phase 4: the trace has {len(runs)} pipeline.run, {len(full)} pages "
             f"({len(pages) - len(full)} out-of-work probes), {len(hashes)} hashes, "
             f"{len(commits)} commits; the report {meta['pipeline_batches']} batches in "
             f"{meta['commit_txns']} transactions")
    for page in full:
        gathers = [c for c in page["children"] if c["name"] == "identifier.gather"]
        slices = [c for c in page["children"] if c["name"] == "pipeline.gather"]
        if len(gathers) != max(1, len(slices)):
            fail(f"phase 4: a page holds {len(gathers)} identifier.gather spans for "
                 f"{len(slices)} slices")
    sums = {}
    for name, key, spans in (("pipeline.page", "pipeline_page_s", pages),
                             ("pipeline.hash", "pipeline_hash_s", hashes),
                             ("pipeline.commit", "pipeline_commit_s", commits)):
        total = sum(s["duration_s"] for s in spans)
        sums[name] = total
        if abs(total - meta[key]) > 0.05 * meta[key] + 1e-4:
            fail(f"phase 4: the {name} spans sum to {total:.4f} s, the report's {key} "
                 f"is {meta[key]:.4f} s")
    grew = series_delta("sd_hash_files_total", hash_files0, "backend")
    if grew != {"cuda": float(n_hashed)}:
        fail(f"phase 4: sd_hash_files_total grew by {grew}, the scan hashed {n_hashed} files")
    mfu = telemetry.value("sd_hash_mfu")
    if not 0 < mfu <= 1:
        fail(f"phase 4: sd_hash_mfu is {mfu}, not in (0, 1]")
    card_line = roofline.card_roofline(node.device)
    hash_s = sum(s["duration_s"] for s in spans_named(tree, "identifier.hash"))
    hashed_bytes = telemetry.value("sd_hash_bytes_total", backend="cuda")
    out = {"pages": len(full), "probes": len(pages) - len(full), "commits": len(commits),
           "span_sums_s": sums, "hash_span_s": hash_s, "sd_hash_mfu_last_batch": mfu,
           "mfu_over_the_scan": hashed_bytes / hash_s / card_line["bytes_per_s"],
           "roofline": card_line,
           "perf_md_int32_ops_per_s": int32_ops_per_s,
           "hash_batches": telemetry.value("sd_hash_batches_total", backend="cuda")}
    log(f"phase 4 telemetry on {card}: telemetry.jobTrace: one pipeline.run, {len(full)} pages "
        f"(+{out['probes']} out-of-work probe), {len(hashes)} hashes, {len(commits)} commits, "
        f"each page's gather inside it; span sums {json.dumps(sums)} within 5% of the report; "
        f"sd_hash_files_total +{n_hashed}; sd_hash_mfu {mfu:.6f} (last batch) and "
        f"{out['mfu_over_the_scan']:.6f} over the scan's identifier.hash spans, against the "
        f"roofline {card_line['int32_ops_per_s'] / 1e12:.2f}e12 INT32 ops/s = "
        f"{card_line['bytes_per_s'] / 1e9:.1f} GB/s of payload at 680 operations a block "
        f"({card_line['sms']} SMs, {card_line['sm_clock_mhz']:.0f} MHz; PERF.md's bound model "
        f"{int32_ops_per_s / 1e12:.2f}e12)")
    return out


# --------------------------------------------------------------------------
# phase 7: the object validator, the device mesh and a tpu-sharded scan
# --------------------------------------------------------------------------


def write_sparse(path: Path, size: int, seed: int) -> None:
    """A sparse file of ``size`` bytes with 4 KiB of seeded random bytes at
    its start, its middle and its end."""
    rng = random.Random(seed)
    with open(path, "wb") as fh:
        fh.truncate(size)
        for off in (0, size // 2, max(0, size - 4096)):
            fh.seek(off)
            fh.write(rng.randbytes(min(4096, size - off)))


def validator_job(db) -> tuple[dict, dict]:
    """(job row, metadata without the job trace's summary) of the last
    object_validator job."""
    row = dict(db.query("SELECT * FROM job WHERE name = 'object_validator' "
                        "ORDER BY date_created")[-1])
    meta = json.loads(row["metadata"]) if row["metadata"] else {}
    meta.pop("trace", None)
    return row, meta


def window_timing(window: tuple, top: tuple, int32_ops_per_s: float, flush) -> dict:
    """Both BLAKE3 kernels at the validator's shapes: the chunk kernel on
    full 2 MiB windows of a long message (offsets past chunk 0, no ROOT),
    the merge of those windows without ROOT, and the level above them with
    ROOT at the shape the validator launched most. Device time (profiler),
    L2-warm and cleared, the wrapper call and the plain version."""
    import torch

    from spacedrive_tpu_torch.ops import blake3 as b3

    out = {}
    B, C = window
    g = torch.Generator(device="cuda")
    g.manual_seed(12)
    rows = torch.randint(-2**31, 2**31 - 1, (B, C * 256), dtype=torch.int32, device="cuda",
                         generator=g)
    base = torch.arange(1, B + 1, dtype=torch.int64, device="cuda") * C
    total = torch.full((B,), (B + 2) * C * 1024, dtype=torch.int64, device="cuda")
    lengths = torch.full((B,), C * 1024, dtype=torch.int32, device="cuda")
    root = torch.zeros(B, dtype=torch.bool, device="cuda")
    blocks = B * C * 16
    cvs = b3.chunk_cvs(rows, lengths, base, total)
    pcvs = b3.chunk_cvs_plain(rows, lengths, base, total)
    if not torch.equal(b3.u32(cvs), pcvs):
        fail("blake3_chunk_cvs disagrees with its plain version on the window rows")
    out["blake3_chunk_cvs@window"] = {
        "ms": device_ms(lambda: b3.chunk_cvs(rows, lengths, base, total), "chunk_cvs_kernel"),
        "cold_ms": device_ms(lambda: b3.chunk_cvs(rows, lengths, base, total), "chunk_cvs_kernel",
                             between=flush.zero_),
        "call_ms": time_ms(lambda: b3.chunk_cvs(rows, lengths, base, total), 50),
        "plain_ms": time_ms(lambda: b3.chunk_cvs_plain(rows, lengths, base, total), 2, warmup=1),
        "bound": bound_ms(B * C * 1024 + B * 20 + B * C * 32, blocks * OPS_PER_COMPRESSION,
                          int32_ops_per_s),
        "shape": f"rows ({B}, {C}*256) u32, full 2 MiB windows at chunk offsets {C}..{B * C}, "
                 f"no ROOT, {B * C} chunks"}
    if not torch.equal(b3.u32(b3.merge(cvs, lengths, root)), b3.merge_plain(pcvs, lengths, root)):
        fail("blake3_merge disagrees with its plain version on the window CVs (no ROOT)")
    parents = B * (C - 1)
    out["blake3_merge@window"] = {
        "ms": device_ms(lambda: b3.merge(cvs, lengths, root), "merge_kernel"),
        "cold_ms": device_ms(lambda: b3.merge(cvs, lengths, root), "merge_kernel",
                             between=flush.zero_),
        "call_ms": time_ms(lambda: b3.merge(cvs, lengths, root), 50),
        "plain_ms": time_ms(lambda: b3.merge_plain(pcvs, lengths, root), 2, warmup=1),
        "bound": bound_ms(B * C * 32 + B * 5 + B * 32, parents * OPS_PER_COMPRESSION,
                          int32_ops_per_s),
        "shape": f"cvs ({B}, {C}, 8) u32, one subtree CV a row, no ROOT, {parents} parents, "
                 f"{(C - 1).bit_length()} levels"}
    R, Cl, nodes = top
    top_cvs = torch.randint(-2**31, 2**31 - 1, (R, Cl, 8), dtype=torch.int32, device="cuda",
                        generator=g)
    top_len = torch.tensor([n * 1024 for n in nodes], dtype=torch.int32, device="cuda")
    top_root = torch.ones(R, dtype=torch.bool, device="cuda")
    if not torch.equal(b3.u32(b3.merge(top_cvs, top_len, top_root)),
                       b3.merge_plain(top_cvs, top_len, top_root)):
        fail("blake3_merge disagrees with its plain version at the top level")
    parents = sum(n - 1 for n in nodes)
    out["blake3_merge@top"] = {
        "ms": device_ms(lambda: b3.merge(top_cvs, top_len, top_root), "merge_kernel"),
        "cold_ms": device_ms(lambda: b3.merge(top_cvs, top_len, top_root), "merge_kernel",
                             between=flush.zero_),
        "call_ms": time_ms(lambda: b3.merge(top_cvs, top_len, top_root), 50),
        "plain_ms": time_ms(lambda: b3.merge_plain(top_cvs, top_len, top_root), 2, warmup=1),
        "bound": bound_ms(sum(nodes) * 32 + R * 5 + R * 32, parents * OPS_PER_COMPRESSION,
                          int32_ops_per_s),
        "shape": f"cvs ({R}, {Cl}, 8) u32, the level above a step's windows with ROOT, "
                 f"{sum(nodes)} window CVs, {parents} parents"}
    for name, t in out.items():
        b, by = t["bound"]
        log(f"time: {name} [{t['shape']}]: kernel {t['ms']:.4f} ms (device time; a wrapper call "
            f"{t['call_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, bound {b:.4f} ms ({by}), "
            f"kernel at {100 * b / t['ms']:.1f}% of bound; with the L2 cleared before each call "
            f"{t['cold_ms']:.4f} ms")
    return out


def validator_checks(tree: dict, row_of) -> dict:
    """The long route against its plain version on the card: 4 of the
    tree's large files (their stored checksums), 8 small files against the
    Python oracle, the edge set at 4-chunk windows merged 4 at a time (also
    against the oracle) and at the default window (files of 0 B-4 MiB, and
    two sparse files past FAN_IN x WINDOW_CHUNKS chunks, which take a second
    merge level). Plain runs stage 512 MiB a batch."""
    from spacedrive_tpu_torch.objects.blake3_ref import blake3 as oracle
    from spacedrive_tpu_torch.objects.validator import full_file_hashes
    from spacedrive_tpu_torch.ops import blake3 as b3

    plain = {"plain": True, "staging_bytes": 512 << 20}
    sizes = tree["sizes"]
    large = [i for i, s in enumerate(sizes) if s > 16 << 20][:4]
    paths = [tree["paths"][i] for i in large]
    t0 = time.perf_counter()
    want = full_file_hashes(paths, "cuda", **plain)
    stored = [row_of(p)["integrity_checksum"] for p in paths]
    if stored != want:
        fail(f"stored checksums of 4 large files differ from the plain route: {stored} {want}")
    small = [i for i, s in enumerate(sizes) if 0 < s <= 100 << 10][:8]
    for i in small:
        p = tree["paths"][i]
        if row_of(p)["integrity_checksum"] != oracle(p.read_bytes()).hex():
            fail(f"the stored checksum of {p} differs from the Python oracle")
    log(f"validator: 4 large files ({sum(sizes[i] for i in large) / 2**20:.0f} MiB) equal the "
        f"plain route on the card and 8 small files the Python oracle "
        f"({time.perf_counter() - t0:.1f} s)")

    edges_dir = WORK / "edges"
    edges_dir.mkdir(parents=True, exist_ok=True)
    K = 1024
    results = {}
    for W, F, label in ((4, 4, "W = 4, F = 4"),
                        (b3.WINDOW_CHUNKS, b3.FAN_IN, "the default window")):
        lens = (0, 1, K, K + 1, W * K - 1, W * K, W * K + 1, 2 * W * K, W * F * K + 1,
                W * F * K + 17)
        files = []
        for n in lens:
            path = edges_dir / f"w{W}-{n}.bin"
            if n > 64 << 20:
                write_sparse(path, n, n)
            else:
                path.write_bytes(random.Random(n).randbytes(n))
            files.append(path)
        t0 = time.perf_counter()
        stats: dict = {}
        got = full_file_hashes(files, "cuda", window_chunks=W, fan_in=F, stats=stats)
        kernel_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = full_file_hashes(files, "cuda", window_chunks=W, fan_in=F, **plain)
        plain_s = time.perf_counter() - t0
        if got != ref:
            fail(f"the long route disagrees with its plain version on the edge set at {label}: "
                 f"{[n for n, a, b in zip(lens, got, ref) if a != b]}")
        small = [k for k, n in enumerate(lens) if n <= 20 * K]
        for k in small:
            if got[k] != oracle(files[k].read_bytes()).hex():
                fail(f"the long route's digest of {lens[k]} B at {label} differs from the oracle")
        log(f"validator: edge set at {label} ({list(lens)} B) equals the plain route on the card "
            f"({kernel_s:.2f} s; plain {plain_s:.2f} s) and, at {[lens[k] for k in small]} B, "
            f"the Python oracle; {stats['windows']} windows, {stats['batches']} launch pairs, "
            f"{stats['levels']} merge levels above the windows")
        results[label] = {"lens": list(lens), "levels": stats["levels"]}
    shutil.rmtree(edges_dir)
    return results


def blake3_blocks(lens: list[int]) -> int:
    """64-byte blocks BLAKE3 compresses for messages of these lengths."""
    return sum(max(1, -(-min(n - c * 1024, 1024) // 64))
               for n in lens for c in range(max(1, -(-n // 1024))))


def mesh_checks(seed: int, int32_ops_per_s: float) -> dict:
    """The four mesh programs over every visible card, and over
    ``["cuda:0"] * 2`` (seq = 1: two batch shards; seq = 2: each message's
    chunks in two windows), each equal to the one-device call. Each program
    is timed a call (CUDA events, its inputs on the host as its callers pass
    them, so the copies to the card are in the time) beside the bound of
    its device work."""
    import numpy as np
    import torch

    from spacedrive_tpu_torch.objects.blake3_ref import blake3 as oracle
    from spacedrive_tpu_torch.ops import blake3 as b3
    from spacedrive_tpu_torch.ops.resize import resize_batch, target_dims
    from spacedrive_tpu_torch.parallel import mesh as tm

    rng = random.Random(seed + 7)
    msgs = [rng.randbytes(rng.choice((0, 1, 1024, 1025, rng.randint(2, 64 * 1024))))
            for _ in range(1000)]
    # copies of three messages of over a chunk (random, so unique) and an
    # empty lane, which is never a duplicate
    planted = [i for i, m in enumerate(msgs) if len(m) > 1025][:3]
    msgs += [msgs[planted[0]], msgs[planted[1]], b"", msgs[planted[2]]]
    msgs += [rng.randbytes(57352) for _ in range(20)]
    words, lengths = b3.pack_messages(msgs, 64)
    one = b3.blake3_batch(torch.from_numpy(words.view(np.int32)).cuda(),
                          torch.from_numpy(lengths).cuda())
    for i in (0, planted[0], 1000, 1023):
        if b3.digests_to_hex(one[:, i : i + 1])[0] != oracle(msgs[i]).hex():
            fail(f"one-device blake3_batch digest {i} differs from the oracle")
    prefix = (b3.u32(one[0]) << 32) | b3.u32(one[1])
    one_dup = tm.dup_flags(prefix, torch.from_numpy(lengths).cuda() > 0)
    rows, row_lens = b3.pack_rows(msgs, 64)
    imgs = np.random.default_rng(seed).integers(0, 256, (8, 480, 640, 3), dtype=np.uint8)
    th, tw = target_dims(640, 480)
    src = np.tile(np.int32([480, 640]), (8, 1))
    tgt = np.tile(np.int32([th, tw]), (8, 1))
    one_img = resize_batch(torch.from_numpy(imgs).cuda(), torch.from_numpy(src).cuda(),
                           torch.from_numpy(tgt).cuda())
    meshes = [("every visible card", tm.make_mesh()),
              ('["cuda:0"] * 2', tm.make_mesh(devices=["cuda:0"] * 2)),
              ('["cuda:0"] * 2, seq = 2', tm.make_mesh(seq=2, devices=["cuda:0"] * 2))]
    out = []
    for label, mesh in meshes:
        digests = tm.sharded_hasher(mesh)(words, lengths)
        row_digests = tm.sharded_row_hasher(mesh)(rows, row_lens)
        id_digests, dup = tm.identify_step(mesh)(words, lengths)
        resized = tm.sharded_resizer(mesh)(imgs, src, tgt)
        bad = [name for name, a, b in (("sharded_hasher", digests, one),
                                       ("sharded_row_hasher", row_digests, one),
                                       ("identify_step digests", id_digests, one),
                                       ("identify_step dup", dup, one_dup),
                                       ("sharded_resizer", resized, one_img))
               if not torch.equal(a, b)]
        if bad:
            fail(f"mesh over {label}: {bad} differ from the one-device call")
        if not (dup[1000] and dup[1001] and dup[1003]) or dup[1002]:
            fail(f"identify_step over {label} flagged {dup.nonzero().flatten().tolist()}")
        ms = {"sharded_hasher": time_ms(lambda: tm.sharded_hasher(mesh)(words, lengths), 3, 1),
              "sharded_row_hasher": time_ms(lambda: tm.sharded_row_hasher(mesh)(rows, row_lens),
                                            3, 1),
              "identify_step": time_ms(lambda: tm.identify_step(mesh)(words, lengths), 3, 1),
              "sharded_resizer": time_ms(lambda: tm.sharded_resizer(mesh)(imgs, src, tgt), 3, 1)}
        out.append({"mesh": label, "shape": mesh.shape, "ms": ms})
    blocks = blake3_blocks([len(m) for m in msgs])
    hash_bound = bound_ms(blocks * 64 + words.nbytes // 16 + len(msgs) * 36,
                          blocks * OPS_PER_COMPRESSION, int32_ops_per_s)
    resize_bound = bound_ms(imgs.nbytes + 8 * 512 * 512 * 3, 0, int32_ops_per_s)
    log(f"mesh: sharded_hasher, sharded_row_hasher, identify_step and sharded_resizer over "
        f"{[(m['mesh'], m['shape']) for m in out]} equal the one-device call on "
        f"{len(msgs)} messages in 64-chunk rows (3 planted duplicates flagged, the empty lanes "
        f"not) and 8 images of 640x480; ms a call with its host-to-device copies "
        f"{[(m['mesh'], m['ms']) for m in out]}; device-work bound of the hashers "
        f"{hash_bound[0]:.4f} ms ({hash_bound[1]}, {blocks} blocks), of the resizer "
        f"{resize_bound[0]:.4f} ms ({resize_bound[1]})")
    return {"meshes": out, "hash_bound": hash_bound, "resize_bound": resize_bound}


def sharded_scan(node, tree_dir: Path, phase4_rows: dict) -> dict:
    """A tpu-sharded location over 4 of the tree's directories (hard links,
    no new bytes) with the node's mesh over ``["cuda:0"] * 2``: its cas_ids
    equal phase 4's, and its hash went through the sharded programs."""
    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.models import Location
    from spacedrive_tpu_torch.ops import _kernels

    root = WORK / "sharded"
    for d in range(4):
        (root / f"d{d:02d}").mkdir(parents=True)
        for p in (tree_dir / f"d{d:02d}").iterdir():
            os.link(p, root / f"d{d:02d}" / p.name)
    node.mesh_devices = ["cuda:0"] * 2
    lib = node.libraries.create("chip-smoke-sharded")
    loc = create_location(lib, root, hasher="tpu-sharded")
    lib.db.update(Location, {"id": loc["id"]}, {"generate_preview_media": False})
    _kernels.reset_counts()
    t0 = time.perf_counter()
    scan_location(lib, loc["id"])
    if not node.jobs.wait_idle(900):
        fail("the tpu-sharded scan did not finish within 900 s")
    scan_s = time.perf_counter() - t0
    by_shape = shape_counts(_kernels.LAUNCHES_BY_SHAPE)
    job, meta, ident_s = identify_job(lib.db)
    if job["status"] != JobStatus.COMPLETED:
        fail(f"the tpu-sharded identify job ended {job}")
    if node.sharded_hasher is None or node.sharded_hasher.mesh.shape != {"data": 2, "seq": 1}:
        fail("the tpu-sharded scan did not hash over the node's two-shard mesh")
    rows = {(r["materialized_path"], r["name"], r["extension"]): r["cas_id"] for r in lib.db.query(
        "SELECT materialized_path, name, extension, cas_id FROM file_path WHERE is_dir = 0")}
    differ = [k for k, cas in rows.items() if phase4_rows[k]["cas_id"] != cas]
    if len(rows) != 4 * len(list((tree_dir / "d00").iterdir())) or differ:
        fail(f"the tpu-sharded scan's {len(rows)} cas_ids: {len(differ)} differ from phase 4's, "
             f"e.g. {differ[:2]}")
    log(f"sharded scan: {len(rows)} files of 4 directories in a tpu-sharded location, scan "
        f"{scan_s:.2f} s, identify {ident_s:.2f} s; every cas_id equals phase 4's; BLAKE3 "
        f"launches by shape (each batch split over 2 shards): "
        f"{ {k: v for k, v in by_shape.items() if k.startswith('blake3')} }")
    return {"files": len(rows), "scan_s": scan_s, "by_shape": by_shape}


def validator_phase(node, lib, loc: dict, tree: dict, tree_dir: Path, phase4_rows: dict,
                    seed: int, int32_ops_per_s: float) -> dict:
    """Phase 7: validate the scan's location on the card, hold the long
    route to its plain version, tamper with two files of one directory and
    revalidate it, run the mesh programs and a tpu-sharded scan."""
    import torch

    from spacedrive_tpu_torch.api.routers.jobs import object_validator
    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.objects import validator
    from spacedrive_tpu_torch.objects.validator import full_file_hashes
    from spacedrive_tpu_torch.ops import _kernels

    t_phase = time.perf_counter()
    db = lib.db
    n_hashed = db.query("SELECT COUNT(*) AS c FROM file_path WHERE is_dir = 0 AND "
                        "cas_id IS NOT NULL")[0]["c"]
    total_bytes = sum(s for s in tree["sizes"] if s > 0)
    torch.cuda.synchronize()
    _kernels.reset_counts()
    validator.reset_counts()
    t0 = time.perf_counter()
    object_validator(node, lib, {"location_id": loc["id"]})
    if not node.jobs.wait_idle(900):
        fail("the validator did not finish within 900 s")
    wall_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    by_shape = shape_counts(_kernels.LAUNCHES_BY_SHAPE)
    raw_shapes = dict(_kernels.LAUNCHES_BY_SHAPE)
    plain_on_card = dict(_kernels.PLAIN_ON_CUDA)
    stats = dict(validator.STATS)
    job, meta = validator_job(db)
    job_s = job_seconds(job)
    if job["status"] != JobStatus.COMPLETED or meta != {"validated": n_hashed, "mismatched": 0}:
        fail(f"the validator ended {job['status']} with {meta} ({job['errors_text']!r:.300}), "
             f"not {n_hashed} validated")
    missing = db.query("SELECT COUNT(*) AS c FROM file_path WHERE cas_id IS NOT NULL AND "
                       "integrity_checksum IS NULL")[0]["c"]
    if missing:
        fail(f"{missing} files with a cas_id have no integrity_checksum")
    for kernel in ("blake3_chunk_cvs", "blake3_merge"):
        if launches.get(kernel, 0) <= 0:
            fail(f"the validator never launched {kernel}")
    if any(plain_on_card.values()):
        fail(f"the validator called plain versions on the card: {plain_on_card}")
    log(f"validator on {node.device}: {n_hashed} files, {total_bytes / 1e9:.3f} GB in "
        f"{job_s:.2f} s (job row; {wall_s:.2f} s to idle) = {n_hashed / job_s:.1f} files/s, "
        f"{total_bytes / job_s / 1e9:.3f} GB/s; reads {stats['read_s']:.2f} s (host wall, 8 "
        f"threads), H2D {stats['h2d_s']:.2f} s, kernels {stats['kernel_s']:.3f} s (CUDA events); "
        f"{stats['windows']} windows in {stats['batches']} launch pairs, "
        f"{stats['levels']} merge levels; launches {launches}; plain versions on the card: 0")
    for kernel, shapes in by_shape.items():
        log(f"validator: {kernel} launches by shape: {shapes}")

    rows = {(r["materialized_path"], r["name"], r["extension"]): dict(r) for r in db.query(
        "SELECT id, materialized_path, name, extension, integrity_checksum FROM file_path "
        "WHERE is_dir = 0")}

    def row_of(path: Path) -> dict:
        rel = path.relative_to(tree_dir)
        return rows[(f"/{rel.parent}/", path.stem, path.suffix.lstrip("."))]

    edges = validator_checks(tree, row_of)
    # the mesh and the tpu-sharded scan before any file changes: the scan's
    # cas_ids must equal phase 4's
    mesh = mesh_checks(seed, int32_ops_per_s)
    sharded = sharded_scan(node, tree_dir, phase4_rows)

    # one byte in a small file and one mid-file in a large one, one directory
    sizes = tree["sizes"]
    big = next(i for i, s in enumerate(sizes) if s > 16 << 20)
    d = big % N_DIRS
    small = next(i for i, s in enumerate(sizes) if 0 < s <= 100 << 10 and i % N_DIRS == d)
    tampered = {}
    for i, off in ((small, 0), (big, sizes[big] // 2)):
        path = tree["paths"][i]
        with open(path, "r+b") as fh:
            fh.seek(off)
            byte = fh.read(1)[0]
            fh.seek(off)
            fh.write(bytes([byte ^ 0x5A]))
        tampered[path] = off
    window = sizes[big] // 2 // (2 << 20)
    new = dict(zip(tampered, full_file_hashes(list(tampered), "cuda", plain=True,
                                              staging_bytes=512 << 20)))
    want_errors = sorted(
        f"integrity MISMATCH /d{d:02d}/{p.stem}: stored {row_of(p)['integrity_checksum'][:16]}… "
        f"!= {new[p][:16]}…" for p in tampered)
    in_dir = db.query("SELECT COUNT(*) AS c FROM file_path WHERE is_dir = 0 AND cas_id IS NOT "
                      "NULL AND materialized_path = ?", [f"/d{d:02d}/"])[0]["c"]
    t0 = time.perf_counter()
    object_validator(node, lib, {"location_id": loc["id"], "sub_path": f"d{d:02d}",
                                 "revalidate": True})
    if not node.jobs.wait_idle(900):
        fail("the revalidation did not finish within 900 s")
    job, meta = validator_job(db)
    errors = sorted((job["errors_text"] or "").split("\n\n"))
    if (job["status"] != JobStatus.COMPLETED_WITH_ERRORS or errors != want_errors
            or meta != {"validated": in_dir - 2, "mismatched": 2}):
        fail(f"revalidating d{d:02d} gave {meta}, {errors}; wanted {want_errors}")
    log(f"validator: one byte changed at 0 of {tree['paths'][small].name} ({sizes[small]} B) and "
        f"at {sizes[big] // 2} (window {window}) of {tree['paths'][big].name} "
        f"({sizes[big] / 2**20:.0f} MiB); revalidating /d{d:02d}/ ({in_dir} files, "
        f"{time.perf_counter() - t0:.2f} s) reports exactly these: {errors}")

    shapes = sorted(((n, shape) for (k, tag, shape), n in raw_shapes.items()
                     if k == "blake3_chunk_cvs" and shape[1] == 2048), reverse=True)
    window_shape = shapes[0][1] if shapes else (32, 2048)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    times = window_timing(window_shape, top_level_shape(tree), int32_ops_per_s, flush)
    del flush
    torch.cuda.empty_cache()
    log(f"phase 7: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "by_shape": by_shape, "stats": stats, "job_s": job_s,
            "files": n_hashed, "bytes": total_bytes, "times": times, "edges": edges,
            "mesh": mesh, "sharded": sharded, "tampered_dir": d}


# --------------------------------------------------------------------------
# phase 8: job control on the card
# --------------------------------------------------------------------------

#: phase 8's pages and groups: 256-file pages (adaptation off), one page a
#: transaction, so a pause, a cancel and a kill land after a few of the 16
#: pages of its 4,096 files
JOBS_ENV = {"SD_SCAN_BATCH": "256", "SD_COMMIT_GROUP": "1"}
#: the kill point of run (c): the eighth seam hit of identify's
#: transactions, the COMMIT of its fourth page (three pages checkpointed)
KILL_SPEC = "commit:kill:skip7"
#: a temporary that a killed thumbnail write would leave
PLANTED_TMP = "thumbnails/ab/ab00000000000000.webp.sd-tmp.0badf00d"


def jobs_tree(tree_dir: Path, skip_dir: int) -> tuple[Path, list[int]]:
    """16 of the tree's directories, the one phase 7 changed left out, as
    hard links (no new bytes: the sparse large files stay sparse)."""
    dirs = [d for d in range(N_DIRS) if d != skip_dir][:16]
    root = WORK / "jobs"
    for d in dirs:
        (root / f"d{d:02d}").mkdir(parents=True)
        for p in (tree_dir / f"d{d:02d}").iterdir():
            os.link(p, root / f"d{d:02d}" / p.name)
    return root, dirs


def jobs_location(lib, root: Path) -> dict:
    from spacedrive_tpu_torch.locations import create_location
    from spacedrive_tpu_torch.models import Location

    loc = create_location(lib, root)
    lib.db.update(Location, {"id": loc["id"]}, {"generate_preview_media": False})
    return loc


def identify_row(db) -> dict:
    return dict(db.query("SELECT * FROM job WHERE name = 'file_identifier'")[0])


def checkpoint_of(row: dict) -> dict:
    return json.loads(row["data"])


def wait_until(what: str, pred, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            fail(f"job control: {what} did not happen within {timeout:.0f} s")
        time.sleep(0.005)


def committed_pages(db, step_number: int) -> tuple[set, set]:
    """(the files with a cas_id, the non-empty files of the first
    ``step_number`` pages): a checkpoint at a page boundary makes them
    equal."""
    rows = db.query("SELECT materialized_path, name, size_in_bytes, cas_id FROM file_path "
                    "WHERE is_dir = 0 AND name != '' ORDER BY id")
    page = int(JOBS_ENV["SD_SCAN_BATCH"])
    want = {(r["materialized_path"], r["name"]) for r in rows[:step_number * page]
            if r["size_in_bytes"]}
    have = {(r["materialized_path"], r["name"]) for r in rows if r["cas_id"]}
    return have, want


def rows_against_phase4(db, phase4_db, phase4_rows: dict, n_files: int, what: str) -> None:
    """Every cas_id and every manifest equal phase 4's for the same files."""
    rows = {(r["materialized_path"], r["name"], r["extension"]): r["cas_id"] for r in db.query(
        "SELECT materialized_path, name, extension, cas_id FROM file_path WHERE is_dir = 0")}
    differ = [k for k, cas in rows.items() if phase4_rows[k]["cas_id"] != cas]
    if len(rows) != n_files or differ:
        fail(f"job control: {what}: {len(rows)} files, {len(differ)} cas_ids differ from "
             f"phase 4's, e.g. {differ[:2]}")
    mine, theirs = scan_rows(db)[2], scan_rows(phase4_db)[2]
    bad = [c for c, m in mine.items() if theirs.get(c) != m]
    want = {c for c in set(rows.values()) if c in theirs}
    if bad or set(mine) != want:
        fail(f"job control: {what}: {len(bad)} manifests differ from phase 4's, "
             f"{len(set(mine) ^ want)} missing or extra")


def pause_resume_run(node, root: Path, phase4_db, phase4_rows: dict, n_files: int) -> dict:
    """Run (a): pause identify after a committed page, check the Paused
    row, its checkpoint and the frozen launch counters, resume it."""
    from spacedrive_tpu_torch.api.routers.jobs import pause, resume
    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import scan_location
    from spacedrive_tpu_torch.ops import _kernels

    lib = node.libraries.create("chip-smoke-pause")
    loc = jobs_location(lib, root)
    t0 = time.perf_counter()
    scan_location(lib, loc["id"])
    wait_until("a committed page", lambda: lib.db.query(
        "SELECT data FROM job WHERE name = 'file_identifier' AND status = ?",
        [JobStatus.RUNNING]) and checkpoint_of(identify_row(lib.db))["step_number"] >= 1)
    job_id = identify_row(lib.db)["id"]
    if not pause(node, job_id):
        fail("job control: pause found no running identify job")
    wait_until("the pause", lambda: identify_row(lib.db)["status"] == JobStatus.PAUSED, 60)
    paused_s = time.perf_counter() - t0
    frozen = dict(_kernels.LAUNCHES)
    time.sleep(2.0)
    if dict(_kernels.LAUNCHES) != frozen:
        fail(f"job control: kernels launched while the job was Paused: {frozen} -> "
             f"{dict(_kernels.LAUNCHES)}")
    state = checkpoint_of(identify_row(lib.db))
    have, want = committed_pages(lib.db, state["step_number"])
    if not 0 < state["step_number"] < len(state["steps"]) or have != want:
        fail(f"job control: paused at step {state['step_number']} of {len(state['steps'])} "
             f"with {len(have)} files identified, {len(want)} in its committed pages")
    chain = {r["name"]: r["status"] for r in lib.db.query("SELECT name, status FROM job")}
    if chain.get("dedup_detector") != JobStatus.PAUSED:
        fail(f"job control: the chain after the paused job is {chain}")
    torch_sync()
    _kernels.reset_counts()
    t1 = time.perf_counter()
    if not resume(node, lib, job_id):
        fail("job control: resume refused the paused job")
    if not node.jobs.wait_idle(600):
        fail("job control: the resumed scan did not finish within 600 s")
    resumed_s = time.perf_counter() - t1
    launches, plain = dict(_kernels.LAUNCHES), dict(_kernels.PLAIN_ON_CUDA)
    row = identify_row(lib.db)
    statuses = {r["name"]: r["status"] for r in lib.db.query("SELECT name, status FROM job")}
    if set(statuses.values()) != {JobStatus.COMPLETED}:
        fail(f"job control: after the resume the jobs ended {statuses}")
    for kernel in ("blake3_chunk_cvs", "blake3_merge", "gear_candidates"):
        if launches.get(kernel, 0) <= 0:
            fail(f"job control: the resumed scan never launched {kernel}")
    if any(plain.values()):
        fail(f"job control: the resumed scan called plain versions on the card: {plain}")
    rows_against_phase4(lib.db, phase4_db, phase4_rows, n_files, "the resumed scan")
    meta = json.loads(row["metadata"])
    log(f"job control (a) pause and resume: paused after {paused_s:.2f} s at step "
        f"{state['step_number']} of {len(state['steps'])} ({len(have)} files committed, whole "
        f"pages); no launch in the 2 s after Paused; resumed in {resumed_s:.2f} s, "
        f"{meta['pipeline_batches']} pages committed by the resumed run; launches of the "
        f"resumed run {launches}, plain versions on the card 0; cas_ids and manifests of "
        f"{n_files} files equal phase 4's")
    return {"paused_s": paused_s, "resumed_s": resumed_s, "paused_step": state["step_number"],
            "steps": len(state["steps"]), "launches": launches}


def cancel_run(node, root: Path) -> dict:
    """Run (b): cancel identify after a committed page: the job and its
    chain end Canceled with only whole pages committed."""
    from spacedrive_tpu_torch.api.routers.jobs import cancel
    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import scan_location

    lib = node.libraries.create("chip-smoke-cancel")
    loc = jobs_location(lib, root)
    t0 = time.perf_counter()
    scan_location(lib, loc["id"])
    wait_until("a committed page", lambda: lib.db.query(
        "SELECT data FROM job WHERE name = 'file_identifier' AND status = ?",
        [JobStatus.RUNNING]) and checkpoint_of(identify_row(lib.db))["step_number"] >= 1)
    if not cancel(node, identify_row(lib.db)["id"]):
        fail("job control: cancel found no running identify job")
    if not node.jobs.wait_idle(120):
        fail("job control: the canceled scan did not stop within 120 s")
    cancel_s = time.perf_counter() - t0
    row = identify_row(lib.db)
    statuses = {r["name"]: r["status"] for r in lib.db.query("SELECT name, status FROM job")}
    state = checkpoint_of(row)
    have, want = committed_pages(lib.db, state["step_number"])
    if (statuses["file_identifier"] != JobStatus.CANCELED
            or statuses["dedup_detector"] != JobStatus.CANCELED or have != want):
        fail(f"job control: cancel left {statuses}, {len(have)} files identified, "
             f"{len(want)} in the {state['step_number']} committed pages")
    log(f"job control (b) cancel: canceled {cancel_s:.2f} s after the scan began, at step "
        f"{state['step_number']} of {len(state['steps'])}: identify and its chain Canceled, "
        f"{len(have)} files identified, exactly the non-empty files of the committed pages")
    return {"cancel_s": cancel_s, "step": state["step_number"], "steps": len(state["steps"])}


def kill_child(data_dir: str, root: str) -> int:
    """The child of run (c): boot a Node on the card on ``data_dir``, plant
    a stale temporary in its thumbnail cache, scan ``root`` and arm
    ``KILL_SPEC`` once identify's init is done, so the commit seam counts
    identify's transactions only. The armed seam SIGKILLs this process."""
    import torch

    if not torch.cuda.is_available():
        fail("the kill child needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from spacedrive_tpu_torch import faults
    from spacedrive_tpu_torch.locations import scan_location
    from spacedrive_tpu_torch.node import Node

    node = Node(data_dir, watch_locations=False)
    lib = node.libraries.create("chip-smoke-kill")
    loc = jobs_location(lib, Path(root))
    planted = Path(data_dir) / PLANTED_TMP
    planted.parent.mkdir(parents=True, exist_ok=True)
    planted.write_bytes(b"half a thumbnail")

    def arm(event) -> None:
        if event.kind == "db.commit" and (event.payload or {}).get("source") == "job.init" \
                and event.payload.get("job") == "file_identifier":
            faults.install(KILL_SPEC)

    node.events.on(arm)
    scan_location(lib, loc["id"])
    node.jobs.wait_idle(600)
    node.shutdown()
    print("job control: the kill child was not killed", file=sys.stderr, flush=True)
    return 3


def kill_run(node_cls, root: Path, phase4_rows: dict, n_files: int) -> dict:
    """Run (c): a child process scans on the card until ``KILL_SPEC``
    SIGKILLs it mid-identify; a Node booted here on its data dir sweeps the
    planted temporary and cold-resumes the Running identify job, which
    finishes the chain with phase 4's cas_ids."""
    import signal
    import sqlite3

    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.ops import _kernels

    data_dir = WORK / "kill-data"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--kill-child",
                           str(data_dir), str(root)], env={**os.environ, **JOBS_ENV},
                          capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != -signal.SIGKILL:
        fail(f"job control: the kill child exited {proc.returncode}, not by SIGKILL:\n"
             f"{proc.stderr[-3000:]}")
    (db_path,) = (data_dir / "libraries").glob("*.db")
    conn = sqlite3.connect(db_path)
    status, blob = conn.execute(
        "SELECT status, data FROM job WHERE name = 'file_identifier'").fetchone()
    conn.close()
    killed_at = json.loads(blob)["step_number"]
    if status != JobStatus.RUNNING or killed_at != 3:
        fail(f"job control: the killed identify job is {status} at step {killed_at}, not "
             f"Running at step 3")
    planted = data_dir / PLANTED_TMP
    if not planted.exists():
        fail("job control: the kill child planted no temporary file")
    _kernels.reset_counts()
    t1 = time.perf_counter()
    node = node_cls(data_dir, watch_locations=False)  # sweeps, then cold-resumes
    try:
        if planted.exists():
            fail(f"job control: the boot sweep left {planted}")
        (lib,) = node.libraries.list()
        if not node.jobs.wait_idle(600):
            fail("job control: the cold-resumed chain did not finish within 600 s")
        resume_s = time.perf_counter() - t1
        statuses = {r["name"]: r["status"] for r in lib.db.query("SELECT name, status FROM job")}
        if set(statuses.values()) != {JobStatus.COMPLETED}:
            fail(f"job control: after the cold resume the jobs ended {statuses}")
        rows = {(r["materialized_path"], r["name"], r["extension"]): r["cas_id"]
                for r in lib.db.query("SELECT materialized_path, name, extension, cas_id "
                                      "FROM file_path WHERE is_dir = 0")}
        meta = json.loads(identify_row(lib.db)["metadata"])
    finally:
        node.shutdown()
    differ = [k for k, cas in rows.items() if phase4_rows[k]["cas_id"] != cas]
    if len(rows) != n_files or differ:
        fail(f"job control: the cold-resumed scan's {len(rows)} cas_ids: {len(differ)} differ "
             f"from phase 4's")
    launches = dict(_kernels.LAUNCHES)
    if launches.get("blake3_chunk_cvs", 0) <= 0 or any(_kernels.PLAIN_ON_CUDA.values()):
        fail(f"job control: the cold resume launched {launches}, plain versions "
             f"{dict(_kernels.PLAIN_ON_CUDA)}")
    log(f"job control (c) kill and cold resume: the child died by SIGKILL at {KILL_SPEC} "
        f"after {child_s:.2f} s (boot, index and three committed pages), its identify row "
        f"Running at step {killed_at}; the boot here swept {PLANTED_TMP} and cold-resumed "
        f"the chain in {resume_s:.2f} s ({meta['pipeline_batches']} pages committed after the "
        f"resume); cas_ids of {n_files} files equal phase 4's; launches {launches}")
    return {"child_s": child_s, "resume_s": resume_s, "killed_at": killed_at,
            "launches": launches}


def job_control_phase(node, tree_dir: Path, phase4_db, phase4_rows: dict, skip_dir: int) -> dict:
    """Phase 8: pause and resume, cancel, kill and cold resume a scan of 16
    of the tree's directories on the card."""
    from spacedrive_tpu_torch.node import Node

    t_phase = time.perf_counter()
    root, dirs = jobs_tree(tree_dir, skip_dir)
    n_files = sum(1 for _ in root.glob("d*/*"))
    saved = {k: os.environ.get(k) for k in JOBS_ENV}
    os.environ.update(JOBS_ENV)
    try:
        paused = pause_resume_run(node, root, phase4_db, phase4_rows, n_files)
        canceled = cancel_run(node, root)
        killed = kill_run(Node, root, phase4_rows, n_files)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t_phase
    log(f"phase 8 (job control): {n_files} files of directories {dirs[0]}-{dirs[-1]} "
        f"(d{skip_dir:02d} left out), {seconds:.1f} s")
    return {"pause": paused, "cancel": canceled, "kill": killed, "seconds": seconds,
            "files": n_files}


def torch_sync() -> None:
    import torch

    torch.cuda.synchronize()


def top_level_shape(tree: dict) -> tuple:
    """(rows, C, nodes a row) of the merge above the windows in the step
    that holds the most large files: one row a file of more than one
    window, its window CVs, C their largest count to a power of two."""
    from spacedrive_tpu_torch.objects.validator import BATCH
    from spacedrive_tpu_torch.ops import blake3 as b3

    sizes = [s for s in tree["sizes"] if s > 0]
    best: list = []
    for s in range(0, len(sizes), BATCH):
        nodes = [-(-n // (b3.WINDOW_CHUNKS * 1024)) for n in sizes[s : s + BATCH]]
        nodes = [n for n in nodes if n > 1]
        if len(nodes) > len(best):
            best = nodes
    return len(best), 1 << (max(best) - 1).bit_length(), best


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
    # the bulk load is set-up: a 256 MiB page cache on the writer holds
    # file_path's indexes while it runs (SQLite's default 2 MiB made it
    # superlinear in the rows); the queries below run at the default again
    cache_pages = db.execute("PRAGMA cache_size").fetchone()[0]
    db.execute("PRAGMA cache_size=-262144")
    n_objects = max(1, N_SEARCH_ROWS // 100)
    db.executemany("INSERT INTO object (pub_id, kind, favorite) VALUES (?, ?, ?)",
                   [(f"ob-{i}", i % 8, int(i % 5 == 0)) for i in range(n_objects)])
    first_obj = db.query("SELECT MIN(id) m FROM object")[0]["m"]
    db.executemany(
        "INSERT INTO file_path (pub_id, location_id, materialized_path, name, extension, "
        "is_dir, hidden, size_in_bytes, object_id, date_created) VALUES (?,?,?,?,?,?,?,?,?,?)",
        [(r[0], loc_id, r[1], r[2], r[3], 0, r[4], r[5],
          None if r[6] is None else first_obj + r[6], r[7]) for r in corpus])
    db.execute(f"PRAGMA cache_size={cache_pages}")
    corpus_s = time.perf_counter() - t0
    # the recipe leaves half its objects without a file_path: remove them
    # now, as the orphan remover's first tick would (its raw DELETE floods
    # the row journal, so a tick between two refreshes below forces a full
    # rebuild)
    lib.orphan_remover.process_clean_up()
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
    engine.refresh_now(lib)  # whatever was noted before the renames
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
    return {"launches": launches, "per_pass": per_pass, "by_shape": by_shape,
            "library_id": lib.id}


# --------------------------------------------------------------------------
# phase 9: the serving path (the rspc router and the server shell)
# --------------------------------------------------------------------------

#: repeats of each query over each transport (the p50 of 3)
SERVE_REPEATS = 3
SEARCH_KERNELS = ("search_substring", "search_exact", "search_lex")
SCAN_KERNELS = ("blake3_chunk_cvs", "blake3_merge", "gear_candidates")


def kernel_counts(names) -> dict:
    from spacedrive_tpu_torch.ops import _kernels

    return {k: _kernels.LAUNCHES.get(k, 0) for k in names}


def serve_search_phase(node, lib, card: str) -> dict:
    """Phase 9 (a): phase 5's queries on the 1,000,000-row library through
    a Server on phase 5's node, over HTTP GET, HTTP POST and the websocket,
    each answer byte-identical to the in-process ``router.resolve`` answer
    and to the engine-off SQL answer, each call growing the search kernels'
    launches by what the in-process call launched; p50s of each transport
    beside the in-process p50. Counts zeroed before, read after."""
    import statistics

    import torch

    from spacedrive_tpu_torch.ops import _kernels
    from spacedrive_tpu_torch.server import Server
    from tests.torch_serve_client import WsClient, rspc_get, rspc_post

    from spacedrive_tpu_torch.api.router import last_rung

    t_phase = time.perf_counter()
    engine = node.search_engine
    engine.refresh_now(lib)
    t0 = time.perf_counter()
    server = Server(node, "127.0.0.1", 0)
    server.start()
    bind_s = time.perf_counter() - t0
    url = f"http://127.0.0.1:{server.port}"
    ws = WsClient("127.0.0.1", server.port)
    try:
        # the pool comes up after the bind
        if server.wait_pool() is None or node.reader_pool is None:
            fail("serve: Server.start brought up no reader pool")
        pool_start_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        _kernels.reset_counts()
        served0 = engine.status()["served"]
        rspc0 = series("sd_rspc_requests_total")
        asked: dict = {}
        p50: dict = {t: {} for t in ("in_process", "get", "post", "ws")}
        expected: dict = {}
        rungs: dict = {}
        for label, key, arg in SEARCH_MATRIX:
            engine.set_enabled(False)
            sql = json.dumps(node.router.resolve(key, arg, lib.id), default=str)
            engine.set_enabled(True)
            # once first: a candidate set past MAX_HYDRATE is scored here the
            # first time only, then goes to the pool (prefers_inprocess)
            node.router.resolve(key, arg, lib.id)
            before = kernel_counts(SEARCH_KERNELS)
            value = node.router.resolve(key, arg, lib.id)
            rungs[label] = last_rung()
            want = json.dumps(value, default=str)
            expected[label] = {k: v - before[k] for k, v in kernel_counts(SEARCH_KERNELS).items()}
            if want != sql:
                fail(f"serve: {label}: the in-process engine answer differs from SQL")
            http_want = json.dumps({"result": value}, default=str)

            def ws_call():
                msg_id, raw = ws.call_raw("query", key, {"library_id": lib.id, "arg": arg})
                return raw.decode(), json.dumps({"jsonrpc": "2.0", "id": msg_id, "result": {
                    "type": "response", "data": value}}, default=str)

            calls = {
                "in_process": lambda: (json.dumps(node.router.resolve(key, arg, lib.id),
                                                  default=str), want),
                "get": lambda: (rspc_get(url, key, arg, lib.id).decode(), http_want),
                "post": lambda: (rspc_post(url, key, arg, lib.id).decode(), http_want),
                "ws": ws_call,
            }
            for transport, fn in calls.items():
                lat = []
                for _ in range(SERVE_REPEATS):
                    before = kernel_counts(SEARCH_KERNELS)
                    t0 = time.perf_counter()
                    got, expect = fn()
                    lat.append((time.perf_counter() - t0) * 1e3)
                    grew = {k: v - before[k] for k, v in kernel_counts(SEARCH_KERNELS).items()}
                    if got != expect:
                        fail(f"serve: {label} over {transport}: the answer is not byte-identical "
                             f"to the in-process one ({len(got)} vs {len(expect)} bytes)")
                    if grew != expected[label]:
                        fail(f"serve: {label} over {transport} launched {grew}, the in-process "
                             f"call {expected[label]}")
                p50[transport][label] = statistics.median(lat)
            # three resolves above, then each transport's repeats
            asked[key] = asked.get(key, 0) + 3 + 4 * SERVE_REPEATS
            log(f"serve: {label} ({key}, rung {rungs[label]}): p50 in-process "
                f"{p50['in_process'][label]:.3f} ms, GET "
                f"{p50['get'][label]:.3f} ms, POST {p50['post'][label]:.3f} ms, websocket "
                f"{p50['ws'][label]:.3f} ms; launches a call {expected[label]}")
        launches = kernel_counts(SEARCH_KERNELS)
        plain = {k: v for k, v in _kernels.PLAIN_ON_CUDA.items() if v}
        served = engine.status()["served"] - served0
        telemetered = serve_telemetry_checks(node, lib, url, rspc0, asked, card)
        pooled = serve_pool_checks(node, lib, card)
        pooled["start_s"] = pool_start_s
        pooled["bind_s"] = bind_s
    finally:
        ws.close()
        server.stop()
    if node.reader_pool is not None:
        fail("serve: Server.stop left the reader pool it started attached")
    if not any(r == "engine" for r in rungs.values()):
        fail(f"serve: no query of phase 5 took the engine's rung: {rungs}")
    for kernel in SEARCH_KERNELS:
        if launches[kernel] <= 0:
            fail(f"serve: the queries over the server never launched {kernel}")
    if plain:
        fail(f"serve: plain versions ran on the card: {plain}")
    median = {t: statistics.median(v.values()) for t, v in p50.items()}
    added = {t: statistics.median(p50[t][q] - p50["in_process"][q] for q in p50[t])
             for t in ("get", "post", "ws")}
    seconds = time.perf_counter() - t_phase
    log(f"serve (phase 9a) on {card}: {len(SEARCH_MATRIX)} queries x 4 routes x "
        f"{SERVE_REPEATS} repeats, every answer byte-identical to the in-process and the SQL "
        f"answer; {served} engine serves; launches {launches}; median of the queries' p50s: "
        + ", ".join(f"{t} {v:.3f} ms" for t, v in median.items())
        + "; added over in-process (median of the per-query differences): "
        + ", ".join(f"{t} {v:.3f} ms" for t, v in added.items()) + f"; {seconds:.1f} s")
    return {"launches": launches, "p50": median, "added_ms": added, "seconds": seconds,
            "rungs": rungs, "pool": pooled, "telemetry": telemetered}


def serve_telemetry_checks(node, lib, url: str, rspc0: dict, asked: dict, card: str) -> dict:
    """Phase 9 (a): the matrix's requests in ``sd_rspc_requests_total``,
    one by one, then an ``ApiError`` and a shed over HTTP; ``GET /metrics``
    read line by line; a slow ``search.paths`` in the ring with its
    ``db.query`` spans."""
    from spacedrive_tpu_torch.telemetry import requests as rq
    from spacedrive_tpu_torch.telemetry.slo import tenant_label
    from tests.torch_serve_client import get, post

    got = {}
    for lbls, v in series("sd_rspc_requests_total").items():
        d = v - rspc0.get(lbls, 0.0)
        if d:
            got[(dict(lbls)["proc"], dict(lbls)["outcome"])] = d
    want = {(k, "ok"): float(n) for k, n in asked.items()}
    if got != want:
        fail(f"serve: sd_rspc_requests_total grew by {got}, the phase asked {want}")
    before = series("sd_rspc_requests_total")
    status, _body = post(url, "/rspc/search.paths", {"arg": {"take": 1},
                                                      "library_id": "no-such-library"})
    budget = node.dispatch_budget
    held = [budget.try_admit(tenant_label(lib.id)) for _ in range(budget.max_inflight)]
    try:
        shed, _body = post(url, "/rspc/search.pathsCount", {"arg": {"search": "x"},
                                                             "library_id": lib.id})
    finally:
        for h in held:
            h.release()
    outcomes = series_delta("sd_rspc_requests_total", before, "outcome")
    if (status, shed) != (400, 429) or outcomes != {"api_error": 1.0, "shed": 1.0}:
        fail(f"serve: an unknown library answered {status}, a held budget {shed}; "
             f"outcomes {outcomes}")
    _s, _h, body = get(url, "/metrics")
    typed = parse_metrics(body.decode())
    os.environ["SD_SLOW_REQUEST_MS"] = "0"
    try:
        _label, key, arg = SEARCH_MATRIX[0]
        node.router.resolve(key, arg, lib.id)
    finally:
        del os.environ["SD_SLOW_REQUEST_MS"]
    slow = [e for e in rq.slow_requests(4) if e["proc"] == key]
    queries = spans_named(slow[0]["tree"], "db.query") if slow else []
    if not queries:
        fail(f"serve: the slow {key} is not in the ring with db.query spans: "
             f"{[e['proc'] for e in rq.slow_requests(4)]}")
    out = {"requests": sum(want.values()), "families": len(typed),
           "metrics_bytes": len(body), "slow_db_queries": len(queries),
           "slow_ms": slow[0]["duration_s"] * 1e3}
    log(f"serve telemetry on {card}: sd_rspc_requests_total grew by the phase's "
        f"{int(out['requests'])} ok requests, proc by proc, then one api_error (400) and one "
        f"shed (429); GET /metrics: {len(typed)} families, {len(body)} B, every line parsed; "
        f"a slow {key} ({out['slow_ms']:.2f} ms) in the ring with {len(queries)} db.query spans")
    return out


#: pool-marked queries the engine does not serve, so the reader pool's
#: workers answer them from the 1,000,000-row library (``file`` and
#: ``location`` take the library's ids at run time; ``wildcard``'s ``_``
#: is a LIKE wildcard, which the engine leaves to SQL)
POOL_MATRIX = [
    ("objects", "search.objects", {"take": 200}),
    ("objects_count", "search.objectsCount", None),
    ("duplicates", "search.duplicates", {"take": 100}),
    ("tags", "tags.list", None),
    ("file", "files.get", None),
    ("location", "locations.get", None),
    ("wildcard", "search.paths", {"search": "report_", "take": 100}),
]
#: the dispatch a worker is killed in: every row sorted by size (seconds
#: of SQL in the worker)
KILL_QUERY = {"search": "_", "order_by": "size_in_bytes", "order_desc": True, "take": 100}


def cuda_handles(pid: int) -> dict:
    """What of CUDA a process holds, read from /proc: its open
    ``/dev/nvidia*`` files and whether ``libcuda`` is mapped."""
    devices = set()
    try:
        for fd in os.listdir(f"/proc/{pid}/fd"):
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                devices.add(target)
        with open(f"/proc/{pid}/maps") as fh:
            libcuda = any("libcuda.so" in line for line in fh)
    except OSError as e:
        return {"error": str(e)}
    return {"devices": sorted(devices), "libcuda": libcuda}


def compute_apps() -> list[str]:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def bump_pool(pool, lib_id: str) -> None:
    """A new watermark for the pool alone, as its bus hook takes a commit:
    a ``db.commit`` on the bus would stale the engine too, and its refresh
    of the 1,000,000-row index holds the library's reader (a COUNT(*)),
    which every pool dispatch waits on for the replica rung's member rows,
    during the timed calls."""
    import types

    pool._on_event(types.SimpleNamespace(kind="db.commit", library_id=lib_id))


def serve_pool_checks(node, lib, card: str) -> dict:
    """Phase 9 (a), the reader pool the shell forked beside the node on the
    card: the pool-marked queries the engine does not serve, answered by
    the workers from the 1,000,000-row library, each byte-identical to the
    in-process answer (a fresh pool watermark before each, so the workers'
    page cache misses; the replay of the same page timed apart as a hit); a
    worker SIGKILLed during a dispatch, whose request fails over to the
    process and answers right while the supervisor respawns the slot; and
    no worker holding anything of CUDA while the node does."""
    import signal
    import statistics

    from spacedrive_tpu_torch.api.router import RawJson, last_rung
    from spacedrive_tpu_torch.server.pool import configured_workers

    pool = node.reader_pool
    status = pool.status()
    if pool.workers != configured_workers() or status["alive"] != pool.workers:
        fail(f"serve: the shell's pool runs {status['alive']} of {pool.workers} workers, "
             f"{configured_workers()} configured")
    ids = {"file": {"file_path_id": lib.db.query(
               "SELECT id FROM file_path ORDER BY id LIMIT 1 OFFSET ?",
               [N_SEARCH_ROWS // 2])[0]["id"]},
           "location": lib.db.query("SELECT id FROM location ORDER BY id")[0]["id"]}
    rungs, lat = {}, {"pool": {}, "pool_hit": {}, "in_process": {}}
    served0 = series("sd_serve_worker_requests_total")
    cache0 = series("sd_serve_worker_cache_total")
    for label, key, arg in POOL_MATRIX:
        arg = ids.get(label, arg)
        times: dict = {k: [] for k in lat}
        for _ in range(SERVE_REPEATS):
            bump_pool(pool, lib.id)
            t0 = time.perf_counter()
            got = node.router.resolve(key, arg, lib.id, raw=True)
            times["pool"].append((time.perf_counter() - t0) * 1e3)
            rungs[label] = last_rung()
            t0 = time.perf_counter()
            again = node.router.resolve(key, arg, lib.id, raw=True)
            times["pool_hit"].append((time.perf_counter() - t0) * 1e3)
            pool.set_enabled(False)
            t0 = time.perf_counter()
            want = json.dumps(node.router.resolve(key, arg, lib.id), default=str).encode()
            times["in_process"].append((time.perf_counter() - t0) * 1e3)
            pool.set_enabled(True)
            if rungs[label] != "pool" or not isinstance(got, RawJson):
                fail(f"serve: {label} ({key}) took the {rungs[label]} rung, not the pool")
            if got.data != want or again.data != want:
                fail(f"serve: the pool's {label} ({key}) page is not the in-process page "
                     f"({len(got.data)} / {len(again.data)} vs {len(want)} bytes)")
        for k in lat:
            lat[k][label] = statistics.median(times[k])
        log(f"serve (pool): {label} ({key}) byte-identical through {pool.workers} workers; "
            f"p50 pool {lat['pool'][label]:.3f} ms (a cached replay "
            f"{lat['pool_hit'][label]:.3f} ms), in-process {lat['in_process'][label]:.3f} ms")

    # the dispatches in the node's process's families, from each reply
    dispatched = series_delta("sd_serve_worker_requests_total", served0, "outcome")
    cached = series_delta("sd_serve_worker_cache_total", cache0, "result")
    n_pool = 2 * len(POOL_MATRIX) * SERVE_REPEATS
    if dispatched != {"ok": float(n_pool)} or not cached.get("hit") or \
            sum(cached.values()) > n_pool:
        fail(f"serve: sd_serve_worker_requests_total grew by {dispatched}, the cache family by "
             f"{cached}; the phase made {n_pool} pool dispatches")
    restart_series0 = series("sd_serve_worker_restarts_total")
    # a worker SIGKILLed in the middle of a dispatch; the supervisor's pings
    # are held off meanwhile, so the one worker out of the idle list is the
    # one serving
    bump_pool(pool, lib.id)
    pool.set_enabled(False)
    want = json.dumps(node.router.resolve("search.paths", KILL_QUERY, lib.id), default=str)
    pool.set_enabled(True)
    health_s, pool.health_s = pool.health_s, 3600.0
    time.sleep(health_s + 0.3)
    restarts0 = pool.status()["restarts"]
    result: dict = {}

    def call() -> None:
        t0 = time.perf_counter()
        result["page"] = json.dumps(node.router.resolve("search.paths", KILL_QUERY, lib.id),
                                    default=str)
        result["rung"], result["ms"] = last_rung(), (time.perf_counter() - t0) * 1e3

    thread = threading.Thread(target=call)
    thread.start()
    victim = None
    deadline = time.monotonic() + 10
    while victim is None and time.monotonic() < deadline:
        with pool._cv:
            busy = [w for w in pool._slots if w is not None and w not in pool._idle]
        victim = busy[0] if busy else None
        time.sleep(0.001)
    if victim is None:
        fail("serve: no worker took the dispatch to be killed")
    os.kill(victim.proc.pid, signal.SIGKILL)
    t_kill = time.perf_counter()
    thread.join(120)
    pool.health_s = health_s
    pool._respawn_wake.set()  # the supervisor waits out the old interval otherwise
    respawn_s = None
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        st = pool.status()
        if st["alive"] == pool.workers and st["restarts"] > restarts0:
            respawn_s = time.perf_counter() - t_kill
            break
        time.sleep(0.01)
    if result.get("rung") != "in_process" or result.get("page") != want:
        fail(f"serve: the dispatch whose worker was killed answered through "
             f"{result.get('rung')}, {'the right' if result.get('page') == want else 'a wrong'} "
             f"page")
    if respawn_s is None or victim.proc.pid in pool.worker_pids():
        fail(f"serve: the killed worker's slot was not respawned: {pool.status()}")
    crashed = series_delta("sd_serve_worker_restarts_total", restart_series0, "reason")
    if crashed.get("crash", 0) < 1:
        fail(f"serve: the killed worker is not in sd_serve_worker_restarts_total: {crashed}")

    # the node holds the card; no worker holds anything of CUDA
    apps = compute_apps()
    held = {pid: cuda_handles(pid) for pid in pool.worker_pids()}
    mine = cuda_handles(os.getpid())
    if len(apps) != 1 or not mine.get("devices"):
        fail(f"serve: nvidia-smi lists compute apps {apps}; this process holds {mine}")
    # a context needs the device files open; a worker may map
    # libcuda without them (not a context), so that is reported, not judged
    if any(h.get("devices") or h.get("error") for h in held.values()):
        fail(f"serve: a pool worker holds a /dev/nvidia* file: {held}")
    out = {"workers": pool.workers, "rungs": rungs,
           "p50_ms": {k: statistics.median(v.values()) for k, v in lat.items()},
           "by_query_ms": lat, "killed_dispatch_ms": result["ms"], "respawn_s": respawn_s,
           "restarts": pool.status()["restarts"], "compute_apps": apps,
           "worker_cuda_handles": sum(len(h.get("devices", [])) for h in held.values()),
           "workers_mapping_libcuda": sum(bool(h.get("libcuda")) for h in held.values()),
           "serve_families": {"requests": dispatched, "cache": cached, "restarts": crashed}}
    log(f"serve (pool) on {card}: {pool.workers} workers (forkserver); {len(POOL_MATRIX)} "
        f"queries byte-identical to in-process; median p50 pool "
        f"{out['p50_ms']['pool']:.3f} ms (cached replay {out['p50_ms']['pool_hit']:.3f} ms), "
        f"in-process {out['p50_ms']['in_process']:.3f} ms; a worker SIGKILLed mid-dispatch: "
        f"the request answered in process in {result['ms']:.1f} ms, right, and the slot "
        f"respawned {respawn_s:.2f} s after the kill; nvidia-smi compute apps {apps} (this "
        f"process holds {len(mine['devices'])} /dev/nvidia* files, the {len(held)} workers "
        f"none; {out['workers_mapping_libcuda']} map libcuda without a device file)")
    return out


class SseTail:
    """A client of ``GET /telemetry/stream`` on its own thread: keeps every
    event it reads until :meth:`close`. The ring's replay starts after the
    newest event already in it, so the tail sees only what comes next."""

    def __init__(self, port: int) -> None:
        import socket

        from spacedrive_tpu_torch import telemetry

        newest = telemetry.recent_events(1)
        after = newest[-1]["seq"] if newest else 0
        self.events: list[dict] = []
        self.head = b""
        self._sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        self._sock.sendall(f"GET /telemetry/stream?after={after} HTTP/1.1\r\n"
                           f"Host: chip-smoke\r\n\r\n".encode())
        self._thread = threading.Thread(target=self._read, daemon=True, name="sse-client")
        self._thread.start()

    def _read(self) -> None:
        buf = b""
        while True:
            try:
                chunk = self._sock.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            if not self.head and b"\r\n\r\n" in buf:
                self.head, buf = buf.split(b"\r\n\r\n", 1)
            while self.head and b"\n\n" in buf:
                frame, buf = buf.split(b"\n\n", 1)
                for line in frame.split(b"\n"):
                    if line.startswith(b"data: "):
                        self.events.append(json.loads(line[6:]))

    def close(self) -> None:
        import socket

        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()
        self._thread.join(10)


def follow_jobs(ws, sub_id: int, url: str, lib_id: str, what: str,
                timeout: float = 300.0) -> tuple[list, list]:
    """Read the websocket until the jobs.progress subscription ``sub_id``
    shows the chain's last job (dedup_detector) finished and no job is
    active; (progress payloads, other events)."""
    from spacedrive_tpu_torch.jobs import JobStatus
    from tests.torch_serve_client import rspc

    progress, other = [], []
    deadline = time.monotonic() + timeout
    done = False
    while not (done and not rspc(url, "jobs.isActive")):
        if time.monotonic() > deadline:
            fail(f"serve: {what}: the chain did not end within {timeout:.0f} s: "
                 f"{[(p['name'], p['status']) for p in progress[-5:]]}")
        try:
            msg = ws.recv(timeout=0.5)
        except TimeoutError:
            continue
        if msg is None:
            fail(f"serve: {what}: the websocket closed")
        if msg.get("id") != sub_id:
            other.append(msg)
            continue
        payload = msg["result"]["data"]["payload"]
        progress.append(payload)
        if payload["name"] == "dedup_detector" and payload["status"] in JobStatus.FINISHED:
            done = True
    return progress, other


def serve_scan_phase(tree_dir: Path, phase4_rows: dict, skip_dir: int, card: str) -> dict:
    """Phase 9 (b) and (c): a scan requested over the rspc of a Server on a
    new node on the card, followed on a jobs.progress websocket
    subscription; then the entry point in a child process."""
    import torch

    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects.media.thumbnail import thumbnail_path
    from spacedrive_tpu_torch.ops import _kernels
    from spacedrive_tpu_torch.server import Server
    from tests.torch_serve_client import WsClient, get, rspc, rspc_get

    t_phase = time.perf_counter()
    dirs = [d for d in range(N_DIRS) if d != skip_dir][-4:]
    root = WORK / "serve" / "lib"
    for d in dirs:
        (root / f"d{d:02d}").mkdir(parents=True)
        for p in (tree_dir / f"d{d:02d}").iterdir():
            os.link(p, root / f"d{d:02d}" / p.name)
    photos = sorted(p for p in (WORK / "photos" / "Web").iterdir() if p.name.startswith("IMG_"))[:8]
    (root / "photos").mkdir()
    for p in photos:
        os.link(p, root / "photos" / p.name)
    os.environ["SD_CHUNK_MANIFESTS"] = "1"
    os.environ["SD_SEARCH_ENGINE"] = "device"
    node = Node(WORK / "serve-data", watch_locations=False)
    server = Server(node, "127.0.0.1", 0)
    server.start()
    url = f"http://127.0.0.1:{server.port}"
    ws = WsClient("127.0.0.1", server.port)
    tail = SseTail(server.port)
    try:
        torch.cuda.synchronize()
        _kernels.reset_counts()
        lib_id = rspc(url, "libraries.create", {"name": "served"})["id"]
        sub = ws.call("subscription", "jobs.progress", {"library_id": lib_id, "arg": None})
        inval = ws.call("subscription", "invalidation.listen")
        if sub["result"] != {"type": "started"} or inval["result"] != {"type": "started"}:
            fail(f"serve: the subscriptions did not start: {sub}, {inval}")
        t0 = time.perf_counter()
        loc = rspc(url, "locations.create", {"path": str(root)}, lib_id)
        progress, other = follow_jobs(ws, sub["id"], url, lib_id, "locations.create")
        create_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rspc(url, "locations.fullRescan", {"location_id": loc["id"]}, lib_id)
        progress2, other2 = follow_jobs(ws, sub["id"], url, lib_id, "locations.fullRescan")
        rescan_s = time.perf_counter() - t0
        launches = kernel_counts(SCAN_KERNELS)
        plain = {k: v for k, v in _kernels.PLAIN_ON_CUDA.items() if v}
        tailed = sse_checks(server, tail)
        lib = node.libraries.get(lib_id)
        jobs = [(r["name"], r["status"]) for r in lib.db.query(
            "SELECT name, status FROM job ORDER BY date_created, rowid")]
        bad_jobs = [j for j in jobs if j[1] not in (JobStatus.COMPLETED,
                                                    JobStatus.COMPLETED_WITH_ERRORS)]
        ends = {(p["name"], p["status"]) for p in progress + progress2
                if p["status"] in JobStatus.FINISHED}
        if bad_jobs or {n for n, _s in ends} < {"indexer", "file_identifier", "media_processor",
                                                "dedup_detector"}:
            fail(f"serve: the scans over the rspc: jobs {jobs}; progress ended {ends}")
        keys = [m["result"]["data"]["payload"].get("key") for m in other + other2 + ws.pending
                if m.get("id") == inval["id"]]
        if "search.paths" not in keys:
            fail(f"serve: invalidation.listen never saw search.paths: {sorted(set(keys))}")
        rows = {(r["materialized_path"], r["name"], r["extension"]): r for r in lib.db.query(
            "SELECT materialized_path, name, extension, cas_id FROM file_path WHERE is_dir = 0")}
        mine = {k: r["cas_id"] for k, r in rows.items() if k[0] != "/photos/"}
        differ = [k for k, cas in mine.items() if phase4_rows[k]["cas_id"] != cas]
        if len(mine) != 4 * len(list((tree_dir / f"d{dirs[0]:02d}").iterdir())) or differ:
            fail(f"serve: the scan over the rspc: {len(mine)} files, {len(differ)} cas_ids differ "
                 f"from phase 4's, e.g. {differ[:2]}")
        for kernel in SCAN_KERNELS:
            if launches[kernel] <= 0:
                fail(f"serve: the scan over the rspc never launched {kernel}")
        if plain:
            fail(f"serve: the scan over the rspc ran plain versions on the card: {plain}")
        thumbs = [r["cas_id"] for k, r in rows.items() if k[0] == "/photos/"]
        missing = [c for c in thumbs if not thumbnail_path(node.data_dir, c).exists()]
        if len(thumbs) != len(photos) or missing:
            fail(f"serve: {len(missing)} of the {len(thumbs)} photos have no thumbnail")
        data = thumbnail_path(node.data_dir, thumbs[0]).read_bytes()
        status, headers, body = get(url, f"/spacedrive/thumbnail/{thumbs[0][:2]}/{thumbs[0]}.webp",
                                    {"Range": "bytes=100-1099"})
        if status != 206 or body != data[100:1100] or \
                headers.get("content-range") != f"bytes 100-1099/{len(data)}":
            fail(f"serve: the ranged thumbnail answered {status} {headers} with "
                 f"{len(body)} bytes")
        node.search_engine.refresh_now(lib)
        arg = {"search": "f0", "take": 100}
        node.search_engine.set_enabled(False)
        sql = node.router.resolve("search.paths", arg, lib_id)
        node.search_engine.set_enabled(True)
        served0 = node.search_engine.status()["served"]
        before = kernel_counts(SEARCH_KERNELS)
        body = rspc_get(url, "search.paths", arg, lib_id)
        if body.decode() != json.dumps({"result": sql}, default=str):
            fail("serve: search.paths over HTTP on the scanned library differs from SQL")
        if node.search_engine.status()["served"] != served0 + 1:
            fail("serve: the engine did not serve search.paths over HTTP")
        if kernel_counts(SEARCH_KERNELS)["search_substring"] <= before["search_substring"]:
            fail("serve: search.paths over HTTP did not launch search_substring")
        log(f"serve (phase 9b) on {card}: libraries.create, locations.create over "
            f"{len(mine)} files of phase 4's directories {dirs} and {len(thumbs)} of phase 6's "
            f"photos (hard links), then locations.fullRescan, over HTTP: create's chain "
            f"{create_s:.2f} s, the rescan's {rescan_s:.2f} s, followed on jobs.progress "
            f"({len(progress) + len(progress2)} events); jobs {jobs}; every cas_id equals "
            f"phase 4's; launches {launches}; invalidation.listen keys {sorted(set(keys))}; a "
            f"ranged thumbnail 206 equal to the file's bytes 100-1099; search.paths over "
            f"HTTP equal to SQL ({len(sql['items'])} items)")
        # (c) the entry point on the same card, a location of one directory
        one = root / f"d{dirs[0]:02d}"
        same_lib = rspc(url, "libraries.create", {"name": "same-tree"})["id"]
        rspc(url, "locations.create", {"path": str(one)}, same_lib)
        if not node.jobs.wait_idle(300):
            fail("serve: the in-process scan of one directory did not end")
        needle = {"search": "f", "take": 300}
        in_process = node.router.resolve("search.paths", needle, same_lib)
        entry = entry_point_check(one, in_process, needle)
    finally:
        tail.close()
        ws.close()
        server.stop()
        node.shutdown()
    seconds = time.perf_counter() - t_phase
    log(f"serve (phase 9b, 9c): {seconds:.1f} s")
    return {"launches": launches, "create_s": create_s, "rescan_s": rescan_s,
            "entry": entry, "seconds": seconds, "sse": tailed}


def sse_checks(server, tail: SseTail) -> dict:
    """Phase 9 (b): the SSE tail opened before the scans saw every job of
    both chains start and end (``job.status``); a client that hangs up
    leaves no tail on the server."""
    from spacedrive_tpu_torch.jobs import JobStatus

    if not tail.head.startswith(b"HTTP/1.1 200") or b"text/event-stream" not in tail.head:
        fail(f"serve: /telemetry/stream answered {tail.head[:120]!r}")
    done = JobStatus.NAMES[JobStatus.COMPLETED]
    want = {"indexer", "file_identifier", "media_processor", "dedup_detector"}
    deadline = time.monotonic() + 10
    while True:
        statuses = [(e.get("job"), e.get("status")) for e in list(tail.events)
                    if e.get("name") == "job.status"]
        seen = {j for j, st in statuses if st == done} & {j for j, st in statuses
                                                          if st == "Running"}
        if seen >= want or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if not seen >= want:
        fail(f"serve: the SSE tail saw job.status {statuses[-8:]}, not every job of the chain "
             f"start and end")
    if server.sse_tails() != 1:
        fail(f"serve: the shell holds {server.sse_tails()} SSE tails, not the one open")
    n = len(tail.events)
    tail.close()
    deadline = time.monotonic() + 10
    while server.sse_tails() and time.monotonic() < deadline:
        time.sleep(0.02)
    if server.sse_tails():
        fail("serve: a hung-up SSE client's tail is still registered on the shell")
    log(f"serve telemetry: the SSE tail read {n} events through both scans, "
        f"{len(statuses)} job.status among them (every job of the chain Running, then "
        f"{done}); the client hung up and the shell dropped its tail")
    return {"events": n, "job_status": len(statuses)}


def same_tree(answer: dict) -> list:
    """A search.paths answer without what differs between two libraries of
    one tree: row, object and location ids, pub_ids and dates."""
    drop = {"id", "location_id", "object_id", "pub_id", "object_pub_id"}
    return [{k: v for k, v in item.items() if k not in drop and not k.startswith("date_")}
            for item in answer["items"]]


def entry_point_check(one: Path, in_process: dict, needle: dict) -> dict:
    """Phase 9 (c): ``python -m spacedrive_tpu_torch.server`` in a child
    process on the card: LISTENING, /health, buildInfo, a library, a
    location of ``one``, fullRescan, one search.paths equal to the
    in-process answer for the same tree; SIGTERM exits 0 within 10 s."""
    import signal

    from tests.torch_serve_client import get, rspc

    env = {**os.environ, "SD_SEARCH_ENGINE": "device", "PYTHONPATH": str(ROOT),
           "SD_LOG": "WARNING", "SD_NO_WATCHER": "1"}
    log_path = WORK / "serve-child.log"
    t0 = time.perf_counter()
    with open(log_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "spacedrive_tpu_torch.server", "--data-dir",
             str(WORK / "serve-child"), "--port", "0"],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=ROOT)
    try:
        line: list = []
        reader = threading.Thread(target=lambda: line.append(proc.stdout.readline()))
        reader.start()
        reader.join(120)
        if not line or not line[0].startswith("LISTENING "):
            fail(f"serve: the entry point printed {line} (exit {proc.poll()}): "
                 f"{log_path.read_text()[-2000:]}")
        boot_s = time.perf_counter() - t0
        url = "http://" + line[0].split()[1]
        if get(url, "/health")[2] != b"OK" or not rspc(url, "buildInfo")["version"]:
            fail("serve: the entry point's /health or buildInfo failed")
        lib_id = rspc(url, "libraries.create", {"name": "child"})["id"]
        loc = rspc(url, "locations.create", {"path": str(one)}, lib_id)
        wait_inactive(url, "the child's scan")
        rspc(url, "locations.fullRescan", {"location_id": loc["id"]}, lib_id)
        wait_inactive(url, "the child's rescan")
        got = rspc(url, "search.paths", needle, lib_id)
        if not got["items"] or same_tree(got) != same_tree(in_process):
            fail(f"serve: the child's search.paths ({len(got['items'])} items) differs from the "
                 f"in-process answer for the same tree ({len(in_process['items'])} items)")
        t_stop = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            code = proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            fail("serve: the entry point did not exit within 10 s of SIGTERM")
        stop_s = time.perf_counter() - t_stop
        if code != 0:
            fail(f"serve: the entry point exited {code} on SIGTERM: {log_path.read_text()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log(f"serve (phase 9c): the entry point on the card: LISTENING after {boot_s:.2f} s, "
        f"/health, buildInfo, a location of {one.name} ({len(got['items'])} paths for "
        f"{needle['search']!r}, equal to the in-process answer), fullRescan; exit 0 "
        f"{stop_s:.2f} s after SIGTERM")
    return {"boot_s": boot_s, "stop_s": stop_s}


def wait_inactive(url: str, what: str, timeout: float = 300.0) -> None:
    from tests.torch_serve_client import rspc

    deadline = time.monotonic() + timeout
    time.sleep(0.2)
    while rspc(url, "jobs.isActive"):
        if time.monotonic() > deadline:
            fail(f"serve: {what} did not end within {timeout:.0f} s")
        time.sleep(0.2)


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
    copies and memsets apart) and the kernels a call launches.

    The profiler now and then drops records (see ``device_ms``), so a
    window counts only if it saw kernels and the same number for each
    call. After three windows without one, the time comes from
    ``event_ms`` (a call's kernels and copies together; no kernel count)
    and the log says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernel_us = sum(e.self_device_time_total for e in prof.key_averages()
                        if not e.key.startswith(("Memcpy", "Memset")))
        kernels = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset")))
        if kernels and kernels % reps == 0 and kernel_us > 0:
            return {"ms": kernel_us / reps / 1e3, "kernels_per_call": kernels // reps}
        seen.append(kernels)
    ms = event_ms(fn, reps, None)
    log(f"time: the profiler saw {seen} kernels in {len(seen)} windows of {reps} calls; "
        f"{ms:.4f} ms per call from CUDA events instead")
    return {"ms": ms, "kernels_per_call": None}


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
#: phone HEICs added where libheif loads and has an encoder: (directory,
#: width, height, count), phones' default format
HEIC_MIX = (("DCIM/Camera", 3024, 4032, 16), ("DCIM/Camera", 4032, 3024, 8))
#: videos added where sd_ffmpeg.cc builds or the ffmpeg CLI exists:
#: (directory, width, height, container, count), VIDEO_FRAMES frames each
#: at 10-17 fps, one rate a file so that no two files share a cas_id
#: (BASELINE config 2 is "images + video")
VIDEO_MIX = (("Movies", 1920, 1080, "mp4", 3), ("Movies", 1280, 720, "mp4", 3),
             ("Movies/mkv", 1920, 1080, "mkv", 2))
VIDEO_FRAMES = 24
#: WAVs probed through ``extract_media_data`` (the media job selects no
#: audio): (sample rate, channels)
WAV_MIX = tuple((rate, channels) for rate in (8000, 16000, 44100, 48000) for channels in (1, 2))
#: files (random bytes) of each new format with no codec on the host: the
#: reference's gates leave them with no thumbnail, row or error
N_GATED_PER_FORMAT = 4


def photo_pixels(gen, h: int, w: int, noise: float = 2.0):
    """A smooth seeded field with light noise, made on the card, so that
    PNG and JPEG sizes stay near a photo's (HEICs take no noise: HEVC
    encodes a noisy 12 MP frame several times slower)."""
    import torch

    p = torch.rand(9, generator=gen, device="cuda")
    y = torch.arange(h, device="cuda", dtype=torch.float32)[:, None, None]
    x = torch.arange(w, device="cuda", dtype=torch.float32)[None, :, None]
    field = 127.5 + 90 * torch.sin(x * (0.001 + 0.006 * p[0:3]) + y * (0.001 + 0.006 * p[3:6])
                                   + 6.283 * p[6:9])
    if noise:
        field += noise * torch.randn((h, w, 3), device="cuda", generator=gen)
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


def build_error_line(e: Exception) -> str:
    """The line of a build error that names the cause (g++'s first
    ``error``), else its first line."""
    lines = str(e).splitlines()
    return next((ln.strip() for ln in lines if "error" in ln), lines[0] if lines else repr(e))


def media_probe(work: Path) -> dict:
    """The host codecs of HEIF and video, probed from the checkout's sources
    (``native/sd_heif.cc``, ``native/sd_ffmpeg.cc``, built into ``_build/``)
    and held against the thumbnailer's own probes; logged before anything
    is written."""
    import glob

    import numpy as np

    from spacedrive_tpu_torch.native import NativeBuildError, ffmpeg_native, heif_native
    from spacedrive_tpu_torch.objects.media import metadata, thumbnail

    probe = {"heif": False, "heif_encoder": False, "ffmpeg": False,
             "ffmpeg_cli": thumbnail._FFMPEG, "ffprobe": metadata._FFPROBE}
    t0 = time.perf_counter()
    try:
        probe["heif"] = heif_native.available()
        heif_why = ("sd_heif.cc built, libheif.so.1 loaded" if probe["heif"]
                    else "sd_heif.cc built, libheif.so.1 did not load")
    except (NativeBuildError, OSError) as e:
        heif_why = f"sd_heif.cc did not build or load: {build_error_line(e)}"
    if probe["heif"]:
        probe["heif_encoder"] = heif_native.encode_file(work / "probe.heic",
                                                        np.zeros((16, 16, 3), np.uint8))
    try:
        ffmpeg_why = f"sd_ffmpeg.cc built ({ffmpeg_native.library()._name})"
        probe["ffmpeg"] = True
    except (NativeBuildError, OSError) as e:
        ffmpeg_why = f"sd_ffmpeg.cc did not build or load: {build_error_line(e)}"
    headers = sorted(glob.glob("/usr/include/libavformat") + glob.glob("/usr/include/*/libavformat")
                     + glob.glob("/usr/local/include/libavformat"))
    if ((thumbnail._native_heif() is not None) != probe["heif"]
            or (thumbnail._native_ffmpeg() is not None) != probe["ffmpeg"]):
        fail(f"the thumbnailer's codec probes disagree with the direct probe {probe}")
    probe["heic_thumbs"] = thumbnail.can_generate_thumbnail("heic")
    probe["video_thumbs"] = thumbnail.can_generate_thumbnail("mp4")
    probe["av_rows"] = probe["ffmpeg"] or probe["ffprobe"] is not None
    log(f"media: probe ({time.perf_counter() - t0:.2f} s): libheif: {heif_why}; HEVC/AV1 encoder "
        f"{'present' if probe['heif_encoder'] else 'absent'}; libav: {ffmpeg_why}; libav headers "
        f"{headers or 'none'}; ffmpeg CLI {probe['ffmpeg_cli'] or 'none'}; ffprobe "
        f"{probe['ffprobe'] or 'none'}")
    log(f"media: so HEIF images are {'' if probe['heic_thumbs'] else 'NOT '}thumbnailable, videos "
        f"are {'' if probe['video_thumbs'] else 'NOT '}thumbnailable, and video and audio files "
        f"{'get' if probe['av_rows'] else 'get NO'} media_data rows here (the reference's gates)")
    return probe


def write_new_formats(root: Path, seed: int, probe: dict, codecs: bool, have_pil: bool) -> dict:
    """HEIC_MIX where libheif can encode (and a WebP encoder exists),
    VIDEO_MIX where a video route exists (the native one resizes its frame
    with PIL), and N_GATED_PER_FORMAT files of
    random bytes for each of .heic and .mp4 whose route is absent (the
    gates must skip them)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from spacedrive_tpu_torch.native import ffmpeg_native, heif_native

    rng = random.Random(seed + 1)
    out: dict = {"heics": [], "videos": [], "gated": []}
    t0 = time.perf_counter()
    if probe["heic_thumbs"] and probe["heif_encoder"] and codecs:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 1)
        for folder, w, h, count in HEIC_MIX:
            (root / folder).mkdir(parents=True, exist_ok=True)
            for _ in range(count):
                out["heics"].append({"path": root / folder / f"IMG_{len(out['heics']):04d}.heic",
                                     "w": w, "h": h, "fmt": "heic"})
        with ThreadPoolExecutor(8) as pool:
            for start in range(0, len(out["heics"]), 8):
                batch = out["heics"][start : start + 8]
                pixels = [photo_pixels(gen, p["h"], p["w"], noise=0) for p in batch]
                if not all(pool.map(lambda pp: heif_native.encode_file(pp[0]["path"], pp[1]),
                                    zip(batch, pixels))):
                    fail("libheif's encoder refused a HEIC it accepted in the probe")
    heic_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if probe["video_thumbs"] and (have_pil or not probe["ffmpeg"]):
        for folder, w, h, ext, count in VIDEO_MIX:
            (root / folder).mkdir(parents=True, exist_ok=True)
            for _ in range(count):
                n = len(out["videos"])
                out["videos"].append({"path": root / folder / f"MOV_{n:04d}.{ext}",
                                      "w": w, "h": h, "fmt": ext, "fps": 10 + n})

        def write_video(v: dict) -> None:
            if probe["ffmpeg"]:
                ffmpeg_native.write_test_video(v["path"], v["w"], v["h"], VIDEO_FRAMES, v["fps"])
            else:
                subprocess.run([probe["ffmpeg_cli"], "-y", "-loglevel", "error", "-f", "lavfi",
                                "-i", f"testsrc=size={v['w']}x{v['h']}:rate={v['fps']}",
                                "-frames:v", str(VIDEO_FRAMES), "-pix_fmt", "yuv420p",
                                str(v["path"])], check=True, capture_output=True, timeout=120)

        with ThreadPoolExecutor(8) as pool:
            list(pool.map(write_video, out["videos"]))
    video_s = time.perf_counter() - t0
    for ext, gated in (("heic", not probe["heic_thumbs"]), ("mp4", not probe["video_thumbs"])):
        if gated:
            (root / "gated").mkdir(exist_ok=True)
            for i in range(N_GATED_PER_FORMAT):
                path = root / "gated" / f"NO_CODEC_{i:02d}.{ext}"
                path.write_bytes(rng.randbytes(rng.randint(2000, 50_000)))
                out["gated"].append({"path": path, "fmt": ext})
    os.sync()
    log(f"media: wrote {len(out['heics'])} HEIC ({sum(p['path'].stat().st_size for p in out['heics']) / 1e6:.1f} MB, "
        f"{heic_s:.1f} s), {len(out['videos'])} videos "
        f"({sum(v['path'].stat().st_size for v in out['videos']) / 1e6:.1f} MB, {video_s:.1f} s) and "
        f"{len(out['gated'])} files of formats with no codec here "
        f"({sorted({g['fmt'] for g in out['gated']})})")
    return out


def video_frame_dims(frame_hw: tuple[int, int]) -> tuple[int, int]:
    """(w, h) of a video thumbnail on the native route: the decoded frame
    scaled by PIL to the target area."""
    from spacedrive_tpu_torch.objects.media.thumbnail import TARGET_PX

    h, w = frame_hw
    if w * h > TARGET_PX:
        factor = math.sqrt(TARGET_PX / (w * h))
        return max(1, round(w * factor)), max(1, round(h * factor))
    return w, h


def check_test_video_frame(frame, path: Path) -> float:
    """The test encoder's green channel is 255 * y / height on every frame:
    the decoded frame's row means must follow it. Returns the largest
    deviation."""
    import numpy as np

    h = frame.shape[0]
    want = 255.0 * (np.arange(h) + 0.5) / h
    dev = float(np.abs(frame[:, :, 1].astype(np.float64).mean(axis=1) - want).max())
    if frame.std() <= 10 or dev > 16:
        fail(f"the frame of {path} does not show the test encoder's gradient "
             f"(std {frame.std():.1f}, green row means off by up to {dev:.1f})")
    return dev


def audio_probe(work: Path, probe: dict) -> dict:
    """WAV_MIX written with the ``wave`` module and read through
    ``extract_media_data``: each a row of one pcm_s16le stream of its rate
    and channels where a stream probe exists, else None (the reference's
    answer)."""
    import wave

    import numpy as np

    from spacedrive_tpu_torch.objects.media import metadata

    work.mkdir(parents=True, exist_ok=True)
    rows, t0 = 0, time.perf_counter()
    for rate, channels in WAV_MIX:
        path = work / f"tone_{rate}_{channels}.wav"
        tone = (8000 * np.sin(2 * np.pi * 440 * np.arange(rate // 4) / rate)).astype(np.int16)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(np.repeat(tone[:, None], channels, axis=1).tobytes())
        row = metadata.extract_media_data(str(path), "wav")
        want = {"codec_type": "audio", "codec": "pcm_s16le", "channels": channels,
                "sample_rate": rate}
        if not probe["av_rows"]:
            if row is not None:
                fail(f"{path} got a media_data row {row} with no stream probe on this host")
            continue
        if row is None or row.get("streams") != [want] or row.get("duration_seconds") != 0.25:
            fail(f"{path}: media_data {row}, expected one stream {want} of 0.25 s")
        rows += 1
    probe_s = time.perf_counter() - t0
    log(f"media: {len(WAV_MIX)} WAVs (8-48 kHz, mono and stereo) through extract_media_data: "
        f"{rows} rows in {probe_s * 1e3:.1f} ms "
        f"({'each with its rate and channels' if rows else 'none: no libav and no ffprobe here, as the reference answers'})")
    return {"wavs": len(WAV_MIX), "rows": rows, "s": probe_s}


def media_job(db) -> tuple[dict, dict, float]:
    """The last scan chain's media job (not a warm-start one)."""
    row = dict(db.query("SELECT * FROM job WHERE name = 'media_processor' AND action LIKE "
                        "'scan_location%' ORDER BY date_created DESC LIMIT 1")[0])
    return row, json.loads(row["metadata"] or "{}"), job_seconds(row)


def media_lane(db) -> dict:
    """Every media job of the library: the chain's and the warm-start
    media-lane jobs identify spawned. Their summed metadata, all their error
    lines, the warm-start jobs' directories, how many of those started
    before identify ended, and the seconds from the first start to the
    last end."""
    from datetime import datetime

    rows = [dict(r) for r in db.query("SELECT * FROM job WHERE name = 'media_processor' "
                                      "ORDER BY date_created")]
    ident = dict(db.query("SELECT * FROM job WHERE name = 'file_identifier' "
                          "ORDER BY date_created LIMIT 1")[0])
    meta: dict = {}
    for r in rows:
        for k, v in json.loads(r["metadata"] or "{}").items():
            if isinstance(v, (int, float)):
                meta[k] = meta.get(k, 0) + v
    warm = [r for r in rows if r["action"] == "media_warm_start"]
    start = min(datetime.fromisoformat(r["date_started"]) for r in rows)
    end = max(datetime.fromisoformat(r["date_completed"]) for r in rows)
    return {"meta": meta, "jobs": len(rows),
            "errors": [e for r in rows for e in (r["errors_text"] or "").split("\n\n") if e],
            "warm": sorted(json.loads(r["data"])["init_args"]["sub_path"] for r in warm),
            "warm_before_identify_ended": sum(r["date_started"] < ident["date_completed"]
                                             for r in warm),
            "span_s": (end - start).total_seconds()}


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
    from spacedrive_tpu_torch.native import ffmpeg_native
    from spacedrive_tpu_torch.objects.media import metadata, processor, thumbnail
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
    probe = media_probe(WORK)
    t0 = time.perf_counter()
    tree = write_photos(tree_dir, seed, have_pil)
    photos, corrupt = tree["photos"], tree["corrupt"]
    by_fmt = {f: sum(1 for p in photos if p["fmt"] == f) for f in ("jpg", "png")}
    log(f"media: wrote {len(photos)} photos ({by_fmt['jpg']} JPEG, {by_fmt['png']} PNG, "
        f"{sum(1 for p in photos if p['exif'])} with EXIF and a GPS fix; "
        f"{tree['bytes'] / 1e6:.1f} MB) and {len(corrupt)} corrupt .jpg files in "
        f"{time.perf_counter() - t0:.1f} s; BASELINE config 3's 1M-file library cut to "
        f"{len(photos) + len(corrupt)} files, its shapes kept")
    added = write_new_formats(tree_dir, seed, probe, native or have_pil, have_pil)
    heics, videos, gated = added["heics"], added["videos"], added["gated"]
    n_files = len(photos) + len(corrupt) + len(heics) + len(videos) + len(gated)

    for knob in ("SD_SEARCH_ENGINE", "SD_CHUNK_MANIFESTS", "SD_PIPELINE"):
        os.environ.pop(knob, None)
    calls: list = []  # (arrays, thumbnails, formats) of each resize the job made
    decoded: dict = {}  # source path -> decoded and reduced shape
    pending: list = []  # formats of the arrays decoded for the next resize
    host_s: dict = {}  # format -> [files, seconds] of host decodes and video thumbnails
    real_resize, real_decode = thumbnail.resize_images, thumbnail._decode_for_device
    real_video = thumbnail._video_thumbnail

    def timed(fmt: str, t0: float) -> None:
        entry = host_s.setdefault(fmt, [0, 0.0])
        entry[0] += 1
        entry[1] += time.perf_counter() - t0

    def recorded_resize(arrays, device):
        out = real_resize(arrays, device)
        calls.append((arrays, out, pending[:]))
        pending.clear()
        return out

    def recorded_decode(source):
        t0 = time.perf_counter()
        arr = real_decode(source)
        fmt = Path(source).suffix.lstrip(".").lower()
        timed(fmt, t0)
        decoded[str(source)] = arr.shape
        pending.append(fmt)
        return arr

    def recorded_video(source, out):
        t0 = time.perf_counter()
        made = real_video(source, out)
        timed(Path(source).suffix.lstrip(".").lower(), t0)
        return made

    thumbnail.resize_images, thumbnail._decode_for_device = recorded_resize, recorded_decode
    thumbnail._video_thumbnail = recorded_video
    node = Node(data_dir, watch_locations=False)
    try:
        lib = node.libraries.create("chip-smoke-photos")
        loc = create_location(lib, tree_dir)
        events: list = []
        node.events.on(lambda e: events.append(e.payload["cas_id"])
                       if e.kind == "new_thumbnail" else None)
        for reset in (resize.reset_counts, thumbnail.reset_counts, metadata.reset_counts,
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
        job, _chain_meta, chain_s = media_job(db)
        # the media lane: warm-start jobs beside identify, then the chain's
        lane = media_lane(db)
        meta, media_s = lane["meta"], lane["span_s"]
        log(f"media: {len(lane['warm'])} warm-start media-lane jobs ({', '.join(lane['warm'])}), "
            f"{lane['warm_before_identify_ended']} of them started before identify ended; the "
            f"chain's media job {chain_s:.2f} s; the lane's {lane['jobs']} media jobs span "
            f"{media_s:.2f} s")
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
        made_cas = set(image_cas) if made else set()
        # HEICs: libheif's decode box-reduced in numpy (whole boxes), then the card's resize
        for p in heics:
            c = cas[str(p["path"])]
            out = thumbnail.thumbnail_path(data_dir, c)
            dims = webp_dims(out.read_bytes()) if out.exists() else None
            k = -(-max(p["w"], p["h"]) // thumbnail.MAX_INPUT_EDGE)
            want_hw = (p["h"] // k, p["w"] // k)
            shape = decoded.get(str(p["path"]))
            if shape is None or tuple(shape[:2]) != want_hw:
                fail(f"{p['path']} decoded and reduced to {shape}, expected {want_hw}")
            th, tw = resize.target_dims(want_hw[1], want_hw[0])
            if dims != (tw, th):
                fail(f"the thumbnail of {p['path']} is {dims}, target_dims says {(tw, th)}")
            made_cas.add(c)
        # videos: one frame (native: long edge DEFAULT_TARGET_EDGE, then PIL
        # to the target area; CLI: 512 px wide), decoded again here to check
        # its shape and the test encoder's gradient
        frame_s, frame_dev = [], 0.0
        for v in videos:
            c = cas[str(v["path"])]
            out = thumbnail.thumbnail_path(data_dir, c)
            dims = webp_dims(out.read_bytes()) if out.exists() else None
            if dims is None:
                fail(f"{v['path']} has no WebP thumbnail at {out}")
            if probe["ffmpeg"]:
                t0 = time.perf_counter()
                frame = ffmpeg_native.decode_frame_rgb(v["path"])
                frame_s.append(time.perf_counter() - t0)
                edge, long = ffmpeg_native.DEFAULT_TARGET_EDGE, max(v["w"], v["h"])
                want_hw = ((v["h"] * edge // long, v["w"] * edge // long) if long > edge
                           else (v["h"], v["w"]))
                if frame.shape != (*want_hw, 3):
                    fail(f"the frame of {v['path']} is {frame.shape}, expected {want_hw}")
                frame_dev = max(frame_dev, check_test_video_frame(frame, v["path"]))
                if dims != video_frame_dims(want_hw):
                    fail(f"the thumbnail of {v['path']} is {dims}, expected "
                         f"{video_frame_dims(want_hw)}")
            elif dims[0] != min(512, v["w"]):
                fail(f"the CLI thumbnail of {v['path']} is {dims}, expected {min(512, v['w'])} wide")
            made_cas.add(c)
        for g in gated:
            if thumbnail.thumbnail_path(data_dir, cas[str(g["path"])]).exists():
                fail(f"{g['path']} has a thumbnail though no codec reads {g['fmt']} here")
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
        # a thumbnail is made once; each media job that selects it counts
        # it and emits its event, the chain's job every one
        if (set(events) != made_cas or len(events) != meta["thumbnails_created"]
                or _chain_meta["thumbnails_created"] != len(made_cas)):
            fail(f"{len(events)} new_thumbnail events ({len(set(events))} cas_ids), "
                 f"{meta['thumbnails_created']} counted by the media jobs, "
                 f"{_chain_meta['thumbnails_created']} by the chain's, {len(made_cas)} "
                 f"thumbnails made")
        routes = (dict(thumbnail.DECODES), dict(thumbnail.ENCODES),
                  dict(processor.SCALAR_RETRIES), dict(metadata.PROBES))
        if retry.DISK_FULL:
            fail(f"the media job absorbed a full disk: {dict(retry.DISK_FULL)}")
        retried = sum(processor.SCALAR_RETRIES.values())
        failed_lines = sum(e.endswith("thumbnail failed (batched + scalar retry)")
                           for e in lane["errors"])
        # each media job that selects a file its batch left out retries it
        if retried != failed_lines or retried < len(corrupt) + (0 if made else len(photos)):
            fail(f"{retried} files retried alone ({dict(processor.SCALAR_RETRIES)}), "
                 f"{len(corrupt)} corrupt")
        call_counts = dict(resize.CALLS)
        if not calls and codecs:
            fail("the media job made no resize call")
        if any(dev != "cuda" for dev, _shape in call_counts) or \
                sum(call_counts.values()) != len(calls):
            fail(f"the resize ran {call_counts}, not only on the card")
        # media_data: one row an image where PIL reads EXIF, a HEIC where
        # libheif loads, a video where a stream probe exists; none else
        rows = {r["cas_id"]: r for r in db.query(
            "SELECT fp.cas_id, md.dimensions, md.media_date, md.camera_data, md.media_location, "
            "md.duration_seconds, md.streams "
            "FROM media_data md JOIN file_path fp ON fp.object_id = md.object_id")}
        heic_cas = {cas[str(p["path"])] for p in heics}
        video_cas = {cas[str(v["path"])] for v in videos} if probe["av_rows"] else set()
        want_rows = (image_cas if have_pil else set()) | heic_cas | video_cas
        if set(rows) != want_rows:
            fail(f"media_data has {len(rows)} rows, expected {len(want_rows)} ({len(image_cas)} "
                 f"images with PIL {have_pil}, {len(heic_cas)} HEIC, {len(video_cas)} videos)")
        for p in heics:
            if json.loads(rows[cas[str(p["path"])]]["dimensions"]) != {"width": p["w"], "height": p["h"]}:
                fail(f"media_data of {p['path']}: {dict(rows[cas[str(p['path'])]])}")
        for v in videos if probe["av_rows"] else ():
            r = rows[cas[str(v["path"])]]
            streams = json.loads(r["streams"] or "[]")
            if (json.loads(r["dimensions"] or "{}") != {"width": v["w"], "height": v["h"]}
                    or [s["codec_type"] for s in streams] != ["video"]
                    or abs(r["duration_seconds"] - VIDEO_FRAMES / v["fps"]) > 0.5):
                fail(f"media_data of {v['path']}: {dict(r)}")
        if not have_pil:
            log("media: PIL is missing: no image got a media_data row, as the reference does")
        else:
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
            log(f"media: media_data has one row for each of the {len(image_cas)} images, with the "
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
        thumbnail._video_thumbnail = real_video
        node.shutdown()
    audio = audio_probe(WORK / "audio", probe)

    if not calls:
        # no decoder here: drive the resize on the card on arrays made here
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        arrays = [photo_pixels(gen, h, w) for h, w in ((750, 1000), (1008, 756), (200, 300))]
        calls.append((arrays, thumbnail.resize_images(arrays, torch.device("cuda")), []))
        log("media: no thumbnail has been made on the card (no codecs); the resize ran on "
            f"{len(arrays)} arrays made here")
    mp = sum(p["w"] * p["h"] for p in photos + heics if str(p["path"]) in decoded) / 1e6
    made = len(made_cas)
    log(f"media job on {card}: {media_s:.2f} s for {n_files} files, "
        f"{made} thumbnails = {made / media_s:.1f} images/s, {mp:.1f} MP decoded = "
        f"{mp / media_s:.1f} MP/s (the media lane's jobs, first start to last end); scan "
        f"{scan_s:.2f} s; media jobs' pipelines, summed: page "
        f"{meta['pipeline_page_s']:.2f} s ({100 * meta['pipeline_page_s'] / meta['pipeline_wall_s']:.1f}%), "
        f"process {meta['pipeline_hash_s']:.2f} s "
        f"({100 * meta['pipeline_hash_s'] / meta['pipeline_wall_s']:.1f}%), commit "
        f"{meta['pipeline_commit_s']:.2f} s "
        f"({100 * meta['pipeline_commit_s'] / meta['pipeline_wall_s']:.1f}%) of wall "
        f"{meta['pipeline_wall_s']:.2f} s, {meta['pipeline_batches']} batches")
    log(f"media: decodes by route {routes[0]}, encodes by route {routes[1]}; files retried "
        f"alone {routes[2]}; media_data rows by probe route {routes[3]}; resize calls by shape "
        f"{call_counts}")
    by_fmt: dict = {}
    for entry in photos + heics + videos + gated:
        fmt = by_fmt.setdefault(entry["fmt"], {"files": 0, "thumbnails": 0, "rows": 0})
        fmt["files"] += 1
        fmt["thumbnails"] += cas[str(entry["path"])] in made_cas
        fmt["rows"] += cas[str(entry["path"])] in rows
    by_fmt["jpg (corrupt)"] = {"files": len(corrupt), "thumbnails": 0, "rows": 0}
    log(f"media: by format (files, thumbnails, media_data rows): "
        + "; ".join(f"{f} {v['files']}, {v['thumbnails']}, {v['rows']}" for f, v in by_fmt.items()))
    log("media: host time by format (the decode and box-reduce of each batched file; the whole "
        "per-file thumbnail of a video): "
        + "; ".join(f"{f} {n} files {t:.2f} s = {1e3 * t / n:.1f} ms each"
                    for f, (n, t) in sorted(host_s.items()))
        + (f"; a native frame decode again after the scan {1e3 * sum(frame_s) / len(frame_s):.1f} ms "
           f"each (green rows within {frame_dev:.1f} of the test gradient)" if frame_s else ""))
    heif_calls = [(a, t, f) for a, t, f in calls if "heic" in f]
    heif_shapes = sorted({(len(a), max(x.shape[0] for x in a), max(x.shape[1] for x in a))
                          for a, _t, _f in heif_calls})
    if heics and sum(f.count("heic") for _a, _t, f in calls) != len(heics):
        fail(f"{sum(f.count('heic') for _a, _t, f in calls)} HEIF images reached the card's resize, "
             f"{len(heics)} written")
    log(f"media: {sum(f.count('heic') for _a, _t, f in calls)} HEIF images went through the card's "
        f"resize in {len(heif_calls)} calls at shapes {heif_shapes}")

    # each call replayed: the resize's device time (profiler) and the copy
    # of its pinned u8 batch to the card (CUDA events); one call of each
    # shape held against the CPU (four of its lanes) and timed beside its
    # bounds and F.interpolate
    cuda = torch.device("cuda")
    per_call, by_shape, err = [], {}, 0
    heif_diff = None
    if heif_calls:
        # one HEIF sub-batch whole: every lane of the card's output against the CPU's
        arrays, thumbs, fmts = heif_calls[0]
        want = resize.resize_batch_host(arrays, torch.device("cpu"))
        heif_diff = sum(int((t.astype(np.int16) != w.astype(np.int16)).sum()) if t.shape == w.shape
                        else t.size for t, w in zip(thumbs, want))
        if heif_diff:
            fail(f"the card's resize of a sub-batch with {fmts.count('heic')} HEIF images differs "
                 f"from the CPU's at {heif_diff} values")
        log(f"media: the card's resize of a sub-batch of {len(arrays)} images "
            f"({fmts.count('heic')} HEIF) against the CPU's: 0 values differ")
    else:
        log("media: no HEIF image was resized on this machine (no libheif or no encoder): the "
            "HEIF sub-batch check did not run")
    for arrays, thumbs, _fmts in calls:
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
        f"{100 * device_s / media_s:.3f}% of the media lane's {media_s:.2f} s; phase 6 "
        f"{time.perf_counter() - t_phase:.1f} s")
    counts = {shape: n for (_dev, shape), n in call_counts.items()}
    for shape, t in by_shape.items():
        t["calls"] = counts.get(shape, 0)
    return {"calls": sum(call_counts.values()), "call_counts": counts, "by_shape": by_shape,
            "max_abs_err": err, "per_call": per_call, "media_s": media_s, "images": made,
            "heif_images": sum(f.count("heic") for _a, _t, f in calls), "heif_shapes": heif_shapes,
            "heif_differing": heif_diff, "by_format": by_fmt, "audio": audio}


# --------------------------------------------------------------------------
# phase 10: the live library (the watcher, the file operations, backups)
# --------------------------------------------------------------------------

#: the watched location: phase 4's small and medium mix at 1,024 files in
#: 16 directories of 64 (the last one's 64 split 32 / 32 with an
#: ``export`` subdirectory); half the size of the first runs of this
#: phase, which came within 9 s of its 90 s budget on a loaded host
LIVE_FILES, LIVE_DIRS = 1024, 16
#: the burst: a camera import of 512 files of 100-512 KiB into 4 new
#: directories; 128 files appended to; a directory of 64 renamed; one of
#: 128 moved in from outside the location; 64 files deleted; the 32-file
#: ``export`` directory moved out (a rename whose other half never comes)
LIVE_IMPORT_DIRS, LIVE_IMPORTS, LIVE_APPENDS, LIVE_MOVED_IN, LIVE_DELETES = 4, 512, 128, 128, 64
#: seconds the watcher gets to settle after a change, at most
LIVE_SETTLE_S = 60.0


def live_tree(root: Path, outside: Path, seed: int) -> dict:
    """The watched tree and the directory that will move in, written from
    the seed; the small files 1 B-100 KiB log-uniform, the medium ones
    100 KiB+1-512 KiB, in phase 4's proportions (4,096 : 11,264)."""
    rng = random.Random(seed)
    data = RandomBytes(seed)
    n_small = LIVE_FILES * N_SMALL // (N_SMALL + N_MEDIUM)

    def size(i: int) -> int:
        if i < n_small:
            return 0 if i % 64 == 0 else max(1, int(math.exp(rng.uniform(0, math.log(100 << 10)))))
        return rng.randint((100 << 10) + 1, 512 << 10)

    order = list(range(LIVE_FILES))
    rng.shuffle(order)
    written = 0
    for k, i in enumerate(order):
        d = k % LIVE_DIRS
        sub = "export/" if d == LIVE_DIRS - 1 and k // LIVE_DIRS % 2 else ""
        path = root / f"d{d:02d}" / sub / f"f{i:05d}.{EXTS[i % len(EXTS)]}"
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = data.take(size(i))
        path.write_bytes(blob)
        written += len(blob)
    incoming = outside / "incoming"
    incoming.mkdir(parents=True)
    for i in range(LIVE_MOVED_IN):
        blob = data.take(size(rng.randrange(LIVE_FILES)))
        (incoming / f"in{i:04d}.{EXTS[i % len(EXTS)]}").write_bytes(blob)
        written += len(blob)
    os.sync()
    return {"data": data, "rng": rng, "bytes": written}


def live_burst(root: Path, outside: Path, tree: dict) -> dict:
    """The user's burst, one change after another: the import, the appends,
    the rename, the move in, the deletes, the move out."""
    data, rng = tree["data"], tree["rng"]
    counts = {"imported": 0, "appended": 0, "deleted": 0, "bytes": 0}
    for k in range(LIVE_IMPORTS):
        d = root / f"DCIM_{k % LIVE_IMPORT_DIRS:02d}"
        d.mkdir(exist_ok=True)
        blob = data.take(rng.randint(100 << 10, 512 << 10))
        (d / f"IMG_{k:05d}.raw").write_bytes(blob)
        counts["imported"] += 1
        counts["bytes"] += len(blob)
    appended = [p for d in range(4, 8)
                for p in sorted((root / f"d{d:02d}").iterdir())[:LIVE_APPENDS // 4]]
    for p in appended[:LIVE_APPENDS]:
        with open(p, "ab") as fh:
            fh.write(data.take(4096))
        counts["appended"] += 1
    renamed = root / f"d{LIVE_DIRS - 2:02d}"
    counts["renamed"] = len(list(renamed.iterdir()))
    os.rename(renamed, root / f"d{LIVE_DIRS - 2:02d}_renamed")
    os.rename(outside / "incoming", root / "incoming")
    per_dir = LIVE_DELETES // 4
    for p in [p for d in range(4) for p in sorted((root / f"d{d:02d}").iterdir())[:per_dir]]:
        p.unlink()
        counts["deleted"] += 1
    export = root / f"d{LIVE_DIRS - 1:02d}" / "export"
    counts["moved_out"] = len(list(export.iterdir()))
    os.rename(export, outside / "export")
    return counts


def live_rows(db) -> tuple:
    """Files as (path, name, extension, size, cas_id), directories by path,
    and the files grouped by the object they share."""
    files = sorted(tuple(r) for r in db.query(
        "SELECT materialized_path, name, extension, size_in_bytes, cas_id FROM file_path "
        "WHERE is_dir = 0"))
    dirs = sorted(tuple(r) for r in db.query(
        "SELECT materialized_path, name FROM file_path WHERE is_dir = 1"))
    groups: dict = {}
    for r in db.query("SELECT object_id, materialized_path, name, extension FROM file_path "
                      "WHERE object_id IS NOT NULL AND is_dir = 0"):
        groups.setdefault(r[0], []).append(tuple(r)[1:])
    return files, dirs, sorted(sorted(g) for g in groups.values())


def live_settle(watcher, what: str, since: float, quiet: float) -> float:
    """Wait until the watcher's buffers are empty, no identify pass runs and
    no event came for ``quiet`` seconds (at most LIVE_SETTLE_S); returns the
    seconds from ``since`` to the last moment it was busy."""
    from spacedrive_tpu_torch.locations import watcher as live

    h = watcher.handler
    deadline = time.perf_counter() + LIVE_SETTLE_S
    last_busy, seen = time.perf_counter(), None
    while True:
        now = time.perf_counter()
        busy = h.files_to_update or h.rename_from or h.need_identify or h.identifying
        counts = (live.STATS["events"], live.STATS["identify"], live.STATS["overflow"])
        if busy or counts != seen:
            last_busy, seen = now, counts
        elif now - last_busy >= quiet:
            return last_busy - since
        if now > deadline:
            fail(f"live library: {what}: the watcher did not settle within {LIVE_SETTLE_S:.0f} s")
        time.sleep(0.02)


def live_fresh(node, root: Path, name: str) -> tuple:
    """A fresh scan (index and identify) of the tree on the second node:
    its rows."""
    from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
    from spacedrive_tpu_torch.objects.file_identifier import FileIdentifierJob

    lib = node.libraries.create(name)
    loc = identify_location(lib, root)
    node.jobs.spawn(lib, [IndexerJob({"location_id": loc["id"]}),
                          FileIdentifierJob({"location_id": loc["id"]})])
    if not node.jobs.wait_idle(300):
        fail(f"live library: the fresh scan {name} did not finish")
    return live_rows(lib.db)


def live_compare(got: tuple, want: tuple, what: str) -> None:
    for part, g, w in zip(("files", "directories", "objects"), got, want):
        if g != w:
            gs, ws = set(map(repr, g)), set(map(repr, w))
            fail(f"live library: {what}: {part} differ from a fresh scan's: only in the "
                 f"watched library {sorted(gs - ws)[:3]}, only in the fresh scan "
                 f"{sorted(ws - gs)[:3]} ({len(g)} against {len(w)})")


def live_backup_and_gate(node_cls, data_dir: Path, lib_id: str, want: tuple) -> dict:
    """(c): overwrite pages of the backed-up library's database, boot; the
    gate quarantines it and restores the backup. Then again with no
    backup: the library comes up with a fresh database."""
    from spacedrive_tpu_torch import recovery

    db_path = data_dir / "libraries" / f"{lib_id}.db"
    out = {}
    for case in ("restored_from_backup", "fresh_db"):
        if case == "fresh_db":
            shutil.rmtree(data_dir / "backups")
        with open(db_path, "r+b") as fh:
            fh.seek(4096)
            fh.write(os.urandom(8 * 4096))
        recovery.reset_counts()
        t0 = time.perf_counter()
        node = node_cls(data_dir, watch_locations=False)
        try:
            boot_s = time.perf_counter() - t0
            got = live_rows(node.libraries.get(lib_id).db)
            notes = [n["data"] for n in node.config.get().get("notifications", [])
                     if n["data"].get("kind") == "library_db_repaired"]
        finally:
            node.shutdown()
        if not notes or notes[-1]["action"] != case or notes[-1]["library_id"] != lib_id:
            fail(f"live library: the gate's notification is {notes}, not {case}")
        if case == "restored_from_backup" and got != want:
            fail("live library: the restored library's rows differ from the backup's")
        if case == "fresh_db" and any(got):
            fail(f"live library: the fresh database holds rows: {[len(p) for p in got]}")
        quarantined = sorted((data_dir / "libraries" / "quarantine").glob(f"{lib_id}.db.corrupt-*"))
        if len(quarantined) != len(out) + 1:
            fail(f"live library: {len(quarantined)} quarantined databases after {case}")
        out[case] = {"boot_s": boot_s, "repairs": dict(recovery.REPAIRS),
                     "checks": dict(recovery.BOOT_CHECKS), "rows": [len(p) for p in got]}
    return out


def live_library_phase(seed: int, card: str) -> dict:
    """Phase 10: a new node on the card watches a seeded location; a burst
    of changes, then the file operations through the router, must leave
    the rows of a fresh scan; then a backup, pages of the database
    overwritten, and the boot gate's repair."""
    import torch

    from spacedrive_tpu_torch.locations import scan_location
    from spacedrive_tpu_torch.locations import watcher as live
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.ops import _kernels

    t_phase = time.perf_counter()
    root, outside = WORK / "live" / "library", WORK / "live" / "outside"
    data_dir = WORK / "live" / "data"
    tree = live_tree(root, outside, seed + 10)
    write_s = time.perf_counter() - t_phase
    os.environ["SD_CHUNK_MANIFESTS"] = "1"
    for knob in ("SD_SEARCH_ENGINE", "SD_PIPELINE", "SD_PIPELINE_DEPTH", "SD_SCAN_SHARDS",
                 "SD_COMMIT_GROUP", "SD_SCAN_BATCH", "SD_SCAN_ADAPT", "SD_NO_WATCHER"):
        os.environ.pop(knob, None)
    node = Node(data_dir, watch_locations=True)
    fresh = Node(WORK / "live" / "fresh", watch_locations=False)
    kernels = ("blake3_chunk_cvs", "blake3_merge", "gear_candidates")
    try:
        lib = node.libraries.create("live")
        loc = identify_location(lib, root)
        watcher = node.locations.watcher_for(lib.id, loc["id"])
        if watcher is None:
            fail("live library: the node started no watcher on the location")
        backend = type(watcher.backend).__name__
        quiet = 0.5 if backend == "InotifyBackend" else 1.5
        t0 = time.perf_counter()
        scan_location(lib, loc["id"])
        if not node.jobs.wait_idle(300):
            fail("live library: the first scan did not finish")
        scan_s = time.perf_counter() - t0
        live_settle(watcher, "the first scan", t0, quiet)

        # (a) the burst
        torch.cuda.synchronize()
        _kernels.reset_counts()
        live.reset_counts()
        t0 = time.perf_counter()
        burst = live_burst(root, outside, tree)
        t_last = time.perf_counter()
        burst_s = t_last - t0
        settled_s = live_settle(watcher, "the burst", t_last, quiet)
        stats_a = dict(live.STATS)
        launches_a = {k: _kernels.LAUNCHES_BY_ORIGIN.get((k, "watcher"), 0) for k in kernels}
        if stats_a.get("identify_failed"):
            fail(f"live library: {stats_a['identify_failed']} identify passes raised on the "
                 "watcher thread")
        for k in ("blake3_chunk_cvs", "blake3_merge"):
            if not launches_a[k]:
                fail(f"live library: the watcher thread never launched {k}")
        if any(_kernels.PLAIN_ON_CUDA.values()):
            fail(f"live library: plain versions ran on the card: {dict(_kernels.PLAIN_ON_CUDA)}")
        rows_a = live_rows(lib.db)
        t0 = time.perf_counter()
        live_compare(rows_a, live_fresh(fresh, root, "fresh-burst"), "after the burst")
        fresh_s = time.perf_counter() - t0
        log(f"live library (phase 10a) on {card}: watcher backend {backend}; wrote "
            f"{LIVE_FILES} files ({tree['bytes'] / 1e9:.3f} GB with the {LIVE_MOVED_IN} to move "
            f"in) in "
            f"{write_s:.1f} s, first scan {scan_s:.2f} s; burst {burst_s:.2f} s "
            f"({burst['imported']} imported, {burst['bytes'] / 1e9:.3f} GB; {burst['appended']} "
            f"appended; a directory of {burst['renamed']} renamed; {LIVE_MOVED_IN} moved in; "
            f"{burst['deleted']} deleted; {burst['moved_out']} moved out); events applied "
            f"{stats_a.get('events', 0)}, "
            f"shallow identify passes {stats_a.get('identify', 0)}, overflow rescans "
            f"{stats_a.get('overflow', 0)}; launches from the watcher thread {launches_a}; "
            f"rows settled {settled_s:.2f} s after the last change; {len(rows_a[0])} files equal "
            f"a fresh scan's on the card ({fresh_s:.2f} s)")

        # (b) the file operations through the router
        _kernels.reset_counts()
        live.reset_counts()
        db = lib.db

        def ids(sql: str, params: list) -> list[int]:
            return [r["id"] for r in db.query(sql, params)]

        def files_in(d: str, n: int, skip: int = 0) -> list[int]:
            return ids("SELECT id FROM file_path WHERE materialized_path = ? AND is_dir = 0 "
                       "AND size_in_bytes > 0 ORDER BY name LIMIT ? OFFSET ?", [f"/{d}/", n, skip])

        ops = [
            ("files.copyFiles", lambda: {"sources": files_in("d08", 8), "target_location_id":
                                         loc["id"], "target_dir": "d09"}),
            ("files.cutFiles", lambda: {"sources": files_in("d10", 8), "target_location_id":
                                        loc["id"], "target_dir": "d11"}),
            ("files.duplicateFiles", lambda: {"sources": files_in("d12", 4)}),
            ("files.renameFile", lambda: {"file_path_id": files_in("d13", 1)[0],
                                          "new_name": "renamed.bin"}),
            ("files.createDirectory", lambda: {"location_id": loc["id"], "sub_path": "",
                                               "name": "New Folder"}),
            ("files.createFile", lambda: {"location_id": loc["id"], "sub_path": "d13",
                                          "name": "notes.txt"}),
            ("files.deleteFiles", lambda: {"sources": files_in("d08", 8, skip=8)}),
            ("files.eraseFiles", lambda: {"sources": files_in("d09", 4, skip=8), "passes": 1}),
        ]
        op_s = {}
        for key, arg in ops:
            t0 = time.perf_counter()
            node.router.resolve(key, arg(), lib.id)
            if not node.jobs.wait_idle(120):
                fail(f"live library: {key}'s job did not finish")
            live_settle(watcher, key, t0, quiet)
            op_s[key] = round(time.perf_counter() - t0, 3)
        failed_jobs = [dict(r) for r in db.query(
            "SELECT name, status, errors_text FROM job WHERE name LIKE 'file_%' AND status NOT IN (?, ?)",
            [2, 6])]
        if failed_jobs:
            fail(f"live library: fs jobs ended {failed_jobs}")
        stats_b = dict(live.STATS)
        launches_b = {k: _kernels.LAUNCHES_BY_ORIGIN.get((k, "watcher"), 0) for k in kernels}
        if stats_b.get("identify_failed"):
            fail("live library: an identify pass raised on the watcher thread")
        rows_b = live_rows(db)
        live_compare(rows_b, live_fresh(fresh, root, "fresh-ops"), "after the file operations")
        log(f"live library (phase 10b): {len(ops)} file operations through the router, each "
            f"settled (s): {json.dumps(op_s)}; events applied {stats_b.get('events', 0)}, "
            f"identify passes {stats_b.get('identify', 0)}; launches from the watcher thread "
            f"{launches_b}; {len(rows_b[0])} files equal a fresh scan's")

        # (c) a backup, then the boot gate
        t0 = time.perf_counter()
        backup_id = node.router.resolve("backups.backup", lib.id)
        backup_s = time.perf_counter() - t0
        lib_id = lib.id
    finally:
        node.shutdown()
        fresh.shutdown()
    gate = live_backup_and_gate(Node, data_dir, lib_id, rows_b)
    seconds = time.perf_counter() - t_phase
    log(f"live library (phase 10c): backup {backup_id[:8]} in {backup_s:.2f} s; pages "
        f"overwritten, the next boot quarantined the database and restored the backup in "
        f"{gate['restored_from_backup']['boot_s']:.2f} s (repairs "
        f"{gate['restored_from_backup']['repairs']}; {len(rows_b[0])} files back); with no "
        f"backup, a fresh database in {gate['fresh_db']['boot_s']:.2f} s; notifications pushed")
    log(f"phase 10 (live library): {seconds:.1f} s")
    if seconds > 90:
        fail(f"phase 10 took {seconds:.1f} s, over its 90 s budget")
    launches = {k: launches_a[k] + launches_b[k] for k in kernels}
    return {"backend": backend, "seconds": seconds, "settled_s": settled_s,
            "launches": launches, "launches_burst": launches_a, "launches_ops": launches_b,
            "events": stats_a.get("events", 0) + stats_b.get("events", 0),
            "identify_passes": stats_a.get("identify", 0) + stats_b.get("identify", 0),
            "overflow": stats_a.get("overflow", 0) + stats_b.get("overflow", 0),
            "ops_s": op_s, "gate": gate}


# --------------------------------------------------------------------------
# phase 11: CRDT sync between two card nodes
# --------------------------------------------------------------------------

#: directories a side: A takes the first 8 of the tree's (the one phase 7
#: changed left out), B the next 8; 2,048 files each, as hard links (half
#: the first runs' depth, which came within 4 s of the 90 s budget and
#: over it on a loaded host)
SYNC_DIRS = 8
#: files in each of the tree's directories
N_FILES_A_DIR = (N_SMALL + N_MEDIUM + N_LARGE) // N_DIRS
#: the date range of the cross-search: every date a scan writes
SYNC_DATES = ["2000-01-01T00:00:00+00:00", "2100-01-01T00:00:00+00:00"]
#: the orphan removers' tick in phase 11 (a library's default is a minute)
SYNC_GC_TICK_S = 0.5


def sync_tree(tree_dir: Path, side: str, dirs: list[int]) -> Path:
    root = WORK / "sync" / side
    for d in dirs:
        (root / f"d{d:02d}").mkdir(parents=True)
        for p in (tree_dir / f"d{d:02d}").iterdir():
            os.link(p, root / f"d{d:02d}" / p.name)
    return root


def sync_pull(libs: dict, lanes: int, live: bool = False) -> dict:
    """An Actor on each library of ``libs`` ({side: (library, peer)})
    pulling the peer's operations at ``lanes`` lanes; ``live``: each is
    woken by its peer's commits."""
    from spacedrive_tpu_torch.sync import Actor, SyncMessage

    os.environ["SD_SYNC_INGEST_LANES"] = str(lanes)
    actors = {}
    for side, (lib, peer) in libs.items():
        actors[side] = Actor(lib, transport=lambda clocks, n, p=peer: p.sync.get_ops(clocks, n))
        if live:
            peer.sync.subscribe(lambda msg, a=actors[side]: (
                a.notify() if msg == SyncMessage.CREATED else None))
    return actors


def sync_gc(lib, seen: dict) -> None:
    """Replace ``lib``'s orphan remover by one that ticks every
    ``SYNC_GC_TICK_S``, its ticks and removals summed into ``seen``."""
    from spacedrive_tpu_torch.objects.gc import OrphanRemoverActor

    lib.orphan_remover.stop()
    remover = OrphanRemoverActor(lib, tick_interval=SYNC_GC_TICK_S, debounce=0.0)
    clean_up = remover.process_clean_up

    def counted() -> int:
        removed = clean_up()
        seen["ticks"] += 1
        seen["removed"] += removed
        return removed

    remover.process_clean_up = counted
    lib.orphan_remover = remover


def sync_settle(actors: dict, what: str) -> None:
    for side, actor in actors.items():
        actor.notify()
    for side, actor in actors.items():
        try:
            if not actor.wait_idle(120):
                fail(f"sync: {what}: the actor of {side} did not settle within 120 s")
        except RuntimeError as e:
            fail(f"sync: {what}: the actor of {side} raised: {e.__cause__!r}")


def sync_compare(a, b, what: str) -> dict:
    from tests.torch_sync_cases import synced_rows

    ra, rb = synced_rows(a.db), synced_rows(b.db)
    if ra != rb:
        only_a, only_b = sorted(ra.keys() - rb.keys()), sorted(rb.keys() - ra.keys())
        differ = sorted(k for k in ra.keys() & rb.keys() if ra[k] != rb[k])
        fail(f"sync: {what}: rows differ: {len(only_a)} only in {a.name} (e.g. {only_a[:2]}), "
             f"{len(only_b)} only in {b.name} (e.g. {only_b[:2]}), {len(differ)} differ "
             f"(e.g. {[(k, ra[k], rb[k]) for k in differ[:1]]})")
    return ra


def sync_reference(seed: int) -> tuple[dict, int]:
    """``--sync`` alone: phase 4's tree and its cas_ids from one scan on a
    card node (no directory left out)."""
    from spacedrive_tpu_torch.node import Node

    write_tree(WORK / "tree", seed)
    os.environ["SD_CHUNK_MANIFESTS"] = "1"
    node = Node(WORK / "reference", watch_locations=False)
    try:
        from spacedrive_tpu_torch.locations import scan_location

        lib = node.libraries.create("reference")
        scan_location(lib, identify_location(lib, WORK / "tree")["id"])
        if not node.jobs.wait_idle(600):
            fail("sync: the reference scan did not finish")
        rows = {(r["materialized_path"], r["name"], r["extension"]): dict(r) for r in lib.db.query(
            "SELECT * FROM file_path WHERE is_dir = 0")}
    finally:
        node.shutdown()
    return rows, -1


def sync_phase(tree_dir: Path, phase4_rows: dict, skip_dir: int, card: str) -> dict:
    """Phase 11: two nodes on the card, emission on through the
    ``syncEmitMessages`` feature flag, scan their halves at once while
    each pulls the other's operations (1 lane), the orphan removers
    ticking; then two fresh libraries pull the whole log, at 1 lane and at
    4; then concurrent edits; then each node searches the rows the other
    scanned."""
    import torch

    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.models import FilePath, Location, Object
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects.file_identifier import FileIdentifierJob
    from spacedrive_tpu_torch.ops import _kernels
    from spacedrive_tpu_torch.p2p import identity
    from tests.torch_sync_cases import pair_libraries, sync_ops

    t_phase = time.perf_counter()
    dirs = [d for d in range(N_DIRS) if d != skip_dir]
    halves = {"A": dirs[:SYNC_DIRS], "B": dirs[SYNC_DIRS:2 * SYNC_DIRS]}
    roots = {side: sync_tree(tree_dir, side, ds) for side, ds in halves.items()}
    link_s = time.perf_counter() - t_phase
    os.environ["SD_CHUNK_MANIFESTS"] = "1"
    os.environ["SD_SEARCH_ENGINE"] = "device"
    for knob in ("SD_PIPELINE", "SD_PIPELINE_DEPTH", "SD_SCAN_SHARDS", "SD_COMMIT_GROUP",
                 "SD_SCAN_BATCH", "SD_SCAN_ADAPT", "SD_SYNC_INGEST_LANES"):
        os.environ.pop(knob, None)
    # each identify batch's launches counted under its library's name
    process = FileIdentifierJob.pipeline_process

    def counted_process(self, ctx, data, batch):
        with _kernels.origin(f"scan:{ctx.library.name}"):
            return process(self, ctx, data, batch)

    FileIdentifierJob.pipeline_process = counted_process
    nodes: dict = {}
    actors: list = []
    gc_seen = {"ticks": 0, "removed": 0}
    try:
        for side in halves:
            node = Node(WORK / "sync" / f"data-{side}", watch_locations=False)
            if node.router.resolve("toggleFeatureFlag", "syncEmitMessages") is not True:
                fail("sync: toggleFeatureFlag did not turn syncEmitMessages on")
            nodes[side] = node
        libs = {side: nodes[side].libraries.create(side) for side in halves}
        for lib in libs.values():
            if not lib.sync.emit_messages:
                fail(f"sync: library {lib.name} does not emit with the feature flag on")
            sync_gc(lib, gc_seen)
        pair_libraries(libs["A"], libs["B"])
        locs = {}
        for side, lib in libs.items():
            loc = create_location(lib, roots[side])
            lib.sync.write_ops(
                [lib.sync.shared_update(Location, loc["pub_id"], "generate_preview_media", False)],
                lambda db, i=loc["id"]: db.update(Location, {"id": i},
                                                  {"generate_preview_media": False}))
            locs[side] = loc

        # (a) the concurrent scans, each side pulling the other's operations live
        pull1 = sync_pull({"A": (libs["A"], libs["B"]), "B": (libs["B"], libs["A"])}, 1,
                          live=True)
        actors += pull1.values()
        torch.cuda.synchronize()
        _kernels.reset_counts()
        t0 = time.perf_counter()
        for side, lib in libs.items():
            scan_location(lib, locs[side]["id"])
        for side, node in nodes.items():
            if not node.jobs.wait_idle(300):
                fail(f"sync: the scan of {side} did not finish")
        t_scans = time.perf_counter()
        scans_s = t_scans - t0
        sync_settle(pull1, "after the scans")
        converge_1 = time.perf_counter() - t_scans
        torch.cuda.synchronize()
        launches_scan = {side: {k: _kernels.LAUNCHES_BY_ORIGIN.get((k, f"scan:{side}"), 0)
                                for k in SCAN_KERNELS} for side in halves}
        scan_totals = kernel_counts(SCAN_KERNELS)
        for side, counts in launches_scan.items():
            for k, n in counts.items():
                if not n:
                    fail(f"sync: the scan of {side} never launched {k}")
        if any(_kernels.PLAIN_ON_CUDA.values()):
            fail(f"sync: plain versions ran on the card: {dict(_kernels.PLAIN_ON_CUDA)}")
        jobs = [dict(r) for lib in libs.values() for r in lib.db.query(
            "SELECT name, status, errors_text FROM job")]
        if any(j["status"] not in (2, 6) for j in jobs):
            fail(f"sync: scan jobs ended {[j for j in jobs if j['status'] not in (2, 6)]}")
        logged = {side: sync_ops(lib) for side, lib in libs.items()}
        pulled_1 = {side: a.pulled for side, a in pull1.items()}
        rate_1 = {side: a.pulled / a.ingest_s if a.ingest_s else None for side, a in pull1.items()}
        rows = sync_compare(libs["A"], libs["B"], "after the scans, 1 lane")
        files = {k: r for k, r in rows.items() if k[0] == "file_path" and not r["is_dir"]}
        by_path = {(r["materialized_path"], r["name"], r["extension"]): r["cas_id"]
                   for r in files.values()}
        differ = [k for k, cas in by_path.items() if phase4_rows[k]["cas_id"] != cas]
        if len(files) != 2 * SYNC_DIRS * N_FILES_A_DIR or differ:
            fail(f"sync: {len(files)} files after the scans, {len(differ)} cas_ids differ from "
                 f"phase 4's, e.g. {differ[:2]}")
        gc_scans = dict(gc_seen)
        log(f"sync (phase 11a) on {card}: instance identities by {identity.ROUTE}; "
            f"{SYNC_DIRS} directories a side as hard links ({link_s:.2f} s); both scans "
            f"{scans_s:.2f} s at once; operations logged A {logged['A']}, B {logged['B']}; "
            f"ingested live, 1 lane: A {pulled_1['A']} from B, B {pulled_1['B']} from A, "
            f"{json.dumps({s: None if r is None else round(r) for s, r in rate_1.items()})} "
            f"ops/s of ingest; rows equal {converge_1:.2f} s after both scans ended; "
            f"{len(files)} files, every cas_id equal to phase 4's; launches by origin "
            f"{json.dumps(launches_scan)} (all {json.dumps(scan_totals)}); orphan removers "
            f"ticked {gc_scans['ticks']} times, removed {gc_scans['removed']}")

        # (b) two fresh libraries on A's node pull the whole log from B, at 1
        # lane and at 4
        catch_up = {}
        for lanes in (1, 4):
            fresh = nodes["A"].libraries.create(f"A{lanes}")
            sync_gc(fresh, gc_seen)
            pair_libraries(fresh, libs["B"])
            fresh.add_remote_instance(libs["A"].instance())
            t0 = time.perf_counter()
            pull = sync_pull({f"A{lanes}": (fresh, libs["B"])}, lanes)
            actor = pull[f"A{lanes}"]
            actors.append(actor)
            sync_settle(pull, f"{lanes} lanes")
            catch_up[lanes] = {"ops": actor.pulled, "converge_s": time.perf_counter() - t0,
                               "ops_s": actor.pulled / actor.ingest_s if actor.ingest_s else None}
            pool = fresh.__dict__.get("_ingest_lanes")
            if lanes == 4 and (pool is None or pool.lanes != 4 or not all(pool.ops_by_lane)):
                fail(f"sync: the 4-lane pull did not spread over 4 lanes: "
                     f"{pool and pool.ops_by_lane}")
            if lanes == 1 and pool is not None:
                fail("sync: the 1-lane pull made a lane pool")
            catch_up[lanes]["ops_by_lane"] = pool.ops_by_lane if pool else [actor.pulled]
            sync_compare(fresh, libs["B"], f"the {lanes}-lane library")
        pulled_4, rate_4, converge_4 = (catch_up[4][k] for k in ("ops", "ops_s", "converge_s"))
        if catch_up[1]["ops"] != pulled_4:
            fail(f"sync: the 1-lane and 4-lane libraries pulled {catch_up[1]['ops']} and "
                 f"{pulled_4} ops of one log")
        log(f"sync (phase 11b): two fresh libraries on A's node pull the whole log from B, "
            f"{pulled_4} ops each: 1 lane {round(catch_up[1]['ops_s'] or 0)} ops/s of ingest, "
            f"rows equal B's {catch_up[1]['converge_s']:.2f} s after its pull began; 4 lanes "
            f"{round(rate_4 or 0)} ops/s, {converge_4:.2f} s, ops by lane "
            f"{json.dumps(catch_up[4]['ops_by_lane'])}")
        os.environ["SD_SYNC_INGEST_LANES"] = "1"

        # (c) concurrent edits, then the same pull loops
        a, b = libs["A"], libs["B"]

        def local_id(lib, model, pub: str) -> int:
            return lib.db.find_one(model, {"pub_id": pub})["id"]

        singles = [dict(r) for r in a.db.query(
            "SELECT fp.pub_id AS fp_pub, fp.location_id AS loc, o.pub_id AS obj_pub "
            "FROM file_path fp JOIN object o ON fp.object_id = o.id WHERE fp.is_dir = 0 "
            "AND (SELECT COUNT(*) FROM file_path x WHERE x.object_id = o.id) = 1 "
            "ORDER BY fp.materialized_path, fp.name")]
        mine = {side: [s for s in singles if s["loc"] == local_id(a, Location, locs[side]["pub_id"])]
                for side in halves}
        noted, doomed, renamed = mine["A"][0], mine["B"][1], mine["A"][2]
        t0 = time.perf_counter()
        for lib, text in ((a, "note from A"), (b, "note from B")):
            lib.node.router.resolve("files.setNote", {"object_id": local_id(
                lib, Object, noted["obj_pub"]), "note": text}, lib.id)
        tag = a.node.router.resolve("tags.create", {"name": "synced-red", "color": "#f00"}, a.id)
        a.node.router.resolve("tags.assign", {"tag_id": tag["id"], "object_ids": [
            local_id(a, Object, doomed["obj_pub"])]}, a.id)
        b.node.router.resolve("files.deleteFiles", {"sources": [
            local_id(b, FilePath, doomed["fp_pub"])]}, b.id)
        a.node.router.resolve("files.renameFile", {"file_path_id": local_id(
            a, FilePath, renamed["fp_pub"]), "new_name": "renamed-by-A.bin"}, a.id)
        b.node.router.resolve("files.setFavorite", {"object_id": local_id(
            b, Object, renamed["obj_pub"]), "favorite": True}, b.id)
        for node in nodes.values():
            if not node.jobs.wait_idle(60):
                fail("sync: the edits' jobs did not finish")
        sync_settle(pull1, "after the edits")
        gc = {side: lib.orphan_remover.process_clean_up() for side, lib in libs.items()}
        edits_s = time.perf_counter() - t0
        rows = sync_compare(a, b, "after the concurrent edits")
        notes = [dict(r) for lib in (a, b) for r in lib.db.query(
            "SELECT timestamp, id, data FROM shared_operation WHERE model = 'object' AND "
            "record_id = ? AND kind = 'u:note' AND instance_id = (SELECT id FROM instance "
            "WHERE id = ?)", [noted["obj_pub"], lib.instance_id])]
        winner = json.loads(max(notes, key=lambda r: (r["timestamp"], r["id"]))["data"])
        obj = rows[("object", noted["obj_pub"])]
        if len(notes) != 2 or obj["note"] != winner:
            fail(f"sync: the concurrent notes ended {obj['note']!r}; the HLC's last write is "
                 f"{winner!r} ({len(notes)} notes logged)")
        if ("object", doomed["obj_pub"]) in rows or ("file_path", doomed["fp_pub"]) in rows:
            fail("sync: the object B deleted while A tagged it survived")
        tags = [r for k, r in rows.items() if k[0] == "tag" and r["name"] == "synced-red"]
        links = [k for k in rows if k[0] == "tag_on_object"]
        if len(tags) != 1 or links:
            fail(f"sync: the tag on the deleted object ended {tags} with links {links}")
        fp = rows[("file_path", renamed["fp_pub"])]
        if (fp["name"], fp["extension"]) != ("renamed-by-A", "bin") or \
                not rows[("object", renamed["obj_pub"])]["favorite"]:
            fail(f"sync: the renamed file ended {fp['name']}.{fp['extension']}, favorite "
                 f"{rows[('object', renamed['obj_pub'])]['favorite']}")
        log(f"sync (phase 11c): concurrent edits converged in {edits_s:.2f} s (pulled, a last "
            f"GC tick removed {json.dumps(gc)}; every tick of the phase removed "
            f"{gc_seen['removed']} in {gc_seen['ticks']}): the note is {winner!r} on both (the later HLC stamp), "
            f"the object B deleted is gone on both with its tag link, A's rename and B's "
            f"favorite both kept")

        # (d) each node searches the rows the other scanned
        torch.cuda.synchronize()
        _kernels.reset_counts()
        searched = {}
        for side, other in (("A", "B"), ("B", "A")):
            node, lib = nodes[side], libs[side]
            other_loc = local_id(lib, Location, locs[other]["pub_id"])
            name = min(k[1] for k in by_path if k[0] == f"/d{halves[other][1]:02d}/")
            queries = [{"search": name, "take": 100},
                       {"location_id": other_loc, "materialized_path": f"/d{halves[other][0]:02d}/",
                        "date_range": SYNC_DATES, "take": 500}]
            node.search_engine.refresh_now(lib)
            for arg in queries:
                node.search_engine.set_enabled(False)
                sql = node.router.resolve("search.paths", arg, lib.id)
                node.search_engine.set_enabled(True)
                got = node.router.resolve("search.paths", arg, lib.id)
                if got != sql or not sql["items"] or any(
                        i["location_id"] != other_loc for i in sql["items"]):
                    fail(f"sync: {side}'s search.paths {arg} on {other}'s rows: "
                         f"{len(got['items'])} items against SQL's {len(sql['items'])}")
                searched[f"{side}:{'name' if 'search' in arg else 'directory'}"] = len(sql["items"])
        torch.cuda.synchronize()
        launches_search = kernel_counts(SEARCH_KERNELS)
        for k, n in launches_search.items():
            if not n:
                fail(f"sync: the cross-search never launched {k}")
        log(f"sync (phase 11d): each node's search.paths on the other's rows equals SQL "
            f"({json.dumps(searched)} items); launches {json.dumps(launches_search)}")
        for actor in actors:
            actor.stop()
    finally:
        FileIdentifierJob.pipeline_process = process
        os.environ.pop("SD_SYNC_INGEST_LANES", None)
        for node in nodes.values():
            node.shutdown()
        shutil.rmtree(WORK / "sync", ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"phase 11 (sync): {seconds:.1f} s")
    if seconds > 90:
        fail(f"phase 11 took {seconds:.1f} s, over its 90 s budget")
    launches = {**{k: launches_scan["A"][k] + launches_scan["B"][k] for k in SCAN_KERNELS},
                **launches_search}
    return {"seconds": seconds, "launches": launches, "launches_scan": launches_scan,
            "logged": logged, "pulled_1": pulled_1, "pulled_4": pulled_4,
            "rate_1": rate_1, "rate_4": rate_4, "converge_1_s": converge_1,
            "converge_4_s": converge_4, "catch_up": catch_up, "gc": gc_seen,
            "scans_s": scans_s, "identity": identity.ROUTE}


# --------------------------------------------------------------------------
# phase 12: p2p between two processes on the card
# --------------------------------------------------------------------------

#: directories a side (4,096 files each), as hard links
P2P_DIRS = 16
#: the delta spacedrop's file, and the blocks its base copy shares or not
DELTA_BYTES = 64 << 20
DELTA_BLOCK = 1 << 20
#: the phase fails past this, the child's boot included
P2P_BUDGET_S = 120.0
#: the child's READY and each of its answers
P2P_ANSWER_S = 300.0


def delta_files(seed: int, outbox: Path, inbox: Path) -> tuple[Path, bytes]:
    """The 64 MiB file at ``outbox`` and, in ``inbox`` under the same name,
    a base copy with every other 1 MiB block the same (about half the
    chunks shared): a large project file edited in place between sends."""
    data = RandomBytes(seed, block=DELTA_BYTES)
    blocks = [data.take(DELTA_BLOCK) for _ in range(DELTA_BYTES // DELTA_BLOCK)]
    other = [data.take(DELTA_BLOCK) for _ in range(len(blocks))]
    fresh = b"".join(blocks)
    base = b"".join(b if i % 2 == 0 else o for i, (b, o) in enumerate(zip(blocks, other)))
    outbox.mkdir(parents=True, exist_ok=True)
    inbox.mkdir(parents=True, exist_ok=True)
    (outbox / "project.bin").write_bytes(fresh)
    (inbox / "project.bin").write_bytes(base)
    return outbox / "project.bin", fresh


def p2p_drop(node, key: str, peer: str, path: Path, done: list) -> tuple[dict, float]:
    """One spacedrop (``p2p.spacedrop`` or ``p2p.spacedropDelta``) from
    ``node``; the sender's Done event and its seconds."""
    t0 = time.perf_counter()
    drop_id = node.router.resolve(key, {"peer_id": peer, "paths": [str(path)]})[0]
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        ev = next((e for e in list(done) if e.get("id") == drop_id), None)
        if ev is not None:
            if ev["type"] != "SpacedropDone":
                fail(f"p2p: {key} ended {ev}")
            return ev, time.perf_counter() - t0
        time.sleep(0.01)
    fail(f"p2p: {key} did not finish within 120 s")
    return {}, 0.0


def delta_plane_timing(fresh: bytes, int32_ops_per_s: float) -> dict:
    """Gear over the one 64 MiB delta file, timed as phase 3 times it on
    the plane ``_plane`` makes (batch tier 8, seven rows of padding). Its
    bound is from the bytes the function must move: the file read once and
    its flags written once; beside it, the bound of the padded plane (its
    flags all written)."""
    import torch

    from spacedrive_tpu_torch.ops import cdc

    plane, plens = cdc._plane([fresh], torch.device("cuda"))
    mask = cdc.DEFAULT_PARAMS.mask
    Bp, L = plane.shape
    n = len(fresh)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    want = cdc.gear_candidates_plain(plane[:1], plens[:1], mask)
    got = cdc.gear_candidates(plane, plens, mask)
    if not torch.equal(got[:1], want) or got[1:].any():
        fail("p2p: gear_candidates on the delta plane differs from its plain version")
    del want, got
    out = {"ms": device_ms(lambda: cdc.gear_candidates(plane, plens, mask),
                           "gear_candidates_kernel", reps=10),
           "cold_ms": device_ms(lambda: cdc.gear_candidates(plane, plens, mask),
                                "gear_candidates_kernel", reps=10, between=flush.zero_),
           "call_ms": time_ms(lambda: cdc.gear_candidates(plane, plens, mask), 10),
           "plain_ms": time_ms(lambda: cdc.gear_candidates_plain(plane, plens, mask), 1,
                               warmup=0),
           "bound": bound_ms(2 * n + 4 + 256 * 4, n * OPS_PER_GEAR_POSITION,
                             int32_ops_per_s),
           "padded_bound_ms": bound_ms(n + Bp * 4 + 256 * 4 + Bp * L,
                                       n * OPS_PER_GEAR_POSITION, int32_ops_per_s)[0],
           "shape": f"plane ({Bp}, {L}) u8, 1 file, {n} B"}
    torch.cuda.empty_cache()
    b, by = out["bound"]
    log(f"time: gear_candidates@delta64MiB {out['shape']}: {out['ms']:.4f} ms device time "
        f"(a wrapper call {out['call_ms']:.4f} ms; L2 cleared {out['cold_ms']:.4f} ms), plain "
        f"{out['plain_ms']:.2f} ms; bound {b:.4f} ms by {by} ({100 * b / out['ms']:.1f}%), "
        f"the padded plane's {out['padded_bound_ms']:.4f} ms")
    return out


def p2p_phase(tree_dir: Path, phase4_rows: dict, skip_dir: int, card: str,
              seed: int, int32_ops_per_s: float, serving: bool = False) -> dict:
    """Phase 12: node A here and node B in a child process on the same
    card pair over the encrypted wire, scan their halves at once (A's cas
    messages hashed on B's card over ``H_HASH``), converge over the network,
    send a file by delta and serve a ranged remote GET; B exits 0 on
    ``quit``. With ``serving``, B runs the search engine
    (``SD_SEARCH_ENGINE=device``) beside its server's default reader pool,
    and phase 14 (b) runs on the converged pair before B quits (it asks B
    to); its result is the ``replica`` key, its seconds outside phase
    12's."""
    import hashlib
    import urllib.request

    import torch

    from spacedrive_tpu_torch.locations import scan_location
    from spacedrive_tpu_torch.models import FilePath
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects.hasher import RemoteHasher
    from spacedrive_tpu_torch.ops import _kernels
    from spacedrive_tpu_torch.p2p import identity
    from tests.torch_p2p_cases import (PeerError, PeerProcess, count_scans, p2p_counts,
                                       p2p_debug_log, p2p_location, p2p_reset, rows_digest)
    from tests.torch_sync_cases import sync_ops

    t_phase = time.perf_counter()
    work = WORK / "p2p"
    dirs = [d for d in range(N_DIRS) if d != skip_dir]
    halves = {"A": dirs[:P2P_DIRS], "B": dirs[P2P_DIRS:2 * P2P_DIRS]}
    roots = {}
    for side, ds in halves.items():
        roots[side] = work / side
        for d in ds:
            (roots[side] / f"d{d:02d}").mkdir(parents=True)
            for p in (tree_dir / f"d{d:02d}").iterdir():
                os.link(p, roots[side] / f"d{d:02d}" / p.name)
    link_s = time.perf_counter() - t_phase
    os.environ["SD_CHUNK_MANIFESTS"] = "1"
    for knob in ("SD_PIPELINE", "SD_PIPELINE_DEPTH", "SD_SCAN_SHARDS", "SD_COMMIT_GROUP",
                 "SD_SCAN_BATCH", "SD_SCAN_ADAPT", "SD_SYNC_INGEST_LANES", "SD_SEARCH_ENGINE",
                 "SD_P2P_DISABLED"):
        os.environ.pop(knob, None)
    p2p_debug_log(work / "A-debug.log")
    t0 = time.perf_counter()
    child = PeerProcess(work / "data-B", roots["B"], "cuda", work / "child-B.log",
                        work / "B-debug.log", timeout=P2P_ANSWER_S,
                        env={"SD_SEARCH_ENGINE": "device"} if serving else None)
    replicated = None
    undo = count_scans("A")
    node = None
    try:
        node = Node(work / "data-A", watch_locations=False)
        for feature in ("syncEmitMessages", "filesOverP2P"):
            node.router.resolve("toggleFeatureFlag", feature)
        ready = child.wait_ready()
        boot_s = time.perf_counter() - t0
        if node.p2p is None:
            child.fail("A started no p2p manager")
        peer_b = ready["identity"]
        done: list = []
        node.events.on(lambda ev: done.append(ev.payload) if ev.kind == "p2p" and (
            ev.payload or {}).get("type") in ("SpacedropDone", "SpacedropFailed") else None)

        # 1. connect and 2. pair
        t0 = time.perf_counter()
        got = node.router.resolve("p2p.debugConnect", {"addr": f"127.0.0.1:{ready['port']}"})
        connect_s = time.perf_counter() - t0
        peers = node.router.resolve("p2p.peers", None)
        rec = next((p for p in peers if p["identity"] == peer_b), None)
        kind = torch.cuda.get_device_name(0)
        if got != peer_b or rec is None or not rec["connected"] or \
                (rec.get("accelerator") or {}).get("kind") != kind:
            child.fail(f"p2p.peers after debugConnect: {peers} (want {peer_b} on {kind})")
        t0 = time.perf_counter()
        node.router.resolve("p2p.pair", {"peer_id": peer_b})
        deadline = time.monotonic() + 60
        lib = None
        while lib is None and time.monotonic() < deadline:
            lib = next((x for x in node.libraries.list() if x.id == ready["library_id"]), None)
            time.sleep(0.01)
        if lib is None:
            child.fail("A has no mirror of B's library 60 s after p2p.pair")
        while time.monotonic() < deadline and RemoteHasher(node)._pick_peer() != peer_b:
            time.sleep(0.01)
        pair_s = time.perf_counter() - t0
        members = node.p2p.nlm.member_nodes(lib)
        if not lib.sync.emit_messages or peer_b not in members or \
                RemoteHasher(node)._pick_peer() != peer_b:
            child.fail(f"after pairing: emit {lib.sync.emit_messages}, members {members}, "
                       f"remote hasher peer {RemoteHasher(node)._pick_peer()}")
        loc = p2p_location(lib, roots["A"], hasher="remote")
        log(f"p2p (phase 12) on {card}: identity route {identity.ROUTE}; links {link_s:.2f} s; "
            f"B's process READY {boot_s:.2f} s after its start (A booted beside it); "
            f"connected {connect_s:.3f} s, B on {rec['accelerator']['kind']}; paired "
            f"{pair_s:.3f} s")

        # 3. both scans at once, A's cas messages hashed on B's card
        p2p_reset()
        child.ask("reset")
        tel0 = {"A": p2p_counts()["telemetry"], "B": child.ask("counts")["telemetry"]}
        logged_before = {"A": sync_ops(lib), "B": child.ask("ops")["logged"]}
        t0 = time.perf_counter()
        child.ask("scan")
        scan_location(lib, loc["id"])
        if not node.jobs.wait_idle(600):
            child.fail("the scan of A did not finish")
        a_s = time.perf_counter() - t0
        b_scan = child.ask("wait_scan")
        scans_s = time.perf_counter() - t0
        t_scans = time.perf_counter()
        torch_sync()
        jobs = [dict(r) for r in lib.db.query("SELECT name, status, errors_text FROM job")]
        jobs += b_scan["jobs"]
        if not b_scan["idle"] or any(j["status"] not in (2, 6) for j in jobs):
            child.fail(f"scan jobs ended {[j for j in jobs if j['status'] not in (2, 6)]}")

        # 4. the rows converge over the network
        want = None
        digest = None
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            digest, n_rows = rows_digest(lib.db)
            want = child.ask("rows")
            if want["digest"] == digest:
                break
            time.sleep(0.5)
        converge_s = time.perf_counter() - t_scans
        if want is None or want["digest"] != digest:
            b_now = child.ask("counts")
            child.fail(f"the rows of A and B differ 120 s after the scans ({n_rows} and "
                       f"{want and want['rows']}); logged A {sync_ops(lib)}, B "
                       f"{child.ask('ops')['logged']}; A's sessions {dict(p2p_counts()['nlm'])}, "
                       f"budget {node.ingest_budget.status()}; B's sessions {b_now['nlm']}, "
                       f"budget {b_now['fleet']['budget']}")
        files = {(r["materialized_path"], r["name"], r["extension"]): r["cas_id"]
                 for r in lib.db.query("SELECT * FROM file_path WHERE is_dir = 0")}
        differ = [k for k, cas in files.items() if phase4_rows[k]["cas_id"] != cas]
        if len(files) != 2 * P2P_DIRS * N_FILES_A_DIR or differ:
            child.fail(f"{len(files)} files after the scans, {len(differ)} cas_ids differ "
                       f"from phase 4's, e.g. {differ[:2]}")
        a_scan = p2p_counts()
        b_counts = child.ask("counts")
        logged = {"A": sync_ops(lib), "B": child.ask("ops")["logged"]}
        hashed = dict(a_scan["p2p"])
        served = {k: b_counts["p2p"].get(k, 0) for k in
                  ("hash_served", "hash_served_messages", "hash_served_bytes")}
        a_cas = a_scan["by_tag"].get("cas", {})
        serve_launches = b_counts["by_origin"].get("hash-serve", {})
        if a_scan["fallbacks"] or not hashed.get("hash_requests") or \
                hashed.get("hash_request_messages") != served["hash_served_messages"] or \
                any(a_cas.values()):
            child.fail(f"A's cas messages: {hashed}, fallbacks {a_scan['fallbacks']}, A's own "
                       f"cas launches {a_cas}; B served {served}")
        for k in ("blake3_chunk_cvs", "blake3_merge"):
            if not serve_launches.get(k):
                child.fail(f"B's card never launched {k} for A's H_HASH batches: "
                           f"{b_counts['by_origin']}")
        for side, counts in (("A", a_scan), ("B", b_counts)):
            scan = counts["by_origin"].get(f"scan:{side}", {})
            need = SCAN_KERNELS if side == "B" else ("blake3_chunk_cvs", "gear_candidates")
            if any(not scan.get(k) for k in need) or counts["plain_on_cuda"]:
                child.fail(f"the scan of {side} launched {scan}; plain versions on the card "
                           f"{counts['plain_on_cuda']}")
        ingested = {"A": a_scan["nlm"].get("pulled_ops", 0),
                    "B": b_counts["nlm"].get("pulled_ops", 0)}
        # each side ingests at least what the other logged in the phase
        if ingested["A"] < logged["B"] - logged_before["B"] or \
                ingested["B"] < logged["A"] - logged_before["A"]:
            child.fail(f"ops logged {logged} ({logged_before} before the scans), ingested "
                       f"over the wire {ingested}")
        mesh_checked = p2p_telemetry_checks(node, child, work, peer_b, tel0, hashed, served)
        log(f"p2p (phase 12, scans): both scans {scans_s:.2f} s at once (A {a_s:.2f} s, B "
            f"{b_scan['seconds']:.2f} s); A's H_HASH {hashed.get('hash_requests')} batches, "
            f"{hashed.get('hash_request_messages')} messages, "
            f"{hashed.get('hash_request_bytes')} B, fallbacks 0, hashed on B's card "
            f"{json.dumps(serve_launches)}; logged {json.dumps(logged)}, ingested over the "
            f"wire {json.dumps(ingested)}; rows equal {converge_s:.2f} s after both scans "
            f"({len(files)} files, every cas_id equal to phase 4's); B's budget "
            f"{json.dumps(b_counts['fleet']['budget'])}; launches by origin A "
            f"{json.dumps(a_scan['by_origin'])}, B "
            f"{json.dumps(b_counts['by_origin'])}")

        # 5. a 64 MiB file by delta, again, and by a plain spacedrop
        inbox = Path(ready["inbox"])
        src, fresh = delta_files(seed + 12, work / "outbox", inbox)
        want_sha = hashlib.sha256(fresh).hexdigest()

        def received(ev: dict, what: str) -> Path:
            path = Path(ev.get("path") or "")
            if not path.is_file() or hashlib.sha256(path.read_bytes()).hexdigest() != want_sha:
                child.fail(f"{what}: B's file {path} is not A's")
            return path

        from spacedrive_tpu_torch.p2p import delta

        drops = {}
        delta.reset_counts()
        ev, secs = p2p_drop(node, "p2p.spacedropDelta", peer_b, src, done)
        got = received(ev, "the delta")
        shipped = dict(delta.BYTES)
        drops["delta"] = {"seconds": secs, "file_bytes": len(fresh),
                          "bytes_shipped": shipped.get("sent", 0),
                          "bytes_reused": shipped.get("reused", 0),
                          "chunks_sent": ev["chunks_sent"], "chunks_reused": ev["chunks_reused"],
                          "busy_windows": dict(delta.BUSY)}
        if not 0 < shipped.get("sent", 0) < 0.6 * len(fresh) or not ev["chunks_reused"]:
            child.fail(f"the delta shipped {shipped} of {len(fresh)} B")
        os.replace(got, inbox / "project.bin")  # B keeps it under its name
        delta.reset_counts()
        ev, secs = p2p_drop(node, "p2p.spacedropDelta", peer_b, src, done)
        received(ev, "the second delta")
        drops["again"] = {"seconds": secs, "bytes_shipped": dict(delta.BYTES).get("sent", 0),
                          "chunks_sent": ev["chunks_sent"], "chunks_reused": ev["chunks_reused"]}
        if ev["chunks_sent"] or drops["again"]["bytes_shipped"]:
            child.fail(f"the second delta of a file B holds shipped {drops['again']}")
        plain_events = len(child.ask("done")["events"])
        ev, secs = p2p_drop(node, "p2p.spacedrop", peer_b, src, done)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            theirs = child.ask("done")["events"][plain_events:]
            if theirs:
                break
            time.sleep(0.05)
        if not theirs or theirs[0]["type"] != "SpacedropDone":
            child.fail(f"B's end of the plain spacedrop: {theirs}")
        received(theirs[0], "the plain spacedrop")
        drops["plain"] = {"seconds": secs, "bytes_shipped": ev["bytes"]}
        delta_counts = {"A": p2p_counts()["by_origin"].get("delta", {}),
                        "B": child.ask("counts")["by_origin"].get("delta", {})}
        for side, counts in delta_counts.items():
            if any(not counts.get(k) for k in SCAN_KERNELS):
                child.fail(f"the delta's chunking on {side} launched {counts}")
        log(f"p2p (phase 12, delta): {json.dumps(drops)}; launches by origin 'delta' "
            f"{json.dumps(delta_counts)}")

        # 6. a ranged GET of one of A's files from B's server
        big = next(r for r in lib.db.query(
            "SELECT * FROM file_path WHERE is_dir = 0 AND size_in_bytes > ? "
            "AND size_in_bytes <= ? ORDER BY materialized_path, name", [256 << 10, 512 << 10])
            if (roots["A"] / r["materialized_path"].strip("/")).is_dir())
        path = roots["A"] / big["materialized_path"].strip("/") / f"{big['name']}.{big['extension']}"
        body = path.read_bytes()
        ids = child.ask("ids", pub_id=big["pub_id"])
        start, end = 4096, len(body) - 4097
        req = urllib.request.Request(
            f"http://127.0.0.1:{ready['http']}/spacedrive/file/{ready['library_id']}/"
            f"{ids['location_id']}/{ids['file_path_id']}", headers={"Range": f"bytes={start}-{end}"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, got_body = resp.status, resp.read()
        get_s = time.perf_counter() - t0
        get_equal = status == 206 and got_body == body[start:end + 1]
        if not get_equal:
            child.fail(f"the ranged remote GET answered {status} with {len(got_body)} B, not "
                       f"bytes {start}-{end} of {path}")
        log(f"p2p (phase 12, serve): B's server answered a ranged GET ({end - start + 1} B) of "
            f"A's {path.name} over H_FILE in {get_s * 1e3:.1f} ms, bytes equal")

        b_end = child.ask("counts")
        a_end = p2p_counts()
        if serving:
            replicated = replica_phase(node, lib, child, peer_b, card)
        else:
            rc = child.quit()
            if rc != 0:
                child.fail(f"the p2p child exited {rc}")
        gear_plane = delta_plane_timing(fresh, int32_ops_per_s)
        del fresh
    except PeerError as exc:
        a_log = work / "A-debug.log"
        fail(f"p2p: {exc}\nA's p2p debug log ends:\n"
             f"{a_log.read_text()[-6000:] if a_log.exists() else ''}")
    finally:
        undo()
        if node is not None:
            node.shutdown()
        child.close()
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t_phase - (replicated["seconds"] if replicated else 0.0)
    log(f"phase 12 (p2p): {seconds:.1f} s")
    if seconds > P2P_BUDGET_S:
        fail(f"phase 12 took {seconds:.1f} s, over its {P2P_BUDGET_S:.0f} s budget")
    launches = {k: a_end["launches"].get(k, 0) + b_end["launches"].get(k, 0)
                for k in SCAN_KERNELS}
    return {"card": card, "seconds": seconds, "identity": identity.ROUTE, "link_s": link_s,
            "boot_s": boot_s, "connect_s": connect_s, "pair_s": pair_s, "scans_s": scans_s,
            "scan_s": {"A": a_s, "B": b_scan["seconds"]}, "logged": logged,
            "ingested": ingested, "converge_s": converge_s,
            "hash": {"batches": hashed.get("hash_requests", 0),
                     "messages": hashed.get("hash_request_messages", 0),
                     "bytes": hashed.get("hash_request_bytes", 0), "served": served},
            "fallbacks": a_scan["fallbacks"], "admission": b_counts["fleet"]["budget"],
            "drops": drops, "get_s": get_s,
            "get_bytes": end - start + 1, "get_equal": get_equal,
            "launches": launches,
            "launches_by_origin": {"A": a_end["by_origin"], "B": b_end["by_origin"]},
            "launches_by_tag": {"A": a_end["by_tag"], "B": b_end["by_tag"]},
            "gear_delta_plane": gear_plane, "replica": replicated, "telemetry": mesh_checked}


def session_records(data_dir: Path) -> dict:
    """trace_id -> records of every sync session trace exported under
    ``data_dir``."""
    out: dict = {}
    traces = data_dir / "logs" / "traces"
    for path in traces.glob("sync-*.jsonl") if traces.is_dir() else ():
        for line in path.read_text().splitlines():
            rec = json.loads(line)
            out.setdefault(rec["trace_id"], []).append(rec)
    return out


def p2p_telemetry_checks(node, child, work: Path, peer_b: str, tel0: dict, hashed: dict,
                         served: dict) -> dict:
    """Phase 12 after the rows converged: both sides' ``sd_p2p_hash_*`` equal
    the remote hasher's batches; ``sd_sync_peer_lag_ops`` is back to 0 on
    both sides; A's and B's exported traces of one session stitch by
    ``trace_id``, B's apply spans under A's window spans."""
    from spacedrive_tpu_torch.telemetry.mesh import peer_label
    from spacedrive_tpu_torch.telemetry.spans import build_tree
    from tests.torch_p2p_cases import p2p_counts

    labels = {"A": peer_label(node.p2p.remote_identity.encode()), "B": peer_label(peer_b)}
    deadline = time.monotonic() + 60
    while True:
        tel = {"A": p2p_counts()["telemetry"], "B": child.ask("counts")["telemetry"]}
        # each side's lag for the other
        lag = {"A": tel["A"]["lag_ops"].get(labels["B"]), "B": tel["B"]["lag_ops"].get(labels["A"])}
        if lag == {"A": 0.0, "B": 0.0} or time.monotonic() > deadline:
            break
        time.sleep(0.2)
    if lag != {"A": 0.0, "B": 0.0}:
        child.fail(f"sd_sync_peer_lag_ops after the rows converged: {lag}")
    grew = {side: {k: tel[side][k] - tel0[side][k] for k in
                   ("hash_requests", "hash_bytes", "hash_serve", "hash_serve_bytes")}
            for side in ("A", "B")}
    if grew["A"]["hash_requests"] != hashed.get("hash_requests") or \
            grew["A"]["hash_bytes"] != hashed.get("hash_request_bytes") or \
            grew["B"]["hash_serve"] != served["hash_served"] or \
            grew["B"]["hash_serve_bytes"] != served["hash_served_bytes"]:
        child.fail(f"sd_p2p_hash_* grew by {grew}; the remote hasher's batches {hashed}, "
                   f"B served {served}")
    deadline = time.monotonic() + 60
    stitched = []
    while not stitched and time.monotonic() < deadline:
        sent, got = session_records(work / "data-A"), session_records(work / "data-B")
        for trace_id in sorted(set(sent) & set(got)):
            windows = {r["span_id"] for r in sent[trace_id] if r["name"] == "sync.window"}
            applies = [r for r in got[trace_id] if r["name"] == "sync.apply"]
            roots = [r for r in sent[trace_id] + got[trace_id] if r["parent_id"] is None]
            if applies and len(roots) == 1 and all(a["parent_id"] in windows for a in applies):
                stitched.append((trace_id, len(windows), len(applies)))
        if not stitched:
            time.sleep(0.5)
    if not stitched:
        child.fail("no sync session of A's exported traces stitches with B's by trace_id, "
                   "B's sync.apply spans under A's sync.window spans")
    trace_id, n_windows, n_applies = stitched[0]
    tree = build_tree(trace_id, sent[trace_id] + got[trace_id])
    nested = sum(1 for w in tree["children"] if w["name"] == "sync.window"
                 for c in w["children"] if c["name"] == "sync.apply")
    if nested != n_applies:
        child.fail(f"the stitched session {trace_id}: {nested} of {n_applies} apply spans "
                   f"under A's windows")
    out = {"sessions_stitched": len(stitched), "example": {"trace_id": trace_id,
           "windows": n_windows, "applies": n_applies}, "hash_families": grew,
           "lag_ops": lag}
    log(f"p2p telemetry: sd_p2p_hash_* equal the remote hasher's batches on both sides "
        f"{json.dumps(grew)}; sd_sync_peer_lag_ops back to 0 on both sides; "
        f"{len(stitched)} sessions of A's exported traces stitch with B's by trace_id (e.g. "
        f"{trace_id}: {n_applies} of B's sync.apply spans under A's {n_windows} windows)")
    return out


# --------------------------------------------------------------------------
# phase 14: the serving tier across two nodes
# --------------------------------------------------------------------------

#: phase 14 (a): the served node's dispatch budget, its rows, the burst
ADMISSION_BUDGET = 4
ADMISSION_ROWS = 50_000
ADMISSION_BURST = 64
#: phase 14 (b): each replica query's repeats
REPLICA_REPEATS = 5
#: phase 14 fails past this: (a) and (b) together
SERVING_BUDGET_S = 90.0


def admission_phase(card: str) -> dict:
    """Phase 14 (a): a node on the card served by the shell with
    ``SD_RSPC_BUDGET=4`` (no pool: admission alone) takes a burst of 64
    concurrent GETs of one search over 50,000 rows. Every answer is the
    right page or a 429 with ``Retry-After``; at least one is a 429; the
    budget's in-flight count comes back to 0; the same GET then answers
    200."""
    import urllib.parse

    from spacedrive_tpu_torch.models import FilePath, Location
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.server import Server
    from tests.torch_serve_client import get

    t_phase = time.perf_counter()
    knobs = {"SD_RSPC_BUDGET": str(ADMISSION_BUDGET), "SD_SERVE_WORKERS": "0",
             "SD_P2P_DISABLED": "1"}
    saved = {k: os.environ.get(k) for k in (*knobs, "SD_SEARCH_ENGINE")}
    os.environ.update(knobs)
    os.environ.pop("SD_SEARCH_ENGINE", None)
    try:
        node = Node(WORK / "admission", watch_locations=False)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    server = None
    try:
        if node.dispatch_budget is None or node.dispatch_budget.max_inflight != ADMISSION_BUDGET:
            fail(f"serving (14a): the node's dispatch budget is {node.dispatch_budget}")
        lib = node.libraries.create("admission")
        loc = lib.db.insert(Location, {"pub_id": "loc-admission", "name": "admission",
                                       "path": "/admission"})
        words = SEARCH_WORDS
        lib.db.insert_many(FilePath, [
            {"pub_id": f"adm-{i:06d}", "location_id": loc, "is_dir": 0,
             "materialized_path": f"/{words[i % len(words)]}/",
             "name": f"{words[(i * 7) % len(words)]}-{i:06d}", "extension": "bin",
             "size_in_bytes": i} for i in range(ADMISSION_ROWS)])
        server = Server(node, "127.0.0.1", 0)
        server.start()
        url = f"http://127.0.0.1:{server.port}"
        arg = {"search": "photo", "take": 100}
        path = "/rspc/search.paths?" + urllib.parse.urlencode(
            {"arg": json.dumps(arg), "library_id": lib.id})
        want = json.dumps({"result": node.router.resolve("search.paths", arg, lib.id)},
                          default=str).encode()
        barrier = threading.Barrier(ADMISSION_BURST)
        answers: list = []

        def one() -> None:
            barrier.wait()
            t0 = time.perf_counter()
            status, headers, body = get(url, path)
            answers.append((status, headers, body, (time.perf_counter() - t0) * 1e3))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one) for _ in range(ADMISSION_BURST)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        burst_s = time.perf_counter() - t0
        ok = [a for a in answers if a[0] == 200]
        shed = [a for a in answers if a[0] == 429]
        if len(answers) != ADMISSION_BURST or len(ok) + len(shed) != len(answers):
            fail(f"serving (14a): the burst answered {sorted(a[0] for a in answers)}")
        if any(a[2] != want for a in ok):
            fail("serving (14a): a 200 of the burst is not the page")
        for status, headers, body, _ms in shed:
            retry = headers.get("retry-after", "")
            if not retry.isdigit() or int(retry) < 1 or \
                    json.loads(body).get("retry_after_ms", 0) <= 0:
                fail(f"serving (14a): a 429 without its retry-after: {headers} {body[:200]!r}")
        if not shed:
            fail(f"serving (14a): {ADMISSION_BURST} concurrent GETs against a budget of "
                 f"{ADMISSION_BUDGET} were all admitted")
        budget = node.dispatch_budget.status()
        status, _headers, body = get(url, path)
        if budget["in_flight"] != 0 or status != 200 or body != want:
            fail(f"serving (14a): after the burst the budget is {budget} and the GET "
                 f"answered {status}")
    finally:
        if server is not None:
            server.stop()
        node.shutdown()
    seconds = time.perf_counter() - t_phase
    out = {"budget": ADMISSION_BUDGET, "burst": ADMISSION_BURST, "ok": len(ok),
           "shed_429": len(shed), "budget_status": budget, "burst_s": burst_s,
           "retry_after_s": sorted({int(a[1]["retry-after"]) for a in shed}),
           "p50_ok_ms": _median([a[3] for a in ok]), "p50_429_ms": _median([a[3] for a in shed]),
           "seconds": seconds}
    log(f"serving (phase 14a) on {card}: {ADMISSION_BURST} concurrent GETs of search.paths "
        f"over {ADMISSION_ROWS} rows against a budget of {ADMISSION_BUDGET}: {len(ok)} pages, "
        f"{len(shed)} answered 429 (Retry-After {out['retry_after_s']} s), in {burst_s:.3f} s; "
        f"p50 {out['p50_ok_ms']:.2f} ms a page, {out['p50_429_ms']:.2f} ms a 429; the budget "
        f"after: {json.dumps(budget)}; {seconds:.1f} s")
    return out


def _median(values: list) -> float | None:
    import statistics

    return statistics.median(values) if values else None


def replica_phase(node, lib, child, peer_b: str, card: str) -> dict:
    """Phase 14 (b), on phase 12's converged pair: A here (a laptop: the
    search engine off) and B in its child process on the card (the engine
    armed beside its default reader pool). A's ``router.resolve`` of
    ``search.pathsCount`` by a name substring, a directory, an extension
    and a date range is served by B over ``H_QUERY`` from B's device index,
    not B's pool: each answer byte-identical to B's local answer and to A's
    in-process SQL answer; B's launches under origin ``replica-serve`` grow
    for all three search kernels. ``search.objectsCount``, which the index
    does not answer, is served by B's pool. Then A marks an object favorite
    with its push to B held back: B is not eligible, the ladder serves A's
    in-process count with the favorite; once B has pulled it, B serves it.
    Then a fault armed on B fails its next serve: the query falls back to
    A's process within ``SD_REPLICA_TIMEOUT_S``; B quits (exit 0, phase
    12's check) and the query again answers in A's process. Pages naming
    row ids (``search.paths``, ``tags.list``) never go to a replica, whose
    ids are its own."""
    import collections
    import statistics

    from spacedrive_tpu_torch.api.router import RawJson, last_rung
    from spacedrive_tpu_torch.server import replica
    from spacedrive_tpu_torch.server.replica import encode_reply, replica_timeout_s

    t_phase = time.perf_counter()
    if node.replica_router is None or node.search_engine is not None:
        child.fail(f"A's replica router {node.replica_router}, search engine "
                   f"{node.search_engine}: phase 14 wants A on SQLite with the replica rung")
    if peer_b not in node.p2p.query_peers(lib.id):
        child.fail(f"B is not among A's replica candidates {node.p2p.query_peers(lib.id)}")
    if not child.ask("refresh")["fresh"]:
        child.fail("B's search index is not fresh after refresh_now")
    b_pool = child.ask("pool")
    if not b_pool["status"] or b_pool["status"]["alive"] < 1:
        child.fail(f"B runs no reader pool: {b_pool}")
    files = lib.db.query("SELECT name, materialized_path, extension, date_created AS d "
                         "FROM file_path WHERE is_dir = 0 ORDER BY name")
    sub = files[len(files) // 3]["name"][:4]
    dirs = sorted({r["materialized_path"] for r in files})
    dates = sorted(r["d"] for r in files)
    exts = collections.Counter(r["extension"] for r in files)
    matrix = [
        ("substring", {"search": sub}),
        ("directory", {"materialized_path": dirs[len(dirs) // 2]}),
        ("extension", {"extensions": [exts.most_common(1)[0][0]]}),
        ("dates", {"date_range": [dates[len(dates) // 8], dates[len(dates) // 2]]}),
    ]
    count = node.router.procedures["search.pathsCount"].fn
    before = child.ask("counts")["by_origin"].get("replica-serve", {})
    replica.reset_counts()
    rungs: dict = {}
    lat: dict = {"replica": {}, "b_local": {}, "a_in_process": {}}

    def one(label: str, key: str, arg) -> bytes:
        """A's dispatch of one query, held to B's local and A's in-process
        answers; records the three times."""
        t0 = time.perf_counter()
        got = node.router.resolve(key, arg, lib.id, raw=True)
        ms = (time.perf_counter() - t0) * 1e3
        rungs[label] = last_rung()
        theirs = child.ask("local", key=key, arg=arg)
        t0 = time.perf_counter()
        mine = encode_reply(node.router.procedures[key].fn(node, lib, arg))
        mine_ms = (time.perf_counter() - t0) * 1e3
        if rungs[label] != "replica" or not isinstance(got, RawJson):
            child.fail(f"serving (14b): {label} took the {rungs[label]} rung; replica "
                       f"{dict(replica.STATS)}")
        if not got.data == theirs["raw"].encode() == mine:
            child.fail(f"serving (14b): {label}: A's replica answer {got.data[:160]!r}, B's "
                       f"local {theirs['raw'][:160]!r}, A's in-process {mine[:160]!r}")
        for k, v in (("replica", ms), ("b_local", theirs["ms"]), ("a_in_process", mine_ms)):
            lat[k].setdefault(label, []).append(v)
        return got.data

    for label, arg in matrix:
        for _ in range(REPLICA_REPEATS):
            one(label, "search.pathsCount", arg)
    after = child.ask("counts")["by_origin"].get("replica-serve", {})
    launches = {k: after.get(k, 0) - before.get(k, 0) for k in SEARCH_KERNELS}
    if any(n <= 0 for n in launches.values()):
        child.fail(f"serving (14b): B's card launched {launches} for A's queries")
    pool_ok = child.ask("pool")["stats"].get("requests_ok", 0)
    if pool_ok != b_pool["stats"].get("requests_ok", 0):
        child.fail(f"serving (14b): B's pool served {pool_ok} queries its index answers")
    objects = one("objects_count", "search.objectsCount", None)
    if child.ask("pool")["stats"].get("requests_ok", 0) != pool_ok + 1:
        child.fail("serving (14b): B's pool did not serve search.objectsCount")
    if replica.STATS["dispatches_ok"] != len(matrix) * REPLICA_REPEATS + 1:
        child.fail(f"serving (14b): A's replica counts {dict(replica.STATS)}")
    p50 = {k: {label: statistics.median(v) for label, v in d.items()} for k, d in lat.items()}
    log(f"serving (phase 14b) on {card}: {len(matrix)} counts x {REPLICA_REPEATS} served by "
        f"B's index over H_QUERY, each B's local answer and A's in-process answer; B's "
        f"launches under 'replica-serve' {json.dumps(launches)}; search.objectsCount "
        f"({objects.decode()}) by B's pool of {b_pool['status']['workers']}; p50 "
        + "; ".join(f"{label} A {p50['replica'][label]:.2f} ms / B local "
                    f"{p50['b_local'][label]:.2f} ms / A SQL {p50['a_in_process'][label]:.2f} ms"
                    for label in p50["replica"]))

    # A marks an object favorite with its push held back: B is not
    # eligible until it pulls
    favorite = {"favorite": True}
    object_id = lib.db.query("SELECT object_id FROM file_path WHERE object_id IS NOT NULL "
                             "ORDER BY id LIMIT 1")[0]["object_id"]
    nlm = node.p2p.nlm
    push = nlm._on_sync_message
    nlm._on_sync_message = lambda library, msg: None
    try:
        node.router.resolve("files.setFavorite", {"object_id": object_id, "favorite": True},
                            lib.id)
        lagging = node.router.resolve("search.pathsCount", favorite, lib.id)
        stale_rung = last_rung()
    finally:
        nlm._on_sync_message = push
    want = count(node, lib, favorite)
    if lagging != want or want < 1 or stale_rung != "in_process" or \
            not replica.STATS["dispatches_not_eligible"]:
        child.fail(f"serving (14b): after A's favorite, pathsCount took {stale_rung} with "
                   f"{lagging} (A's SQL {want}); replica {dict(replica.STATS)}")
    t0 = time.perf_counter()
    node.p2p.schedule(nlm.originate(lib))
    served = None
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        time.sleep(0.3)  # past the not-eligible cooldown
        served = node.router.resolve("search.pathsCount", favorite, lib.id, raw=True)
        if last_rung() == "replica":
            break
    eligible_s = time.perf_counter() - t0
    if last_rung() != "replica" or served.data != json.dumps(want).encode() or \
            served.data != child.ask("local", key="search.pathsCount", arg=favorite)[
                "raw"].encode():
        child.fail(f"serving (14b): B did not serve the favorite count within 30 s of the "
                   f"push ({last_rung()})")
    log(f"serving (phase 14b): A's favorite: pathsCount served in process while B lagged, "
        f"by B {eligible_s:.2f} s after the push")

    # a failed serve on B, then B gone: A's process answers within the timeout
    label, arg = matrix[0]
    want = encode_reply(count(node, lib, arg))
    fallback: dict = {}
    child.ask("faults", spec="replica_serve:eio:once")
    b_last = child.ask("counts")
    for case in ("b_failed", "b_quit"):
        if case == "b_quit":
            rc = child.quit()
            if rc != 0:
                child.fail(f"the p2p child exited {rc}")
        t0 = time.perf_counter()
        page = json.dumps(node.router.resolve("search.pathsCount", arg, lib.id)).encode()
        ms = (time.perf_counter() - t0) * 1e3
        fallback[case] = {"rung": last_rung(), "ms": ms}
        if last_rung() != "in_process" or page != want or ms > replica_timeout_s() * 1e3:
            child.fail(f"serving (14b): with {case} {label} took {last_rung()} in {ms:.0f} ms")
    if not replica.STATS["dispatches_error"]:
        child.fail(f"serving (14b): B's failed serve reached A as {dict(replica.STATS)}")
    seconds = time.perf_counter() - t_phase
    log(f"serving (phase 14b): B's serve failed (replica_serve:eio), then B quit (exit 0); "
        f"{label} answered in A's process in {fallback['b_failed']['ms']:.1f} / "
        f"{fallback['b_quit']['ms']:.1f} ms (SD_REPLICA_TIMEOUT_S {replica_timeout_s():.0f} s); "
        f"replica counts {json.dumps(dict(replica.STATS))}; {seconds:.1f} s")
    return {"seconds": seconds, "rungs": {**rungs, "favorite_while_lagging": stale_rung,
                                          "favorite_after_pull": "replica",
                                          "after_b_failed": fallback["b_failed"]["rung"],
                                          "after_b_quit": fallback["b_quit"]["rung"]},
            "p50_ms": {k: statistics.median(v.values()) for k, v in p50.items()},
            "by_query_ms": p50, "launches": launches, "b_pool_workers":
                b_pool["status"]["workers"],
            "launches_by_origin_b": b_last["by_origin"].get("replica-serve", {}),
            "eligible_after_push_s": eligible_s,
            "fallback_ms": {k: v["ms"] for k, v in fallback.items()},
            "stats": dict(replica.STATS)}


def serving_summary(card: str, phase9: dict | None, replicated: dict, admitted: dict) -> dict:
    """The ``{"serving": ...}`` line: the rung of every query of phases 9
    and 14, the pool's and the in-process p50s, the 429s, A's p50 for a
    replica dispatch beside B's local p50, the seconds; fails when phase 14
    took more than its budget."""
    seconds = replicated["seconds"] + admitted["seconds"]
    log(f"phase 14 (serving tier): {seconds:.1f} s (a {admitted['seconds']:.1f} s, b "
        f"{replicated['seconds']:.1f} s)")
    if seconds > SERVING_BUDGET_S:
        fail(f"phase 14 took {seconds:.1f} s, over its {SERVING_BUDGET_S:.0f} s budget")
    out = {"card": card, "seconds": seconds,
           "rungs": {"phase14_replica": replicated["rungs"]},
           "replica_p50_ms": replicated["p50_ms"]["replica"],
           "replica_b_local_p50_ms": replicated["p50_ms"]["b_local"],
           "replica_a_in_process_p50_ms": replicated["p50_ms"]["a_in_process"],
           "replica_fallback_ms": replicated["fallback_ms"],
           "replica_b_pool_workers": replicated["b_pool_workers"],
           "admission": {k: admitted[k] for k in ("budget", "burst", "ok", "shed_429",
                                                 "retry_after_s", "p50_ok_ms", "p50_429_ms",
                                                 "seconds")},
           "shed_429": admitted["shed_429"], "replica_seconds": replicated["seconds"]}
    if phase9 is not None:
        pooled = phase9["pool"]
        out["rungs"].update({"phase9_engine_matrix": phase9["rungs"],
                             "phase9_pool_matrix": pooled["rungs"],
                             "phase9_killed_worker_dispatch": "in_process"})
        out.update({"pool_workers": pooled["workers"], "pool_start_s": pooled["start_s"],
                    "server_bind_s": pooled["bind_s"],
                    "pool_p50_ms": pooled["p50_ms"]["pool"],
                    "pool_cached_p50_ms": pooled["p50_ms"]["pool_hit"],
                    "in_process_p50_ms": pooled["p50_ms"]["in_process"],
                    "pool_respawn_s": pooled["respawn_s"],
                    "compute_apps": pooled["compute_apps"], "phase9_seconds": phase9["seconds"]})
    return out


# --------------------------------------------------------------------------
# phase 13: crypto on the card's node
# --------------------------------------------------------------------------

#: phase 13's files: 8 of phase 4's under 100 KiB, 8 from 100 KiB to 1 MiB,
#: its 6 smallest large files (16 MiB and up, copied whole), and 3 of random
#: bytes: 2 MiB and 2 MiB + 17 B (one block, and two blocks with a 17-byte
#: last one) and 64 MiB
CRYPTO_PICK = 8
CRYPTO_LARGE = 6
CRYPTO_MADE = {"block-2MiB.bin": 2 << 20, "block-2MiB-17.bin": (2 << 20) + 17,
               "stream-64MiB.bin": 64 << 20}
#: the phase fails past this many seconds
CRYPTO_BUDGET_S = 90


def crypto_files(tree_dir: Path, root: Path, seed: int) -> list[str]:
    """Copy phase 4's picks into ``root`` (one directory for each size
    class) and write the three made files; returns their paths relative to
    ``root``."""
    small, medium, large = [], [], []
    # the tree's dNN directories only: a location over it leaves its
    # .spacedrive sidecar in the root
    for d in sorted(tree_dir.glob("d[0-9][0-9]")):
        for p in sorted(d.iterdir()):
            if not p.is_file() or p.name.startswith("."):
                continue
            size = p.stat().st_size
            if 0 < size < 100 << 10:
                small.append(p)
            elif (100 << 10) < size <= 1 << 20:
                medium.append(p)
            elif size > 1 << 20:
                large.append((size, p))
    picks = {"small": small[:CRYPTO_PICK], "medium": medium[:CRYPTO_PICK],
             "large": [p for _s, p in sorted(large)[:CRYPTO_LARGE]]}
    rels = []
    for cls, paths in picks.items():
        if len(paths) < (CRYPTO_LARGE if cls == "large" else CRYPTO_PICK):
            fail(f"crypto: phase 4's tree has only {len(paths)} {cls} files")
        (root / cls).mkdir(parents=True)
        for p in paths:
            shutil.copyfile(p, root / cls / p.name)
            rels.append(f"{cls}/{p.name}")
    data = RandomBytes(seed + 13)
    (root / "made").mkdir()
    for name, size in CRYPTO_MADE.items():
        (root / "made" / name).write_bytes(data.take(size))
        rels.append(f"made/{name}")
    return rels


def crypto_rows(db) -> dict:
    """path relative to the location -> the file_path row's id, cas_id and
    integrity checksum."""
    return {f"{r['materialized_path'].strip('/')}/{r['name']}.{r['extension']}".lstrip("/"): r
            for r in (dict(x) for x in db.query(
                "SELECT id, materialized_path, name, extension, cas_id, integrity_checksum "
                "FROM file_path WHERE is_dir = 0"))}


def crypto_job(db, name: str) -> dict:
    row = dict(db.query("SELECT * FROM job WHERE name = ? ORDER BY rowid DESC LIMIT 1",
                        [name])[0])
    row["metadata"] = json.loads(row["metadata"]) if row["metadata"] else {}
    return row


def crypto_phase(tree_dir: Path, seed: int, card: str) -> dict:
    """Phase 13: a node on the card scans a location of phase 4's files and
    three made ones, encrypts them through ``files.encryptFiles`` (13 with a
    stored key, XChaCha20-Poly1305 and the sealed metadata; 12 with a
    password and AES-256-GCM; the originals erased), rescans, decrypts them
    with the same keys, rescans and validates; the wrong password, a
    tampered file and a lock and unlock on the way."""
    import cryptography
    import torch
    from cryptography.hazmat.backends.openssl.backend import backend as openssl

    from spacedrive_tpu_torch.crypto import hashing, header, primitives
    from spacedrive_tpu_torch.locations import create_location, scan_location
    from spacedrive_tpu_torch.models import Location
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects import crypto_jobs
    from spacedrive_tpu_torch.objects.file_identifier import FileIdentifierJob
    from spacedrive_tpu_torch.objects.validator import ObjectValidatorJob
    from spacedrive_tpu_torch.ops import _kernels

    t_phase = time.perf_counter()
    versions = {"cryptography": cryptography.__version__,
                "openssl": openssl.openssl_version_text()}
    log(f"crypto (phase 13): cryptography {versions['cryptography']}, {versions['openssl']}")
    root, data_dir = WORK / "crypto" / "vault", WORK / "crypto" / "data"
    rels = crypto_files(tree_dir, root, seed)
    sizes = {p: (root / p).stat().st_size for p in rels}
    seconds = {"files_s": time.perf_counter() - t_phase}
    os.environ["SD_CHUNK_MANIFESTS"] = "1"
    for knob in ("SD_PIPELINE", "SD_PIPELINE_DEPTH", "SD_SCAN_SHARDS", "SD_COMMIT_GROUP",
                 "SD_SCAN_BATCH", "SD_SCAN_ADAPT"):
        os.environ.pop(knob, None)

    # the phase's launches counted under one origin: every identify batch
    # and every validator step; the streams and the password hashes timed
    process, validate = FileIdentifierJob.pipeline_process, ObjectValidatorJob.execute_step
    enc_streams = crypto_jobs.Encryptor.encrypt_streams.__func__
    dec_streams = crypto_jobs.Decryptor.decrypt_streams.__func__
    argon2id = hashing._argon2id
    streams: dict = {"encrypt": [], "decrypt": []}
    hashes: list = []

    def counted_process(self, ctx, data, batch):
        with _kernels.origin("crypto"):
            return process(self, ctx, data, batch)

    def counted_validate(self, ctx, *a):
        with _kernels.origin("crypto"):
            return validate(self, ctx, *a)

    def timed(fn, what):
        def run(cls, key, nonce, algorithm, reader, writer, aad=b""):
            t0 = time.perf_counter()
            n = fn(cls, key, nonce, algorithm, reader, writer, aad)
            streams[what].append((n, time.perf_counter() - t0))
            return n
        return classmethod(run)

    def timed_argon2id(*a):
        t0 = time.perf_counter()
        out = argon2id(*a)
        hashes.append(time.perf_counter() - t0)
        return out

    FileIdentifierJob.pipeline_process = counted_process
    ObjectValidatorJob.execute_step = counted_validate
    crypto_jobs.Encryptor.encrypt_streams = timed(enc_streams, "encrypt")
    crypto_jobs.Decryptor.decrypt_streams = timed(dec_streams, "decrypt")
    hashing._argon2id = timed_argon2id
    node = None
    try:
        torch.cuda.synchronize()
        _kernels.reset_counts()
        node = Node(data_dir, watch_locations=False)
        if node.key_manager is None:
            fail("crypto: the node has no key manager (is cryptography importable?)")
        lib = node.libraries.create("crypto")
        loc = create_location(lib, root)
        lib.db.update(Location, {"id": loc["id"]}, {"generate_preview_media": False})
        r = node.router.resolve

        def rescan(what: str) -> dict:
            t0 = time.perf_counter()
            scan_location(lib, loc["id"])
            if not node.jobs.wait_idle(300):
                fail(f"crypto: the {what} did not finish")
            seconds[f"{what}_s"] = time.perf_counter() - t0
            return crypto_rows(lib.db)

        def validate_all(what: str) -> dict:
            t0 = time.perf_counter()
            r("jobs.objectValidator", {"location_id": loc["id"]}, lib.id)
            if not node.jobs.wait_idle(300):
                fail(f"crypto: the {what} did not finish")
            job = crypto_job(lib.db, "object_validator")
            if job["status"] != 2:
                fail(f"crypto: the {what} ended {job['status']}: {job['errors_text']}")
            seconds[f"{what}_s"] = time.perf_counter() - t0
            return crypto_rows(lib.db)

        def run_job(what: str, key: str, arg: dict) -> dict:
            t0 = time.perf_counter()
            r(key, arg, lib.id)
            if not node.jobs.wait_idle(300):
                fail(f"crypto: {what} did not finish")
            seconds[f"{what}_s"] = time.perf_counter() - t0
            return crypto_job(lib.db, "file_encryptor" if "encrypt" in key else "file_decryptor")

        # 1. the location, scanned and validated on the card
        first = rescan("scan")
        if sorted(first) != sorted(rels) or not all(first[p]["cas_id"] for p in rels):
            fail(f"crypto: the first scan has {len(first)} rows, not the {len(rels)} files "
                 "each with a cas_id")
        first = validate_all("validate")
        if not all(first[p]["integrity_checksum"] for p in rels):
            fail("crypto: the validator left a file without its checksum")

        # 2. the key manager through the router
        t0 = time.perf_counter()
        if r("keys.setup", "chip-smoke master password") is not True:
            fail("crypto: keys.setup")
        kid = r("keys.add", {"name": "chip-smoke"})
        if r("keys.mount", kid) is not True or r("keys.setDefault", kid) is not True:
            fail("crypto: keys.mount / keys.setDefault")
        r("keys.updateAutomountStatus", {"uuid": kid, "status": True})
        if r("keys.getDefault") != kid or r("keys.listMounted") != [kid]:
            fail("crypto: the default key is not the mounted one")
        seconds["keys_s"] = time.perf_counter() - t0

        # 3. encrypt: 13 with the key (the 64 MiB file among them), 12 with a password
        by_key = rels[0::2]  # every size class, the 2 MiB and 64 MiB files
        by_password = [p for p in rels if p not in by_key]
        password = "chip-smoke: correct horse battery staple"
        groups = {"key": (by_key, {"key_uuid": kid}),
                  "password": (by_password, {"password": password})}
        for name, (paths, secret) in groups.items():
            job = run_job(f"encrypt_{name}", "files.encryptFiles", {
                "sources": [first[p]["id"] for p in paths], **secret,
                "algorithm": "XChaCha20Poly1305" if name == "key" else "Aes256Gcm",
                "metadata": name == "key", "erase_original": True})
            if job["status"] != 2 or job["metadata"].get("encrypted") != len(paths):
                fail(f"crypto: encrypt ({name}) ended {job['status']} "
                     f"{job['metadata']}: {job['errors_text']}")
        left = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file()
                      and p.name != ".spacedrive")
        if left != sorted(f"{p}.bytes" for p in rels):
            fail(f"crypto: after encrypting, the location holds {left[:4]}...")
        # a copy of a sealed file with its last byte flipped: its second
        # block's tag, so block 0 is written before the failure
        tampered = root / "made" / "tampered.bin.bytes"
        raw = bytearray((root / "made" / "block-2MiB.bin.bytes").read_bytes())
        raw[-1] ^= 1
        tampered.write_bytes(bytes(raw))

        sealed = rescan("rescan_sealed")
        plain_ids = {first[p]["cas_id"] for p in rels}
        for p in rels:
            row = sealed.get(f"{p}.bytes")
            if row is None or not row["cas_id"]:
                fail(f"crypto: {p}.bytes has no cas_id after the rescan")
            if row["cas_id"] in plain_ids:
                fail(f"crypto: {p}.bytes has a plaintext's cas_id")
        km = node.key_manager
        for p in by_key:
            with open(root / f"{p}.bytes", "rb") as fh:
                h = header.FileHeader.from_reader(fh)
            meta = h.decrypt_metadata(h.decrypt_master_key(
                primitives.Protected(km.get_key(kid).expose())))
            want = {"name": Path(p).name, "size": sizes[p], "cas_id": first[p]["cas_id"]}
            if {k: meta.get(k) for k in want} != want or not meta.get("object_pub_id"):
                fail(f"crypto: {p}.bytes's metadata {meta}, not {want}")

        # 4. the failure cases: a wrong password, the tampered copy
        wrong = run_job("wrong_password", "files.decryptFiles", {
            "sources": [sealed[f"{by_password[0]}.bytes"]["id"]], "password": "wrong"})
        bad = run_job("tampered", "files.decryptFiles", {
            "sources": [sealed["made/tampered.bin.bytes"]["id"]], "key_uuid": kid})
        for what, job, text, out in (
                ("wrong password", wrong, "incorrect password", root / by_password[0]),
                ("tampered file", bad, "decryption failed", root / "made" / "tampered.bin")):
            if job["status"] != 6 or text not in (job["errors_text"] or ""):
                fail(f"crypto: the {what} ended {job['status']}: {job['errors_text']}")
            if out.exists():
                fail(f"crypto: the {what} left plaintext at {out}")
        tampered.unlink()
        # lock and unlock: the automount key comes back
        r("keys.lockKeyManager")
        if r("keys.isUnlocked") or r("keys.listMounted"):
            fail("crypto: keys.lockKeyManager left the manager unlocked or a key mounted")
        r("keys.unlockKeyManager", "chip-smoke master password")
        if r("keys.listMounted") != [kid]:
            fail("crypto: unlocking did not mount the automount key again")
        keyring_store = r("keys.enableAutoUnlock")
        r("keys.disableAutoUnlock")

        # 5. decrypt with the same keys, rescan, validate
        for name, (paths, secret) in groups.items():
            job = run_job(f"decrypt_{name}", "files.decryptFiles", {
                "sources": [sealed[f"{p}.bytes"]["id"] for p in paths], **secret,
                "erase_original": True})
            if job["status"] != 2 or job["metadata"].get("decrypted") != len(paths):
                fail(f"crypto: decrypt ({name}) ended {job['status']} "
                     f"{job['metadata']}: {job['errors_text']}")
        back = rescan("rescan_plain")
        if sorted(back) != sorted(rels):
            fail(f"crypto: after decrypting, the rows are {sorted(back)[:4]}...")
        for p in rels:
            if back[p]["cas_id"] != first[p]["cas_id"]:
                fail(f"crypto: {p} came back with cas_id {back[p]['cas_id']}, "
                     f"not {first[p]['cas_id']}")
        back = validate_all("revalidate")
        for p in rels:
            if back[p]["integrity_checksum"] != first[p]["integrity_checksum"]:
                fail(f"crypto: {p}'s checksum {back[p]['integrity_checksum']} is not "
                     f"its original's {first[p]['integrity_checksum']}")
        torch.cuda.synchronize()
        launches = {k: _kernels.LAUNCHES_BY_ORIGIN.get((k, "crypto"), 0)
                    for k in (*SCAN_KERNELS, *SEARCH_KERNELS)}
        for k in SCAN_KERNELS:
            if not launches[k]:
                fail(f"crypto: {k} never launched for the phase's scans and validations")
        plain = sum(_kernels.PLAIN_ON_CUDA.values())
        if plain:
            fail(f"crypto: plain versions ran on the card: {dict(_kernels.PLAIN_ON_CUDA)}")
    finally:
        FileIdentifierJob.pipeline_process, ObjectValidatorJob.execute_step = process, validate
        crypto_jobs.Encryptor.encrypt_streams = classmethod(enc_streams)
        crypto_jobs.Decryptor.decrypt_streams = classmethod(dec_streams)
        hashing._argon2id = argon2id
        if node is not None:
            node.shutdown()
        shutil.rmtree(WORK / "crypto", ignore_errors=True)
    big = CRYPTO_MADE["stream-64MiB.bin"]
    rates = {}
    for what in ("encrypt", "decrypt"):
        n_s = [(n, s) for n, s in streams[what] if n >= big]
        if len(n_s) != 1:
            fail(f"crypto: {len(n_s)} {what} streams of the 64 MiB file")
        rates[f"{what}_64MiB_mb_s"] = big / n_s[0][1] / 1e6
    total = time.perf_counter() - t_phase
    out = {"seconds": total, "steps_s": seconds, **rates,
           "argon2id_ms": 1e3 * sum(hashes) / len(hashes), "argon2id_hashes": len(hashes),
           "files": len(rels), "bytes": sum(sizes.values()),
           "keyring_store": keyring_store, "launches": launches, **versions, "card": card}
    log(f"phase 13 (crypto): {total:.1f} s; {json.dumps(out)}")
    if total > CRYPTO_BUDGET_S:
        fail(f"phase 13 took {total:.1f} s, over its {CRYPTO_BUDGET_S} s budget")
    return out


# --------------------------------------------------------------------------
# phase 15: telemetry's cost on the card
# --------------------------------------------------------------------------

#: phase 15 fails past this
TELEMETRY_BUDGET_S = 60.0
#: directories of phase 4's tree the profiled rescan reads
PROFILED_DIRS = 4
#: the profiler's rate in the profiled rescan
PROFILE_HZ = 200


def telemetry_rescan(node, root: Path, name: str, enabled: bool) -> dict:
    """One pipelined rescan of ``root`` into a new library with telemetry
    on or off: its seconds, files/s, kernel launches and the synchronizing
    CUDA calls ``torch.cuda.set_sync_debug_mode("warn")`` reported."""
    import warnings

    import torch

    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.jobs import JobStatus
    from spacedrive_tpu_torch.locations import scan_location
    from spacedrive_tpu_torch.ops import _kernels

    lib = node.libraries.create(name)
    loc = identify_location(lib, root)
    torch.cuda.synchronize()
    _kernels.reset_counts()
    telemetry.set_enabled(enabled)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                scan_location(lib, loc["id"])
                if not node.jobs.wait_idle(300):
                    fail(f"telemetry: the {name} rescan did not finish")
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        telemetry.set_enabled(True)
    torch.cuda.synchronize()
    job, meta, seconds = identify_job(lib.db)
    if job["status"] != JobStatus.COMPLETED:
        fail(f"telemetry: the {name} rescan's identify job ended {job['status']}")
    # one warning a call that synchronizes (the mode's own notice, given
    # once when it is first set, is not one)
    syncs = [str(w.message) for w in caught
             if str(w.message).startswith("called a synchronizing CUDA operation")]
    kinds: dict = {}
    for text in syncs:
        kinds[text[:80]] = kinds.get(text[:80], 0) + 1
    files = meta["total_orphan_paths"]
    return {"telemetry": "on" if enabled else "off", "seconds": seconds,
            "files": files, "files_per_s": files / seconds,
            "launches": {k: _kernels.LAUNCHES.get(k, 0) for k in SCAN_KERNELS},
            "sync_calls": len(syncs), "sync_kinds": kinds,
            "trace": "trace" in meta, "batches": meta["pipeline_batches"]}


def telemetry_phase(tree_dir: Path, card: str) -> dict:
    """Phase 15: four pipelined rescans of phase 4's first
    :data:`RESCAN_DIRS` directories (4,096 files) in the order off, on, on,
    off, with fixed 1,024-file pages, so each rescan launches the same
    kernels; launches and synchronizing calls equal off and on. Then a
    rescan of :data:`PROFILED_DIRS` directories on a node with
    ``SD_PROFILE_HZ`` set: its samples fall in ``pipeline.*`` spans, and
    the ``sd_proc_*`` gauges are set."""
    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.node import Node

    t_phase = time.perf_counter()
    root = WORK / "rescan"
    if not root.is_dir():
        rescan_tree(tree_dir)
    saved = {k: os.environ.pop(k, None) for k in (
        "SD_PIPELINE", "SD_PIPELINE_DEPTH", "SD_SCAN_SHARDS", "SD_COMMIT_GROUP",
        "SD_SCAN_BATCH", "SD_SEARCH_ENGINE", "SD_PROFILE_HZ")}
    os.environ["SD_CHUNK_MANIFESTS"] = "1"
    # fixed pages: every rescan launches the same kernels on the same pages
    os.environ["SD_SCAN_ADAPT"] = "0"
    runs = []
    node = Node(WORK / "telemetry-data", watch_locations=False)
    try:
        for i, enabled in enumerate((False, True, True, False)):
            runs.append(telemetry_rescan(node, root, f"telemetry-{i}", enabled))
            log(f"telemetry (phase 15) on {card}: rescan {i + 1} with telemetry "
                f"{runs[-1]['telemetry']}: {runs[-1]['seconds']:.2f} s, "
                f"{runs[-1]['files_per_s']:.1f} files/s, {runs[-1]['batches']} pages, launches "
                f"{json.dumps(runs[-1]['launches'])}, synchronizing calls "
                f"{runs[-1]['sync_calls']}")
    finally:
        node.shutdown()
    for run in runs[1:]:
        if run["launches"] != runs[0]["launches"]:
            fail(f"telemetry: launches with telemetry {run['telemetry']} {run['launches']}, "
                 f"off {runs[0]['launches']}")
        if run["sync_calls"] != runs[0]["sync_calls"] or \
                run["sync_kinds"] != runs[0]["sync_kinds"]:
            fail(f"telemetry: synchronizing calls with telemetry {run['telemetry']} "
                 f"{run['sync_kinds']}, off {runs[0]['sync_kinds']}")
        if run["trace"] != (run["telemetry"] == "on"):
            fail(f"telemetry: a rescan with telemetry {run['telemetry']} has trace={run['trace']}")
    if not runs[0]["sync_calls"]:
        fail("telemetry: the sync debug mode reported no synchronizing call (the digests' "
             "reads back to the host are some)")

    # the profiled rescan
    os.environ["SD_PROFILE_HZ"] = str(PROFILE_HZ)
    small = WORK / "telemetry-profiled"
    for d in range(PROFILED_DIRS):
        (small / f"d{d:02d}").mkdir(parents=True)
        for p in (root / f"d{d:02d}").iterdir():
            os.link(p, small / f"d{d:02d}" / p.name)
    node = Node(WORK / "telemetry-profiled-data", watch_locations=False)
    try:
        if node.profiler is None:
            fail(f"telemetry: SD_PROFILE_HZ={PROFILE_HZ} started no profiler")
        profiled = telemetry_rescan(node, small, "telemetry-profiled", True)
        by_span = node.profiler.totals_by_span()
        proc = {name: telemetry.value(name) for name in
                ("sd_proc_rss_bytes", "sd_proc_open_fds", "sd_proc_threads")}
    finally:
        node.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        os.environ.pop("SD_SCAN_ADAPT", None)
    pipeline_samples = {k: v for k, v in by_span.items() if k.startswith("pipeline.")}
    if not pipeline_samples:
        fail(f"telemetry: the profiler attributed no sample to a pipeline.* span: {by_span}")
    if not all(proc.values()):
        fail(f"telemetry: sd_proc_* gauges {proc}")
    exported = sorted(p.name for p in (WORK / "telemetry-profiled-data" / "logs" /
                                       "profiles").glob("*.folded"))
    if not exported:
        fail("telemetry: the profiled node exported no folded profile at shutdown")
    off = [r["seconds"] for r in runs if r["telemetry"] == "off"]
    on = [r["seconds"] for r in runs if r["telemetry"] == "on"]
    seconds = time.perf_counter() - t_phase
    out = {"card": card, "seconds": seconds, "runs": runs,
           "off_s": off, "on_s": on,
           "on_over_off": (sum(on) / len(on)) / (sum(off) / len(off)),
           "profiled": {"seconds": profiled["seconds"], "files": profiled["files"],
                        "hz": PROFILE_HZ, "samples_by_span": by_span,
                        "exported": exported},
           "proc": proc}
    log(f"phase 15 (telemetry) on {card}: rescans off {off}, on {on} s (on / off "
        f"{out['on_over_off']:.3f}); launches and synchronizing calls equal off and on; the "
        f"profiled rescan ({profiled['files']} files at {PROFILE_HZ} Hz) put "
        f"{sum(pipeline_samples.values())} samples in {sorted(pipeline_samples)}; "
        f"sd_proc_* {json.dumps(proc)}; {seconds:.1f} s")
    if seconds > TELEMETRY_BUDGET_S:
        fail(f"phase 15 took {seconds:.1f} s, over its {TELEMETRY_BUDGET_S:.0f} s budget")
    shutil.rmtree(small, ignore_errors=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of all generated data")
    parser.add_argument("--kernels", action="store_true",
                        help="build, parity and timing only; no main path, no ok line")
    parser.add_argument("--live", action="store_true",
                        help="build, then phase 10 (the live library) only; no ok line")
    parser.add_argument("--sync", action="store_true",
                        help="build, write and scan phase 4's tree, then phase 11 (sync) "
                             "only; no ok line")
    parser.add_argument("--p2p", action="store_true",
                        help="build, write and scan phase 4's tree, then phase 12 (p2p) "
                             "only; no ok line")
    parser.add_argument("--crypto", action="store_true",
                        help="build, write phase 4's tree, then phase 13 (crypto) only; "
                             "no ok line")
    parser.add_argument("--serving", action="store_true",
                        help="build, write and scan phase 4's tree, then phase 12's pair and "
                             "phase 14 (the serving tier) only; no ok line")
    parser.add_argument("--telemetry", action="store_true",
                        help="build, write phase 4's tree, then phase 15 (telemetry's cost) "
                             "only; no ok line")
    parser.add_argument("--kill-child", nargs=2, metavar=("DATA_DIR", "TREE"),
                        help="phase 8's child process: scan TREE into a Node on DATA_DIR "
                             "until the armed commit seam kills it")
    args = parser.parse_args()
    if args.kill_child:
        return kill_child(*args.kill_child)
    t_script = time.perf_counter()

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
    if args.live:
        try:
            live = live_library_phase(args.seed, card)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        print(card, flush=True)
        print(json.dumps({"live_library": live}), flush=True)
        return 0
    if args.sync:
        try:
            synced = sync_phase(WORK / "tree", *sync_reference(args.seed), card)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        print(card, flush=True)
        print(json.dumps({"sync": synced}), flush=True)
        return 0
    if args.p2p:
        try:
            paired = p2p_phase(WORK / "tree", *sync_reference(args.seed), card, args.seed,
                               int32_ops_per_s)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        print(card, flush=True)
        print(json.dumps({"p2p": paired}), flush=True)
        return 0
    if args.serving:
        try:
            paired = p2p_phase(WORK / "tree", *sync_reference(args.seed), card, args.seed,
                               int32_ops_per_s, serving=True)
            admitted = admission_phase(card)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        serving = serving_summary(card, None, paired.pop("replica"), admitted)
        print(card, flush=True)
        print(json.dumps({"p2p": paired}), flush=True)
        print(json.dumps({"serving": serving}), flush=True)
        return 0
    if args.telemetry:
        try:
            write_tree(WORK / "tree", args.seed)
            telemetered = telemetry_phase(WORK / "tree", card)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        print(card, flush=True)
        print(json.dumps({"telemetry": telemetered}), flush=True)
        return 0
    if args.crypto:
        try:
            write_tree(WORK / "tree", args.seed)
            crypted = crypto_phase(WORK / "tree", args.seed, card)
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        print(card, flush=True)
        print(json.dumps({"crypto": crypted}), flush=True)
        return 0
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
        served = (None if args.kernels else
                  serve_scan_phase(WORK / "tree", main["rows"], main["tampered_dir"], card))
        live = None if args.kernels else live_library_phase(args.seed, card)
        synced = (None if args.kernels else
                  sync_phase(WORK / "tree", main["rows"], main["tampered_dir"], card))
        paired = (None if args.kernels else
                  p2p_phase(WORK / "tree", main["rows"], main["tampered_dir"], card,
                            args.seed, int32_ops_per_s, serving=True))
        admitted = None if args.kernels else admission_phase(card)
        crypted = None if args.kernels else crypto_phase(WORK / "tree", args.seed, card)
        telemetered = None if args.kernels else telemetry_phase(WORK / "tree", card)
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
    serving = serving_launches = None
    if main is not None:
        replicated = paired.pop("replica")
        serving_launches = replicated["launches"]
        serving = serving_summary(card, main["serving"], replicated, admitted)
        times.update(main["validator"]["times"])
        # phase 12: Gear over the one 64 MiB file of the delta spacedrop
        times["gear_candidates@delta64MiB"] = paired["gear_delta_plane"]
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
        if main is not None:
            # phase 9: the serving path, counted in its own windows
            kernels[-1]["launches_serving"] = (main["serving"] if search else served)[
                "launches"][name]
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
                # phase 7: the validator's full-file hashes, counted in their own window
                kernels[-1]["launches_validator"] = main["validator"]["launches"].get(name, 0)
                kernels[-1]["launches_by_shape_validator"] = main["validator"]["by_shape"].get(name, {})
            # phase 10: the watcher thread's identify passes
            kernels[-1]["launches_watcher"] = live["launches"].get(name, 0)
        if main is not None:
            # phase 11: both nodes' scans (BLAKE3, Gear) and the searches
            # of the rows the other node's operations brought in
            kernels[-1]["launches_sync"] = synced["launches"][name]
            # phase 12: both processes (the scans, B's H_HASH service for
            # A's cas messages, the delta's chunking on both ends), by origin
            kernels[-1]["launches_p2p"] = paired["launches"].get(name, 0)
            kernels[-1]["launches_p2p_by_origin"] = {
                side: {o: c[name] for o, c in by.items() if c.get(name)}
                for side, by in paired["launches_by_origin"].items()}
            # phase 13: the crypto node's scans and validations
            kernels[-1]["launches_crypto"] = crypted["launches"][name]
        if main is not None and search:
            # phase 14 (b): B's launches for A's queries over H_QUERY
            kernels[-1]["launches_replica"] = serving_launches[name]
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
            "heif_images": media["heif_images"], "heif_shapes": media["heif_shapes"],
            "heif_differing_values": media["heif_differing"],
            "max_abs_err": max(errs["resize_batch"], media["max_abs_err"]), **resize_row(t),
            "other_shapes": {s["shape"]: resize_row(s) for _k, s in shapes[1:]},
            "example_full_sub_batch": resize_row(resize_example)})
        # the mesh programs (phase 7): a call over each mesh, copies included
        mesh = main["validator"]["mesh"]
        for name, line in (("sharded_hasher", 73), ("sharded_row_hasher", 87),
                           ("identify_step", 103), ("sharded_resizer", 141)):
            bound = mesh["resize_bound" if name == "sharded_resizer" else "hash_bound"]
            programs.append({
                "name": name, "route": "pytorch", "source": "spacedrive_tpu_torch/parallel/mesh.py",
                "replaces": f"spacedrive_tpu/parallel/mesh.py:{line}", "max_abs_err": 0,
                "ms": mesh["meshes"][0]["ms"][name],
                "ms_by_mesh": {m["mesh"]: m["ms"][name] for m in mesh["meshes"]},
                "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None})
        print(json.dumps({"device_programs": programs}), flush=True)
        print(json.dumps({"p2p": paired}), flush=True)
        print(json.dumps({"crypto": crypted}), flush=True)
        print(json.dumps({"serving": serving}), flush=True)
        print(json.dumps({"telemetry": {
            "scan": main["trace"], "serve": main["serving"]["telemetry"],
            "serve_pool": main["serving"]["pool"]["serve_families"],
            "sse": served["sse"], "p2p": paired["telemetry"], "cost": telemetered}}),
            flush=True)
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s")
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
