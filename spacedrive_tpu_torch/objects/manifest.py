"""Chunk-manifest stage of FileIdentifierJob (``SD_CHUNK_MANIFESTS=1``).

Counterpart of ``spacedrive_tpu/objects/manifest.py``: the page gather
attaches each file's whole-content payload (small files reuse the cas message
body, larger ones are read, with transient read errors retried; files over
:func:`payload_cap`, 4 MiB unless ``SD_CHUNK_MAX_BYTES`` says otherwise, are
skipped), the process
stage chunks the page on the node's device with :mod:`..ops.cdc` (the Gear
kernel, then the BLAKE3 kernels for the chunk ids), and the commit stage
writes ``chunk_manifest`` rows inside the identifier's transaction.

There is no router and no CPU re-dispatch: on the card a kernel failure
raises and fails the job, so a scan can never hide the device.

Telemetry: the process stage runs in an ``identifier.chunk`` span, which
closes after the chunk flags and ids reached the host, and counts
``sd_chunk_{files,chunks,bytes,skipped,quarantined}_total``. The
reference's chunk-router families are kept with one engine: each batch
counts in ``sd_chunk_router_batches_total{backend}`` (``device`` on the
card, ``cpu`` on the plain versions) and moves the EWMA of
``sd_chunk_router_bytes_per_sec{backend}``; ``sd_chunk_router_flips_total``
stays 0, since one engine cannot flip.
"""

from __future__ import annotations

import os
import threading
import time

import torch

from .. import faults, telemetry
from ..models import ChunkManifest
from ..ops import cdc
from ..retry import RetryPolicy, retry_call

#: the whole-payload cap when ``SD_CHUNK_MAX_BYTES`` is unset: larger files
#: skip manifests
MAX_PAYLOAD_BYTES = 4 * 1024 * 1024

#: transient payload-read retries (the same shape as cas.GATHER_RETRY)
PAYLOAD_RETRY = RetryPolicy(attempts=3, base_s=0.01, max_s=0.1, budget_s=1.0)

_CHUNK_FILES = telemetry.counter(
    "sd_chunk_files_total", "files chunked into manifests")
_CHUNK_CHUNKS = telemetry.counter(
    "sd_chunk_chunks_total", "content-defined chunks produced")
_CHUNK_BYTES = telemetry.counter(
    "sd_chunk_bytes_total", "payload bytes run through the CDC kernel")
_CHUNK_QUARANTINED = telemetry.counter(
    "sd_chunk_quarantined_total",
    "per-item manifest failures quarantined (file still identifies)")
_CHUNK_SKIPPED = telemetry.counter(
    "sd_chunk_skipped_total",
    "files skipped by the manifest stage (payload over SD_CHUNK_MAX_BYTES)")
_CHUNK_ROUTER_BPS = telemetry.gauge(
    "sd_chunk_router_bytes_per_sec",
    "EWMA transfer-inclusive CDC payload bytes/s per engine (router input)",
    labels=("backend",))
telemetry.counter(
    "sd_chunk_router_flips_total",
    "engine flips by the per-batch chunk router (hysteresis-damped)")
_CHUNK_ROUTER_BATCHES = telemetry.counter(
    "sd_chunk_router_batches_total",
    "chunk (sub-)batches the router dispatched per engine",
    labels=("backend",))

#: EWMA weight of the newest batch's rate, and the rate per engine
_EWMA_ALPHA = 0.3
_EWMA: dict[str, float] = {}
_EWMA_LOCK = threading.Lock()

#: the cas message is size_le_8 ‖ content for files at or under this
#: (cas.MINIMUM_FILE_SIZE) — their payload is the message body, free
_SMALL = 102400


def manifests_enabled() -> bool:
    return os.environ.get("SD_CHUNK_MANIFESTS", "").strip().lower() in (
        "1", "true", "on", "yes")


def payload_cap() -> int:
    """The whole-payload cap: ``SD_CHUNK_MAX_BYTES`` where it parses as an
    integer (at least 1), else :data:`MAX_PAYLOAD_BYTES`."""
    raw = os.environ.get("SD_CHUNK_MAX_BYTES", "").strip()
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return MAX_PAYLOAD_BYTES


def _read_payload(path: str, msg: bytes, size: int) -> bytes:
    """One file's whole-content chunk payload; the ``chunk`` fault seam sits
    here, inside the retry, as in the reference (``manifest.py:105-109``)."""
    faults.inject("chunk", key=path)
    if size <= _SMALL:
        return bytes(msg[8:])
    with open(path, "rb") as fh:
        return fh.read(size)


def pipeline_chunk_gather(paths: list[str], rows: list[dict], messages: list) -> None:
    """Attach ``row['_chunk_payload']`` to every hashable row: the payload
    bytes, ``None`` (cas gather failed, or over :func:`payload_cap`:
    skipped, not quarantined), or the read's exception once transient errors
    have outlasted ``PAYLOAD_RETRY`` (the file's manifest is quarantined at
    commit)."""
    cap = payload_cap()
    for path, row, msg in zip(paths, rows, messages):
        size = row["size_in_bytes"] or 0
        if isinstance(msg, Exception) or size > cap:
            row["_chunk_payload"] = None
            if not isinstance(msg, Exception):
                _CHUNK_SKIPPED.inc()
            continue
        try:
            row["_chunk_payload"] = retry_call(
                lambda p=path, m=msg, s=size: _read_payload(p, m, s), policy=PAYLOAD_RETRY)
        except Exception as e:  # noqa: BLE001 — per-file quarantine
            row["_chunk_payload"] = e


def pipeline_chunk_process(rows: list[dict], device: torch.device, trace=None) -> None:
    """Chunk every gathered payload of the page on ``device``; results land
    as ``row['_chunk_manifest']`` (ordered ``(chunk_id, length)`` pairs)."""
    work = [r for r in rows if isinstance(r.get("_chunk_payload"), bytes)]
    if not work:
        return
    payloads = [r["_chunk_payload"] for r in work]
    nbytes = sum(len(p) for p in payloads)
    backend = "device" if torch.device(device).type == "cuda" else "cpu"
    # both calls return host lists: the span closes after the flags and
    # the ids came back from the card
    with telemetry.span(trace, "identifier.chunk", files=len(work), bytes=nbytes) as sp:
        t0 = time.perf_counter()
        chunks = cdc.chunk_batch(payloads, device=device)
        ids = cdc.chunk_ids(payloads, chunks, device=device)
        _observe_rate(backend, nbytes, time.perf_counter() - t0)
    for row, fid, fch in zip(work, ids, chunks):
        row["_chunk_manifest"] = [(cid, ln) for cid, (_off, ln) in zip(fid, fch)]
        row["_chunk_payload"] = None  # the payload bytes are dead weight now
    _CHUNK_FILES.inc(len(work))
    _CHUNK_CHUNKS.inc(sum(len(c) for c in chunks))
    _CHUNK_BYTES.inc(nbytes)
    sp.set(chunks=sum(len(c) for c in chunks))


def _observe_rate(backend: str, nbytes: int, wall_s: float) -> None:
    """Count one chunk batch and fold its bytes/s into the engine's EWMA."""
    _CHUNK_ROUTER_BATCHES.inc(backend=backend)
    if wall_s <= 0 or not telemetry.enabled():
        return
    rate = nbytes / wall_s
    with _EWMA_LOCK:
        prev = _EWMA.get(backend)
        rate = rate if prev is None else _EWMA_ALPHA * rate + (1 - _EWMA_ALPHA) * prev
        _EWMA[backend] = rate
    _CHUNK_ROUTER_BPS.set(rate, backend=backend)


def commit_manifest_rows(db, items: list[tuple[int, list[tuple[str, int]]]]) -> int:
    """Overwrite-then-insert the batch's manifests; ``items`` is
    ``(object_id, manifest)``, already one per object. The caller owns the
    transaction."""
    rows = []
    for oid, manifest in items:
        db.delete(ChunkManifest, {"object_id": oid})
        for seq, (chunk_hash, length) in enumerate(manifest):
            rows.append({"object_id": oid, "seq": seq,
                         "chunk_hash": chunk_hash, "length": length})
    if rows:
        db.insert_many(ChunkManifest, rows)
    return len(items)


def quarantine_errors(rows: list[dict], location_path: str) -> list[str]:
    """Rows whose payload read failed lose only their manifest — the file
    still identifies. Returns the soft-error strings for the step result."""
    from .file_identifier import abs_path

    errs = []
    for row in rows:
        p = row.get("_chunk_payload")
        if isinstance(p, Exception):
            errs.append(f"chunk manifest quarantined {abs_path(location_path, row)}: {p!r}")
            row["_chunk_payload"] = None
    if errs:
        _CHUNK_QUARANTINED.inc(len(errs))
    return errs
