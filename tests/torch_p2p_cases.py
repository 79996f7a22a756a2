"""Shared helpers of the port's p2p tests and of ``chip_smoke.py`` phase
12 (no jax): waiting, pairing two nodes over loopback, collecting a node's
p2p events, a small seeded tree, the digest of a library's synced rows,
the p2p counters of a process, and a peer node in a process of its own
(``tests/torch_p2p_peer.py``, driven by :class:`PeerProcess`)."""

from __future__ import annotations

import hashlib
import json
import os
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np


def wait_for(predicate, timeout: float = 20.0, interval: float = 0.02, msg: str = "condition"):
    """Poll ``predicate`` until it is truthy; its value, or AssertionError."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout} s waiting for {msg}")


def count(db, table: str) -> int:
    return db.query(f"SELECT COUNT(*) AS n FROM {table}")[0]["n"]


def addr_of(node) -> str:
    return f"127.0.0.1:{node.p2p.port}"


def ident_of(node) -> str:
    return node.p2p.remote_identity.encode()


def pair(originator, responder, name: str = "shared", timeout: float = 20.0):
    """``responder`` makes a library and auto-accepts; ``originator`` pairs
    with it over ``p2p.pair``. Returns (originator's mirror, responder's
    library) once the mirror exists and both know each other's node."""
    lib_r = responder.libraries.create(name)
    responder.config.write(p2p_auto_accept_library=lib_r.id)
    originator.router.resolve("p2p.pair", {"peer_id": addr_of(responder)})
    lib_o = wait_for(lambda: next((x for x in originator.libraries.list() if x.id == lib_r.id),
                                  None), timeout, msg="the mirrored library")
    wait_for(lambda: ident_of(originator) in responder.p2p.nlm.member_nodes(lib_r)
             and ident_of(responder) in originator.p2p.nlm.member_nodes(lib_o),
             timeout, msg="membership on both sides")
    return lib_o, lib_r


class Events:
    """The ``p2p`` event payloads a node emits, as they arrive."""

    def __init__(self, node) -> None:
        self.items: list[dict] = []
        node.events.on(lambda ev: self.items.append(ev.payload) if ev.kind == "p2p" else None)

    def of(self, kind: str, **match) -> list[dict]:
        return [e for e in list(self.items) if e.get("type") == kind
                and all(e.get(k) == v for k, v in match.items())]

    def wait(self, kind: str, timeout: float = 20.0, **match) -> dict:
        return wait_for(lambda: (self.of(kind, **match) or [None])[0], timeout, msg=kind)


def blob(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


#: sizes of :func:`small_tree`'s files: an empty file, whole-file messages,
#: and sampled ones (over 100 KiB)
TREE_SIZES = (0, 1, 700, 5_000, 60_000, 100 * 1024, 150_000, 300_000)


def small_tree(root: Path, seed: int, prefix: str = "f") -> Path:
    """Two directories of :data:`TREE_SIZES` files, names unique by
    ``prefix``, plus one copy (two paths, one object)."""
    for d in range(2):
        (root / f"d{d}").mkdir(parents=True, exist_ok=True)
        for i, size in enumerate(TREE_SIZES):
            (root / f"d{d}" / f"{prefix}{d}{i}.bin").write_bytes(blob(seed * 100 + d * 10 + i,
                                                                     size))
    (root / "d1" / f"{prefix}copy.bin").write_bytes((root / "d0" / f"{prefix}06.bin").read_bytes())
    return root


#: the kernels a p2p run launches (the scans, the hash service, the delta)
P2P_KERNELS = ("blake3_chunk_cvs", "blake3_merge", "gear_candidates")


def rows_digest(db) -> tuple[str, int]:
    """sha256 of a library's synced rows, and their count."""
    from tests.torch_sync_cases import synced_rows

    rows = synced_rows(db)
    text = json.dumps(sorted([list(k), v] for k, v in rows.items()), default=str,
                      sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest(), len(rows)


def synchronize() -> None:
    """Wait for the card's queued work, where there is a card."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def p2p_counts() -> dict:
    """This process's kernel launches (all, by origin, by caller's tag),
    plain versions run on the card, remote-hasher fallbacks, the p2p, nlm
    and delta counters and the telemetry families of the mesh (totals of
    the hash families; the sync lag and sessions by peer label), JSON-safe."""
    from spacedrive_tpu_torch import telemetry
    from spacedrive_tpu_torch.objects.hasher import RemoteHasher
    from spacedrive_tpu_torch.ops import _kernels
    from spacedrive_tpu_torch.p2p import delta, manager, nlm

    synchronize()
    by_origin: dict = {}
    for (k, origin), n in _kernels.LAUNCHES_BY_ORIGIN.items():
        by_origin.setdefault(origin or "-", {})[k] = n
    by_tag: dict = {}
    for (k, tag, _shape), n in _kernels.LAUNCHES_BY_SHAPE.items():
        by_tag.setdefault(tag or "-", {}).setdefault(k, 0)
        by_tag[tag or "-"][k] += n
    return {"launches": {k: _kernels.LAUNCHES.get(k, 0) for k in P2P_KERNELS},
            "by_origin": by_origin, "by_tag": by_tag,
            "plain_on_cuda": dict(_kernels.PLAIN_ON_CUDA),
            "fallbacks": dict(RemoteHasher.FALLBACKS), "p2p": dict(manager.STATS),
            "nlm": dict(nlm.STATS),
            "delta": {"transfers": dict(delta.TRANSFERS), "chunks": dict(delta.CHUNKS),
                      "bytes": dict(delta.BYTES), "busy": dict(delta.BUSY)},
            "telemetry": {
                "hash_requests": telemetry.value("sd_p2p_hash_requests_total"),
                "hash_bytes": telemetry.value("sd_p2p_hash_bytes_total"),
                "hash_serve": sum(v for _l, v in telemetry.series_values(
                    "sd_p2p_hash_serve_total")),
                "hash_serve_bytes": sum(v for _l, v in telemetry.series_values(
                    "sd_p2p_hash_serve_bytes_total")),
                "lag_ops": {lbl["peer"]: v for lbl, v in telemetry.series_values(
                    "sd_sync_peer_lag_ops")},
                "sessions": {lbl["peer"]: v for lbl, v in telemetry.series_values(
                    "sd_sync_remote_sessions_total")}}}


def p2p_reset() -> None:
    """Zero every counter :func:`p2p_counts` reads."""
    from spacedrive_tpu_torch.objects.hasher import RemoteHasher
    from spacedrive_tpu_torch.ops import _kernels
    from spacedrive_tpu_torch.p2p import delta, manager, nlm

    synchronize()
    _kernels.reset_counts()
    RemoteHasher.reset_counts()
    for module in (manager, nlm, delta):
        module.reset_counts()


def p2p_debug_log(path: Path) -> None:
    """This process's p2p and sync loggers at DEBUG into ``path`` (not the
    console), for the tail a failed run prints."""
    import logging

    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    for name in ("spacedrive_tpu_torch.p2p", "spacedrive_tpu_torch.sync"):
        logger = logging.getLogger(name)
        logger.setLevel(logging.DEBUG)
        logger.addHandler(handler)


def count_scans(side: str):
    """Count each identify batch's launches under origin ``scan:<side>``;
    returns the undo."""
    from spacedrive_tpu_torch.objects.file_identifier import FileIdentifierJob
    from spacedrive_tpu_torch.ops import _kernels

    process = FileIdentifierJob.pipeline_process

    def counted_process(self, ctx, data, batch):
        with _kernels.origin(f"scan:{side}"):
            return process(self, ctx, data, batch)

    FileIdentifierJob.pipeline_process = counted_process
    return lambda: setattr(FileIdentifierJob, "pipeline_process", process)


def p2p_location(lib, root: Path, hasher: str | None = None) -> dict:
    """A location over ``root`` with preview media off, the change logged
    as an operation."""
    from spacedrive_tpu_torch.locations import create_location
    from spacedrive_tpu_torch.models import Location

    loc = create_location(lib, root, hasher=hasher)
    lib.sync.write_ops(
        [lib.sync.shared_update(Location, loc["pub_id"], "generate_preview_media", False)],
        lambda db, i=loc["id"]: db.update(Location, {"id": i}, {"generate_preview_media": False}))
    return loc


class PeerError(AssertionError):
    """The peer process failed, or a check on its answers did; the message
    ends with the tails of its logs."""


class PeerProcess:
    """``tests/torch_p2p_peer.py`` in a child process: its READY line
    (:meth:`wait_ready`), then one JSON answer a command, each read with
    its own timeout. Its stderr goes to ``log``; ``debug_log`` is where it
    writes its p2p and sync loggers at DEBUG."""

    SCRIPT = Path(__file__).with_name("torch_p2p_peer.py")

    def __init__(self, data_dir: Path, tree: Path, device: str, log: Path,
                 debug_log: Path | None = None, timeout: float = 120.0,
                 env: dict | None = None) -> None:
        """``env``: variables set for the child beside this process's."""
        self.log_path, self.debug_log, self.timeout = log, debug_log, timeout
        self._log = open(log, "w")
        argv = [sys.executable, str(self.SCRIPT), str(data_dir), str(tree), device]
        self.proc = subprocess.Popen(
            argv + ([str(debug_log)] if debug_log else []), stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self._log, text=True, bufsize=1,
            env={**{k: v for k, v in os.environ.items() if k != "SD_P2P_DISABLED"},
                 **(env or {})})
        self._lines: "queue.Queue[str | None]" = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()
        self.ready: dict = {}

    def _pump(self) -> None:
        for line in self.proc.stdout:
            self._lines.put(line)
        self._lines.put(None)

    def wait_ready(self) -> dict:
        ready = self.read("READY")
        if not ready.get("ready"):
            self.fail(f"the peer process answered {ready} for READY")
        self.ready = ready
        return ready

    def read(self, what: str) -> dict:
        try:
            line = self._lines.get(timeout=self.timeout)
        except queue.Empty:
            line = None
        if line is None:
            self.fail(f"the peer process gave no answer to {what}")
        return json.loads(line)

    def ask(self, op: str, **kw) -> dict:
        self.proc.stdin.write(json.dumps({"op": op, **kw}) + "\n")
        self.proc.stdin.flush()
        return self.read(op)

    def fail(self, msg: str) -> None:
        """Kill the process and raise :class:`PeerError` with its logs' tails."""
        self.proc.kill()
        rc = self.proc.wait(10)
        self._log.flush()
        tails = f"its log ends:\n{self.log_path.read_text()[-3000:]}"
        if self.debug_log is not None and self.debug_log.exists():
            tails += f"\nits p2p debug log ends:\n{self.debug_log.read_text()[-6000:]}"
        raise PeerError(f"{msg} (exit {rc}); {tails}")

    def quit(self, timeout: float = 30.0) -> int:
        self.proc.stdin.write(json.dumps({"op": "quit"}) + "\n")
        self.proc.stdin.flush()
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.fail(f"the peer process did not exit within {timeout:.0f} s of quit")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(10)
        self._log.close()
