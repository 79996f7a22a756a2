"""A port node in a process of its own: node B of the two-process p2p runs
(``chip_smoke.py`` phase 12 and the on-card test), driven through
``tests.torch_p2p_cases.PeerProcess`` (no jax).

Run: ``python tests/torch_p2p_peer.py <data_dir> <tree_dir> [device [debug_log]]``
(device: ``cuda``, the default, or ``cpu``; ``debug_log``: a file for the
p2p and sync loggers at DEBUG).

Boots a Node with ``syncEmitMessages`` and ``filesOverP2P`` on, makes a
library that pairing accepts without asking, with a location on
``tree_dir`` (preview media off, not yet scanned; identify's launches
counted under origin ``scan:B``), accepts every spacedrop into
``<data_dir>/inbox``, runs a ``Server`` on an ephemeral port, prints one
READY JSON line (``port``, ``http``, ``identity``, ``library_id``,
``inbox``), then answers JSON commands, one a line, on stdin, one JSON line
each:

  {"op": "reset"}      zero the counters of ``p2p_counts`` -> {"ok"}
  {"op": "scan"}       start the location's scan -> {"ok"}
  {"op": "wait_scan"}  wait for the jobs -> {"idle", "seconds", "jobs"}
  {"op": "rows"}       -> {"digest", "rows"}: the synced rows' sha256
  {"op": "ops"}        -> {"logged"}: the operations this instance logged
  {"op": "counts"}     -> ``p2p_counts()`` and ``fleet`` (sync.fleetStatus)
  {"op": "done"}       -> {"events"}: the spacedrops ended so far
  {"op": "ids", "pub_id": ...}  -> the file_path's id and its location's
  {"op": "refresh"}    bring the search index up to date -> {"fresh"}
  {"op": "local", "key": ..., "arg": ...}  the handler's page here, in
                       this process -> {"raw", "ms"} (``raw``: the encoded
                       page as text; ``ms``: the handler's milliseconds)
  {"op": "faults", "spec": ...}  arm a fault plan here (null clears it)
  {"op": "pool"}       wait for the server's reader pool -> {"status",
                       "stats", "pids"} (``status`` null without a pool)
  {"op": "quit"}       shut the node down and exit 0
"""

import json
import sys
import time
from pathlib import Path


def main() -> int:
    data_dir, tree_dir = Path(sys.argv[1]), Path(sys.argv[2])
    device = sys.argv[3] if len(sys.argv) > 3 else "cuda"
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    out, sys.stdout = sys.stdout, sys.stderr  # answers on stdout, logs on stderr

    from spacedrive_tpu_torch import faults
    from spacedrive_tpu_torch.locations import scan_location
    from spacedrive_tpu_torch.models import FilePath, Location
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.server import Server
    from spacedrive_tpu_torch.server.replica import encode_reply
    from tests.torch_p2p_cases import (count_scans, p2p_counts, p2p_debug_log, p2p_location,
                                       p2p_reset, rows_digest, synchronize)
    from tests.torch_sync_cases import sync_ops

    if len(sys.argv) > 4:
        p2p_debug_log(Path(sys.argv[4]))
    node = Node(data_dir, device=device, watch_locations=False)
    for feature in ("syncEmitMessages", "filesOverP2P"):
        if not node.config.has_feature(feature):
            node.config.toggle_feature(feature)
    lib = node.libraries.create("peer")
    loc = p2p_location(lib, tree_dir)
    node.config.write(p2p_auto_accept_library=lib.id)
    inbox = data_dir / "inbox"
    inbox.mkdir(exist_ok=True)
    done: list = []

    def on_event(event) -> None:
        if event.kind != "p2p":
            return
        ev = event.payload or {}
        if ev.get("type") == "SpacedropRequest":
            node.p2p.accept_spacedrop(ev["id"], str(inbox))
        elif ev.get("type") in ("SpacedropDone", "SpacedropFailed"):
            done.append(ev)

    node.events.on(on_event)
    count_scans("B")
    server = Server(node, "127.0.0.1", 0)
    server.start()

    def answer(obj) -> None:
        out.write(json.dumps(obj, default=str) + "\n")
        out.flush()

    answer({"ready": True, "port": node.p2p.port, "http": server.port,
            "identity": node.p2p.remote_identity.encode(), "library_id": lib.id,
            "inbox": str(inbox)})
    t_scan = None
    for line in sys.stdin:
        cmd = json.loads(line)
        op = cmd["op"]
        if op == "quit":
            break
        if op == "reset":
            p2p_reset()
            answer({"ok": True})
        elif op == "scan":
            t_scan = time.perf_counter()
            scan_location(lib, loc["id"])
            answer({"ok": True})
        elif op == "wait_scan":
            idle = node.jobs.wait_idle(600)
            synchronize()
            jobs = [dict(r) for r in lib.db.query("SELECT name, status, errors_text FROM job")]
            answer({"idle": idle, "seconds": time.perf_counter() - t_scan, "jobs": jobs})
        elif op == "rows":
            digest, n = rows_digest(lib.db)
            answer({"digest": digest, "rows": n})
        elif op == "ops":
            answer({"logged": sync_ops(lib)})
        elif op == "counts":
            answer({**p2p_counts(), "fleet": node.router.resolve("sync.fleetStatus", None)})
        elif op == "done":
            answer({"events": done})
        elif op == "ids":
            fp = lib.db.find_one(FilePath, {"pub_id": cmd["pub_id"]})
            answer({"file_path_id": fp and fp["id"], "location_id": fp and fp["location_id"],
                    "location_pub_id": fp and lib.db.find_one(
                        Location, {"id": fp["location_id"]})["pub_id"]})
        elif op == "refresh":
            node.search_engine.refresh_now(lib)
            answer({"fresh": node.search_engine.status()["libraries"][lib.id]["fresh"]})
        elif op == "local":
            t0 = time.perf_counter()
            page = node.router.procedures[cmd["key"]].fn(node, lib, cmd.get("arg"))
            ms = (time.perf_counter() - t0) * 1e3
            answer({"raw": encode_reply(page).decode(), "ms": ms})
        elif op == "pool":
            from spacedrive_tpu_torch.server import pool as pool_mod

            pool = server.wait_pool(120)
            answer({"status": pool and pool.status(), "stats": dict(pool_mod.STATS),
                    "pids": pool.worker_pids() if pool else []})
        elif op == "faults":
            if cmd.get("spec"):
                faults.install(cmd["spec"])
            else:
                faults.clear()
            answer({"ok": True})
        else:
            answer({"error": f"unknown op {op}"})
    server.stop()
    node.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
