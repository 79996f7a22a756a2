"""Entry point of the headless server shell (``spacedrive_tpu/server/__main__.py``).

The reference's flags and environment: ``DATA_DIR`` and ``PORT``,
``SD_AUTH=user:password`` for basic auth, ``SD_LOG`` for the log level. One
flag more, ``--device``: the card by default (a node with no card raises),
``cpu`` for the kernels' plain versions. It prints ``LISTENING host:port``
once bound; SIGTERM or SIGINT stops the server, then the node, and exits 0.
Arm the search engine with ``SD_SEARCH_ENGINE=device``.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="spacedrive_tpu_torch.server")
    parser.add_argument("--data-dir", default=os.environ.get("DATA_DIR", "./sd_data"))
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=int(os.environ.get("PORT", "8080")))
    parser.add_argument("--auth", default=os.environ.get("SD_AUTH"),
                        help="user:password for basic auth")
    parser.add_argument("--log-level", default=os.environ.get("SD_LOG", "INFO"))
    parser.add_argument("--device", default=None,
                        help="torch device of the node (default: the CUDA card)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname).1s %(name)s %(message)s")

    from ..node import Node
    from .shell import Server

    node = Node(args.data_dir, device=args.device)
    server = Server(node, args.host, args.port, auth=args.auth)
    server.start()
    # the bound port on stdout, for the scripts and tests that parse it
    print(f"LISTENING {server.host}:{server.port}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda _sig, _frame: stop.set())
    signal.signal(signal.SIGTERM, lambda _sig, _frame: stop.set())
    # a timed wait, not signal.pause(): the kernel may deliver the signal to
    # any of the server's threads, and pause() in the main thread then never
    # returns; the handler runs in the main thread at its next wake-up
    while not stop.wait(0.5):
        pass
    server.stop()
    node.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
