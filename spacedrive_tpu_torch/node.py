"""Node: the runtime a scan runs in.

Counterpart of ``spacedrive_tpu/node.py`` (``Node`` :75), trimmed to the node
config, the event bus, the libraries under ``<data_dir>/libraries/``, the job
runner, the search engine (armed by ``SD_SEARCH_ENGINE=device``, as in the
JAX package) and the device. ``device`` defaults to the CUDA card and raises
when there is none; ``device="cpu"`` runs the kernels' plain PyTorch
versions. p2p, the key manager, telemetry, alerts, the accelerator probe and
the reader pool are not ported.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import torch

from . import resolve_device
from .config import load_node_config
from .events import EventBus
from .jobs import Jobs
from .library import Libraries
from .objects.hasher import DeviceHasher
from .search.engine import SearchEngine

logger = logging.getLogger(__name__)


class Node:
    def __init__(self, data_dir: str | Path,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.config = load_node_config(self.data_dir)
        self.events = EventBus()
        self.hasher = DeviceHasher(self.device)
        self.jobs = Jobs()
        self.libraries = Libraries(self.data_dir, node=self)
        self.libraries.init()
        self.search_engine = SearchEngine.maybe_start(self)
        logger.info("node %s up on %s", self.config["id"][:8], self.device)

    def emit(self, kind: str, payload: Any = None, library_id: str | None = None) -> None:
        self.events.emit_kind(kind, payload, library_id)

    def shutdown(self) -> None:
        """Let spawned jobs finish, stop the job worker and the search
        engine, close the databases."""
        self.jobs.shutdown()
        if self.search_engine is not None:
            self.search_engine.stop()
        self.libraries.close()
