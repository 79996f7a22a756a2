"""Node: the runtime a scan runs in.

Counterpart of ``spacedrive_tpu/node.py`` (``Node`` :75), trimmed to the node
config, the libraries under ``<data_dir>/libraries/``, the job runner and the
device. ``device`` defaults to the CUDA card and raises when there is none;
``device="cpu"`` runs the kernels' plain PyTorch versions. p2p, the key
manager, telemetry, alerts, the accelerator probe and the reader pool are
not ported.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from . import resolve_device
from .config import load_node_config
from .jobs import Jobs
from .library import Libraries
from .objects.hasher import DeviceHasher

logger = logging.getLogger(__name__)


class Node:
    def __init__(self, data_dir: str | Path,
                 device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.config = load_node_config(self.data_dir)
        self.hasher = DeviceHasher(self.device)
        self.jobs = Jobs()
        self.libraries = Libraries(self.data_dir, node=self)
        self.libraries.init()
        logger.info("node %s up on %s", self.config["id"][:8], self.device)

    def shutdown(self) -> None:
        """Let spawned jobs finish, stop the job worker, close the databases."""
        self.jobs.shutdown()
        self.libraries.close()
