"""Node configuration (trimmed).

Counterpart of ``spacedrive_tpu/config.py`` (``NodeConfig`` and
``ConfigManager``): a versioned JSON file, ``node_state.sdconfig`` in the
data dir, holding the node's identity and name, the device inventory the
node records at boot (``accelerator``: the card's kind and count, or none
on a CPU node, as the reference records its probe; peers read it to route
their cas messages to a card) and the node-level notifications, the
runtime feature flags that survive restarts (``features``, the
reference's :43-115: :class:`BackendFeature`,
:meth:`ConfigManager.toggle_feature`, :meth:`ConfigManager.has_feature`),
and the p2p keys (:63-70): ``keypair_seed`` (the node's ed25519 seed, hex;
a config written before p2p gets one at its next load), ``platform``,
``p2p_enabled`` (true; false, or ``SD_P2P_DISABLED`` in the environment,
keeps the node offline), ``p2p_port`` (None: an ephemeral port),
``p2p_discovery_port`` (None: no UDP beacons), ``p2p_static_peers``
(``["host:port", ...]``, pinged every 10 s) and
``p2p_auto_accept_library`` (the library a pairing request joins without
asking). :class:`ConfigManager` reads it under a lock and writes it through
atomically. The config migrator is not ported.
"""

from __future__ import annotations

import json
import os
import platform as _platform
import secrets
import threading
import uuid
from pathlib import Path
from typing import Any

from .atomic import atomic_write_text

VERSION = 1
FILENAME = "node_state.sdconfig"

#: the reference's record of a node with no accelerator
NO_ACCELERATOR = {"kind": None, "devices": 0, "mesh": []}


class BackendFeature:
    """Runtime-toggleable feature flags (the reference's names), each added
    with the slice that reads it (the port has no ``tpuThumbnails`` gate).
    ``filesOverP2P`` lets paired nodes read this node's files."""

    SYNC_EMIT_MESSAGES = "syncEmitMessages"
    FILES_OVER_P2P = "filesOverP2P"
    ALL = (SYNC_EMIT_MESSAGES, FILES_OVER_P2P)


#: the reference's Platform enum of the running system
PLATFORM = {"Windows": 1, "Darwin": 2, "Linux": 3}.get(_platform.system(), 0)

#: the p2p keys of a fresh config (reference :63-70)
P2P_DEFAULTS = {"p2p_enabled": True, "p2p_port": None, "p2p_discovery_port": None,
                "p2p_static_peers": [], "p2p_auto_accept_library": None}


def load_node_config(data_dir: str | Path) -> dict[str, Any]:
    """Read the node config, creating it with defaults on first boot."""
    path = Path(data_dir) / FILENAME
    if path.exists():
        config = json.loads(path.read_text())
        if "keypair_seed" in config:
            return config
        # a config from before p2p: the node gets its key now, once
        config = {"keypair_seed": secrets.token_hex(32), "platform": PLATFORM,
                  **P2P_DEFAULTS, **config}
        atomic_write_text(path, json.dumps(config, indent=2))
        return config
    config = {"version": VERSION, "id": str(uuid.uuid4()),
              "name": os.uname().nodename if hasattr(os, "uname") else "spacedrive",
              "keypair_seed": secrets.token_hex(32), "platform": PLATFORM,
              **P2P_DEFAULTS,
              "features": [],
              "accelerator": dict(NO_ACCELERATOR)}
    atomic_write_text(path, json.dumps(config, indent=2))
    return config


class ConfigManager:
    """Thread-safe access with write-through persistence."""

    def __init__(self, data_dir: str | Path) -> None:
        self._path = Path(data_dir) / FILENAME
        self._data = load_node_config(data_dir)
        self._lock = threading.Lock()

    def get(self) -> dict[str, Any]:
        with self._lock:
            return dict(self._data)

    def write(self, **updates: Any) -> dict[str, Any]:
        with self._lock:
            self._data.update(updates)
            self._save()
            return dict(self._data)

    def _save(self) -> None:
        atomic_write_text(self._path, json.dumps(self._data, indent=2))

    def toggle_feature(self, feature: str) -> bool:
        """Flip ``feature``; returns its new state (``toggleFeatureFlag``)."""
        if feature not in BackendFeature.ALL:
            raise ValueError(f"unknown feature flag: {feature}")
        with self._lock:
            features = set(self._data.get("features", []))
            enabled = feature not in features
            (features.add if enabled else features.discard)(feature)
            self._data["features"] = sorted(features)
            self._save()
            return enabled

    def has_feature(self, feature: str) -> bool:
        with self._lock:
            return feature in self._data.get("features", [])
