"""Node configuration (trimmed).

Counterpart of ``spacedrive_tpu/config.py``: a versioned JSON file,
``node_state.sdconfig`` in the data dir, holding the node's identity and
name. p2p keys, feature flags and the accelerator inventory are not ported.
"""

from __future__ import annotations

import json
import os
import uuid
from pathlib import Path
from typing import Any

VERSION = 1
FILENAME = "node_state.sdconfig"


def load_node_config(data_dir: str | Path) -> dict[str, Any]:
    """Read the node config, creating it with defaults on first boot."""
    path = Path(data_dir) / FILENAME
    if path.exists():
        return json.loads(path.read_text())
    config = {"version": VERSION, "id": str(uuid.uuid4()),
              "name": os.uname().nodename if hasattr(os, "uname") else "spacedrive"}
    path.write_text(json.dumps(config, indent=2))
    return config
