"""A port Node that a fault plan kills mid-identify.

Run by ``tests/test_torch_job_resume.py`` and ``tests/test_torch_on_card.py``
as a child process (no jax)::

    python tests/torch_kill_child.py <data_dir> <tree> <fault spec> <batch> <group> [device]

It boots ``Node(data_dir, device=device, watch_locations=False)``
(``cpu`` by default; the on-card test passes ``cuda``), indexes ``tree``
into a new library, plants a stale ``*.sd-tmp`` file in the node's thumbnail cache,
arms ``<fault spec>`` (a ``kill`` rule) and identifies the location with
``<batch>``-file pages and ``<group>``-page commit groups. The armed seam
SIGKILLs the process mid-identify; if it never fires, the child exits 3.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    data_dir, tree, spec, batch, group = sys.argv[1:6]
    device = sys.argv[6] if len(sys.argv) > 6 else "cpu"
    os.environ["SD_COMMIT_GROUP"] = group
    os.environ["SD_SCAN_SHARDS"] = "1"
    from spacedrive_tpu_torch import faults
    from spacedrive_tpu_torch.locations import create_location
    from spacedrive_tpu_torch.locations.indexer_job import IndexerJob
    from spacedrive_tpu_torch.node import Node
    from spacedrive_tpu_torch.objects import file_identifier as fi

    fi.BATCH_SIZE = int(batch)
    node = Node(data_dir, device=device, watch_locations=False)
    lib = node.libraries.create("kill")
    loc_id = create_location(lib, tree)["id"]
    node.jobs.spawn(lib, [IndexerJob({"location_id": loc_id})])
    assert node.jobs.wait_idle(120)
    stale = Path(data_dir) / "thumbnails" / "ab" / "abcdef.webp.sd-tmp.1234abcd"
    stale.parent.mkdir(parents=True, exist_ok=True)
    stale.write_bytes(b"half a thumbnail")
    faults.install(spec)
    node.jobs.spawn(lib, [fi.FileIdentifierJob({"location_id": loc_id})])
    node.jobs.wait_idle(120)
    node.shutdown()
    return 3  # the kill never fired


if __name__ == "__main__":
    sys.exit(main())
