"""Volume enumeration: mounted disks with capacity and SSD/HDD kind.

Counterpart of ``spacedrive_tpu/volumes.py``: ``/proc/mounts`` parsed,
``statvfs`` for capacity, ``/sys/block/<dev>/queue/rotational`` for the
disk's kind; pseudo filesystems are skipped.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any

_PSEUDO_FS = {
    "proc", "sysfs", "devtmpfs", "devpts", "tmpfs", "cgroup", "cgroup2",
    "securityfs", "pstore", "efivarfs", "bpf", "debugfs", "tracefs",
    "fusectl", "configfs", "ramfs", "autofs", "mqueue", "hugetlbfs",
    "binfmt_misc", "overlay", "squashfs", "nsfs", "rpc_pipefs", "fuse.lxcfs",
}


def _disk_kind(device: str) -> str:
    """SSD | HDD | Unknown, from the block queue's rotational flag."""
    name = os.path.basename(device)
    # partition suffixes: sda1 -> sda, nvme0n1p2 -> nvme0n1
    for candidate in (name, name.rstrip("0123456789"),
                      name.split("p")[0] if "p" in name else name):
        rot = Path(f"/sys/block/{candidate}/queue/rotational")
        if rot.exists():
            try:
                return "HDD" if rot.read_text().strip() == "1" else "SSD"
            except OSError:
                return "Unknown"
    return "Unknown"


def get_volumes() -> list[dict[str, Any]]:
    volumes: list[dict[str, Any]] = []
    seen_mounts: set[str] = set()
    try:
        with open("/proc/mounts") as fh:
            lines = fh.readlines()
    except OSError:
        lines = []
    for line in lines:
        parts = line.split()
        if len(parts) < 3:
            continue
        device, mount_point, fs_type = parts[0], parts[1], parts[2]
        if fs_type in _PSEUDO_FS or not device.startswith("/"):
            continue
        mount_point = mount_point.replace("\\040", " ")
        if mount_point in seen_mounts:
            continue
        seen_mounts.add(mount_point)
        try:
            st = os.statvfs(mount_point)
        except OSError:
            continue
        volumes.append({
            "name": os.path.basename(mount_point) or mount_point,
            "mount_point": mount_point,
            "file_system": fs_type,
            "total_capacity": st.f_blocks * st.f_frsize,
            "available_capacity": st.f_bavail * st.f_frsize,
            "disk_type": _disk_kind(device),
            "is_root_filesystem": mount_point == "/",
        })
    if not volumes:  # no visible mounts (a container): the root filesystem
        st = os.statvfs("/")
        volumes.append({
            "name": "/", "mount_point": "/", "file_system": "unknown",
            "total_capacity": st.f_blocks * st.f_frsize,
            "available_capacity": st.f_bavail * st.f_frsize,
            "disk_type": "Unknown", "is_root_filesystem": True,
        })
    return volumes


def volume_for_path(path: str | Path) -> dict[str, Any] | None:
    """The volume of the longest mounted prefix of ``path``."""
    path = str(Path(path).resolve())
    best = None
    for vol in get_volumes():
        mp = vol["mount_point"]
        if path == mp or path.startswith(mp.rstrip("/") + "/") or mp == "/":
            if best is None or len(mp) > len(best["mount_point"]):
                best = vol
    return best
