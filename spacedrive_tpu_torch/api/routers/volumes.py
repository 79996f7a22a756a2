"""volumes.list (``spacedrive_tpu/api/routers/volumes.py``)."""

from __future__ import annotations

from ...volumes import get_volumes


def mount(router) -> None:
    @router.query("volumes.list")
    def list_volumes(node, _arg):
        return get_volumes()
