"""backups.* procedures (``spacedrive_tpu/api/routers/backups.py``): getAll,
backup, restore, delete."""

from __future__ import annotations

from ...backups import delete_backup, do_backup, do_restore, list_backups


def mount(router) -> None:
    @router.query("backups.getAll")
    def get_all(node, _arg):
        return {"backups": list_backups(node), "directory": str(node.data_dir / "backups")}

    @router.mutation("backups.backup")
    def backup(node, library_id: str):
        return do_backup(node, library_id)

    @router.mutation("backups.restore")
    def restore(node, backup_path: str):
        return do_restore(node, backup_path)

    @router.mutation("backups.delete")
    def delete(node, backup_id: str):
        delete_backup(node, backup_id)
        return None
