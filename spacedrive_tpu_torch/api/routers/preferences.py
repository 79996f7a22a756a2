"""preferences.{get,update} (``spacedrive_tpu/api/routers/preferences.py``)."""

from __future__ import annotations

from ...preferences import get_preferences, update_preferences


def mount(router) -> None:
    @router.library_query("preferences.get", pool=True)
    def get(node, library, _arg):
        return get_preferences(library)

    @router.library_mutation("preferences.update")
    def update(node, library, tree):
        update_preferences(library, tree or {})
        return None
