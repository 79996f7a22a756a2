"""Root procedures (``spacedrive_tpu/api/routers/root.py``): buildInfo,
nodeState, the invalidation feed and toggleFeatureFlag."""

from __future__ import annotations

from ... import __version__
from ._util import filtered_subscription


def mount(router) -> None:
    @router.query("buildInfo")
    def build_info(node, _arg):
        """Version + commit of the running core."""
        return {"version": __version__, "commit": "dev"}

    @router.query("nodeState")
    def node_state(node, _arg):
        """Node config + data dir + device inventory."""
        cfg = node.config.get()
        return {
            "id": cfg["id"], "name": cfg["name"],
            "data_path": str(node.data_dir),
            "p2p_port": cfg.get("p2p_port"),
            "features": cfg.get("features", []),
            "accelerator": cfg.get("accelerator"),
        }

    @router.subscription("invalidation.listen")
    def invalidation_listen(node, _arg):
        """Stream of invalidate_query events, the frontend cache-refresh
        feed."""
        return filtered_subscription(node, {"invalidate_query"})

    @router.mutation("toggleFeatureFlag")
    def toggle_feature_flag(node, feature: str):
        """Flip a BackendFeature; returns the new enabled state. The sync
        flag turns every open library's emission on or off."""
        from ...config import BackendFeature

        enabled = node.config.toggle_feature(feature)
        if feature == BackendFeature.SYNC_EMIT_MESSAGES:
            for library in node.libraries.list():
                library.sync.emit_messages = enabled
        node.emit("feature_flags", node.config.get().get("features", []))
        return enabled
