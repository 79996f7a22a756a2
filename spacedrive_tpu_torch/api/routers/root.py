"""Root procedures (``spacedrive_tpu/api/routers/root.py``): buildInfo,
nodeState and the invalidation feed. ``toggleFeatureFlag`` is not ported:
the port's node config holds no feature flags."""

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
