"""Headless server shell (the reference's apps/server).

``python -m spacedrive_tpu_torch.server --data-dir DIR --port N`` boots a
Node on the card (``--device cpu`` for the plain versions) and serves
/health, /rspc (HTTP and websocket JSON-RPC), /schema, and the /spacedrive
file and thumbnail routes.
"""

from .shell import Server

__all__ = ["Server"]
