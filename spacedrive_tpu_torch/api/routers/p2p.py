"""p2p.* procedures (``spacedrive_tpu/api/routers/p2p.py``): the events
subscription, the NLM state, the peers and this node's address card,
spacedrop (plain and delta) with accept and cancel, pairing and its
response, and ``debugConnect`` (a direct ``host:port`` handshake, the
static-peer path). A node whose p2p is off answers the mutations and
``p2p.identity`` with a 503 ApiError, as a build without p2p does."""

from __future__ import annotations

from ..router import ApiError
from ._util import filtered_subscription


def _p2p(node):
    p2p = getattr(node, "p2p", None)
    if p2p is None:
        raise ApiError("p2p is not running", code=503)
    return p2p


def mount(router) -> None:
    @router.subscription("p2p.events")
    def events(node, _arg):
        return filtered_subscription(node, {"p2p"})

    @router.query("p2p.nlmState")
    def nlm_state(node, _arg):
        p2p = getattr(node, "p2p", None)
        return {} if p2p is None else p2p.nlm_state()

    @router.query("p2p.peers")
    def peers(node, _arg):
        """Known and connected peers with their metadata (the accelerator
        record included: what the remote hasher routes by)."""
        p2p = getattr(node, "p2p", None)
        return [] if p2p is None else p2p.peer_list()

    @router.query("p2p.identity")
    def identity(node, _arg):
        """This node's public identity and listen port."""
        p2p = _p2p(node)
        return {"identity": p2p.remote_identity.encode(), "port": p2p.port}

    @router.mutation("p2p.spacedrop")
    def spacedrop(node, arg):
        return _p2p(node).spacedrop(arg["peer_id"], arg["paths"])

    @router.mutation("p2p.spacedropDelta")
    def spacedrop_delta(node, arg):
        """A drop that ships only the chunks the receiver lacks."""
        return _p2p(node).spacedrop_delta(arg["peer_id"], arg["paths"])

    @router.mutation("p2p.acceptSpacedrop")
    def accept_spacedrop(node, arg):
        """A ``target_dir`` of None declines the drop."""
        try:
            _p2p(node).accept_spacedrop(arg["id"], arg.get("target_dir"))
        except KeyError as e:
            raise ApiError(str(e), code=404) from e
        return None

    @router.mutation("p2p.cancelSpacedrop")
    def cancel_spacedrop(node, arg):
        _p2p(node).cancel_spacedrop(arg["id"])
        return None

    @router.mutation("p2p.pair")
    def pair(node, arg):
        return _p2p(node).pair(arg["peer_id"])

    @router.mutation("p2p.pairingResponse")
    def pairing_response(node, arg):
        try:
            _p2p(node).pairing_response(arg["pairing_id"], arg["decision"])
        except KeyError as e:
            raise ApiError(str(e), code=404) from e
        return None

    @router.mutation("p2p.debugConnect")
    def debug_connect(node, arg):
        """Handshake ``addr`` (``host:port``); returns the peer's identity."""
        p2p = _p2p(node)

        async def _connect():
            _reader, writer, meta = await p2p.open_stream(arg["addr"])
            writer.close()
            return meta["identity"]

        return p2p.run_coro(_connect(), timeout=30)
