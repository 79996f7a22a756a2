"""p2p: how nodes find each other, pair libraries, replicate CRDT ops,
share a hasher and move file bytes (a trimmed copy of
``spacedrive_tpu/p2p``, on the same wire).

TCP sessions authenticated with the nodes' ed25519 identities and sealed
with ChaCha20Poly1305 (:mod:`.secure`), multiplexed into substreams
(:mod:`.mux`), one header-tagged exchange each (:mod:`.proto`), served by
the node's :class:`P2PManager` (:mod:`.manager`): pairing
(:mod:`.pairing`), sync sessions (:mod:`.nlm`), spacedrop and delta
spacedrop (:mod:`.spaceblock`, :mod:`.delta`), files and previews for
library members, and the shared hasher service. Peers come from UDP
beacons (:mod:`.discovery`, off unless ``p2p_discovery_port`` is set), the
``p2p_static_peers`` config key or ``p2p.debugConnect``. The accept-layer
throttle and auto-ban, the network fault model and ``H_QUERY`` serving are
not ported.
"""

from .discovery import DiscoveredPeer, Discovery
from .identity import (Identity, RemoteIdentity, decode_identity, encode_identity,
                       remote_identity_of)
from .manager import P2PManager, Peer
from .nlm import NetworkedLibraries
from .pairing import PairingManager
from .proto import Header, Range, SpaceblockRequest

__all__ = [
    "DiscoveredPeer", "Discovery", "Header", "Identity", "NetworkedLibraries",
    "P2PManager", "PairingManager", "Peer", "Range", "RemoteIdentity",
    "SpaceblockRequest", "decode_identity", "encode_identity",
    "remote_identity_of",
]
