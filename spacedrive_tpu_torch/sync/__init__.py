"""CRDT sync (a trimmed copy of ``spacedrive_tpu/sync``).

HLC-ordered per-field last-write-wins replication of library state: the
operation factories and their atomic emission into the op log
(:mod:`.manager`), the annotation-driven applier (:mod:`.apply`), the
ingester with stale-op rejection and the pull :class:`Actor`
(:mod:`.ingest`), the partitioned ingest lanes (:mod:`.lanes`) and the
node's ingest budget (:mod:`.admission`). The transport is a seam: a
direct call to the peer library's ``sync.get_ops``, as in the JAX
package's two-instance tests, or the network, where the p2p sync sessions
(:mod:`..p2p.nlm`) pull the same windows over the wire and admit each
through the budget.
"""

from .admission import IngestBudget
from .crdt import CREATE, DELETE, UPDATE_PREFIX, CRDTOperation, RelationOp, SharedOp, ref
from .hlc import HLC, ntp64
from .ingest import Actor, Ingester
from .lanes import IngestLanes, get_lane_pool, lane_count
from .manager import SyncManager, SyncMessage, emitter

__all__ = [
    "CREATE", "DELETE", "UPDATE_PREFIX", "CRDTOperation", "RelationOp",
    "SharedOp", "ref", "HLC", "ntp64", "Actor", "Ingester",
    "IngestBudget", "IngestLanes", "SyncManager", "SyncMessage",
    "emitter", "get_lane_pool", "lane_count",
]
