"""Ingest admission budget, as ``sync.fleetStatus`` reports it.

A trimmed copy of ``spacedrive_tpu/sync/admission.py``, cut to the
:class:`IngestBudget`'s bounds and its status (``node.ingest_budget``).
The reference's ``try_admit`` with its ``Admission`` and ``Busy`` verdicts
is called by the p2p sessions and the replica tier only, neither of which
is ported, so nothing here admits or sheds a window: the in-flight and
shed counters stay at zero. ``DispatchBudget`` is not ported either.
"""

from __future__ import annotations

#: the reference's default bounds: ops admitted but not yet durable across
#: all peers (about four production pull windows), and bytes sized for
#: JSON-framed windows
DEFAULT_BUDGET_OPS = 4000
DEFAULT_BUDGET_BYTES = 32 * 1024 * 1024


class IngestBudget:
    """The node-wide bound on (ops, bytes) in flight across every ingest
    source."""

    def __init__(self, max_ops: int = DEFAULT_BUDGET_OPS,
                 max_bytes: int = DEFAULT_BUDGET_BYTES) -> None:
        self.max_ops = max(1, int(max_ops))
        self.max_bytes = max(1, int(max_bytes))

    def status(self) -> dict:
        """The budget as ``sync.fleetStatus`` reports it."""
        return {
            "budget_ops": self.max_ops,
            "budget_bytes": self.max_bytes,
            "ops_in_flight": 0,
            "bytes_in_flight": 0,
            "peers_in_flight": 0,
            "shed_windows": 0,
            "shed_ops": 0,
        }
