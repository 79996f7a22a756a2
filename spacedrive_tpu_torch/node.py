"""Node: the runtime a scan runs in.

Counterpart of ``spacedrive_tpu/node.py`` (``Node`` :75), trimmed to the node
config, the event bus, the libraries under ``<data_dir>/libraries/`` (each
with its sync manager), the node's sync ingest budget (``ingest_budget``,
:107-110), the job manager, the locations actor, the thumbnail remover, the search engine
(armed by ``SD_SEARCH_ENGINE=device``, as in the JAX package), the rspc
router (``node.router``, mounted last, as at :271-273) and the device,
whose kind and count the node records in its config at boot. The boot order is the reference's (:191-199): every job type is
registered, the libraries are swept of stale temporaries and opened, the
locations actor starts, each library's unfinished jobs cold-resume from
their checkpoints (on the node's device: the kernels load from
``_build``), and p2p starts last (``_start_p2p``, :280-296: ``node.p2p``,
a :class:`.p2p.P2PManager` listening on an ephemeral TCP port, unless the
config's ``p2p_enabled`` is false or ``SD_P2P_DISABLED`` is set; a
bring-up failure leaves the node offline, ``node.p2p`` None). :meth:`Node.shutdown` checkpoints the running jobs instead of
waiting for them: call ``jobs.wait_idle`` first to let them finish. ``device`` defaults to the CUDA card and raises
when there is none; ``device="cpu"`` runs the kernels' plain PyTorch
versions. ``mesh_devices`` is the device list a ``tpu-sharded`` location's
mesh spans (``objects.hasher.get_hasher``; default every visible card, or
the node's device on a CPU node). ``key_manager`` (:122-141) is a
:class:`.crypto.KeyManager` on ``<data_dir>/keystore.json``, made before
the jobs cold-resume (a crypto job with a ``key_uuid`` resolves its key
there) and auto-unlocked from the keyring when the keystore asks for it;
without ``cryptography`` it is None, as in the reference.
``dispatch_budget`` (:106-121) is the router's admission at dispatch, a
:class:`.sync.admission.DispatchBudget`, unless ``SD_RSPC_ADMISSION`` is
``0`` or ``off``. ``reader_pool`` (:146-155) is None until the server shell
(or a caller) attaches a :class:`.server.pool.ReaderPool`; shutdown stops
one still attached. ``replica_router`` is a
:class:`.server.replica.ReplicaRouter` over p2p, made after
``_start_p2p`` (:200-204) unless p2p is off or ``SD_REPLICAS=0``.

Telemetry is wired as at :213-259, before the search engine and the
router: the flight recorder's events are bridged onto the node's bus
(``telemetry.event``, which ``telemetry.watch`` and the shell's SSE tail
read), ``alerts`` is an :class:`.telemetry.alerts.AlertEvaluator`
(``SD_ALERT_RULES``, ``SD_ALERT_INTERVAL_S``; a firing edge is a node
notification), ``slo`` an :class:`.telemetry.slo.SloEngine`
(``SD_SLO_OBJECTIVES``, ``SD_SLO_INTERVAL_S``), ``resources`` the
:class:`.telemetry.profiler.ResourceWatcher` (``sd_proc_*`` and the
request p99 gauges) and ``profiler`` the span-tagged
:class:`.telemetry.profiler.SamplingProfiler`, None unless
``SD_PROFILE_HZ`` is set. :meth:`Node.shutdown` stops and joins each of
them, exports the profile under ``<data_dir>/logs/profiles/`` and removes
the event hook (the registry is process-wide; a test boots many nodes).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Any

import torch

from . import resolve_device
from .api.router import mount as api_mount
from .config import NO_ACCELERATOR, ConfigManager
from .events import EventBus
from .jobs import Jobs, register_builtin_jobs
from .library import Libraries
from .locations.manager import LocationsActor
from .objects.gc import ThumbnailRemoverActor
from .objects.hasher import DeviceHasher
from .search.engine import SearchEngine
from .sync.admission import DispatchBudget, IngestBudget

logger = logging.getLogger(__name__)


def _accelerator(device: torch.device) -> dict[str, Any]:
    """The reference's record of its accelerator probe, for the card."""
    if device.type != "cuda":
        return dict(NO_ACCELERATOR)
    n = torch.cuda.device_count()
    return {"kind": torch.cuda.get_device_name(device), "devices": n, "mesh": [n]}


class Node:
    def __init__(self, data_dir: str | Path, device: str | torch.device | None = None,
                 mesh_devices: list | None = None,
                 watch_locations: bool | None = None) -> None:
        self.device = resolve_device(device)
        if watch_locations is None:
            watch_locations = not os.environ.get("SD_NO_WATCHER")
        self.watch_locations = watch_locations
        self.mesh_devices = mesh_devices
        self.sharded_hasher = None  # made at the first tpu-sharded scan
        self.data_dir = Path(data_dir)
        self.data_dir.mkdir(parents=True, exist_ok=True)
        self.config = ConfigManager(self.data_dir)
        self.config.write(accelerator=_accelerator(self.device))
        self.p2p = None
        self.events = EventBus()
        # every ingest source of the node admits through it
        self.ingest_budget = IngestBudget()
        # admission at rspc dispatch: over-budget dispatches shed with 429
        self.dispatch_budget = (
            DispatchBudget() if os.environ.get("SD_RSPC_ADMISSION", "1") not in ("0", "off")
            else None)
        # the serving tier's remote rungs: a reader pool is attached by the
        # server shell, the replica router once p2p is up
        self.reader_pool = None
        self.replica_router = None
        self.hasher = DeviceHasher(self.device)
        self.jobs = Jobs()
        self.libraries = Libraries(self.data_dir, node=self)
        self.thumbnail_remover = ThumbnailRemoverActor(self)
        self.search_engine = None
        self.key_manager = self._start_key_manager()
        register_builtin_jobs()  # every job type, before a cold resume looks one up
        self.libraries.init()
        self.locations = LocationsActor(self)
        for library in self.libraries.list():
            revived = self.jobs.cold_resume(library)
            if revived:
                logger.info("cold-resumed %d jobs of library %s", revived, library.id[:8])
        self._start_telemetry()
        self.search_engine = SearchEngine.maybe_start(self)
        self.router = api_mount(self)
        self._start_p2p()
        if self.p2p is not None:
            from .server.replica import ReplicaRouter

            self.replica_router = ReplicaRouter.maybe_start(self)
        logger.info("node %s up on %s", self.config.get()["id"][:8], self.device)

    def _start_telemetry(self) -> None:
        """The event bridge, the alert evaluator, the SLO engine, the
        resource watcher and the sampling profiler (off unless
        ``SD_PROFILE_HZ`` is set)."""
        from . import telemetry
        from .notifications import emit_node_notification
        from .telemetry.alerts import AlertEvaluator
        from .telemetry.profiler import ResourceWatcher, SamplingProfiler
        from .telemetry.slo import SloEngine

        def _telemetry_event_hook(record: dict, _emit=self.events.emit_kind) -> None:
            _emit("telemetry.event", record)

        self._telemetry_event_hook = _telemetry_event_hook
        telemetry.add_event_hook(_telemetry_event_hook)

        def _alert_notify(rule, firing: bool, value) -> None:
            if not firing:
                return  # the resolved edge stays in the event ring
            emit_node_notification(self, {
                "type": "alert", "rule": rule.name, "series": rule.series,
                "severity": rule.severity, "value": value,
                "description": rule.description})

        self.alerts = AlertEvaluator(
            interval_s=float(os.environ.get("SD_ALERT_INTERVAL_S", "5")),
            notify=_alert_notify).start()
        self.slo = SloEngine(
            interval_s=float(os.environ.get("SD_SLO_INTERVAL_S", "5"))).start()
        self.resources = ResourceWatcher().start()
        self.profiler = SamplingProfiler().start()

    def _start_key_manager(self):
        """The keystore's manager, auto-unlocked where the keystore enabled
        it; None without the crypto dependencies."""
        try:
            from .crypto.keymanager import KeyManager

            km = KeyManager(self.data_dir / "keystore.json")
        except ImportError as e:
            logger.warning("crypto stack unavailable (%s); key manager disabled", e)
            return None
        try:
            if km.try_auto_unlock():
                logger.info("key manager auto-unlocked from the keyring")
        except Exception:
            logger.exception("keyring auto-unlock failed; password unlock still available")
        return km

    def _start_p2p(self) -> None:
        """Start the p2p control plane, last in the boot."""
        cfg = self.config.get()
        if not cfg.get("p2p_enabled", True) or os.environ.get("SD_P2P_DISABLED"):
            return
        try:
            from .p2p.manager import P2PManager

            self.p2p = P2PManager(self)
            self.p2p.start()
        except Exception:
            logger.exception("p2p failed to start; the node stays offline")
            self.p2p = None

    def emit(self, kind: str, payload: Any = None, library_id: str | None = None) -> None:
        self.events.emit_kind(kind, payload, library_id)

    def shutdown(self) -> None:
        """Stop the search engine, checkpoint the running jobs (each pauses
        at its last committed step or group; cold resume revives it at the
        next boot), stop the watchers, p2p and the actors, close the
        databases. A reader pool still attached is stopped first; the
        telemetry tickers stop and join after the jobs."""
        if self.reader_pool is not None:
            self.reader_pool.stop()
            self.reader_pool = None
        if self.search_engine is not None:
            self.search_engine.stop()
        self.jobs.shutdown()
        from . import telemetry

        self.alerts.stop()
        self.slo.stop()
        self.resources.stop()
        if self.profiler is not None:
            self.profiler.stop()
            self.profiler.export(self.data_dir)
        telemetry.remove_event_hook(self._telemetry_event_hook)
        self.locations.stop()
        if self.p2p is not None:
            self.p2p.stop()
        self.thumbnail_remover.stop()
        self.libraries.close()
