"""Pairing: the originator/responder exchange that mirrors a library to a
peer.

A copy of ``spacedrive_tpu/p2p/pairing.py``, on the same wire:

- the originator mints a fresh ed25519 instance identity and pub_id, sends
  ``Header::Pair`` and a request carrying that instance's row (its public
  half only), and waits;
- the responder asks for a decision (``p2p.pairingResponse``; a node with
  ``p2p_auto_accept_library`` in its config answers with that library
  without asking), inserts the originator's instance into the library,
  with the handshake-proven node identity as its ``node_remote_identity``
  (the membership anchor), and answers with the library's name and every
  instance row it knows;
- the originator creates the mirror under the same uuid, holding its
  private identity, registers the other instances, and both sides start a
  sync session (:mod:`.nlm`) so the op logs converge.

``PairingProgress`` events go out on the node's ``p2p`` event stream.
"""

from __future__ import annotations

import asyncio
import datetime as dt
import itertools
import logging
import uuid
from typing import TYPE_CHECKING, Any

from .identity import Identity, encode_identity, remote_identity_of
from .proto import Header, json_frame, read_json

if TYPE_CHECKING:
    from .manager import P2PManager, Peer

logger = logging.getLogger(__name__)

DECISION_TIMEOUT = 60.0
RESPONSE_TIMEOUT = 120.0
#: how long the responder waits before its first push to the new mirror
ORIGINATE_DELAY_S = 0.5


def _iso(v: Any) -> Any:
    return v.isoformat() if isinstance(v, dt.datetime) else v


def _instance_wire(row: dict[str, Any]) -> dict[str, Any]:
    """Instance row → wire form; the identity crosses as its public half."""
    ident = remote_identity_of(row["identity"])
    return {"pub_id": row["pub_id"], "identity": "R:" + ident.encode(),
            "node_remote_identity": row.get("node_remote_identity"),
            "node_id": row["node_id"], "node_name": row["node_name"],
            "node_platform": row["node_platform"],
            "last_seen": _iso(row["last_seen"]), "date_created": _iso(row["date_created"])}


def _parse_instance(inst: dict[str, Any]) -> dict[str, Any]:
    row = dict(inst)
    for key in ("last_seen", "date_created"):
        if isinstance(row.get(key), str):
            row[key] = dt.datetime.fromisoformat(row[key])
    row.setdefault("timestamp", 0)
    return row


class PairingManager:
    def __init__(self, manager: "P2PManager") -> None:
        self.manager = manager
        self._ids = itertools.count(0)
        self._pending: dict[int, asyncio.Future] = {}

    def _emit(self, pairing_id: int, status: Any) -> None:
        self.manager.emit({"type": "PairingProgress", "id": pairing_id, "status": status})

    def decision(self, pairing_id: int, decision: Any) -> None:
        """The answer to a pending request: ``{"accept": library_id}``, or
        anything else to reject."""
        fut = self._pending.pop(pairing_id, None)
        if fut is None:
            raise KeyError(f"no pending pairing {pairing_id}")
        self.manager._loop.call_soon_threadsafe(lambda: fut.done() or fut.set_result(decision))

    # -- originator ----------------------------------------------------------
    def originator(self, peer_id: str) -> int:
        pairing_id = next(self._ids)
        self._emit(pairing_id, "EstablishingConnection")
        self.manager.schedule(self._originator(pairing_id, peer_id))
        return pairing_id

    async def _originator(self, pairing_id: int, peer_id: str) -> None:
        node = self.manager.node
        try:
            reader, writer, _meta = await self.manager.open_stream(peer_id)
        except (OSError, KeyError, asyncio.TimeoutError) as e:
            self._emit(pairing_id, {"Error": f"connect failed: {e}"})
            return
        try:
            writer.write(Header.pair().to_bytes())
            identity = Identity()
            instance_pub_id = str(uuid.uuid4())
            cfg = node.config.get()
            now = dt.datetime.now(dt.timezone.utc).isoformat()
            self._emit(pairing_id, "PairingRequested")
            writer.write(json_frame({"instance": {
                "pub_id": instance_pub_id,
                "identity": "R:" + identity.to_remote_identity().encode(),
                "node_id": cfg["id"], "node_name": cfg["name"],
                "node_platform": cfg.get("platform", 0),
                "last_seen": now, "date_created": now}}))
            await writer.drain()

            resp = await asyncio.wait_for(read_json(reader), RESPONSE_TIMEOUT)
            if resp.get("decision") != "accepted":
                self._emit(pairing_id, "PairingRejected")
                return
            library_id = resp["library_id"]
            self._emit(pairing_id, {"PairingInProgress": {
                "library_name": resp["library_name"],
                "library_description": resp.get("library_description", "")}})
            if any(lib.id == library_id for lib in node.libraries.list()):
                self._emit(pairing_id, "LibraryAlreadyExists")
                return
            loop = asyncio.get_running_loop()
            library = await loop.run_in_executor(None, lambda: node.libraries.create(
                resp["library_name"], description=resp.get("library_description", ""),
                lib_id=library_id, instance_pub_id=instance_pub_id,
                instance_identity=encode_identity(identity)))
            for inst in resp.get("instances", []):
                if inst["pub_id"] == instance_pub_id:
                    continue
                await loop.run_in_executor(None, library.add_remote_instance,
                                           _parse_instance(inst))
            await loop.run_in_executor(None, node.libraries.notify_instances_modified, library)
            self._emit(pairing_id, {"PairingComplete": library_id})
            # announce this (empty) mirror: the responder learns the
            # instance is live, and its own push brings the data back
            await self.manager.nlm.originate(library)
        except (OSError, asyncio.TimeoutError) as e:
            self._emit(pairing_id, {"Error": str(e)})
        finally:
            writer.close()

    # -- responder -----------------------------------------------------------
    async def responder(self, reader, writer, peer: "Peer") -> None:
        node = self.manager.node
        req = await read_json(reader)
        inst = req["instance"]
        pairing_id = next(self._ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[pairing_id] = fut
        self.manager.emit({"type": "PairingRequest", "id": pairing_id,
                           "identity": peer.identity, "name": inst.get("node_name", "?")})
        auto = node.config.get().get("p2p_auto_accept_library")
        if auto:
            fut.set_result({"accept": auto})
        try:
            decision = await asyncio.wait_for(fut, DECISION_TIMEOUT)
        except asyncio.TimeoutError:
            decision = None
        finally:
            self._pending.pop(pairing_id, None)
        library_id = decision.get("accept") if isinstance(decision, dict) else None
        if not library_id:
            writer.write(json_frame({"decision": "rejected"}))
            await writer.drain()
            self._emit(pairing_id, "PairingRejected")
            return
        try:
            library = node.libraries.get(library_id)
        except KeyError:
            writer.write(json_frame({"decision": "rejected"}))
            await writer.drain()
            self._emit(pairing_id, {"Error": f"library {library_id} not loaded"})
            return
        loop = asyncio.get_running_loop()
        row = _parse_instance(inst)
        # the membership anchor is the handshake-proven node identity
        row["node_remote_identity"] = peer.identity
        await loop.run_in_executor(None, library.add_remote_instance, row)
        await loop.run_in_executor(None, node.libraries.notify_instances_modified, library)
        from ..models import Instance

        instances = []
        for r in await loop.run_in_executor(None, library.db.find, Instance):
            try:
                instances.append(_instance_wire(r))
            except ValueError:
                continue  # a placeholder identity
        writer.write(json_frame({
            "decision": "accepted", "library_id": library.id, "library_name": library.name,
            "library_description": library.description, "instances": instances}))
        await writer.drain()
        self._emit(pairing_id, {"PairingComplete": library.id})
        self.manager.schedule(self._originate_soon(library))

    async def _originate_soon(self, library) -> None:
        await asyncio.sleep(ORIGINATE_DELAY_S)  # the originator makes its mirror
        await self.manager.nlm.originate(library)
