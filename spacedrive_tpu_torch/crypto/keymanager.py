"""Key manager: a root key unlocked by a master password, guarding stored keys.

Counterpart of ``spacedrive_tpu/crypto/keymanager.py``, on the same
keystore file (JSON: ``root_slot``, ``keys``, ``default``,
``auto_unlock``, ``auto_unlock_check``). ``setup(password)`` makes a random
root key and seals it into a keyslot-shaped record; ``unlock`` opens it.
Stored keys are random 32-byte keys sealed under the root key; ``mount``
opens one for the crypto jobs, ``unmount`` drops it. Keys flagged
automount mount at every unlock. Nothing secret reaches the disk unsealed.

Writers snapshot the store under the state lock and persist after
releasing it (:meth:`KeyManager._snapshot`, :meth:`KeyManager._persist`):
a job that mounts a key never waits on the keystore's disk write, and a
version gate keeps a late, stale snapshot from overwriting a newer one.
"""


from __future__ import annotations

import base64
import json
import threading
import uuid as uuid_mod
from pathlib import Path

from .hashing import HashingAlgorithm
from .header import Keyslot
from .primitives import Protected, generate_master_key
from .stream import Algorithm, CryptoError, Decryptor, Encryptor


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode())


def _slot_to_json(slot: Keyslot) -> dict:
    return {
        "version": slot.version,
        "algorithm": slot.algorithm.value,
        "hashing": _b64(slot.hashing_algorithm.encode()),
        "salt": _b64(slot.salt),
        "content_salt": _b64(slot.content_salt),
        "master_key": _b64(slot.master_key),
        "nonce": _b64(slot.nonce),
    }


def _slot_from_json(obj: dict) -> Keyslot:
    return Keyslot(
        version=obj["version"],
        algorithm=Algorithm(obj["algorithm"]),
        hashing_algorithm=HashingAlgorithm.decode(_unb64(obj["hashing"])),
        salt=_unb64(obj["salt"]),
        content_salt=_unb64(obj["content_salt"]),
        master_key=_unb64(obj["master_key"]),
        nonce=_unb64(obj["nonce"]),
    )


class KeyManagerError(Exception):
    pass


class KeyManager:
    def __init__(self, store_path: str | Path) -> None:
        self.store_path = Path(store_path)
        self._lock = threading.RLock()
        self._root: Protected | None = None
        self._mounted: dict[str, Protected] = {}
        self._store = self._load()
        # persistence runs OUTSIDE self._lock (mount/get_key on the
        # encrypt/decrypt job path must never wait on keystore disk
        # I/O); the save lock only orders writers, and the version gate
        # keeps a stale snapshot from clobbering a newer one on disk
        self._save_lock = threading.Lock()
        self._store_version = 0
        self._saved_version = 0

    # -- persistence ---------------------------------------------------------
    def _load(self) -> dict:
        if self.store_path.exists():
            try:
                return json.loads(self.store_path.read_text())
            except (OSError, json.JSONDecodeError):
                pass
        return {"root_slot": None, "keys": {}, "default": None}

    def _snapshot(self) -> tuple[int, str]:
        """Serialize the store (call under ``self._lock``); hand the
        result to :meth:`_persist` AFTER releasing the lock."""
        self._store_version += 1
        return self._store_version, json.dumps(self._store, indent=1)

    def _persist(self, snap: tuple[int, str]) -> None:
        version, payload = snap
        with self._save_lock:
            if version <= self._saved_version:
                return  # a newer snapshot already reached disk
            self.store_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.store_path.with_suffix(".tmp")
            # the one write under a lock: _save_lock only orders writers
            tmp.write_text(payload)
            tmp.replace(self.store_path)
            self._saved_version = version

    # -- lifecycle -----------------------------------------------------------
    @property
    def is_setup(self) -> bool:
        return self._store.get("root_slot") is not None

    @property
    def is_unlocked(self) -> bool:
        return self._root is not None

    def setup(self, master_password: str | Protected) -> None:
        with self._lock:
            if self.is_setup:
                raise KeyManagerError("key manager is already set up")
            pw = master_password if isinstance(master_password, Protected) \
                else Protected(master_password)
            root = generate_master_key()
            slot = Keyslot.new(Algorithm.XCHACHA20_POLY1305,
                               HashingAlgorithm.argon2id(), pw, root)
            self._store["root_slot"] = _slot_to_json(slot)
            self._root = root
            snap = self._snapshot()
        self._persist(snap)

    def unlock(self, master_password: str | Protected) -> None:
        with self._lock:
            if not self.is_setup:
                raise KeyManagerError("key manager is not set up")
            pw = master_password if isinstance(master_password, Protected) \
                else Protected(master_password)
            slot = _slot_from_json(self._store["root_slot"])
            try:
                self._root = slot.unseal(pw)
            except CryptoError as e:
                raise KeyManagerError("incorrect master password") from e
            # automount: flagged keys mount as soon as the manager unlocks
            self._automount()

    def change_master_password(self, current: str | Protected,
                               new: str | Protected) -> None:
        """Re-seal the root key under a new master password. Stored keys
        stay as they are: the root key they are sealed under does not
        change."""
        with self._lock:
            self.unlock(current)  # verifies `current`, sets self._root
            pw = new if isinstance(new, Protected) else Protected(new)
            slot = Keyslot.new(Algorithm.XCHACHA20_POLY1305,
                               HashingAlgorithm.argon2id(), pw, self._root)
            self._store["root_slot"] = _slot_to_json(slot)
            snap = self._snapshot()
        self._persist(snap)

    def clear_master_password(self) -> None:
        """Drop the in-memory root key WITHOUT unmounting keys: already-
        mounted keys keep working, but nothing new can be unsealed until
        the next unlock."""
        with self._lock:
            if self._root is not None:
                self._root.zeroize()
            self._root = None

    def lock(self) -> None:
        with self._lock:
            if self._root is not None:
                self._root.zeroize()
            self._root = None
            for key in self._mounted.values():
                key.zeroize()
            self._mounted.clear()

    # -- keyring auto-unlock -------------------------------------------------
    def _keyring_account(self) -> str:
        import hashlib

        tag = hashlib.sha256(str(self.store_path).encode()).hexdigest()[:16]
        return f"km-root:{tag}"

    def _default_keyring(self):
        from .keyring import default_store

        return default_store(self.store_path.parent)

    def _recorded_keyring(self):
        """The backend RECORDED at enable time — disable/try must talk to
        the store that actually holds the secret, not whatever
        default_store() resolves to today (backend availability can flip
        between runs: seccomp, containers)."""
        from .keyring import FileSecretStore, KernelKeyringStore

        name = self._store.get("auto_unlock")
        if name == "kernel-keyring":
            return KernelKeyringStore()
        if name == "file":
            return FileSecretStore(self.store_path.parent / "keyring.json")
        return self._default_keyring()

    def enable_auto_unlock(self, store=None) -> str:
        """Park the root secret in a secret store (:mod:`.keyring`) so this
        keystore unlocks across process restarts without the master
        password and with no plaintext on disk. Returns the store's name."""
        import hashlib

        with self._lock:
            root = self._require_root()
            store = store or self._default_keyring()
            store.set(self._keyring_account(), root.expose())
            self._store["auto_unlock"] = store.name
            # check value: a stale/foreign keyring entry must never be
            # installed as the root (preimage-resistant, reveals nothing
            # about the random 256-bit key)
            self._store["auto_unlock_check"] = hashlib.sha256(
                b"sd-km-check|" + root.expose()).hexdigest()
            name = store.name
            snap = self._snapshot()
        self._persist(snap)
        return name

    def disable_auto_unlock(self, store=None) -> None:
        with self._lock:
            store = store or self._recorded_keyring()
            store.delete(self._keyring_account())
            self._store.pop("auto_unlock", None)
            self._store.pop("auto_unlock_check", None)
            snap = self._snapshot()
        self._persist(snap)

    def try_auto_unlock(self, store=None) -> bool:
        """Unlock from the secret store when enabled; False when the store
        has no (or a stale) secret — the password path still works."""
        with self._lock:
            if not self.is_setup or self.is_unlocked \
                    or not self._store.get("auto_unlock"):
                return False
            import hashlib

            store = store or self._recorded_keyring()
            secret = store.get(self._keyring_account())
            if not secret:
                return False
            check = hashlib.sha256(b"sd-km-check|" + secret).hexdigest()
            if check != self._store.get("auto_unlock_check"):
                return False  # stale/foreign entry: never install it
            self._root = Protected(secret)
            self._automount()
            return True

    def _automount(self) -> None:
        import logging

        for kid, rec in self._store["keys"].items():
            if rec.get("automount"):
                try:
                    self.mount(kid)
                except Exception:
                    # one corrupt key record (truncated base64, bad AEAD
                    # tag) must not make unlock itself fail
                    logging.getLogger(__name__).warning(
                        "automount failed for key %s", kid, exc_info=True)

    def _require_root(self) -> Protected:
        if self._root is None:
            raise KeyManagerError("key manager is locked")
        return self._root

    # -- stored keys ---------------------------------------------------------
    def add_key(self, name: str = "") -> str:
        """Create + persist a new random key sealed under the root key;
        returns its uuid (auto-mounted)."""
        with self._lock:
            root = self._require_root()
            key = generate_master_key()
            algorithm = Algorithm.XCHACHA20_POLY1305
            nonce = algorithm.generate_nonce()
            sealed = Encryptor.encrypt_bytes(root, nonce, algorithm, key.expose())
            kid = str(uuid_mod.uuid4())
            self._store["keys"][kid] = {
                "name": name, "algorithm": algorithm.value,
                "nonce": _b64(nonce), "key": _b64(sealed),
            }
            self._mounted[kid] = key
            snap = self._snapshot()
        self._persist(snap)
        return kid

    def mount(self, kid: str) -> None:
        with self._lock:
            root = self._require_root()
            rec = self._store["keys"].get(kid)
            if rec is None:
                raise KeyManagerError(f"no stored key {kid}")
            if kid in self._mounted:
                return
            self._mounted[kid] = Decryptor.decrypt_bytes(
                root, _unb64(rec["nonce"]), Algorithm(rec["algorithm"]),
                _unb64(rec["key"]))

    def unmount(self, kid: str) -> None:
        with self._lock:
            key = self._mounted.pop(kid, None)
            if key is not None:
                key.zeroize()

    def get_key(self, kid: str) -> Protected:
        with self._lock:
            if kid not in self._mounted:
                self.mount(kid)
            return self._mounted[kid]

    def delete_key(self, kid: str) -> None:
        with self._lock:
            self.unmount(kid)
            self._store["keys"].pop(kid, None)
            snap = self._snapshot()
        self._persist(snap)

    def unmount_all(self) -> int:
        with self._lock:
            n = len(self._mounted)
            for key in self._mounted.values():
                key.zeroize()
            self._mounted.clear()
            return n

    def list_keys(self) -> list[dict]:
        with self._lock:
            return [{"uuid": kid, "name": rec.get("name", ""),
                     "mounted": kid in self._mounted,
                     "automount": bool(rec.get("automount")),
                     "default": kid == self._store.get("default")}
                    for kid, rec in self._store["keys"].items()]

    def list_mounted(self) -> list[str]:
        with self._lock:
            return list(self._mounted)

    # -- default key / automount --------------------------------------------
    def set_default(self, kid: str) -> None:
        with self._lock:
            if kid not in self._store["keys"]:
                raise KeyManagerError(f"no stored key {kid}")
            self._store["default"] = kid
            snap = self._snapshot()
        self._persist(snap)

    def get_default(self) -> str | None:
        with self._lock:
            return self._store.get("default")

    def set_automount(self, kid: str, status: bool) -> None:
        with self._lock:
            rec = self._store["keys"].get(kid)
            if rec is None:
                raise KeyManagerError(f"no stored key {kid}")
            rec["automount"] = bool(status)
            snap = self._snapshot()
        self._persist(snap)

    # -- keystore backup / restore -------------------------------------------
    def backup_keystore(self, path: str | Path) -> int:
        """Copy the (everything-sealed) keystore out; returns key count."""
        with self._lock:
            payload = json.dumps(self._store, indent=1)
            count = len(self._store["keys"])
        Path(path).write_text(payload)
        return count

    def restore_keystore(self, path: str | Path,
                         password: str | Protected) -> int:
        """Merge keys from a backup keystore, verifying with THAT keystore's
        master password and re-sealing each key under our root key. Returns
        how many keys were imported (duplicates skipped)."""
        try:
            backup = json.loads(Path(path).read_text())
        except (OSError, json.JSONDecodeError) as e:
            raise KeyManagerError(f"unreadable backup: {e}") from e
        with self._lock:
            root = self._require_root()
            if not backup.get("root_slot"):
                raise KeyManagerError("backup has no root keyslot")
            pw = password if isinstance(password, Protected) \
                else Protected(password)
            try:
                their_root = _slot_from_json(backup["root_slot"]).unseal(pw)
            except (CryptoError, KeyError, ValueError) as e:
                raise KeyManagerError(
                    "incorrect backup master password") from e
            imported = 0
            for kid, rec in (backup.get("keys") or {}).items():
                if kid in self._store["keys"]:
                    continue
                try:
                    raw = Decryptor.decrypt_bytes(
                        their_root, _unb64(rec["nonce"]),
                        Algorithm(rec["algorithm"]), _unb64(rec["key"]))
                except (CryptoError, KeyError, ValueError):
                    continue  # damaged record: import the rest
                algorithm = Algorithm.XCHACHA20_POLY1305
                nonce = algorithm.generate_nonce()
                self._store["keys"][kid] = {
                    "name": rec.get("name", ""), "algorithm": algorithm.value,
                    "nonce": _b64(nonce),
                    "key": _b64(Encryptor.encrypt_bytes(
                        root, nonce, algorithm, raw.expose())),
                }
                raw.zeroize()
                imported += 1
            their_root.zeroize()
            snap = self._snapshot() if imported else None
        if snap is not None:
            self._persist(snap)
        return imported
