"""Secret stores for the key manager's auto-unlock.

Counterpart of ``spacedrive_tpu/crypto/keyring.py``: somewhere to park the
key manager's root secret so a keystore unlocks across process restarts
without a plaintext secret on disk. :func:`default_store` picks:

- :class:`KernelKeyringStore`: the Linux kernel user keyring through raw
  ``add_key`` / ``request_key`` / ``keyctl`` syscalls (``ctypes``). The
  secret lives in kernel memory, scoped to the uid, until reboot. A
  container may refuse the syscalls (EPERM or ENOSYS); the probe then
  fails and the file store is taken.
- :class:`FileSecretStore`: the secret sealed with XChaCha20-Poly1305
  under a key derived from ``/etc/machine-id``, the uid and a fixed string,
  in a 0600 file beside the keystore. It keeps the data directory alone
  from giving the secret away; a whole disk image holds the machine id too.

``SERVICE`` names the entries in both stores and is the reference's, so
either package reads what the other wrote.
"""


from __future__ import annotations

import ctypes
import hashlib
import json
import os
from pathlib import Path
from typing import Protocol

SERVICE = "spacedrive_tpu"

# keyctl-family syscall numbers are per-architecture; an unmapped arch must
# never issue a mismapped syscall with secret bytes as arguments
_SYSCALLS = {
    "x86_64": (248, 249, 250),    # add_key, request_key, keyctl
    "aarch64": (217, 218, 219),
}


def _syscall_numbers() -> tuple[int, int, int] | None:
    import platform

    return _SYSCALLS.get(platform.machine())

_KEY_SPEC_USER_KEYRING = -4
_KEYCTL_READ = 11
_KEYCTL_UNLINK = 9


class SecretStore(Protocol):
    name: str

    def get(self, account: str) -> bytes | None: ...
    def set(self, account: str, secret: bytes) -> None: ...
    def delete(self, account: str) -> None: ...


class KeyringError(Exception):
    pass


class KernelKeyringStore:
    """Linux kernel user-keyring backend ("user" key type)."""

    name = "kernel-keyring"

    def __init__(self) -> None:
        nums = _syscall_numbers()
        if nums is None:
            raise KeyringError("kernel keyring: unmapped architecture")
        self._sys_add_key, self._sys_request_key, self._sys_keyctl = nums
        self._libc = ctypes.CDLL(None, use_errno=True)

    def _desc(self, account: str) -> bytes:
        return f"{SERVICE}:{account}".encode()

    def set(self, account: str, secret: bytes) -> None:
        kid = self._libc.syscall(
            self._sys_add_key, b"user", self._desc(account), secret, len(secret),
            _KEY_SPEC_USER_KEYRING)
        if kid < 0:
            raise KeyringError(f"add_key failed: errno {ctypes.get_errno()}")

    def _find(self, account: str) -> int:
        kid = self._libc.syscall(
            self._sys_request_key, b"user", self._desc(account), None,
            _KEY_SPEC_USER_KEYRING)
        return int(kid)

    def get(self, account: str) -> bytes | None:
        kid = self._find(account)
        if kid < 0:
            return None
        size = self._libc.syscall(self._sys_keyctl, _KEYCTL_READ, kid, None, 0)
        if size < 0:
            return None
        buf = ctypes.create_string_buffer(size)
        got = self._libc.syscall(self._sys_keyctl, _KEYCTL_READ, kid, buf, size)
        if got < 0:
            return None
        return buf.raw[:got]

    def delete(self, account: str) -> None:
        kid = self._find(account)
        if kid >= 0:
            self._libc.syscall(self._sys_keyctl, _KEYCTL_UNLINK, kid,
                               _KEY_SPEC_USER_KEYRING)

    @classmethod
    def available(cls) -> bool:
        try:
            store = cls()
            probe = f"__probe__{os.getpid()}"
            store.set(probe, b"x")
            ok = store.get(probe) == b"x"
            store.delete(probe)
            return ok
        except Exception:
            return False


class FileSecretStore:
    """The machine-bound sealed file (see the module docstring)."""

    name = "file"

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)

    def _machine_key(self) -> bytes:
        try:
            machine = Path("/etc/machine-id").read_text().strip()
        except OSError:
            machine = "no-machine-id"
        material = f"{SERVICE}-keyring|{machine}|{os.getuid()}".encode()
        return hashlib.sha256(material).digest()

    def _load(self) -> dict:
        try:
            return json.loads(self.path.read_text())
        except (OSError, json.JSONDecodeError):
            return {}

    def _save(self, blob: dict) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        fd = os.open(str(tmp), os.O_CREAT | os.O_TRUNC | os.O_WRONLY, 0o600)
        with os.fdopen(fd, "w") as fh:
            json.dump(blob, fh)
        tmp.replace(self.path)

    def set(self, account: str, secret: bytes) -> None:
        from .primitives import Protected
        from .stream import Algorithm, Encryptor

        algorithm = Algorithm.XCHACHA20_POLY1305
        nonce = algorithm.generate_nonce()
        sealed = Encryptor.encrypt_bytes(
            Protected(self._machine_key()), nonce, algorithm, secret)
        blob = self._load()
        blob[account] = {"nonce": nonce.hex(), "sealed": sealed.hex(),
                         "algorithm": algorithm.value}
        self._save(blob)

    def get(self, account: str) -> bytes | None:
        from .primitives import Protected
        from .stream import Algorithm, Decryptor

        rec = self._load().get(account)
        if rec is None:
            return None
        try:
            return Decryptor.decrypt_bytes(
                Protected(self._machine_key()), bytes.fromhex(rec["nonce"]),
                Algorithm(rec["algorithm"]),
                bytes.fromhex(rec["sealed"])).expose()
        except Exception:
            return None

    def delete(self, account: str) -> None:
        blob = self._load()
        if blob.pop(account, None) is not None:
            self._save(blob)


def default_store(data_dir: str | Path) -> SecretStore:
    """The kernel keyring where the host allows it, else the machine-bound
    sealed file beside the keystore."""
    if KernelKeyringStore.available():
        return KernelKeyringStore()
    return FileSecretStore(Path(data_dir) / "keyring.json")
