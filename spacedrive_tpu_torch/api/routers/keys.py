"""keys.* procedures: the key manager's surface.

Counterpart of ``spacedrive_tpu/api/routers/keys.py``, all 23 procedures:
setup, unlock, lock and the master password, stored keys with the default
key and automount flags, mount, unmount, ``unmountAll`` and
``listMounted``, ``getKey``, auto-unlock, and keystore backup and restore.
A locked, not-set-up or wrong-password manager answers an
:class:`ApiError` (400), as in the reference.
"""


from __future__ import annotations

import functools

from ...crypto.keymanager import KeyManagerError
from ..router import ApiError


#: procedures the server shell refuses while it runs without basic auth
#: (any local user can reach a localhost port): getKey returns raw key
#: material, backupKeystore writes a path of the caller's choice,
#: restoreKeystore merges key material the caller knows, enableAutoUnlock
#: parks the root secret in the keyring store (weaker at rest than
#: Argon2id) and disableAutoUnlock deletes it. In-process callers are not
#: affected.
SECRET_PROCEDURES = frozenset({
    "keys.getKey", "keys.backupKeystore", "keys.restoreKeystore",
    "keys.enableAutoUnlock", "keys.disableAutoUnlock",
})


def _km(node):
    km = getattr(node, "key_manager", None)
    if km is None:
        raise ApiError("no key manager on this node")
    return km


def _translate(fn):
    """A locked, not-set-up or wrong-password manager is the client's error."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except KeyManagerError as e:
            raise ApiError(str(e))

    return wrapper


def mount(router) -> None:
    @router.query("keys.isSetup")
    @_translate
    def is_setup(node, _arg=None):
        return _km(node).is_setup

    @router.query("keys.isUnlocked")
    @_translate
    def is_unlocked(node, _arg=None):
        return _km(node).is_unlocked

    @router.mutation("keys.setup")
    @_translate
    def setup(node, password: str):
        _km(node).setup(password)
        return True

    @router.mutation("keys.unlockKeyManager")
    @_translate
    def unlock(node, password: str):
        _km(node).unlock(password)
        return True

    @router.mutation("keys.lockKeyManager")
    @_translate
    def lock(node, _arg=None):
        _km(node).lock()
        return True

    @router.query("keys.list")
    @_translate
    def list_keys(node, _arg=None):
        return _km(node).list_keys()

    @router.mutation("keys.add")
    @_translate
    def add(node, arg):
        name = (arg or {}).get("name", "") if isinstance(arg, dict) else (arg or "")
        return _km(node).add_key(name)

    @router.mutation("keys.mount")
    @_translate
    def mount_key(node, key_uuid: str):
        _km(node).mount(key_uuid)
        return True

    @router.mutation("keys.unmount")
    @_translate
    def unmount_key(node, key_uuid: str):
        _km(node).unmount(key_uuid)
        return True

    @router.mutation("keys.deleteFromLibrary")
    @_translate
    def delete(node, key_uuid: str):
        _km(node).delete_key(key_uuid)
        return True

    @router.query("keys.listMounted")
    @_translate
    def list_mounted(node, _arg=None):
        return _km(node).list_mounted()

    @router.mutation("keys.unmountAll")
    @_translate
    def unmount_all(node, _arg=None):
        return _km(node).unmount_all()

    @router.query("keys.getDefault")
    @_translate
    def get_default(node, _arg=None):
        return _km(node).get_default()

    @router.mutation("keys.setDefault")
    @_translate
    def set_default(node, key_uuid: str):
        _km(node).set_default(key_uuid)
        return True

    @router.query("keys.getKey")
    @_translate
    def get_key(node, key_uuid: str):
        import base64

        return base64.b64encode(_km(node).get_key(key_uuid).expose()).decode()

    @router.mutation("keys.updateAutomountStatus")
    @_translate
    def update_automount(node, arg):
        _km(node).set_automount(arg["uuid"], bool(arg["status"]))
        return True

    @router.mutation("keys.changeMasterPassword")
    @_translate
    def change_master_password(node, arg):
        _km(node).change_master_password(arg["current"], arg["new"])
        return True

    @router.mutation("keys.clearMasterPassword")
    @_translate
    def clear_master_password(node, _arg=None):
        _km(node).clear_master_password()
        return True

    @router.query("keys.isKeyManagerUnlocking")
    @_translate
    def is_unlocking(node, _arg=None):
        return False  # unlock is synchronous: never seen mid-way

    @router.mutation("keys.enableAutoUnlock")
    @_translate
    def enable_auto_unlock(node, _arg=None):
        """Park the root secret in the keyring (the kernel user keyring, or
        the machine-bound sealed file) so this keystore unlocks across
        restarts; returns the store's name."""
        return _km(node).enable_auto_unlock()

    @router.mutation("keys.disableAutoUnlock")
    @_translate
    def disable_auto_unlock(node, _arg=None):
        _km(node).disable_auto_unlock()
        return True

    @router.mutation("keys.backupKeystore")
    @_translate
    def backup_keystore(node, path: str):
        return _km(node).backup_keystore(path)

    @router.mutation("keys.restoreKeystore")
    @_translate
    def restore_keystore(node, arg):
        return _km(node).restore_keystore(arg["path"], arg["password"])
