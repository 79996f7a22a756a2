"""FileEncryptorJob and FileDecryptorJob.

Counterpart of ``spacedrive_tpu/objects/crypto_jobs.py``. A step a file:
the encryptor writes ``<name>.bytes`` beside the source, a header (magic,
one keyslot, optionally the sealed metadata: name, size, the row's cas_id
and its object's pub_id) and then the LE31 AEAD stream of 1 MiB blocks;
the header is the stream's AAD, so a tampered header fails block 0. The
decryptor writes the plaintext beside the ``.bytes`` file under the name
less the suffix. A failed step unlinks its partial output and is an error
line; the job goes on.

The key is a password, or a stored key of the node's key manager
(``key_uuid``), whose bytes are the keyslot's password. Passwords are never
persisted (``SECRET_INIT_KEYS``): a job paused or killed with a password
cannot resume, one with a ``key_uuid`` can.

``finalize`` runs the light rescan of each touched directory, as the
reference does: it inserts the new files' rows without a cas_id and drops
the erased ones. Like the reference, the job identifies nothing: the
new rows get their cas_ids at the next scan of the location or the
watcher's next pass.
"""


from __future__ import annotations

from pathlib import Path
from typing import Any

from ..crypto import Algorithm, FileHeader, Protected
from ..crypto.primitives import generate_master_key
from ..crypto.stream import CryptoError, Decryptor, Encryptor
from ..jobs import EarlyFinish, JobContext, JobError, StepResult
from .fs import _FsJob, find_available_name

BYTES_EXT = ".bytes"


def _resolve_key(ctx: JobContext, init_args: dict[str, Any]) -> Protected:
    if init_args.get("password"):
        return Protected(init_args["password"])
    key_uuid = init_args.get("key_uuid")
    if key_uuid:
        km = getattr(ctx.library.node, "key_manager", None)
        if km is None:
            raise JobError("no key manager on this node")
        return Protected(km.get_key(key_uuid).expose())
    raise JobError(
        "needs a password or a key_uuid (passwords are never persisted in "
        "checkpoints — a crypto job resumed after shutdown must use a "
        "key-manager key_uuid or be re-submitted)")


class FileEncryptorJob(_FsJob):
    """init_args: sources [file_path ids], password | key_uuid,
    algorithm ("XChaCha20Poly1305" | "Aes256Gcm"), metadata: bool,
    erase_original: bool."""

    NAME = "file_encryptor"
    SECRET_INIT_KEYS = ("password",)

    def init(self, ctx: JobContext):
        steps = []
        for row, src in self._sources(ctx):
            if row["is_dir"]:
                continue  # files only
            steps.append({"file_path_id": row["id"], "src": str(src),
                          "location_id": row["location_id"],
                          "sub_path": (row["materialized_path"] or "/").strip("/")})
        if not steps:
            raise EarlyFinish("nothing to encrypt")
        _resolve_key(ctx, self.init_args)  # fail fast on bad key config
        algo = self.init_args.get("algorithm", "XChaCha20Poly1305")
        data = {
            "algorithm": (Algorithm.AES_256_GCM if algo == "Aes256Gcm"
                          else Algorithm.XCHACHA20_POLY1305).value,
            "metadata": bool(self.init_args.get("metadata")),
            "erase_original": bool(self.init_args.get("erase_original")),
            "rescan": sorted({(s["location_id"], s["sub_path"]) for s in steps}),
        }
        return data, steps, {"encrypted": 0, "bytes": 0}

    def execute_step(self, ctx: JobContext, data, step, step_number) -> StepResult:
        src = Path(step["src"])
        if not src.is_file():
            return StepResult(errors=[f"encrypt {src}: no longer a file"])
        key = _resolve_key(ctx, self.init_args)
        algorithm = Algorithm(data["algorithm"])
        master_key = generate_master_key()
        header = FileHeader.new(algorithm)
        header.add_keyslot(key, master_key)
        if data["metadata"]:
            row = ctx.library.db.query(
                "SELECT fp.*, o.pub_id AS object_pub_id FROM file_path fp "
                "LEFT JOIN object o ON fp.object_id = o.id WHERE fp.id = ?",
                [step["file_path_id"]])
            meta = {"name": src.name, "size": src.stat().st_size}
            if row:
                meta["cas_id"] = row[0]["cas_id"]
                meta["object_pub_id"] = row[0]["object_pub_id"]
            header.add_metadata(master_key, meta)
        dst = find_available_name(src.with_name(src.name + BYTES_EXT))
        try:
            # streamed, no temporary copy; a failure unlinks the partial
            # output below
            with open(src, "rb") as reader, open(dst, "wb") as writer:
                header.write(writer)
                written = Encryptor.encrypt_streams(
                    master_key, header.nonce, algorithm, reader, writer,
                    header.aad())
            if data["erase_original"]:
                src.unlink()
        except (OSError, CryptoError) as e:
            dst.unlink(missing_ok=True)
            return StepResult(errors=[f"encrypt {src}: {e}"])
        finally:
            master_key.zeroize()
            key.zeroize()
        ctx.progress(message=f"encrypted {src.name}")
        return StepResult(metadata={"encrypted": 1, "bytes": written})

    def finalize(self, ctx: JobContext, data, run_metadata):
        for loc_id, sub in data["rescan"]:
            self._rescan(ctx, loc_id, {sub})
        ctx.library.emit("invalidate_query", {"key": "search.paths"})
        return run_metadata


class FileDecryptorJob(_FsJob):
    """init_args: sources [file_path ids of .bytes files], password | key_uuid,
    erase_original: bool."""

    NAME = "file_decryptor"
    SECRET_INIT_KEYS = ("password",)

    def init(self, ctx: JobContext):
        steps = []
        for row, src in self._sources(ctx):
            if row["is_dir"]:
                continue
            steps.append({"file_path_id": row["id"], "src": str(src),
                          "location_id": row["location_id"],
                          "sub_path": (row["materialized_path"] or "/").strip("/")})
        if not steps:
            raise EarlyFinish("nothing to decrypt")
        _resolve_key(ctx, self.init_args)
        data = {
            "erase_original": bool(self.init_args.get("erase_original")),
            "rescan": sorted({(s["location_id"], s["sub_path"]) for s in steps}),
        }
        return data, steps, {"decrypted": 0, "bytes": 0}

    def execute_step(self, ctx: JobContext, data, step, step_number) -> StepResult:
        src = Path(step["src"])
        key = _resolve_key(ctx, self.init_args)
        try:
            with open(src, "rb") as reader:
                header = FileHeader.from_reader(reader)
                master_key = header.decrypt_master_key(key)
                name = src.name[:-len(BYTES_EXT)] if src.name.endswith(BYTES_EXT) \
                    else src.name + ".decrypted"
                dst = find_available_name(src.with_name(name))
                try:
                    # streamed; a failure unlinks the partial output
                    with open(dst, "wb") as writer:
                        written = Decryptor.decrypt_streams(
                            master_key, header.nonce, header.algorithm,
                            reader, writer, header.aad())
                except CryptoError:
                    dst.unlink(missing_ok=True)
                    raise
                finally:
                    master_key.zeroize()
            if data["erase_original"]:
                src.unlink()
        except (OSError, CryptoError) as e:
            return StepResult(errors=[f"decrypt {src}: {e}"])
        finally:
            key.zeroize()
        ctx.progress(message=f"decrypted {src.name}")
        return StepResult(metadata={"decrypted": 1, "bytes": written})

    def finalize(self, ctx: JobContext, data, run_metadata):
        for loc_id, sub in data["rescan"]:
            self._rescan(ctx, loc_id, {sub})
        ctx.library.emit("invalidate_query", {"key": "search.paths"})
        return run_metadata
