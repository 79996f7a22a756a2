"""The port's crypto stack (spacedrive_tpu_torch/crypto/) against the JAX
package's, on the CPU.

- Primitives: the HChaCha20 vector of draft-irtf-cfrg-xchacha; the port's
  BLAKE3 oracle in keyed and derive-key modes equal to the JAX oracle at
  0-4,096 bytes, its plain digests unchanged (a published vector too).
- Streams: both algorithms at the block edges (empty, 1 B, BLOCK_LEN - 1,
  BLOCK_LEN, BLOCK_LEN + 1, 2 x BLOCK_LEN): with the randomness seeded in
  both packages (``tests/torch_crypto_cases.seed_crypto``) the ciphertext
  bytes are equal, and each package decrypts the other's. Truncation,
  reordered blocks and a changed AAD fail with nothing written past the
  last good block.
- Hashing: the tier tables equal the JAX package's; one Argon2id hash at
  STANDARD is equal; BalloonBlake3 is equal with both ``_BALLOON`` tables
  made small.
- Headers: the serialised bytes are equal under seeded randomness; two
  keyslots and the sealed metadata and preview open across packages; a
  third keyslot, a bad magic and a cut header are refused.
- Key manager and keyring: a keystore written by either package's
  ``KeyManager`` unlocks in the other's with the same keys, default and
  automount; password change and clear; backup and restore across
  packages; the file store's blob opens across packages and holds no
  plaintext; auto-unlock survives a restart, through the router of a port
  Node too; a stale keyring secret is never installed; the persist
  version gate.

Every test but the STANDARD hash runs Argon2id at
``tests/torch_crypto_cases.CHEAP_ARGON2`` in both packages, so the file
takes seconds.
"""

import io

import pytest

from spacedrive_tpu.crypto import header as jax_header
from spacedrive_tpu.crypto import hashing as jax_hashing
from spacedrive_tpu.crypto import keymanager as jax_km
from spacedrive_tpu.crypto import keyring as jax_keyring
from spacedrive_tpu.crypto import primitives as jax_primitives
from spacedrive_tpu.crypto import stream as jax_stream
from spacedrive_tpu.objects import blake3_ref as jax_b3
from spacedrive_tpu_torch.crypto import header, hashing, keymanager, keyring, primitives, stream
from spacedrive_tpu_torch.crypto.xchacha import XChaCha20Poly1305, hchacha20
from spacedrive_tpu_torch.objects import blake3_ref
from tests.torch_crypto_cases import cheap_argon2, seed_crypto
from tests.torch_scan_cases import blob, one_torch_thread  # noqa: F401

BLOCK = primitives.BLOCK_LEN
EDGES = (0, 1, BLOCK - 1, BLOCK, BLOCK + 1, 2 * BLOCK)
PACKAGES = {"jax": (jax_stream, jax_header, jax_km, jax_keyring, jax_primitives),
            "port": (stream, header, keymanager, keyring, primitives)}


@pytest.fixture(autouse=True)
def cheap(request, monkeypatch):
    if request.node.name != "test_argon2id_standard_matches_jax":
        cheap_argon2(monkeypatch)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_hchacha20_ietf_vector():
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a0000000031415927")
    assert hchacha20(key, nonce).hex() == (
        "82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc")


def test_xchacha_roundtrip_and_tamper():
    key, nonce = blob(1, 32), blob(2, 24)
    aead = XChaCha20Poly1305(key)
    ct = aead.encrypt(nonce, b"payload", b"aad")
    assert aead.decrypt(nonce, ct, b"aad") == b"payload"
    with pytest.raises(Exception):
        aead.decrypt(nonce, ct, b"other-aad")
    with pytest.raises(Exception):
        aead.decrypt(nonce, bytes([ct[0] ^ 1]) + ct[1:], b"aad")


@pytest.mark.parametrize("n", [0, 1, 64, 1024, 1025, 4096])
def test_blake3_modes_match_the_jax_oracle(n):
    data, key = blob(n + 3, n), blob(n + 4, 32)
    assert blake3_ref.blake3(data) == jax_b3.blake3(data)
    assert blake3_ref.blake3(data, 131) == jax_b3.blake3(data, 131)
    assert blake3_ref.blake3_keyed(key, data) == jax_b3.blake3_keyed(key, data)
    assert blake3_ref.derive_key("ctx", data) == jax_b3.derive_key("ctx", data)
    assert blake3_ref.derive_key(primitives.FILE_KEY_CONTEXT, data, 64) == \
        jax_b3.derive_key(jax_primitives.FILE_KEY_CONTEXT, data, 64)
    assert blake3_ref.blake3_keyed(key, data) != blake3_ref.blake3(data)
    assert primitives.derive_key(key, data[:16], primitives.ROOT_KEY_CONTEXT) == \
        jax_primitives.derive_key(key, data[:16], jax_primitives.ROOT_KEY_CONTEXT)


def test_plain_blake3_digest_unchanged():
    # the published BLAKE3 digest of the empty input
    assert blake3_ref.blake3_hex(b"") == (
        "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262")
    with pytest.raises(ValueError):
        blake3_ref.blake3_keyed(b"short", b"x")


def test_on_disk_constants_match():
    for name in ("BLOCK_LEN", "AEAD_TAG_LEN", "KEY_LEN", "ENCRYPTED_KEY_LEN", "SALT_LEN",
                 "SECRET_KEY_LEN", "ROOT_KEY_CONTEXT", "MASTER_PASSWORD_CONTEXT",
                 "FILE_KEY_CONTEXT"):
        assert getattr(primitives, name) == getattr(jax_primitives, name), name
    for name in ("MAGIC_BYTES", "HEADER_VERSION", "KEYSLOT_SIZE", "MAX_KEYSLOTS"):
        assert getattr(header, name) == getattr(jax_header, name), name
    assert keyring.SERVICE == jax_keyring.SERVICE == "spacedrive_tpu"
    assert [(a.name, a.value, a.nonce_len) for a in stream.Algorithm] == \
        [(a.name, a.value, a.nonce_len) for a in jax_stream.Algorithm]


def test_random_bytes_is_the_one_source(monkeypatch):
    drawn = []
    monkeypatch.setattr(primitives, "random_bytes", lambda n: drawn.append(n) or b"\x07" * n)
    assert primitives.generate_master_key().expose() == b"\x07" * 32
    assert primitives.generate_salt() == b"\x07" * 16
    assert stream.Algorithm.AES_256_GCM.generate_nonce() == b"\x07" * 8
    assert drawn == [32, 16, 8]


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def _encrypt(pkg: str, algorithm_value: int, plain: bytes, aad: bytes, seed: int,
             monkeypatch) -> tuple[bytes, bytes, bytes]:
    """(key, nonce, ciphertext) of one stream, the key and nonce seeded."""
    mod = PACKAGES[pkg][0]
    prim = PACKAGES[pkg][4]
    seed_crypto(monkeypatch, seed)
    algorithm = mod.Algorithm(algorithm_value)
    key = prim.generate_master_key()
    nonce = algorithm.generate_nonce()
    out = io.BytesIO()
    written = mod.Encryptor.encrypt_streams(key, nonce, algorithm, io.BytesIO(plain), out, aad)
    assert written == len(out.getvalue())
    return key.expose(), nonce, out.getvalue()


def _decrypt(pkg: str, algorithm_value: int, key: bytes, nonce: bytes, ct: bytes,
             aad: bytes) -> bytes:
    mod = PACKAGES[pkg][0]
    prim = PACKAGES[pkg][4]
    out = io.BytesIO()
    mod.Decryptor.decrypt_streams(prim.Protected(key), nonce, mod.Algorithm(algorithm_value),
                                  io.BytesIO(ct), out, aad)
    return out.getvalue()


@pytest.mark.parametrize("algorithm", [0, 1], ids=["xchacha", "aes-gcm"])
@pytest.mark.parametrize("size", EDGES, ids=[f"{n}B" for n in EDGES])
def test_stream_ciphertext_equal_and_opens_across_packages(algorithm, size, monkeypatch):
    plain = blob(size, size)
    aad = b"header-bytes"
    jk, jn, jct = _encrypt("jax", algorithm, plain, aad, 7, monkeypatch)
    pk, pn, pct = _encrypt("port", algorithm, plain, aad, 7, monkeypatch)
    assert (pk, pn) == (jk, jn)
    assert pct == jct
    blocks = max(1, -(-size // BLOCK))
    assert len(pct) == size + 16 * blocks
    assert _decrypt("jax", algorithm, pk, pn, pct, aad) == plain
    assert _decrypt("port", algorithm, jk, jn, jct, aad) == plain


@pytest.mark.parametrize("algorithm", [0, 1], ids=["xchacha", "aes-gcm"])
def test_stream_refuses_truncation_reorder_and_a_changed_aad(algorithm, monkeypatch):
    plain = blob(3, 3 * BLOCK)
    key, nonce, ct = _encrypt("port", algorithm, plain, b"hdr", 3, monkeypatch)
    cb = BLOCK + 16
    bad = {
        "truncated": ct[:2 * cb],
        "reordered": ct[cb:2 * cb] + ct[:cb] + ct[2 * cb:],
        "last dropped to one block": ct[:cb],
    }
    for what, data in bad.items():
        with pytest.raises(stream.CryptoError):
            _decrypt("port", algorithm, key, nonce, data, b"hdr")
    out = io.BytesIO()
    with pytest.raises(stream.CryptoError):
        stream.Decryptor.decrypt_streams(primitives.Protected(key), nonce,
                                         stream.Algorithm(algorithm), io.BytesIO(ct), out,
                                         b"hdS")
    assert out.getvalue() == b""  # block 0 fails through the AAD: nothing written
    with pytest.raises(stream.CryptoError):
        stream.Encryptor(primitives.Protected(key), nonce + b"x", stream.Algorithm(algorithm))


# ---------------------------------------------------------------------------
# password hashing
# ---------------------------------------------------------------------------

def test_tier_tables_and_encoding_match():
    by_name = lambda table: {p.name: v for p, v in table.items()}  # noqa: E731
    assert by_name(hashing._BALLOON) == by_name(jax_hashing._BALLOON)
    assert hashing._BALLOON_DELTA == jax_hashing._BALLOON_DELTA
    for kind in ("argon2id", "balloon_blake3"):
        for params in hashing.Params:
            algo = getattr(hashing.HashingAlgorithm, kind)(params)
            jalgo = getattr(jax_hashing.HashingAlgorithm, kind)(jax_hashing.Params(params.value))
            assert algo.encode() == jalgo.encode()
            assert hashing.HashingAlgorithm.decode(jalgo.encode()) == algo


def test_argon2id_standard_matches_jax():
    def by_name(table):
        return {p.name: v for p, v in table.items()}

    assert by_name(hashing._ARGON2) == by_name(jax_hashing._ARGON2)
    assert hashing._ARGON2[hashing.Params.STANDARD] == (131_072, 8, 4)
    salt = blob(5, 16)
    got = hashing.HashingAlgorithm.argon2id().hash(primitives.Protected("pw"), salt)
    want = jax_hashing.HashingAlgorithm.argon2id().hash(jax_primitives.Protected("pw"), salt)
    assert got.expose() == want.expose() and len(got) == 32


def test_argon2id_secret_and_salt_change_the_output():
    algo = hashing.HashingAlgorithm.argon2id()
    salt = blob(6, 16)
    plain = algo.hash(primitives.Protected("pw"), salt)
    with_secret = algo.hash(primitives.Protected("pw"), salt, primitives.Protected(b"s" * 18))
    other_salt = algo.hash(primitives.Protected("pw"), blob(7, 16))
    assert len({plain.expose(), with_secret.expose(), other_salt.expose()}) == 3


def test_balloon_blake3_matches_jax_at_small_tiers(monkeypatch):
    for module in (hashing, jax_hashing):
        monkeypatch.setattr(module, "_BALLOON", {p: (24, 2) for p in module.Params})
    salt = blob(8, 16)
    for secret in (None, b"secretkey"):
        got = hashing.HashingAlgorithm.balloon_blake3().hash(
            primitives.Protected("pw"), salt,
            primitives.Protected(secret) if secret else None)
        want = jax_hashing.HashingAlgorithm.balloon_blake3().hash(
            jax_primitives.Protected("pw"), salt,
            jax_primitives.Protected(secret) if secret else None)
        assert got.expose() == want.expose()
    again = hashing.HashingAlgorithm.balloon_blake3().hash(primitives.Protected("pw"),
                                                          blob(9, 16))
    assert again.expose() != got.expose()


# ---------------------------------------------------------------------------
# headers and keyslots
# ---------------------------------------------------------------------------

def _header(pkg: str, algorithm_value: int, seed: int, monkeypatch, hashing_kind="argon2id"):
    """A header with two keyslots, metadata and a preview, every random
    byte seeded; returns (serialized bytes, master key bytes)."""
    _s, mod, _k, _r, prim = PACKAGES[pkg]
    hmod = hashing if pkg == "port" else jax_hashing
    seed_crypto(monkeypatch, seed)
    master = prim.generate_master_key()
    h = mod.FileHeader.new(mod.Algorithm(algorithm_value))
    algo = getattr(hmod.HashingAlgorithm, hashing_kind)()
    h.add_keyslot(prim.Protected("password-one"), master, algo)
    h.add_keyslot(prim.Protected("password-two"), master)
    h.add_metadata(master, {"name": "secret.txt", "size": 123, "cas_id": "ab" * 8})
    h.add_preview_media(master, b"\x89PNG preview")
    with pytest.raises(mod.CryptoError):
        h.add_keyslot(prim.Protected("three"), master)
    return h.serialize(), master.expose()


@pytest.mark.parametrize("algorithm", [0, 1], ids=["xchacha", "aes-gcm"])
def test_header_bytes_equal_and_open_across_packages(algorithm, monkeypatch):
    for module in (hashing, jax_hashing):
        monkeypatch.setattr(module, "_BALLOON", {p: (16, 1) for p in module.Params})
    jraw, jmaster = _header("jax", algorithm, 11, monkeypatch, "balloon_blake3")
    praw, pmaster = _header("port", algorithm, 11, monkeypatch, "balloon_blake3")
    assert praw == jraw and pmaster == jmaster
    assert praw[:7] == b"sdtpenc"
    for reader, raw in (("port", jraw), ("jax", praw)):
        _s, mod, _k, _r, prim = PACKAGES[reader]
        parsed, offset = mod.FileHeader.from_bytes(raw + b"payload")
        assert offset == len(raw) and len(parsed.keyslots) == 2
        for pw in ("password-one", "password-two"):
            assert parsed.decrypt_master_key(prim.Protected(pw)).expose() == jmaster
        with pytest.raises(mod.CryptoError):
            parsed.decrypt_master_key(prim.Protected("wrong"))
        mk = prim.Protected(jmaster)
        assert parsed.decrypt_metadata(mk) == {"name": "secret.txt", "size": 123,
                                               "cas_id": "ab" * 8}
        assert parsed.decrypt_preview_media(mk) == b"\x89PNG preview"


def test_header_refuses_bad_magic_and_cut_headers(monkeypatch):
    with pytest.raises(stream.CryptoError):
        header.FileHeader.from_reader(io.BytesIO(b"notmagic" + b"\x00" * 300))
    raw, _m = _header("port", 0, 12, monkeypatch)
    for cut in (9, 20, 100, 270):  # the version, nonce, keyslots, metadata
        with pytest.raises(stream.CryptoError):
            parsed, _off = header.FileHeader.from_bytes(raw[:cut])
            parsed.decrypt_metadata(primitives.Protected(_m))
    slot = header.Keyslot.new(stream.Algorithm.AES_256_GCM,
                              hashing.HashingAlgorithm.argon2id(),
                              primitives.Protected("pw"), primitives.Protected(_m))
    assert len(slot.encode()) == header.KEYSLOT_SIZE
    assert header.Keyslot.decode(slot.encode()).unseal(primitives.Protected("pw")).expose() == _m


# ---------------------------------------------------------------------------
# key manager and keyring
# ---------------------------------------------------------------------------

def _fill(km) -> dict:
    """Set up a keystore: three keys, a default, one automount; returns
    {uuid: key bytes}."""
    km.setup("master-pw")
    kids = [km.add_key(name) for name in ("first", "second", "third")]
    km.set_default(kids[1])
    km.set_automount(kids[2], True)
    return {k: km.get_key(k).expose() for k in kids}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_keystore_opens_across_packages(writer, reader, tmp_path):
    path = tmp_path / "keystore.json"
    keys = _fill(PACKAGES[writer][2].KeyManager(path))
    km = PACKAGES[reader][2].KeyManager(path)
    assert km.is_setup and not km.is_unlocked
    with pytest.raises(PACKAGES[reader][2].KeyManagerError):
        km.unlock("wrong")
    km.unlock("master-pw")
    rows = {r["uuid"]: r for r in km.list_keys()}
    assert set(rows) == set(keys)
    assert [r["name"] for r in km.list_keys()] == ["first", "second", "third"]
    kids = list(keys)
    assert km.get_default() == kids[1] and rows[kids[1]]["default"]
    assert km.list_mounted() == [kids[2]] and rows[kids[2]]["automount"]
    assert {k: km.get_key(k).expose() for k in kids} == keys


def test_password_change_and_clear_across_packages(tmp_path):
    path = tmp_path / "ks.json"
    km = keymanager.KeyManager(path)
    keys = _fill(km)
    km.change_master_password("master-pw", "correct horse")
    jkm = jax_km.KeyManager(path)
    with pytest.raises(jax_km.KeyManagerError):
        jkm.unlock("master-pw")
    jkm.unlock("correct horse")
    assert {k: jkm.get_key(k).expose() for k in keys} == keys
    with pytest.raises(keymanager.KeyManagerError):
        km.change_master_password("master-pw", "x")
    kid = next(iter(keys))
    km.clear_master_password()
    assert not km.is_unlocked
    assert km.get_key(kid).expose() == keys[kid]  # mounted keys stay usable
    with pytest.raises(keymanager.KeyManagerError):
        km.add_key("needs the root")
    km.lock()
    assert km.list_mounted() == []
    km.unlock("correct horse")
    assert km.list_mounted() == [list(keys)[2]]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_backup_restore_across_packages(writer, reader, tmp_path):
    a = PACKAGES[writer][2].KeyManager(tmp_path / "a.json")
    keys = _fill(a)
    assert a.backup_keystore(tmp_path / "backup.json") == 3
    b = PACKAGES[reader][2].KeyManager(tmp_path / "b.json")
    b.setup("beta")
    own = b.add_key("own")
    with pytest.raises(PACKAGES[reader][2].KeyManagerError):
        b.restore_keystore(tmp_path / "backup.json", "wrong")
    assert b.restore_keystore(tmp_path / "backup.json", "master-pw") == 3
    assert b.restore_keystore(tmp_path / "backup.json", "master-pw") == 0
    assert {k: b.get_key(k).expose() for k in keys} == keys
    assert {r["uuid"] for r in b.list_keys()} == set(keys) | {own}
    with pytest.raises(PACKAGES[reader][2].KeyManagerError):
        b.restore_keystore(tmp_path / "missing.json", "master-pw")


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_file_store_opens_across_packages_without_plaintext(writer, reader, tmp_path):
    path = tmp_path / "keyring.json"
    secret = blob(13, 32)
    PACKAGES[writer][3].FileSecretStore(path).set("acct", secret)
    raw = path.read_bytes()
    assert secret not in raw and secret.hex().encode() not in raw
    assert oct(path.stat().st_mode & 0o777) == "0o600"
    store = PACKAGES[reader][3].FileSecretStore(path)
    assert store.get("acct") == secret
    store.delete("acct")
    assert PACKAGES[writer][3].FileSecretStore(path).get("acct") is None


def test_file_store_blob_is_machine_bound(tmp_path, monkeypatch):
    store = keyring.FileSecretStore(tmp_path / "keyring.json")
    store.set("acct", b"s3cret-material!")
    monkeypatch.setattr(keyring.FileSecretStore, "_machine_key", lambda self: b"\x01" * 32)
    assert store.get("acct") is None


def test_default_store_picks_a_backend(tmp_path):
    store = keyring.default_store(tmp_path)
    assert store.name in ("kernel-keyring", "file")
    store.set("probe", b"v")
    assert store.get("probe") == b"v"
    store.delete("probe")


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_auto_unlock_survives_a_restart(writer, reader, tmp_path):
    path = tmp_path / "keystore.json"
    km = PACKAGES[writer][2].KeyManager(path)
    keys = _fill(km)
    store = PACKAGES[writer][3].FileSecretStore(tmp_path / "keyring.json")
    assert km.enable_auto_unlock(store) == "file"
    again = PACKAGES[reader][2].KeyManager(path)
    assert not again.is_unlocked
    assert again.try_auto_unlock()  # the recorded store, read by the reader's package
    assert {k: again.get_key(k).expose() for k in keys} == keys
    for f in tmp_path.iterdir():
        data = f.read_bytes()
        for key in keys.values():
            assert key not in data and key.hex().encode() not in data, f
    again.disable_auto_unlock()
    third = PACKAGES[writer][2].KeyManager(path)
    assert not third.try_auto_unlock()
    third.unlock("master-pw")
    assert third.is_unlocked


def test_a_stale_keyring_secret_is_never_installed(tmp_path):
    km = keymanager.KeyManager(tmp_path / "ks.json")
    _fill(km)
    store = keyring.FileSecretStore(tmp_path / "keyring.json")
    km.enable_auto_unlock(store)
    store.set(km._keyring_account(), b"\x00" * 32)
    assert not keymanager.KeyManager(tmp_path / "ks.json").try_auto_unlock(store)


def test_node_auto_unlocks_at_boot(tmp_path, monkeypatch):
    from spacedrive_tpu_torch.node import Node

    monkeypatch.setenv("SD_P2P_DISABLED", "1")
    data = tmp_path / "data"
    node = Node(data, device="cpu", watch_locations=False)
    try:
        r = node.router.resolve
        assert r("keys.isSetup") is False
        r("keys.setup", "master-pw")
        kid = r("keys.add", {"name": "k1"})
        assert r("keys.enableAutoUnlock") in ("kernel-keyring", "file")
    finally:
        node.shutdown()
    node = Node(data, device="cpu", watch_locations=False)
    try:
        assert node.key_manager.is_unlocked
        assert node.router.resolve("keys.list")[0]["uuid"] == kid
        node.router.resolve("keys.disableAutoUnlock")
    finally:
        node.shutdown()
    node = Node(data, device="cpu", watch_locations=False)
    try:
        assert node.key_manager.is_setup and not node.key_manager.is_unlocked
    finally:
        node.shutdown()


def test_persist_version_gate(tmp_path):
    km = keymanager.KeyManager(tmp_path / "keys.json")
    v1 = km._snapshot()
    km._store["marker"] = "newer"
    v2 = km._snapshot()
    assert v2[0] > v1[0]
    km._persist(v2)
    km._persist(v1)  # a stale snapshot arriving late is dropped
    assert "newer" in km.store_path.read_text()
    assert not km.store_path.with_suffix(".tmp").exists()

