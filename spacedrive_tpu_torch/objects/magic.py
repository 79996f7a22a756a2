"""Magic-byte kind resolution for conflicting/unknown extensions (copy of
spacedrive_tpu/objects/magic.py).

Reference: crates/file-ext/src/magic.rs — extensions with several plausible
formats (`ExtensionPossibility::Conflicts`, e.g. ``ts`` TypeScript vs
MPEG-TS, ``db`` SQLite vs anything) are disambiguated by header signatures;
the identifier consults it at file_identifier/mod.rs:75. Table-driven here:
each signature is (offset, bytes) pairs that must all match within the
first 512 bytes.
"""

from __future__ import annotations

import logging
from pathlib import Path

from .kind import ObjectKind, kind_from_extension

logger = logging.getLogger(__name__)

HEADER_LEN = 512

#: (kind, [(offset, signature bytes), ...]) — first match wins, ordered
#: most-specific first (RIFF/ftyp containers before generic prefixes)
MAGIC_SIGNATURES: list[tuple[int, list[tuple[int, bytes]]]] = [
    # containers whose subtype picks the kind
    (ObjectKind.IMAGE, [(0, b"RIFF"), (8, b"WEBP")]),
    (ObjectKind.AUDIO, [(0, b"RIFF"), (8, b"WAVE")]),
    (ObjectKind.VIDEO, [(0, b"RIFF"), (8, b"AVI ")]),
    (ObjectKind.IMAGE, [(4, b"ftypheic")]),
    (ObjectKind.IMAGE, [(4, b"ftypheix")]),
    (ObjectKind.IMAGE, [(4, b"ftypavif")]),
    (ObjectKind.AUDIO, [(4, b"ftypM4A")]),
    (ObjectKind.VIDEO, [(4, b"ftyp")]),          # generic ISO-BMFF → video
    # images
    (ObjectKind.IMAGE, [(0, b"\x89PNG\r\n\x1a\n")]),
    (ObjectKind.IMAGE, [(0, b"\xff\xd8\xff")]),
    (ObjectKind.IMAGE, [(0, b"GIF87a")]),
    (ObjectKind.IMAGE, [(0, b"GIF89a")]),
    (ObjectKind.IMAGE, [(0, b"II*\x00")]),        # TIFF LE
    (ObjectKind.IMAGE, [(0, b"MM\x00*")]),        # TIFF BE
    (ObjectKind.IMAGE, [(0, b"BM")]),
    (ObjectKind.IMAGE, [(0, b"8BPS")]),           # psd
    # audio
    (ObjectKind.AUDIO, [(0, b"ID3")]),
    (ObjectKind.AUDIO, [(0, b"\xff\xfb")]),
    (ObjectKind.AUDIO, [(0, b"\xff\xf3")]),
    (ObjectKind.AUDIO, [(0, b"fLaC")]),
    (ObjectKind.AUDIO, [(0, b"OggS")]),
    (ObjectKind.AUDIO, [(0, b"MThd")]),           # midi
    # video
    (ObjectKind.VIDEO, [(0, b"\x1a\x45\xdf\xa3")]),  # EBML: mkv/webm
    (ObjectKind.VIDEO, [(0, b"\x47"), (188, b"\x47")]),  # MPEG-TS sync beat
    (ObjectKind.VIDEO, [(0, b"\x00\x00\x01\xba")]),  # MPEG-PS
    # archives
    (ObjectKind.ARCHIVE, [(0, b"PK\x03\x04")]),
    (ObjectKind.ARCHIVE, [(0, b"\x1f\x8b")]),     # gzip
    (ObjectKind.ARCHIVE, [(0, b"7z\xbc\xaf\x27\x1c")]),
    (ObjectKind.ARCHIVE, [(0, b"Rar!\x1a\x07")]),
    (ObjectKind.ARCHIVE, [(0, b"BZh")]),
    (ObjectKind.ARCHIVE, [(0, b"\xfd7zXZ\x00")]),
    (ObjectKind.ARCHIVE, [(0, b"\x28\xb5\x2f\xfd")]),  # zstd
    (ObjectKind.ARCHIVE, [(257, b"ustar")]),      # tar
    # executables
    (ObjectKind.EXECUTABLE, [(0, b"\x7fELF")]),
    (ObjectKind.EXECUTABLE, [(0, b"MZ")]),
    (ObjectKind.EXECUTABLE, [(0, b"\xca\xfe\xba\xbe")]),  # mach-o fat / class
    (ObjectKind.EXECUTABLE, [(0, b"\xcf\xfa\xed\xfe")]),  # mach-o 64
    # documents / databases / fonts / misc
    (ObjectKind.DOCUMENT, [(0, b"%PDF-")]),
    (ObjectKind.DATABASE, [(0, b"SQLite format 3\x00")]),
    (ObjectKind.FONT, [(0, b"\x00\x01\x00\x00\x00")]),  # ttf
    (ObjectKind.FONT, [(0, b"OTTO")]),
    (ObjectKind.FONT, [(0, b"wOFF")]),
    (ObjectKind.FONT, [(0, b"wOF2")]),
    (ObjectKind.ENCRYPTED, [(0, b"sdtpenc")]),    # this framework's header
    (ObjectKind.IMAGE, [(0, b"<svg")]),
    (ObjectKind.BOOK, [(0, b"%!PS")]),
]

#: extensions whose meaning is ambiguous enough that magic wins when found
#: (the Conflicts arm of ExtensionPossibility, magic.rs:12-15)
CONFLICTING_EXTENSIONS = {
    "ts",    # TypeScript vs MPEG-TS
    "mts",   # MPEG-TS vs Metal shader
    "m2ts",
    "db",    # SQLite vs generic data
    "key",   # key material vs Keynote
    "s",     # assembly vs other
    "raw",   # camera raw vs raw bytes
    "dat",
    "bin",
    "mid",   # midi vs other
}


# First-byte dispatch table: scanning all ~46 signatures per file costs
# ~90µs in the identifier's object-creation hot loop; bucketing by the
# first signature byte cuts the candidate set to 0–3 per file. Entries
# keep their MAGIC_SIGNATURES index so overlapping candidates (e.g. an
# offset-257 tar signature vs an offset-0 one) are still tried in the
# original priority order.
def _build_sniff_table() -> tuple[dict[int, list], dict[int, list]]:
    by_first: dict[int, list] = {}
    by_offset: dict[int, list] = {}  # first part not at offset 0
    for i, (kind, parts) in enumerate(MAGIC_SIGNATURES):
        off, sig = parts[0]
        if off == 0 and sig:
            by_first.setdefault(sig[0], []).append((i, kind, parts))
        else:
            # grouped by (offset, first byte): the common miss then costs
            # one byte compare per group instead of a candidate scan
            by_offset.setdefault(off, []).append((i, kind, parts))
    return ({b: sorted(v) for b, v in by_first.items()},
            {o: sorted(v) for o, v in by_offset.items()})


_SNIFF_BY_FIRST, _SNIFF_BY_OFFSET = _build_sniff_table()
_EMPTY: list = []


def sniff_kind(head: bytes) -> int | None:
    """Header bytes → ObjectKind, or None when no signature matches.
    Priority order (MAGIC_SIGNATURES index) is preserved across the
    offset-0 bucket and the offset groups."""
    if not head:
        return None
    candidates = _SNIFF_BY_FIRST.get(head[0], _EMPTY)
    extra: list = []
    for off, group in _SNIFF_BY_OFFSET.items():
        if len(head) > off and any(head[off] == g[2][0][1][0] for g in group):
            extra = extra + group
    if extra:
        candidates = sorted(candidates + extra)
    for _, kind, parts in candidates:
        if all(head[off:off + len(sig)] == sig for off, sig in parts):
            return kind
    return None


def looks_text(head: bytes) -> bool:
    """sd-file-ext's text detection: NUL-free, valid UTF-8 (tolerating a
    multibyte sequence cut at the sample edge), mostly printable."""
    if not head or b"\x00" in head:
        return False
    try:
        text = head.decode("utf-8")
    except UnicodeDecodeError as e:
        # only a full HEADER_LEN sample can have a cut multibyte tail, and
        # a sequence starting ≥4 bytes before the end had room to finish —
        # anything else is genuinely invalid, not truncated
        if len(head) < HEADER_LEN or e.start < len(head) - 3:
            return False
        text = head[:e.start].decode("utf-8")
        if not text:
            return False
    printable = sum(ch.isprintable() or ch in "\t\n\r\f" for ch in text)
    return printable >= 0.97 * len(text)


def _read_head(path: str | Path) -> bytes:
    try:
        with open(path, "rb") as fh:
            return fh.read(HEADER_LEN)
    except OSError:
        return b""


def resolve_kind(extension: str | None, path: str | Path | None = None,
                 is_dir: bool = False, head: bytes | None = None) -> int:
    """Extension-first resolution with magic-byte override for conflicting
    or unknown extensions (Extension::resolve_conflicting semantics):
    a confident extension wins without touching the disk; otherwise the
    header decides; the extension table is the fallback."""
    ext_kind = kind_from_extension(extension, is_dir)
    if is_dir:
        return ext_kind
    ext = (extension or "").lower().lstrip(".")
    needs_magic = ext in CONFLICTING_EXTENSIONS or ext_kind == ObjectKind.UNKNOWN
    if not needs_magic:
        return ext_kind
    if head is None:
        if path is None:
            return ext_kind
        head = _read_head(path)
    if not head:
        return ext_kind
    sniffed = sniff_kind(head)
    if sniffed is not None:
        return sniffed
    # no signature: an unknown extension with readable content is TEXT
    # (sd-file-ext text detection)
    if ext_kind == ObjectKind.UNKNOWN and looks_text(head):
        return ObjectKind.TEXT
    return ext_kind
