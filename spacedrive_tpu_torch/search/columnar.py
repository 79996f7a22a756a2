"""The columnar search index: fixed-width byte columns + filter columns.

Counterpart of ``spacedrive_tpu/search/columnar.py``. One
:class:`ColumnarIndex` per library holds every ``file_path`` row as a
fixed-width columnar record, on the host (numpy):

- **byte rows** (``(cap, W) u8``, row-major, where the JAX package keeps
  plane-major ``(W, cap)`` planes under the same ``*_planes`` names):
  folded ``name`` (W=64) for LIKE-substring scoring, raw
  ``materialized_path`` (W=96) and ``extension`` (W=12) for SQL ``=``/``IN``
  byte equality, and ``date_created`` (W=40) for BINARY-collation range
  compares;
- **key columns** (``(cap,) int32``) beside the path and extension rows:
  :func:`.kernels.row_keys` of each zero-padded row, which the exact-match
  kernel compares before it reads a row (rows an upsert wrote get their
  keys in one pass at :meth:`ColumnarIndex.refresh_keys`, which the
  mirror's delta feed runs);
- **filter columns**: ``location_id`` (i64), ``kind`` (i32), ``hidden`` /
  ``favorite`` (i8), ``size_in_bytes`` (i64), each with −1 for NULL;
- an **overflow sidecar**: the few rows whose value truncated at a plane
  width keep their full decoded fields host-side; every query patches those
  rows through :func:`match_row`, the pure-Python oracle, so truncation can
  never change an answer.

Rows are kept sorted by ``id`` (AUTOINCREMENT ids are monotonic, so appends
preserve the invariant and slot lookup is a binary search); deletes flip an
``alive`` bit; updates are written in place. The :class:`DeviceMirror` keeps
the scored columns resident on the node's device as torch tensors in the
master's layout (row-major bytes are what the kernels read), patched from
the master's delta feed with ``index_copy_``. Unlike the JAX mirror, which
copies ``size`` and ``location`` with ``jnp.asarray`` and so narrows them to
int32 when 64-bit mode is off, they stay int64 here: a size of 3 GiB is a
size of 3 GiB, as in SQLite.

:func:`eval_mask_device` builds a query's mask on the device from the
kernels of :mod:`.kernels` and copies it to the host once. Semantics are the
SQL path's, exactly: :func:`parse_predicate` normalizes a ``search.paths``
arg with the SAME coercions ``api/routers/search.py`` applies, and returns
None for anything the index cannot answer bit-exactly (LIKE wildcards in the
needle, tag subqueries, NUL bytes, over-long needles); those queries stay on
SQLite. The JAX package's presence bitmap and CPU engine (``prescreen_np``,
``eval_mask_cpu``) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np
import torch

from . import kernels
from .kernels import MAX_NEEDLE, fold

W_NAME = 64
W_PATH = 96
W_EXT = 12
W_DATE = 40

#: sentinel for NULL in integer filter columns (no real value collides:
#: ids/sizes/kinds/locations are non-negative, hidden/favorite are 0/1)
NULL_I = -1

_GROW = 4096  # minimum capacity step (one tile of rows)


@dataclasses.dataclass(frozen=True)
class Predicate:
    """A normalized, index-answerable ``search.paths`` filter set."""

    location: int | None = None
    needle: bytes | None = None          # folded LIKE-substring needle
    exts: tuple[bytes, ...] | None = None
    kinds: tuple[int, ...] | None = None
    favorite: int | None = None
    exclude_hidden: bool = False
    path: bytes | None = None            # materialized_path equality
    date_lo: bytes | None = None
    date_hi: bytes | None = None
    size_lo: int | None = None
    size_hi: int | None = None


def parse_predicate(arg: dict[str, Any]) -> tuple[Predicate | None, str]:
    """(predicate, "") when the index can answer this filter set
    bit-exactly, else (None, reason). Coercions mirror
    api/routers/search.py `_path_filters` EXACTLY — any divergence is a
    byte-identity bug, so prefer returning None over approximating."""
    if arg.get("tags"):
        return None, "tags"  # subquery over tag_on_object — SQLite's
    pred: dict[str, Any] = {}
    if arg.get("location_id") is not None:
        v = arg["location_id"]
        if not isinstance(v, int) or isinstance(v, bool):
            return None, "arg"
        pred["location"] = v
    if arg.get("search"):
        # the SQL path binds f"%{search}%": stringified, % and _ live as
        # LIKE wildcards there — wildcard semantics stay on SQLite
        needle = fold(str(arg["search"]).encode("utf-8"))
        if (b"%" in needle or b"_" in needle or b"\x00" in needle
                or not 1 <= len(needle) <= MAX_NEEDLE):
            return None, "needle"
        pred["needle"] = needle
    if arg.get("extensions"):
        try:
            exts = tuple(e.lstrip(".").lower().encode("utf-8")
                         for e in arg["extensions"])
        except AttributeError:
            return None, "arg"
        if any(b"\x00" in e for e in exts):
            return None, "arg"
        pred["exts"] = exts
    if arg.get("kinds"):
        kinds = tuple(arg["kinds"])
        if not all(isinstance(k, int) and not isinstance(k, bool)
                   for k in kinds):
            return None, "arg"
        pred["kinds"] = kinds
    if arg.get("favorite") is not None:
        try:
            pred["favorite"] = int(arg["favorite"])
        except (TypeError, ValueError):
            return None, "arg"
    if not arg.get("include_hidden"):
        pred["exclude_hidden"] = True
    if arg.get("materialized_path"):
        v = arg["materialized_path"]
        if not isinstance(v, str):
            return None, "arg"
        pred["path"] = v.encode("utf-8")
    if arg.get("date_range"):
        rng = arg["date_range"]
        if not isinstance(rng, (list, tuple)) or len(rng) != 2:
            return None, "arg"
        for key, bound in zip(("date_lo", "date_hi"), rng):
            if bound is None:
                continue
            if not isinstance(bound, str):
                return None, "arg"
            raw = bound.encode("utf-8")
            if len(raw) > W_DATE or b"\x00" in raw:
                return None, "arg"
            pred[key] = raw
    if arg.get("size_range"):
        rng = arg["size_range"]
        if not isinstance(rng, (list, tuple)) or len(rng) != 2:
            return None, "arg"
        for key, bound in zip(("size_lo", "size_hi"), rng):
            if bound is None:
                continue
            if not isinstance(bound, int) or isinstance(bound, bool):
                return None, "arg"
            pred[key] = bound
    return Predicate(**pred), ""


def match_row(fields: dict[str, Any], pred: Predicate) -> bool:
    """Pure-Python row matcher with the SQL path's exact semantics — the
    overflow-row patch and the parity oracle tests compare every engine
    against."""
    if pred.location is not None and fields.get("location_id") != pred.location:
        return False
    if pred.exclude_hidden:
        hidden = fields.get("hidden")
        if not (hidden is None or not hidden):
            return False
    if pred.needle is not None:
        name = fields.get("name")
        if name is None or pred.needle not in fold(name.encode("utf-8")):
            return False
    if pred.exts is not None:
        ext = fields.get("extension")
        if ext is None or ext.encode("utf-8") not in pred.exts:
            return False
    if pred.path is not None:
        path = fields.get("materialized_path")
        if path is None or path.encode("utf-8") != pred.path:
            return False
    if pred.kinds is not None:
        kind = fields.get("kind")
        if kind is None or kind not in pred.kinds:
            return False
    if pred.favorite is not None:
        fav = fields.get("favorite")
        if fav is None or int(fav) != pred.favorite:
            return False
    if pred.date_lo is not None or pred.date_hi is not None:
        date = fields.get("date_created")
        if date is None:
            return False
        raw = str(date).encode("utf-8")
        if pred.date_lo is not None and raw < pred.date_lo:
            return False
        if pred.date_hi is not None and raw > pred.date_hi:
            return False
    if pred.size_lo is not None or pred.size_hi is not None:
        size = fields.get("size_in_bytes")
        if size is None:
            return False
        if pred.size_lo is not None and size < pred.size_lo:
            return False
        if pred.size_hi is not None and size > pred.size_hi:
            return False
    return True


#: the loader SELECT every build/refresh path uses (LEFT JOIN pulls the
#: object-side filter columns; decode stays cheap — raw sqlite3.Row)
LOADER_SQL = (
    "SELECT fp.id AS id, fp.name AS name, fp.extension AS extension, "
    "fp.materialized_path AS materialized_path, "
    "fp.location_id AS location_id, fp.hidden AS hidden, "
    "fp.size_in_bytes AS size_in_bytes, fp.date_created AS date_created, "
    "o.kind AS kind, o.favorite AS favorite "
    "FROM file_path fp LEFT JOIN object o ON fp.object_id = o.id")


def _text_bytes(value: Any) -> bytes | None:
    if value is None:
        return None
    return str(value).encode("utf-8")


class ColumnarIndex:
    """The numpy master copy of one library's index."""

    #: every per-row array, with the fill of an empty slot
    COLUMNS = {"ids": 0, "alive": False, "name_len": 0, "path_len": 0,
               "ext_len": 0, "date_len": 0, "location": 0, "hidden": 0,
               "kind": 0, "favorite": 0, "size": 0}
    PLANES = ("name_planes", "path_planes", "ext_planes", "date_planes")
    #: key column -> the byte rows it keys (kernels.row_keys of each row; a
    #: zero row's key is 0, the fill of an empty slot)
    KEYS = {"path_key": "path_planes", "ext_key": "ext_planes"}

    def __init__(self) -> None:
        self.n = 0
        self.cap = 0
        self.ids = np.empty(0, dtype=np.int64)
        self.alive = np.empty(0, dtype=bool)
        self.name_planes = np.empty((0, W_NAME), dtype=np.uint8)
        self.name_len = np.empty(0, dtype=np.int32)
        self.path_planes = np.empty((0, W_PATH), dtype=np.uint8)
        self.path_len = np.empty(0, dtype=np.int32)
        self.ext_planes = np.empty((0, W_EXT), dtype=np.uint8)
        self.ext_len = np.empty(0, dtype=np.int32)
        self.date_planes = np.empty((0, W_DATE), dtype=np.uint8)
        self.date_len = np.empty(0, dtype=np.int32)
        self.location = np.empty(0, dtype=np.int64)
        self.hidden = np.empty(0, dtype=np.int8)
        self.kind = np.empty(0, dtype=np.int32)
        self.favorite = np.empty(0, dtype=np.int8)
        self.size = np.empty(0, dtype=np.int64)
        self.path_key = np.empty(0, dtype=np.int32)
        self.ext_key = np.empty(0, dtype=np.int32)
        #: id -> full decoded fields for rows a fixed width truncated
        self.overflow: dict[int, dict[str, Any]] = {}
        #: bumped on every mutation — the DeviceMirror resyncs
        #: (incrementally) when its generation falls behind
        self.generation = 0
        self._delta_slots: list[int] | None = []
        #: slots whose rows an upsert wrote since the last refresh_keys
        self._stale_keys: list[int] = []

    # -- capacity ------------------------------------------------------------
    def _ensure_cap(self, extra: int) -> None:
        need = self.n + extra
        if need <= self.cap:
            return
        new_cap = max(_GROW, self.cap * 2)
        while new_cap < need:
            new_cap *= 2
        for name, fill in (*self.COLUMNS.items(), *((key, 0) for key in self.KEYS)):
            old = getattr(self, name)
            out = np.full(new_cap, fill, dtype=old.dtype)
            out[: self.n] = old[: self.n]
            setattr(self, name, out)
        for name in self.PLANES:
            old = getattr(self, name)
            out = np.zeros((new_cap, old.shape[1]), dtype=np.uint8)
            out[: self.n] = old[: self.n]
            setattr(self, name, out)
        self.cap = new_cap
        #: capacity change invalidates every mirror slice — full resync
        self._delta_slots = None

    # -- row encode ----------------------------------------------------------
    def _write_plane(self, planes: np.ndarray, lens: np.ndarray,
                     slot: int, raw: bytes | None) -> bool:
        """Returns True when the value overflowed its plane width."""
        width = planes.shape[1]
        planes[slot] = 0
        if raw is None:
            lens[slot] = NULL_I
            return False
        clipped = raw[:width]
        if clipped:
            planes[slot, : len(clipped)] = np.frombuffer(
                clipped, dtype=np.uint8)
        lens[slot] = len(raw)
        return len(raw) > width

    def _write_row(self, slot: int, row: Any) -> None:
        fields = {k: row[k] for k in row.keys()} if not isinstance(row, dict) \
            else row
        self.ids[slot] = fields["id"]
        self.alive[slot] = True
        name_raw = _text_bytes(fields.get("name"))
        over = self._write_plane(self.name_planes, self.name_len, slot,
                                 None if name_raw is None
                                 else fold(name_raw))
        over |= self._write_plane(self.path_planes, self.path_len, slot,
                                  _text_bytes(fields.get("materialized_path")))
        over |= self._write_plane(self.ext_planes, self.ext_len, slot,
                                  _text_bytes(fields.get("extension")))
        over |= self._write_plane(self.date_planes, self.date_len, slot,
                                  _text_bytes(fields.get("date_created")))
        loc = fields.get("location_id")
        self.location[slot] = NULL_I if loc is None else loc
        hidden = fields.get("hidden")
        self.hidden[slot] = NULL_I if hidden is None else int(bool(hidden))
        kind = fields.get("kind")
        self.kind[slot] = NULL_I if kind is None else kind
        fav = fields.get("favorite")
        self.favorite[slot] = NULL_I if fav is None else int(bool(fav))
        size = fields.get("size_in_bytes")
        self.size[slot] = NULL_I if size is None else size
        row_id = int(fields["id"])
        if over:
            self.overflow[row_id] = {
                "name": fields.get("name"),
                "extension": fields.get("extension"),
                "materialized_path": fields.get("materialized_path"),
                "date_created": fields.get("date_created"),
                "location_id": loc, "hidden": hidden, "kind": kind,
                "favorite": fav, "size_in_bytes": size,
            }
        else:
            self.overflow.pop(row_id, None)

    def _write_keys(self, slots) -> None:
        """The key columns at ``slots`` (a slice or an index array) from
        their rows, one vectorized pass per column."""
        for key, attr in self.KEYS.items():
            getattr(self, key)[slots] = kernels.row_keys(getattr(self, attr)[slots])

    def refresh_keys(self) -> None:
        """Bring the key columns up to date with the rows upserts wrote."""
        if self._stale_keys:
            self._write_keys(np.unique(np.asarray(self._stale_keys, dtype=np.int64)))
            self._stale_keys = []

    def _note_delta(self, slot: int) -> None:
        self.generation += 1
        if self._delta_slots is not None:
            self._delta_slots.append(slot)
            if len(self._delta_slots) > 4096:
                self._delta_slots = None

    # -- bulk build ----------------------------------------------------------
    def build(self, rows: Iterable[Any]) -> None:
        rows = list(rows)
        self.n = 0
        self.cap = 0
        self.overflow.clear()
        self._ensure_cap(max(len(rows), 1))
        for i, row in enumerate(rows):
            self._write_row(i, row)
        self.n = len(rows)
        self._write_keys(slice(0, self.n))
        self._stale_keys = []
        self.generation += 1
        self._delta_slots = None

    # -- incremental ---------------------------------------------------------
    def slot_of(self, row_id: int) -> int | None:
        i = int(np.searchsorted(self.ids[: self.n], row_id))
        if i < self.n and self.ids[i] == row_id:
            return i
        return None

    @property
    def max_id(self) -> int:
        return int(self.ids[self.n - 1]) if self.n else 0

    @property
    def alive_count(self) -> int:
        return int(self.alive[: self.n].sum())

    def upsert(self, row: Any) -> bool:
        """Update in place or append; False = the row's id is below
        ``max_id`` but unknown (an explicit-id insert the sorted-append
        invariant cannot absorb — the caller full-rebuilds)."""
        row_id = int(row["id"])
        slot = self.slot_of(row_id)
        if slot is None:
            if row_id <= self.max_id:
                return False
            self._ensure_cap(1)
            slot = self.n
            self.n += 1
        self._write_row(slot, row)
        self._stale_keys.append(slot)
        self._note_delta(slot)
        return True

    def delete_id(self, row_id: int) -> None:
        slot = self.slot_of(row_id)
        if slot is not None and self.alive[slot]:
            self.alive[slot] = False
            self.overflow.pop(row_id, None)
            self._note_delta(slot)

    # -- introspection -------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return sum(getattr(self, name).nbytes
                   for name in (*self.COLUMNS, *self.PLANES, *self.KEYS))

    def consume_delta(self) -> list[int] | None:
        """Changed slots since the last call (None = resync everything);
        the DeviceMirror's incremental-update feed. The key columns are
        current when it returns."""
        self.refresh_keys()
        delta = self._delta_slots
        self._delta_slots = []
        return delta


def index_from_jax(idx: Any) -> ColumnarIndex:
    """The port's index holding the columns of a JAX-package
    ``ColumnarIndex`` (duck-typed: its numpy arrays are read, nothing of that
    package is imported). Its plane-major ``(W, CAP)`` byte planes become
    the port's row-major ``(CAP, W)`` rows, and the key columns are computed
    from them; the presence bitmap is not carried."""
    out = ColumnarIndex()
    out.n, out.cap = idx.n, idx.cap
    for name in ColumnarIndex.COLUMNS:
        setattr(out, name, np.array(getattr(idx, name), copy=True))
    for name in ColumnarIndex.PLANES:
        setattr(out, name, np.ascontiguousarray(np.asarray(getattr(idx, name)).T))
    for key in ColumnarIndex.KEYS:
        setattr(out, key, np.zeros(out.cap, dtype=np.int32))
    out._write_keys(slice(0, out.n))
    out.overflow = {k: dict(v) for k, v in idx.overflow.items()}
    out.generation = 1
    out._delta_slots = None
    return out


class DeviceMirror:
    """Torch copies of the scored columns, resident on ``device`` and
    patched incrementally (``index_copy_`` of the changed slots) from the
    master's delta feed — queries never pay a host→device copy of the index.
    Byte columns are row-major ``(CAP, W)`` u8 with their int32 key columns
    beside them; ``location`` and ``size`` stay int64."""

    #: mirror key -> master byte rows ``(CAP, W)``
    ROWS = {"name": "name_planes", "path": "path_planes", "ext": "ext_planes",
            "date": "date_planes"}
    #: master columns the masks read, with the fill past ``n``
    COLUMNS = {"path_len": NULL_I, "ext_len": NULL_I, "date_len": NULL_I,
               "location": NULL_I, "hidden": NULL_I, "kind": NULL_I,
               "favorite": NULL_I, "size": NULL_I, "alive": False,
               # the key of a zero row: padding rows keep keys that match
               "path_key": 0, "ext_key": 0}

    def __init__(self, device: str | torch.device) -> None:
        self.device = torch.device(device)
        self.generation = -1
        self.cap = 0
        self.arrays: dict[str, torch.Tensor] = {}
        #: whole-index uploads and incremental patches so far
        self.uploads = 0
        self.patches = 0

    def sync(self, idx: ColumnarIndex) -> None:
        if self.generation == idx.generation and self.cap:
            idx.consume_delta()  # stay drained
            return
        delta = idx.consume_delta()
        dev_cap = kernels.pad_cap(max(idx.n, 1))
        n, dev = idx.n, self.device
        if delta is None or dev_cap != self.cap or not self.arrays:
            self.arrays = {}
            for key, attr in self.ROWS.items():
                planes = getattr(idx, attr)
                rows = torch.zeros((dev_cap, planes.shape[1]), dtype=torch.uint8,
                                   device=dev)
                rows[:n] = torch.from_numpy(planes[:n]).to(dev)
                self.arrays[key] = rows
            for key, fill in self.COLUMNS.items():
                live = torch.from_numpy(getattr(idx, key)[:n])
                out = torch.full((dev_cap,), fill, dtype=live.dtype, device=dev)
                out[:n] = live.to(dev)
                self.arrays[key] = out
            self.cap = dev_cap
            self.uploads += 1
        elif delta:
            slots = np.unique(np.asarray(delta, dtype=np.int64))
            at = torch.from_numpy(slots).to(dev)
            for key, attr in self.ROWS.items():
                self.arrays[key].index_copy_(
                    0, at, torch.from_numpy(getattr(idx, attr)[slots]).to(dev))
            for key in self.COLUMNS:
                self.arrays[key].index_copy_(
                    0, at, torch.from_numpy(getattr(idx, key)[slots]).to(dev))
            self.patches += 1
        self.generation = idx.generation


# ---------------------------------------------------------------------------
# mask evaluation
# ---------------------------------------------------------------------------


def _equals(col: torch.Tensor, value: int) -> torch.Tensor:
    """``col == value`` with SQL's answer for a value the column's type
    cannot hold (no row; torch would wrap it into range)."""
    info = torch.iinfo(col.dtype)
    if not info.min <= value <= info.max:
        return torch.zeros_like(col, dtype=torch.bool)
    return col == value


def eval_mask_device(idx: ColumnarIndex, mirror: DeviceMirror,
                     pred: Predicate) -> np.ndarray:
    """(n,) bool host mask of the rows matching ``pred``: built on the
    mirror's device from the kernels of :mod:`.kernels`, copied to the host
    once, then the overflow rows are re-decided there."""
    mirror.sync(idx)
    arr = mirror.arrays
    m = arr["alive"].clone()
    # negative filter values would collide with the NULL sentinel (−1):
    # SQL `col = -1` matches nothing (no stored negatives), so mirror that
    if pred.location is not None:
        m &= _equals(arr["location"], pred.location) if pred.location >= 0 \
            else False
    if pred.exclude_hidden:
        m &= arr["hidden"] <= 0
    if pred.kinds is not None:
        kinds = [k for k in pred.kinds if k >= 0]
        m &= torch.isin(arr["kind"], torch.tensor(kinds, dtype=torch.int64,
                                                  device=mirror.device)) \
            if kinds else False
    if pred.favorite is not None:
        m &= _equals(arr["favorite"], pred.favorite) if pred.favorite >= 0 \
            else False
    if pred.size_lo is not None:
        m &= (arr["size"] >= 0) & (arr["size"] >= pred.size_lo)
    if pred.size_hi is not None:
        m &= (arr["size"] >= 0) & (arr["size"] <= pred.size_hi)
    if pred.exts is not None:
        ext_m = torch.zeros_like(m)
        for needle in pred.exts:
            ext_m |= (kernels.exact(arr["ext"], needle, arr["ext_key"])
                      & (arr["ext_len"] == len(needle)))
        m &= ext_m
    if pred.path is not None:
        m &= (kernels.exact(arr["path"], pred.path, arr["path_key"])
              & (arr["path_len"] == len(pred.path)))
    if pred.date_lo is not None or pred.date_hi is not None:
        valid = arr["date_len"] >= 0
        if pred.date_lo is not None:
            m &= valid & (kernels.lex_cmp(arr["date"], pred.date_lo) >= 0)
        if pred.date_hi is not None:
            m &= valid & (kernels.lex_cmp(arr["date"], pred.date_hi) <= 0)
    if pred.needle is not None:
        m &= kernels.substring(arr["name"], pred.needle)
    out = m[: idx.n].cpu().numpy()
    _patch_overflow(idx, pred, out)
    return out


def _patch_overflow(idx: ColumnarIndex, pred: Predicate,
                    m: np.ndarray) -> None:
    """Re-decide every truncated row host-side against the full values —
    plane scoring may miss (a substring spanning the cut) or over-match
    (an exact prefix) there; the Python oracle is authoritative."""
    for row_id, fields in idx.overflow.items():
        slot = idx.slot_of(row_id)
        if slot is not None and slot < m.shape[0] and idx.alive[slot]:
            m[slot] = match_row(fields, pred)
