"""ctypes binding of HEIF/AVIF decode (``sd_heif.cc`` over a dlopen'd libheif).

Counterpart of ``spacedrive_tpu/native/heif_native.py`` (``available`` :51,
``dims`` :55, ``decode_rgb`` :68, ``encode_file`` :91). The library has no
link-time libheif dependency, so it builds wherever g++ does;
:func:`available` says whether the libheif runtime loaded. Unlike the
reference, importing this module builds nothing: :func:`library` builds and
binds on first use and raises :class:`..NativeBuildError` where g++ fails.
:func:`encode_file` exists so that tests and ``chip_smoke.py`` can write
fixtures; it answers False where libheif has no HEVC or AV1 encoder.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import build_shared

HEIF_EXTENSIONS = {"heic", "heif", "avif"}
LIBS = ("-ldl",)

#: the largest primary image decoded: a hostile file must not allocate
#: without bound
MAX_PIXELS = 64 * 1024 * 1024

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class HeifError(Exception):
    pass


def library() -> ctypes.CDLL:
    """The binding, built and bound on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_shared("sdheif", ["sd_heif.cc"], LIBS)))
            lib.sd_heif_available.argtypes = []
            lib.sd_heif_available.restype = ctypes.c_int
            lib.sd_heif_decode_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
            lib.sd_heif_decode_rgb.restype = ctypes.c_int64
            lib.sd_heif_encode_file.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32]
            lib.sd_heif_encode_file.restype = ctypes.c_int32
            lib.sd_heif_dims.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
            lib.sd_heif_dims.restype = ctypes.c_int32
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the libheif runtime loads (builds the binding first)."""
    return bool(library().sd_heif_available())


def dims(path: str | Path) -> tuple[int, int]:
    """(width, height) of the primary image, read from the container with
    no HEVC decode (the metadata extractor's route)."""
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    rc = library().sd_heif_dims(str(path).encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise HeifError("libheif runtime not available" if rc == -1
                        else f"unreadable heif file ({rc})")
    return w.value, h.value


def decode_rgb(path: str | Path) -> np.ndarray:
    """The primary image as an (h, w, 3) uint8 array. The buffer is sized
    from the declared dimensions, read without a decode, and capped at
    MAX_PIXELS."""
    dw, dh = dims(path)
    if dw * dh > MAX_PIXELS:
        raise HeifError("image exceeds decode size limit")
    # the decoded plane may be a little larger than declared (codec
    # alignment); the C side still bounds the copy by cap
    cap = max(dw + 64, 64) * max(dh + 64, 64) * 3
    out = np.empty(cap, np.uint8)
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    rc = library().sd_heif_decode_rgb(str(path).encode(), out.ctypes.data_as(ctypes.c_void_p),
                                      cap, ctypes.byref(w), ctypes.byref(h))
    if rc < 0:
        raise HeifError({-1: "libheif runtime not available",
                         -3: "image exceeds decode size limit"}.get(
                             int(rc), f"heif decode failed ({rc})"))
    return out[:rc].reshape(h.value, w.value, 3).copy()


def encode_file(path: str | Path, rgb: np.ndarray, quality: int = 60) -> bool:
    """Write RGB24 as .heic / .avif; False where the local libheif has no
    encoder (callers skip then)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    rc = library().sd_heif_encode_file(str(path).encode(), rgb.ctypes.data_as(ctypes.c_void_p),
                                       w, h, int(quality))
    if rc == -4:
        return False
    if rc != 0:
        raise HeifError(f"heif encode failed ({rc})")
    return True
