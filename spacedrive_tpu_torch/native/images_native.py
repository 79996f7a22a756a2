"""ctypes binding of the image codecs (``sd_images.cc``).

Counterpart of ``spacedrive_tpu/native/images_native.py``: JPEG and PNG
decoded straight into numpy RGB buffers (JPEG scaled down in DCT space
while it decodes) and RGB encoded as WebP, over the system's libjpeg,
libpng and libwebp. Unlike the reference, importing this module builds
nothing: :func:`library` builds and binds on first use and raises
:class:`..NativeBuildError` where the toolchain or the libraries' headers
are missing (the thumbnailer then uses PIL).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from . import build_shared

#: formats the native decoder reads; the thumbnailer sends the rest to PIL
NATIVE_DECODE_EXTENSIONS = {"jpg", "jpeg", "png"}
LIBS = ("-ljpeg", "-lpng", "-lwebp")
#: the largest image the decoder takes; its per-thread buffer holds it
MAX_PIXELS = 64_000_000

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class ImageDecodeError(Exception):
    pass


def library() -> ctypes.CDLL:
    """The codec library, built and bound on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_shared("sdimages", ["sd_images.cc"], LIBS)))
            lib.sd_image_decode_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
            lib.sd_image_decode_rgb.restype = ctypes.c_int64
            lib.sd_image_encode_webp.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
            lib.sd_image_encode_webp.restype = ctypes.c_uint64
            lib.sd_webp_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
            lib.sd_webp_free.restype = None
            _lib = lib
        return _lib


_scratch = threading.local()


def _scratch_buf(nbytes: int) -> np.ndarray:
    """A decode buffer reused by each thread: a thumbnail batch decodes
    one image after another, and a fresh ~190 MiB buffer each time churns
    the allocator."""
    buf = getattr(_scratch, "buf", None)
    if buf is None or buf.nbytes < nbytes:
        buf = np.empty(nbytes, np.uint8)
        _scratch.buf = buf
    return buf


def decode_rgb(path: str | Path, max_edge: int) -> np.ndarray:
    """Decode to an (h, w, 3) uint8 array. ``max_edge`` > 0 lets a JPEG
    scale down while it decodes (its edge stays at or above max_edge; the
    caller finishes the reduction). Raises :class:`ImageDecodeError` on an
    unsupported or corrupt file, or one over ``MAX_PIXELS``."""
    lib = library()
    buf = _scratch_buf(MAX_PIXELS * 3)
    w = ctypes.c_int32(0)
    h = ctypes.c_int32(0)
    n = lib.sd_image_decode_rgb(str(path).encode(), buf.ctypes.data, buf.nbytes, max_edge,
                                ctypes.byref(w), ctypes.byref(h))
    if n <= 0:
        raise ImageDecodeError(f"native decode failed for {path} (rc={n})")
    return buf[:n].reshape(h.value, w.value, 3).copy()


def encode_webp(rgb: np.ndarray, quality: float) -> bytes:
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError("encode_webp wants (h, w, 3) uint8")
    lib = library()
    rgb = np.ascontiguousarray(rgb)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.sd_image_encode_webp(rgb.ctypes.data, rgb.shape[1], rgb.shape[0], float(quality),
                                 ctypes.byref(out))
    if n == 0:
        raise ImageDecodeError("webp encode failed")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.sd_webp_free(out)
