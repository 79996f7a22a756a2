"""ctypes binding of the linked FFmpeg wrapper (``sd_ffmpeg.cc``).

Counterpart of ``spacedrive_tpu/native/ffmpeg_native.py`` (``probe`` :61,
``decode_frame_rgb`` :72, ``write_test_video`` :89): one representative
video frame for a thumbnail (embedded cover art first, else a keyframe
``SEEK_PERCENTAGE`` of the way in, scaled in libswscale), stream probing
for the metadata extractor, and a small test encoder. The library links
libavformat, libavcodec, libavutil and libswscale and needs their headers.
Unlike the reference, importing this module builds nothing: :func:`library`
builds and binds on first use and raises :class:`..NativeBuildError` where
the headers or the libraries are missing (the thumbnailer then tries the
``ffmpeg`` CLI, the metadata extractor ``ffprobe``).
"""

from __future__ import annotations

import ctypes
import json
import threading
from pathlib import Path
from typing import Any

import numpy as np

from . import build_shared

LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")

#: seek point as a fraction of the duration (the reference's thumbnailer
#: seek_percentage 0.1)
SEEK_PERCENTAGE = 0.1

#: decode edge of a video frame for a thumbnail: a little over the 512 px
#: canvas, so the area-preserving scale step has room on wide frames
DEFAULT_TARGET_EDGE = 768

_lib_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The wrapper, built and bound on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_shared("sdffmpeg", ["sd_ffmpeg.cc"], LIBS)))
            lib.sd_ffmpeg_probe_json.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                                 ctypes.c_int64]
            lib.sd_ffmpeg_probe_json.restype = ctypes.c_int64
            lib.sd_ffmpeg_decode_frame_rgb.argtypes = [
                ctypes.c_char_p, ctypes.c_double, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
            lib.sd_ffmpeg_decode_frame_rgb.restype = ctypes.c_int64
            lib.sd_ffmpeg_write_test_video.argtypes = [
                ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
            lib.sd_ffmpeg_write_test_video.restype = ctypes.c_int32
            lib.sd_ffmpeg_err_str.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            lib.sd_ffmpeg_err_str.restype = None
            _lib = lib
        return _lib


class FfmpegError(Exception):
    def __init__(self, code: int):
        buf = ctypes.create_string_buffer(256)
        library().sd_ffmpeg_err_str(int(code), buf, 256)
        super().__init__(buf.value.decode(errors="replace"))
        self.code = int(code)


def probe(path: str | Path) -> dict[str, Any]:
    """Format and stream metadata: duration, bit_rate, container tags and
    the streams (codec, dimensions, fps, channels, sample_rate,
    attached_pic)."""
    lib = library()
    cap = 1 << 16
    buf = ctypes.create_string_buffer(cap)
    rc = lib.sd_ffmpeg_probe_json(str(path).encode(), buf, cap)
    if rc < 0:
        raise FfmpegError(rc)
    return json.loads(buf.value.decode(errors="replace"))


def decode_frame_rgb(path: str | Path, seek_percent: float = SEEK_PERCENTAGE,
                     target_edge: int = DEFAULT_TARGET_EDGE) -> np.ndarray:
    """One representative RGB frame as an (h, w, 3) uint8 array."""
    lib = library()
    edge = target_edge if target_edge > 0 else 8192
    cap = edge * edge * 3
    out = np.empty(cap, np.uint8)
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    rc = lib.sd_ffmpeg_decode_frame_rgb(str(path).encode(), float(seek_percent),
                                        int(target_edge), out.ctypes.data_as(ctypes.c_void_p),
                                        cap, ctypes.byref(w), ctypes.byref(h))
    if rc < 0:
        raise FfmpegError(rc)
    return out[:rc].reshape(h.value, w.value, 3).copy()


def write_test_video(path: str | Path, width: int = 64, height: int = 48,
                     frames: int = 24, fps: int = 12) -> None:
    """Encode a small gradient video (a test fixture writer)."""
    rc = library().sd_ffmpeg_write_test_video(str(path).encode(), int(width), int(height),
                                              int(frames), int(fps))
    if rc != 0:
        raise FfmpegError(rc)
