"""Host C++ of the port, built with g++ at first use.

Counterpart of ``spacedrive_tpu/native/__init__.py`` (``build_shared`` :21).
Each translation unit here compiles to a shared library under the package's
``_build/`` directory (gitignored), named by a hash of its sources and link
libraries so an edited source rebuilds, and is bound with ``ctypes``.
Builders race safely: each compiles to a temporary file and renames it into
place.

A missing ``g++`` or a failed build raises :class:`NativeBuildError`, as a
failed ``nvcc`` build of the CUDA kernels does (``ops/_kernels.py``). The
cas gather has no stand-in: a pure-Python one would make every gather time
meaningless. The image codecs (``sd_images.cc``, linked against the system's
libjpeg, libpng and libwebp) are a host codec choice: where they do not
build, the thumbnailer decodes and encodes with PIL, as the reference does,
and logs why.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"

GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


class NativeBuildError(RuntimeError):
    pass


def target(name: str, sources: list[str], libs: tuple[str, ...] = ()) -> Path:
    """The library ``build_shared(name, sources, libs)`` writes."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update((NATIVE_DIR / src).read_bytes())
    digest.update(" ".join(libs).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_shared(name: str, sources: list[str], libs: tuple[str, ...] = ()) -> Path:
    """Compile ``sources`` (relative to this directory) into
    ``_build/lib<name>-<hash>.so`` unless that library exists; returns its
    path. ``libs`` (``-l`` flags) go after the sources, where the linker
    needs them. Raises :class:`NativeBuildError` without ``g++`` or when the
    compile fails."""
    out = target(name, sources, libs)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(f"g++ not found: lib{name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, *(str(NATIVE_DIR / s) for s in sources),
                               "-o", tmp, *libs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(f"g++ failed building lib{name} (exit "
                                   f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
