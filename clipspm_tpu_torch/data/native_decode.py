"""ctypes binding for the native C++ batch JPEG decoder.

The source is the shared ``native/frame_decoder.cc``, read in place; the
port builds it with ``g++ ... -ljpeg`` into its own git-ignored
``clipspm_tpu_torch/build/`` (never into ``native/``). As in
``clipspm_tpu/data/native_decode.py``, decoding falls back to PIL when the
library cannot be built or loaded (no libjpeg) or a file is not a baseline
JPEG of the expected geometry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "frame_decoder.cc")
BUILD_DIR = os.path.join(_PKG, "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libframe_decoder-{digest}.so")


def _build(out: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", SOURCE, "-o", tmp,
           "-shared", "-ljpeg", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


def get_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the decoder library; None if unavailable."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        path = _library_path()
        if not os.path.isfile(path) and not _build(path):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _lib_failed = True
            return None
        lib.decode_jpeg_frames.restype = ctypes.c_int
        lib.decode_jpeg_frames.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        if lib.frame_decoder_version() != 1:
            raise RuntimeError("native/frame_decoder.cc version mismatch")
        _lib = lib
        return _lib


def decode_frames(paths: Sequence[str], height: int, width: int,
                  n_threads: int = 8) -> np.ndarray:
    """Decode JPEG ``paths`` into a uint8 ``[N, H, W, 3]`` array: the native
    threaded decoder when every file decodes cleanly at the expected
    geometry, else PIL for the whole batch."""
    n = len(paths)
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    lib = get_library()
    if lib is not None and n > 0:
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        rc = lib.decode_jpeg_frames(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            height, width, n_threads)
        if rc == 0:
            return out
    from PIL import Image

    for i, p in enumerate(paths):
        with Image.open(p) as im:
            im = im.convert("RGB")
            if im.size != (width, height):
                # aspect-preserving resize + center crop, not a stretch
                w0, h0 = im.size
                scale = max(width / w0, height / h0)
                im = im.resize((max(width, round(w0 * scale)),
                                max(height, round(h0 * scale))))
                w1, h1 = im.size
                left, top = (w1 - width) // 2, (h1 - height) // 2
                im = im.crop((left, top, left + width, top + height))
            out[i] = np.asarray(im, dtype=np.uint8)
    return out
