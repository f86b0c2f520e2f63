"""ctypes bindings for the native host IO runtime (native/uvit_io.cpp).

Counterpart of uncertainty_vit_tpu/utils/native.py (:34-154), over the same
C++ source. The shared library is compiled at first use with
``g++ -O3 -fPIC -shared ... -ljpeg -lpthread`` into
``build/native/libuvit_io-<hash>.so`` under the checkout (listed in
.gitignore; the hash covers the source and the flags), never next to the
source. It exposes:
  - decode_jpeg_batch(paths, size, num_threads) → (batch u8 [N,S,S,3], ok [N])
  - decode_jpeg_batch_letterbox(paths, short, canvas, num_threads)
  - assemble_batch(arrays, num_threads) → contiguous stacked array

Every native call releases the GIL (ctypes does so), so decoding and
assembly run on real threads. This is host IO, not a kernel: where the
library cannot be built (no compiler, no libjpeg) ``available()`` is False,
``assemble_batch`` is ``np.stack`` and the decoders raise, and the callers
take their Python path, as the JAX package's do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SRC = Path(__file__).resolve().parents[2] / "native" / "uvit_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the library is not available, once its first use failed to build or load it
BUILD_ERROR: Optional[str] = None


def _build() -> Path:
    """The library of the current source and flags, compiled unless it
    exists; raises OSError or SubprocessError where it cannot be built."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode())
    lib = BUILD_DIR / f"libuvit_io-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS], check=True,
                       capture_output=True, text=True, timeout=120)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, lib)  # atomic: another process may be building the same
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, BUILD_ERROR
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except subprocess.CalledProcessError as e:
            BUILD_ERROR = f"g++ failed (rc {e.returncode}): {e.stderr.strip()[-400:]}"
            return None
        except (OSError, subprocess.SubprocessError) as e:
            BUILD_ERROR = f"{type(e).__name__}: {e}"
            return None
        lib.uvit_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.uvit_decode_batch.restype = None
        lib.uvit_decode_batch_letterbox.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.uvit_decode_batch_letterbox.restype = None
        lib.uvit_assemble_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        lib.uvit_assemble_batch.restype = None
        lib.uvit_io_version.argtypes = []
        lib.uvit_io_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (building it on the
    first call)."""
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_jpeg_batch(paths: Sequence[str], size: int, num_threads: int = 8
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode, resize the shorter side to ``size`` (bilinear) and centre-crop
    JPEGs into [N, size, size, 3] uint8. Returns (batch, ok): ok[i] is False
    for a corrupt or non-JPEG file, which the caller resamples
    (dataset_folder.py:164-171)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO runtime unavailable")
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    statuses = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.uvit_decode_batch(c_paths, n, size, _u8(out),
                          statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    return out, statuses == 0


def decode_jpeg_batch_letterbox(paths: Sequence[str], short_size: int, canvas: int,
                                num_threads: int = 8
                                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Letterboxed decode: [N, canvas, canvas, 3] zero-filled squares with
    the aspect-preserving resize pasted top-left, and each image's valid
    extent (h, w) [N, 2]. Returns (batch, valid_hw, ok)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO runtime unavailable")
    n = len(paths)
    out = np.empty((n, canvas, canvas, 3), np.uint8)
    valid_hw = np.zeros((n, 2), np.int32)
    statuses = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.uvit_decode_batch_letterbox(
        c_paths, n, short_size, canvas, _u8(out),
        valid_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads,
    )
    return out, valid_hw, statuses == 0


def assemble_batch(arrays: List[np.ndarray], num_threads: int = 8) -> np.ndarray:
    """Stack equally shaped arrays (``np.stack`` without the GIL); np.stack
    itself where the library is not available."""
    lib = _load()
    if lib is None:
        return np.stack(arrays)
    first = np.asarray(arrays[0])
    contig = [np.ascontiguousarray(a) for a in arrays]
    for a in contig:
        if a.shape != first.shape or a.dtype != first.dtype:
            raise ValueError(f"assemble_batch takes equal shapes and dtypes: {a.shape} "
                             f"{a.dtype} against {first.shape} {first.dtype}")
    n = len(contig)
    out = np.empty((n,) + first.shape, first.dtype)
    ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in contig])
    lib.uvit_assemble_batch(ptrs, n, first.nbytes, _u8(out), num_threads)
    return out
