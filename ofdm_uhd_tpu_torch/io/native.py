"""ctypes loader for the native IQ deframer (native_src/deframe.cpp).

The counterpart of `ofdm_uhd_tpu/io/native.py`. g++ builds the library
at first use into the port's build directory (kernels/build.py
`build_dir()`, under the checkout's gitignored build/), named by a hash
of the source and flags, never beside the source. Where it cannot be
built, `_load` raises ImportError, so callers (io.capture) take the NumPy
path; `available()` says which path they take. Host code, not a device
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from ..kernels.build import build_dir

SRC = Path(__file__).resolve().parent / "native_src" / "deframe.cpp"
# no -march=native: a build directory copied to another machine must load
# there (the conversions are one multiply, or one clamp and round, a
# value, so the bits do not depend on the instruction set)
FLAGS = ("-O3", "-shared", "-fPIC")


class _Native:
    lib: ctypes.CDLL | None = None
    error: ImportError | None = None


_NATIVE = _Native()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    return build_dir() / f"libdeframe_{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    if _NATIVE.lib is not None:
        return _NATIVE.lib
    if _NATIVE.error is not None:
        raise _NATIVE.error
    so = library_path()
    try:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
                out = Path(tmp) / so.name
                subprocess.run(["g++", *FLAGS, "-o", str(out), str(SRC)],
                               check=True, capture_output=True, timeout=120)
                os.replace(out, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.SubprocessError) as e:
        _NATIVE.error = ImportError(f"native deframe build failed: {e}")
        raise _NATIVE.error from e
    lib.sc16_to_fc32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_long]
    lib.sc16_to_fc32.restype = None
    lib.fc32_to_sc16.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_long]
    lib.fc32_to_sc16.restype = None
    lib.block_power.argtypes = [ctypes.c_void_p, ctypes.c_long]
    lib.block_power.restype = ctypes.c_double
    _NATIVE.lib = lib
    return lib


def available() -> bool:
    """Whether the native library is built and loaded (read_capture then
    converts sc16 through it), building it on the first call."""
    try:
        _load()
    except ImportError:
        return False
    return True


def deframe_sc16(raw: bytes) -> np.ndarray:
    """Interleaved int16 IQ bytes -> complex64 array (native convert)."""
    lib = _load()
    n = len(raw) // 4
    inbuf = np.frombuffer(raw, dtype=np.int16, count=2 * n)
    out = np.empty(2 * n, dtype=np.float32)
    lib.sc16_to_fc32(inbuf.ctypes.data, out.ctypes.data, n)
    return out.view(np.complex64)


def frame_sc16(samples: np.ndarray) -> bytes:
    """complex64 array -> interleaved int16 IQ bytes (native convert)."""
    lib = _load()
    n = len(samples)
    inbuf = np.ascontiguousarray(samples, dtype=np.complex64).view(np.float32)
    out = np.empty(2 * n, dtype=np.int16)
    lib.fc32_to_sc16(inbuf.ctypes.data, out.ctypes.data, n)
    return out.tobytes()


def block_power(samples: np.ndarray) -> float:
    """Mean |x|^2 of a complex64 block (native reduction; AGC feed)."""
    lib = _load()
    buf = np.ascontiguousarray(samples, dtype=np.complex64).view(np.float32)
    return float(lib.block_power(buf.ctypes.data, len(samples)))
