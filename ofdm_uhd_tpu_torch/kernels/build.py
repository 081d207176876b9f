"""Build the hand-written CUDA kernels at first use and load them.

Each source in csrc/ compiles for sm_90a in its own `nvcc` process, all
started together; one more `nvcc` links the objects into one shared
library with a plain C interface (csrc/ofdm_kernels.h), loaded with
ctypes. No PyTorch header is compiled, so the build takes seconds. The
library lands in build/ofdm_uhd_tpu_torch/ beside the package (listed in
.gitignore), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the existing file.

Nothing here runs at import: `library()` builds on its first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("binding.cu", "viterbi.cu", "fft.cu", "localize.cu", "extract.cu",
           "fir.cu", "fir_bf16.cu", "scfront.cu", "halo.cu", "shift.cu",
           "banded.cu", "deframe.cu")
HEADERS = ("ofdm_kernels.h", "viterbi_group.cuh", "viterbi_window.cuh",
           "fir_strided.cuh", "fir_interp.cuh", "scfront_tile.cuh",
           "scfront_split.cuh", "localize_warp.cuh", "banded_body.cuh",
           "shift_body.cuh")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = (ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-lineinfo")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C interface: every entry point returns a cudaError_t (0 = launched)
_SIGNATURES = {
    # llr, rec, bits, batch, n, group, traceback, stream
    "ofdm_viterbi": [_P, _P, _P, _I, _I, _I, _I, _P],
    # llr, dec, bits, batch, n, windows, l, ov, e, stream
    "ofdm_viterbi_windowed": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # llr, bits, batch, n, windows, l, ov, e, stream
    "ofdm_viterbi_windowed_warp": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, y, twiddles, rows, log2n, inverse, stream
    "ofdm_fft": [_P, _P, _P, _I, _I, _I, _P],
    # x, y, twiddles, route twiddles, rows, log2n1, log2n2, inverse, stream
    "ofdm_fft_columns": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, y, twiddles, rows, log2n1, log2n2, inverse, stream
    "ofdm_fft_rows_t": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, y, twiddles, rows, log2n, inverse, in_stride, in_off, cp, stream
    "ofdm_fft_cp": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # m, p, cand, d, eps, caps, nd, mf, span, cp_half, rel, stream
    "ofdm_localize": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      ctypes.c_float, _P],
    # capture, ds, out, caps, n, mf, frame_len, stream
    "ofdm_extract": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, w, y, rows, n_in, n_out, nt, stride, pad_left, stream
    "ofdm_fir_strided": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, g, y, rows, n, l, nd, d_max, stream
    "ofdm_fir_interp": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the bf16 tier of the two above, with the same arguments
    "ofdm_fir_bf16_strided": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ofdm_fir_bf16_interp": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the shifted-FMA tier: x, w, y, rows, n, nt, pad_left, stream
    "ofdm_shift_fir": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, w, y, rows, n_in, n_out, m, nt, pad_left, stream
    "ofdm_shift_decim": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, g, y, rows, n, l, nd, d_max, stream
    "ofdm_shift_interp": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # kind, rows, n_in, n_out, nt, m, lead, out[8]
    "ofdm_shift_plan": [_I, _I, _I, _I, _I, _I, _I, _P],
    # the banded tier: x, w, y, rows, n_in, n_out, nt, stride, pad_left,
    # stream
    "ofdm_banded_strided": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, g, y, rows, n, l, nd, d_max, stream
    "ofdm_banded_interp": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # r, p, rr, rows, n, l, stream
    "ofdm_banded_sc": [_P, _P, _P, _I, _I, _I, _P],
    # capture, ds, out, caps, n, mf, frame_len, stream
    "ofdm_deframe": [_P, _P, _P, _I, _I, _I, _I, _P],
    # r, p, m, rows, n, l, stream
    "ofdm_scfront": [_P, _P, _P, _I, _I, _I, _P],
    # r, p, rr, rows, n, l, stream
    "ofdm_sc_correlate": [_P, _P, _P, _I, _I, _I, _P],
    # r, set, rows, n, l, w, stream
    "ofdm_sc_span": [_P, _P, _I, _I, _I, _I, _P],
    # set, p, q, rows, n, l, w, metric, stream
    "ofdm_sc_stride": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # src pointers, dst pointers (host arrays), pairs, h, stream
    "ofdm_halo_from_right": [_P, _P, _I, _I, _P],
    # device, peer
    "ofdm_enable_peer_access": [_I, _I],
    # device
    "ofdm_set_device": [_I],
}


class _Loaded:
    lib: ctypes.CDLL | None = None
    log: str = ""                     # nvcc's output (ptxas -v when verbose)


_LOADED = _Loaded()
# the device last made current for the library's runtime, per host thread
# (a CUDA runtime's current device is per thread)
_CURRENT = threading.local()


def build_dir() -> Path:
    """build/ofdm_uhd_tpu_torch/ under the checkout holding the package."""
    return Path(__file__).resolve().parents[2] / "build" / "ofdm_uhd_tpu_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(needs the CUDA toolkit and an sm_90a card)")


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library; built from csrc/ on the first call.

    verbose=True adds `-Xptxas -v` to a build, so `build_log()` shows each
    kernel's registers, shared memory and spills. A verbose build keeps
    that report beside the library, and a verbose call loads it from
    there; a library built without it is built again, verbose.
    """
    if _LOADED.lib is not None:
        return _LOADED.lib
    flags = FLAGS + (("-Xptxas", "-v") if verbose else ())
    # `-Xptxas -v` only reports, so it stays out of the name: a verbose
    # build is the library that another process (the tools of cli/) loads
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update((CSRC / name).read_bytes())
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libofdm_kernels_{h.hexdigest()[:16]}.so"
    report = so.with_suffix(".ptxas.log")
    if not so.exists() or (verbose and not report.exists()):
        _compile_and_link(flags, so)
        if verbose:
            tmp = report.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(_LOADED.log)
            os.replace(tmp, report)
    elif verbose:
        _LOADED.log = report.read_text()
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.ofdm_error_string.argtypes = [ctypes.c_int]
    lib.ofdm_error_string.restype = ctypes.c_char_p
    _LOADED.lib = lib
    return lib


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; wait for every one; raise if any
    failed. Their output goes to build_log()."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    _LOADED.log += "".join(outs)
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")


def _compile_and_link(flags: tuple, so: Path) -> None:
    """One nvcc per source into objects, then one link into `so`,
    replaced atomically so that concurrent builds agree."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        objs = [str(Path(tmp) / f"{Path(s).stem}.o") for s in SOURCES]
        _run_all([[nvcc, *flags, "-c", "-o", o, str(CSRC / s)]
                  for s, o in zip(SOURCES, objs)])
        lib = str(Path(tmp) / so.name)
        _run_all([[nvcc, ARCH, "-shared", "-o", lib, *objs]])
        os.replace(lib, so)


def build_log() -> str:
    return _LOADED.log


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (launch refused)."""
    if err != 0:
        msg = _LOADED.lib.ofdm_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


def check_inputs(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on the first one's CUDA
    device (the kernels index raw row-major memory)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{kernel}: inputs must share one CUDA device, "
                             f"got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: inputs must be contiguous")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer value; also
    makes `device` current for the kernels' runtime (the library carries
    its own, and a launch must go to a stream of its current device). The
    library is asked only when the device differs from the one it was last
    given on this thread or from PyTorch's current one, so a one-card run
    makes the call once."""
    device = torch.device(device)
    current = torch.cuda.current_device()
    index = device.index if device.index is not None else current
    if getattr(_CURRENT, "index", None) != index or current != index:
        check(library().ofdm_set_device(index), "set device")
        _CURRENT.index = index
    # the raw handle: no Stream object (host time a launch pays)
    return torch._C._cuda_getCurrentRawStream(index)

