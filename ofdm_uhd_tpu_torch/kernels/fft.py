"""Batched orthonormal FFT/IFFT and its CP-fused forms: hand kernels +
plain versions.

  fft / ifft (K3): replace ofdm_uhd_tpu/kernels/pallas_fft.py:fft_pallas;
      complex64 [..., N] -> [..., N], power-of-two N from 2 to 2^24: one
      launch up to 4096 (ONE_LAUNCH_N), the four-step route above
      (`route`).
  cp_strip_fft (K5, RX): replaces pallas_fft.py:cp_strip_fft_pallas;
      symbol rows [..., in_len] -> the FFT of [..., start:start+n].
  ifft_cp (K5, TX): replaces pallas_fft.py:ifft_cp_pallas; grid rows
      [..., n] -> the IFFT with its last cp samples prepended, [..., n+cp].
The K5 forms take power-of-two n up to 512, where the reference routes
them (ofdm_uhd_tpu/phy/frame.py:60-65,101-106). CUDA source: csrc/fft.cu,
one kernel for all three (K3 is its case of contiguous rows and no CP): a
self-sorting Stockham FFT with each transform's samples in registers,
radix-16 passes and one pass of the remaining radix (`plan`), one
shared-memory exchange between two passes and no bit reversal; K5 reads
the strip in place (a row stride and an offset) and writes the CP from the
same registers, so neither a contiguous copy of the windows nor a
concatenation pass remains. The wrapper hands the kernel its twiddle table
(`twiddle_table`). The plain versions are torch.fft with norm='ortho' (and
torch.cat); the kernels never call cuFFT.

Above 4096 points a transform takes five launches (`route`): with N = N1
N2, N1 = 2^ceil(k/2) and N2 = 2^floor(k/2) (both <= 4096 up to 2^24), each
row viewed [N1, N2] is transposed to [N2, N1], transformed in rows of N1
by K3, multiplied by W_N^(n2 k1) and transposed back (one launch of the
transpose-twiddle kernel, `ofdm_fft_transpose`), transformed in rows of
N2, and transposed to the natural output order. The two ortho scales
multiply to 1/sqrt N; the inverse takes K3's inverse and the conjugate
twiddles. `four_step_plain` runs the same route through the plain
versions of its steps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import build, policy

ONE_LAUNCH_N = 4096  # K3's one-launch plans (csrc/fft.cu kMaxLog2N = 12)
MAX_N = 1 << 24     # the four-step route: N1, N2 <= ONE_LAUNCH_N
MAX_CP_N = 512      # the K5 forms: n <= 512, as the reference routes them


def fft_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    f = torch.fft.ifft if inverse else torch.fft.fft
    return f(x, norm="ortho").to(torch.complex64)


def plan(n: int) -> list[int]:
    """The kernel's passes for an n-point transform: radix 16 while more
    than one pass remains, then the remaining radix (256: [16, 16]; 1024:
    [16, 16, 4]; n <= 16: [n])."""
    passes = (n.bit_length() + 2) // 4
    return [16] * (passes - 1) + [n >> (4 * (passes - 1))]


def twiddle_table(n: int) -> np.ndarray:
    """The twiddles of every pass after the first, in the order the kernel
    reads them: for the pass of radix R after NS points are transformed,
    exp(-2 pi i q r / (NS R)) at [(r - 1) NS + q], 0 < r < R, q < NS, from
    float64 cast to complex64 (empty for a one-pass plan)."""
    parts, ns = [], 1
    for p, radix in enumerate(plan(n)):
        if p > 0:
            k = (np.arange(1, radix)[:, None] * np.arange(ns)
                 * (n // (ns * radix)))
            parts.append(np.exp(-2j * np.pi * k / n).ravel())
        ns *= radix
    return np.concatenate(parts or [np.zeros(0)]).astype(np.complex64)


@functools.lru_cache(maxsize=16)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(twiddle_table(n)).to(device)


def route(n: int) -> list[tuple]:
    """The launches of an n-point transform: [("fft", n)] up to
    ONE_LAUNCH_N; above, the four-step route over n = n1 * n2 (n1 =
    2^ceil(k/2), n2 = 2^floor(k/2)): ("transpose", r, c, twiddle) moves
    each row's [r, c] view to [c, r] (times W_n^(i j) where twiddle),
    ("fft", m) transforms rows of m."""
    if n < 2 or n > MAX_N or n & (n - 1):
        raise ValueError(f"fft: N must be a power of two in [2, {MAX_N}], "
                         f"got {n}")
    if n <= ONE_LAUNCH_N:
        return [("fft", n)]
    k = n.bit_length() - 1
    n1, n2 = 1 << ((k + 1) // 2), 1 << (k // 2)
    return [("transpose", n1, n2, False), ("fft", n1),
            ("transpose", n2, n1, True), ("fft", n2),
            ("transpose", n1, n2, False)]


def four_step_twiddle_table(n: int) -> np.ndarray:
    """W_n^(i j) = exp(-2 pi i i j / n) at [i * n1 + j], i < n2, j < n1
    (the route's middle transpose reads it as its input is laid out), from
    float64 cast to complex64."""
    _, n2, n1, _ = route(n)[2]
    k = np.arange(n2)[:, None] * np.arange(n1)
    return np.exp(-2j * np.pi * k / n).ravel().astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _four_step_twiddles(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(four_step_twiddle_table(n)).to(device)


def transpose_plain(x: torch.Tensor, r: int, c: int,
                    tw: torch.Tensor | None, inverse: bool) -> torch.Tensor:
    """Rows [B, r * c] viewed [B, r, c] -> [B, c * r], y[b, j, i] =
    x[b, i, j] * tw[i * c + j] (conjugated for the inverse; none where tw
    is None)."""
    y = x.reshape(-1, r, c)
    if tw is not None:
        y = y * (tw.conj() if inverse else tw).reshape(r, c)
    return y.transpose(1, 2).reshape(-1, r * c)


def _transpose_cuda(x: torch.Tensor, r: int, c: int,
                    tw: torch.Tensor | None, inverse: bool) -> torch.Tensor:
    """One launch of the transpose-twiddle kernel on contiguous rows."""
    build.check_inputs("fft_transpose", x)
    y = torch.empty_like(x)
    lib = build.library()
    err = lib.ofdm_fft_transpose(x.data_ptr(), y.data_ptr(),
                                 None if tw is None else tw.data_ptr(),
                                 x.numel() // (r * c), r, c, int(inverse),
                                 build.stream_ptr(x.device))
    build.check(err, "fft_transpose")
    policy.count_launch("fft_transpose")
    return y


def _fft_launch(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """One launch of K3 on contiguous rows [..., n], n <= ONE_LAUNCH_N."""
    n = x.shape[-1]
    build.check_inputs("fft", x)
    y = torch.empty_like(x)
    lib = build.library()
    err = lib.ofdm_fft(x.data_ptr(), y.data_ptr(),
                       _twiddles(n, x.device).data_ptr(), x.numel() // n,
                       n.bit_length() - 1, int(inverse),
                       build.stream_ptr(x.device))
    build.check(err, "fft")
    policy.count_launch("fft")
    return y


def _run_route(x: torch.Tensor, inverse: bool, sub_fft, transpose
               ) -> torch.Tensor:
    """x [..., n] through route(n), each step by the given functions."""
    n = x.shape[-1]
    y = x.reshape(-1, n)
    for step in route(n):
        if step[0] == "fft":
            m = step[1]
            y = sub_fft(y.reshape(-1, m), inverse).reshape(-1, n)
        else:
            _, r, c, twiddle = step
            tw = _four_step_twiddles(n, y.device) if twiddle else None
            y = transpose(y, r, c, tw, inverse)
    return y.reshape(x.shape)


def four_step_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The kernels' route for x [..., n] through the plain versions of its
    steps (fft_plain, transpose_plain); fft_plain's function."""
    return _run_route(x, inverse, fft_plain, transpose_plain)


def _fft_cuda(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    if x.dtype != torch.complex64:
        raise ValueError(f"fft: need complex64, got {x.dtype}")
    build.check_inputs("fft", x)
    return _run_route(x, inverse, _fft_launch, _transpose_cuda)


def cp_strip_fft_plain(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    return fft_plain(x[..., start:start + n])


def ifft_cp_plain(x: torch.Tensor, cp: int) -> torch.Tensor:
    y = fft_plain(x, inverse=True)
    return torch.cat([y[..., y.shape[-1] - cp:], y], dim=-1)


def _check_cp_n(kernel: str, x: torch.Tensor, n: int) -> None:
    if x.dtype != torch.complex64 or x.dim() < 1:
        raise ValueError(f"{kernel}: need complex64 [..., n], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if n < 2 or n > MAX_CP_N or n & (n - 1):
        raise ValueError(f"{kernel}: n must be a power of two in "
                         f"[2, {MAX_CP_N}], got {n}")


def _fft_cp_cuda(kernel: str, x: torch.Tensor, n: int, start: int, cp: int,
                 inverse: bool) -> torch.Tensor:
    """One launch of ofdm_fft_cp over the rows of x [..., in_len]: each
    row's [start, start + n) transformed, its last cp outputs prepended."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: needs a CUDA tensor, got {x.device}")
    in_len = x.shape[-1]
    flat = x.reshape(-1, in_len)          # a view wherever the rows allow
    rows = flat.shape[0]
    # the kernel takes any row stride >= in_len over unit-stride rows
    if flat.stride(-1) != 1 or (rows > 1 and flat.stride(0) < in_len):
        flat = flat.contiguous()
    y = torch.empty((rows, n + cp), dtype=torch.complex64, device=x.device)
    lib = build.library()
    err = lib.ofdm_fft_cp(flat.data_ptr(), y.data_ptr(),
                          _twiddles(n, x.device).data_ptr(), rows,
                          n.bit_length() - 1, int(inverse),
                          flat.stride(0) if rows > 1 else in_len, start, cp,
                          build.stream_ptr(x.device))
    build.check(err, kernel)
    policy.count_launch(kernel)
    return y.reshape(x.shape[:-1] + (n + cp,))


def cp_strip_fft(x: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Symbol rows [..., in_len] -> ortho FFT of [..., start:start+n]."""
    _check_cp_n("cpfft", x, n)
    if start < 0 or start + n > x.shape[-1]:
        raise ValueError(f"cpfft: the window [{start}, {start + n}) leaves "
                         f"the {x.shape[-1]}-sample rows")
    if policy.use_kernel(x):
        return _fft_cp_cuda("cpfft", x, n, start, 0, inverse=False)
    return cp_strip_fft_plain(x, start, n)


def ifft_cp(x: torch.Tensor, cp: int) -> torch.Tensor:
    """Grid rows [..., n] -> ortho IFFT with its last cp samples
    prepended, [..., n + cp]."""
    n = x.shape[-1]
    _check_cp_n("ifftcp", x, n)
    if cp < 0 or cp > n:
        raise ValueError(f"ifftcp: need 0 <= cp <= {n}, got {cp}")
    if policy.use_kernel(x):
        return _fft_cp_cuda("ifftcp", x, n, 0, cp, inverse=True)
    return ifft_cp_plain(x, cp)


def fft(x: torch.Tensor) -> torch.Tensor:
    """N-point FFT along the last axis, norm='ortho'."""
    if policy.use_kernel(x):
        return _fft_cuda(x, inverse=False)
    return fft_plain(x)


def ifft(x: torch.Tensor) -> torch.Tensor:
    """N-point IFFT along the last axis, norm='ortho'."""
    if policy.use_kernel(x):
        return _fft_cuda(x, inverse=True)
    return fft_plain(x, inverse=True)
