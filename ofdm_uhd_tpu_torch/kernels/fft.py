"""Batched orthonormal FFT/IFFT and its CP-fused forms: hand kernels +
plain versions.

  fft / ifft (K3): replace ofdm_uhd_tpu/kernels/pallas_fft.py:fft_pallas;
      complex64 [..., N] -> [..., N], power-of-two N from 2 to 2^24: one
      launch up to ONE_LAUNCH_N, two passes above (`route`).
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

Above ONE_LAUNCH_N a transform takes two launches (`route`), each
reading and writing every row once: with N = N1 N2 and each row viewed
[N1, N2] (n = N2 n1 + n2), the column pass (`ofdm_fft_columns`) takes the
N1-point transform of each column at element stride N2, multiplies output
k1 by W_N^(n2 k1) (`route_twiddle_table`, from float64) and stores it at
[k1, n2]; the row pass (`ofdm_fft_rows_t`) takes the N2-point transform
of each row k1 and stores output k2 at X[k1 + N1 k2], the natural order,
through a shared tile. N2 = ROW_N (512) while N1 = N / ROW_N <= 4096,
above that N1 = 4096: chip_smoke.py's route_splits times every split
(PERF.md), and N2 = 512 was the fastest at 8192-65536. The two ortho scales multiply to 1/sqrt N; the
inverse takes K3's inverse and the conjugate twiddles. `two_pass_plain`
runs the same route through the plain versions of its steps
(`columns_plain`, `rows_t_plain`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import build, policy

ONE_LAUNCH_N = 8192  # K3 in one launch (csrc/fft.cu kMaxLog2N = 13)
PASS_MAX_N = 4096   # each pass of the route above (kMaxPassLog2N = 12)
ROW_N = 512         # the row pass's transform, where n <= ROW_N PASS_MAX_N
MAX_N = 1 << 24     # the route: N1, N2 <= PASS_MAX_N
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
    ONE_LAUNCH_N; above, two passes over n = n1 * n2, n2 = ROW_N where
    that leaves n1 <= PASS_MAX_N (else n2 = n / PASS_MAX_N):
    ("columns", n1, n2) transforms each row's [n1, n2] view along n1
    and multiplies by W_n^(n2 k1), ("rows_t", n1, n2) transforms along
    n2 and stores Z[k1, k2] at [k1 + n1 k2]."""
    if n < 2 or n > MAX_N or n & (n - 1):
        raise ValueError(f"fft: N must be a power of two in [2, {MAX_N}], "
                         f"got {n}")
    if n <= ONE_LAUNCH_N:
        return [("fft", n)]
    n2 = max(min(ROW_N, PASS_MAX_N, n // 2), n // PASS_MAX_N)
    return [("columns", n // n2, n2), ("rows_t", n // n2, n2)]


def route_twiddle_table(n1: int, n2: int) -> np.ndarray:
    """W_n^(j k1) = exp(-2 pi i j k1 / n), n = n1 n2, at [k1 * n2 + j],
    k1 < n1, j < n2 (the column pass reads it in its output's layout),
    from float64 cast to complex64."""
    n = n1 * n2
    k = (np.arange(n1, dtype=np.int64)[:, None] * np.arange(n2)) % n
    return np.exp(-2j * np.pi * k / n).ravel().astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _route_twiddles(n1: int, n2: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(route_twiddle_table(n1, n2)).to(device)


def rows_per_block(n2: int) -> int:
    """The n2-point transforms a block of the row pass holds (csrc/fft.cu
    Plan::kPerBlock); n1 must be a multiple of it."""
    return 4096 // n2 if n2 >= 16 else 256


def columns_plain(x: torch.Tensor, n1: int, n2: int, tw: torch.Tensor,
                  inverse: bool) -> torch.Tensor:
    """Rows [B, n1 * n2] viewed [B, n1, n2]: each column's n1-point
    transform (fft_plain), output k1 times tw[k1 * n2 + j] (conjugated for
    the inverse), in the same layout."""
    y = fft_plain(x.reshape(-1, n1, n2).transpose(1, 2), inverse)
    w = (tw.conj() if inverse else tw).reshape(n1, n2)
    return (y.transpose(1, 2) * w).reshape(-1, n1 * n2)


def rows_t_plain(x: torch.Tensor, n1: int, n2: int,
                 inverse: bool) -> torch.Tensor:
    """Rows [B, n1 * n2] viewed [B, n1, n2]: each row's n2-point transform
    Z[k1, k2] (fft_plain), stored at [k1 + n1 k2]."""
    z = fft_plain(x.reshape(-1, n1, n2), inverse)
    return z.transpose(1, 2).reshape(-1, n1 * n2)


def _check_pass(kernel: str, x: torch.Tensor, n1: int, n2: int) -> None:
    for m in (n1, n2):
        if m < 2 or m > PASS_MAX_N or m & (m - 1):
            raise ValueError(f"{kernel}: n1 and n2 must be powers of two in "
                             f"[2, {PASS_MAX_N}], got {n1} x {n2}")
    if x.dtype != torch.complex64 or x.dim() < 1 or x.shape[-1] != n1 * n2:
        raise ValueError(f"{kernel}: need complex64 [..., {n1 * n2}], got "
                         f"{x.dtype} {tuple(x.shape)}")


def _columns_cuda(x: torch.Tensor, n1: int, n2: int, tw: torch.Tensor,
                  inverse: bool) -> torch.Tensor:
    """One launch of the column pass on contiguous rows [..., n1 * n2]."""
    _check_pass("fft_columns", x, n1, n2)
    if tw.dtype != torch.complex64 or tw.numel() != n1 * n2:
        raise ValueError(f"fft_columns: need the {n1} x {n2} complex64 "
                         f"route twiddles, got {tw.dtype} {tuple(tw.shape)}")
    build.check_inputs("fft_columns", x, tw)
    y = torch.empty_like(x)
    lib = build.library()
    err = lib.ofdm_fft_columns(x.data_ptr(), y.data_ptr(),
                               _twiddles(n1, x.device).data_ptr(),
                               tw.data_ptr(), x.numel() // (n1 * n2),
                               n1.bit_length() - 1, n2.bit_length() - 1,
                               int(inverse), build.stream_ptr(x.device))
    build.check(err, "fft_columns")
    policy.count_launch("fft_columns")
    return y


def _rows_t_cuda(x: torch.Tensor, n1: int, n2: int,
                 inverse: bool) -> torch.Tensor:
    """One launch of the row pass on contiguous rows [..., n1 * n2]."""
    _check_pass("fft_rows_t", x, n1, n2)
    if n1 % rows_per_block(n2):
        raise ValueError(f"fft_rows_t: n1 = {n1} is not a multiple of the "
                         f"{rows_per_block(n2)} rows a block holds")
    build.check_inputs("fft_rows_t", x)
    y = torch.empty_like(x)
    lib = build.library()
    err = lib.ofdm_fft_rows_t(x.data_ptr(), y.data_ptr(),
                              _twiddles(n2, x.device).data_ptr(),
                              x.numel() // (n1 * n2), n1.bit_length() - 1,
                              n2.bit_length() - 1, int(inverse),
                              build.stream_ptr(x.device))
    build.check(err, "fft_rows_t")
    policy.count_launch("fft_rows_t")
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


def _run_route(x: torch.Tensor, inverse: bool, one, columns, rows_t
               ) -> torch.Tensor:
    """x [..., n] through route(n), each step by the given functions."""
    n = x.shape[-1]
    y = x.reshape(-1, n)
    for step in route(n):
        if step[0] == "fft":
            y = one(y, inverse)
        elif step[0] == "columns":
            _, n1, n2 = step
            y = columns(y, n1, n2, _route_twiddles(n1, n2, y.device),
                        inverse)
        else:
            _, n1, n2 = step
            y = rows_t(y, n1, n2, inverse)
    return y.reshape(x.shape)


def two_pass_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The kernels' route for x [..., n] through the plain versions of its
    steps (fft_plain, columns_plain, rows_t_plain); fft_plain's
    function."""
    return _run_route(x, inverse, fft_plain, columns_plain, rows_t_plain)


def _fft_cuda(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    if x.dtype != torch.complex64:
        raise ValueError(f"fft: need complex64, got {x.dtype}")
    build.check_inputs("fft", x)
    return _run_route(x, inverse, _fft_launch, _columns_cuda, _rows_t_cuda)


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
