"""Batched orthonormal FFT/IFFT: hand kernel + plain version.

Replaces ofdm_uhd_tpu/kernels/pallas_fft.py:fft_pallas (CUDA source:
csrc/fft.cu, a shared-memory radix-2 FFT for power-of-two N up to 2048).
The plain version is torch.fft with norm='ortho'; the kernel never calls
cuFFT. Both take complex64 [..., N] and transform the last axis.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import build, policy

MAX_N = 2048


def fft_plain(x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    f = torch.fft.ifft if inverse else torch.fft.fft
    return f(x, norm="ortho").to(torch.complex64)


@functools.lru_cache(maxsize=16)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i k / n), k < n/2, in float64 then cast to complex64."""
    k = np.arange(n // 2)
    w = np.exp(-2j * np.pi * k / n).astype(np.complex64)
    return torch.from_numpy(w).to(device)


def _fft_cuda(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    n = x.shape[-1]
    if x.dtype != torch.complex64:
        raise ValueError(f"fft: need complex64, got {x.dtype}")
    if n < 2 or n > MAX_N or n & (n - 1):
        raise ValueError(f"fft: N must be a power of two in [2, {MAX_N}], "
                         f"got {n}")
    build.check_inputs("fft", x)
    y = torch.empty_like(x)
    rows = x.numel() // n
    lib = build.library()
    err = lib.ofdm_fft(x.data_ptr(), y.data_ptr(),
                       _twiddles(n, x.device).data_ptr(), rows,
                       n.bit_length() - 1, int(inverse),
                       build.stream_ptr(x.device))
    build.check(err, "fft")
    policy.count_launch("fft")
    return y


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
