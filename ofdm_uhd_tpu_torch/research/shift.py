"""The shifted-FMA filter tier (K11): the counterpart of
ofdm_uhd_tpu/research/pallas_shift.py.

The reference keeps this tier as a measured A/B baseline beside its MXU
filters and routes no user path to it; neither does the port. It computes
the functions of kernels/fir.py's exact tier (the 'same' FIR, M-fold
decimation, L-fold interpolation) and of kernels/sync.py's correlator in
another layout: the signal as float32 (re, im) planes, a tile plus its
halo on chip, one weighted FMA per tap, the decimation phase-split
(csrc/shift.cu holds the kernels and their design).

  fir_shift(x, taps)               fir_shift_pallas, _fir_shift_phased
  polyphase_decim_shift(x, m, taps)   polyphase_decim_shift_pallas
  polyphase_interp_shift(x, l, taps)  polyphase_interp_shift_pallas
  sc_correlate_shift(r, l)         sc_correlate_shift_pallas

Each routes by the tensor's device (kernels/policy.py): a CUDA tensor
launches the kernel (counted as shift_fir, shift_decim, shift_interp,
shift_sc), a CPU tensor, or any inside policy.plain_versions(), takes the
plain version, which is the port's plain function of the same math
(kernels/fir.py decim_plain and interp_plain, kernels/sync.py
sc_correlate_plain). Coefficients are the reference's: the taps as float32
reversed, the branch matrix from the float64 prototype times L.

The S&C correlator is K9's function in K9's order (pairwise-doubling
boxcars, P over l and R = 0.5 * the energy over 2l), so it runs on K9's
kernel (csrc/scfront.cu ofdm_sc_correlate) under its own count. One
difference stays: the TPU kernel forms the energy as re*re + im*im, K9
and the plain version as |r|^2 (hypotf, squared), which differ by float32
rounding (tests/test_torch_shift.py measures it).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import build, policy
from ..kernels import fir as KF
from ..kernels import sync as KS
from ..phy import tables as T


@functools.lru_cache(maxsize=32)
def _phase_kernel(taps_key: tuple, m: int) -> np.ndarray:
    """The decimation's per-phase taps [m, nd], nd = ceil(nt / m):
    kern[p, d] = w[d*m + p], w = the taps reversed, zeros past nt
    (pallas_shift.py:339-344)."""
    w = KF._reversed_taps(taps_key)
    nd = -(-len(w) // m)
    padded = np.zeros(nd * m, np.float32)
    padded[:len(w)] = w
    return np.ascontiguousarray(padded.reshape(nd, m).T)


@functools.lru_cache(maxsize=32)
def _interp_kernel(taps_key: tuple, l: int) -> np.ndarray:
    """The branch matrix with each branch reversed [l, nd]
    (pallas_shift.py:409-411)."""
    g = KF._branch_matrix(taps_key, l)[0]
    return np.ascontiguousarray(g[:, ::-1])


def _launch(kernel: str, flat: torch.Tensor, n_out: int, *args
            ) -> torch.Tensor:
    y = torch.empty((flat.shape[0], n_out), dtype=torch.complex64,
                    device=flat.device)
    entry = getattr(build.library(), "ofdm_" + kernel)
    err = entry(flat.data_ptr(), args[0].data_ptr(), y.data_ptr(),
                flat.shape[0], *args[1:], build.stream_ptr(flat.device))
    build.check(err, kernel)
    policy.count_launch(kernel)
    return y


def _fir_cuda(x: torch.Tensor, taps) -> torch.Tensor:
    flat = KF._rows(x, "shift_fir")
    key, w, pad_l = KF._corr_weights(taps)
    wt = T.on_device(KF._reversed_taps, (key,), None, x.device)
    n = flat.shape[1]
    return _launch("shift_fir", flat, n, wt, n, len(w), pad_l).reshape(
        x.shape)


def _decim_cuda(x: torch.Tensor, m: int, taps) -> torch.Tensor:
    flat = KF._rows(x, "shift_decim")
    if m < 1:
        raise ValueError(f"shift_decim: need m >= 1, got {m}")
    key, _, pad_l = KF._corr_weights(taps)
    kern = T.on_device(_phase_kernel, (key, m), None, x.device)
    n_in = flat.shape[1]
    n_out = n_in // m
    y = _launch("shift_decim", flat, n_out, kern, n_in, n_out, m,
                kern.shape[1], pad_l)
    return y.reshape(x.shape[:-1] + (n_out,))


def _interp_cuda(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    flat = KF._rows(x, "shift_interp")
    if l < 1:
        raise ValueError(f"shift_interp: need l >= 1, got {l}")
    key = KF._f64_key(taps)
    d_max = KF._branch_matrix(key, l)[2]
    kern = T.on_device(_interp_kernel, (key, l), None, x.device)
    n = flat.shape[1]
    y = _launch("shift_interp", flat, n * l, kern, n, l, kern.shape[1],
                d_max)
    return y.reshape(x.shape[:-1] + (n * l,))


def _sc_cuda(r: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    return KS._sccorr_cuda(r, l, counter="shift_sc")


def fir_shift(x: torch.Tensor, taps) -> torch.Tensor:
    """'Same'-aligned real-taps FIR of complex x [..., n] -> [..., n], any
    tap count: y[i] = sum_j taps[j] * x[i + half - j]."""
    if policy.use_kernel(x):
        return _fir_cuda(x, taps)
    return KF.decim_plain(x, 1, taps)


def polyphase_decim_shift(x: torch.Tensor, m: int, taps) -> torch.Tensor:
    """M-fold decimation [..., n] -> [..., n // m]: the 'same' FIR at every
    m-th sample, phase-split."""
    if policy.use_kernel(x):
        return _decim_cuda(x, m, taps)
    return KF.decim_plain(x, m, taps)


def polyphase_interp_shift(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    """L-fold interpolation [..., n] -> [..., n*l]; taps = the prototype
    low-pass (gain L applied here)."""
    if policy.use_kernel(x):
        return _interp_cuda(x, l, taps)
    return KF.interp_plain(x, l, taps)


def sc_correlate_shift(r: torch.Tensor, l: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """r [..., n] complex64 -> (P [..., nd] c64, R [..., nd] f32),
    nd = n - 2l + 1, l a power of two."""
    if policy.use_kernel(r):
        return _sc_cuda(r, l)
    return KS.sc_correlate_plain(r, l)
