"""The shifted-FMA filter tier (K11): the counterpart of
ofdm_uhd_tpu/research/pallas_shift.py.

The reference keeps this tier as a measured A/B baseline beside its MXU
filters and routes no user path to it; neither does the port. It computes
the functions of kernels/fir.py's exact tier (the 'same' FIR, M-fold
decimation, L-fold interpolation) and of kernels/sync.py's correlator in
another layout: a tile plus its halo on chip, one weighted float32 FMA per
tap and component, the decimation phase-split (csrc/shift.cu launches
them, csrc/shift_body.cuh holds their design).

  fir_shift(x, taps)               fir_shift_pallas, _fir_shift_phased
  polyphase_decim_shift(x, m, taps)   polyphase_decim_shift_pallas
  polyphase_interp_shift(x, l, taps)  polyphase_interp_shift_pallas
  sc_correlate_shift(r, l)         sc_correlate_shift_pallas

Each routes by the tensor's device (kernels/policy.py): a CUDA tensor
launches the kernel (counted as shift_fir, shift_decim, shift_interp,
shift_sc), a CPU tensor, or any inside policy.plain_versions(), takes the
plain version, which is the port's plain function of the same math
(kernels/fir.py decim_plain and interp_plain, kernels/sync.py
sc_correlate_plain). A CUDA tensor launches its kernel once on the
complex64 rows as they lie, with nothing else on the device but the
output's torch.empty. Coefficients are the reference's, on the device as
kernels/banded.py caches them by the taps' bytes: the correlation weights
(the float32 taps reversed), which the kernel reads as the per-phase taps
w[d*m + p] itself, and the branch matrix from the float64 prototype times
L, which it reverses by index.

The S&C correlator is K9's function in K9's order (pairwise-doubling
boxcars, P over l and R = 0.5 * the energy over 2l), so it runs on K9's
kernel (csrc/scfront.cu ofdm_sc_correlate) under its own count. One
difference stays: the TPU kernel forms the energy as re*re + im*im, K9
and the plain version as |r|^2 (hypotf, squared), which differ by float32
rounding (tests/test_torch_shift.py measures it).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import banded as KB
from ..kernels import build, policy
from ..kernels import fir as KF
from ..kernels import sync as KS


def _launch(kernel: str, x: torch.Tensor, flat: torch.Tensor, n_out: int,
            coef: torch.Tensor, *args) -> torch.Tensor:
    """One launch of ofdm_<kernel> on the rows `flat` [B, n] of x [..., n]
    as they lie: [..., n_out]."""
    y = flat.new_empty((flat.shape[0], n_out))
    err = getattr(build.library(), "ofdm_" + kernel)(
        flat.data_ptr(), coef.data_ptr(), y.data_ptr(), flat.shape[0],
        *args, build.stream_ptr(x.device))
    build.check(err, kernel)
    policy.count_launch(kernel)
    return KB._shaped(y, x)


def _fir_cuda(x: torch.Tensor, taps) -> torch.Tensor:
    flat = KB._rows(x, "shift_fir")
    w, pad_l = KB._weights(np.asarray(taps, np.float32).tobytes(), x.device)
    n = flat.shape[1]
    return _launch("shift_fir", x, flat, n, w, n, w.numel(), pad_l)


def _decim_cuda(x: torch.Tensor, m: int, taps) -> torch.Tensor:
    flat = KB._rows(x, "shift_decim")
    if m < 1:
        raise ValueError(f"shift_decim: need m >= 1, got {m}")
    w, pad_l = KB._weights(np.asarray(taps, np.float32).tobytes(), x.device)
    n_in = flat.shape[1]
    return _launch("shift_decim", x, flat, n_in // m, w, n_in, n_in // m, m,
                   w.numel(), pad_l)


def _interp_cuda(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    flat = KB._rows(x, "shift_interp")
    if l < 1:
        raise ValueError(f"shift_interp: need l >= 1, got {l}")
    g, nd, d_max = KB._branches(np.asarray(taps, np.float64).tobytes(), l,
                                x.device)
    n = flat.shape[1]
    return _launch("shift_interp", x, flat, n * l, g, n, l, nd, d_max)


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
