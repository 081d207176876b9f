"""The banded filter tier (K8): the FIR family and the Schmidl-Cox window
sums as banded matrix products, one hand kernel (csrc/banded.cu, float32
accuracy on the tensor cores) beside its plain versions.

The counterpart of ofdm_uhd_tpu/kernels/pallas_fir.py (fir_pallas,
polyphase_interp_pallas, polyphase_decim_pallas on _banded_kernel) and
pallas_sync.py:40 sc_correlate_pallas (on _moving_sum_pallas). The
reference keeps this tier beside its production filters and routes no user
path to it; neither does the port. Its functions, in float32:

  fir_banded(x, taps, blk=512)            'same' FIR, [..., n] -> [..., n]
  polyphase_interp_banded(x, l, taps, blk=256)     [..., n] -> [..., n*l]
  polyphase_decim_banded(x, m, taps, blk=512)  [..., n] -> [..., ceil(n/m)]
  sc_correlate_banded(r, l, blk=None)    (P [..., nd], R [..., nd])

The decimation is the full-rate FIR kept at every m-th sample, ceil(n/m)
outputs (pallas_fir.py:174-180), where kernels/fir.py's decimation gives
n // m. The S&C sums are direct window sums (P over l of conj(r[n])
r[n+l] as Re and Im planes, R = 0.5 x the sum over 2l of |r|^2, nd =
n - 2l + 1), not K9's pairwise doubling. `blk`, the TPU's block of
outputs, does not change the function; the card ignores it.

Each routes by the tensor's device (kernels/policy.py): a CUDA tensor
launches the kernel on K8's float32 planes, the rows [2B, n] of the re and
im parts (the S&C: the lag products' planes and the energies), counted as
banded_fir, banded_decim, banded_interp, banded_sc; a CPU tensor, or any
inside policy.plain_versions(), takes the plain version: kernels/fir.py's
exact float32 correlation (then [..., ::m]), interp_plain, and a direct
window sum (conv1d with a band of ones).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..phy import tables as T
from . import build, policy
from . import fir as KF


def _planes(x: torch.Tensor, kernel: str) -> tuple[torch.Tensor, int]:
    """K8's plane split: complex64 [..., n] -> float32 rows [2B, n] (the re
    rows, then the im rows), B."""
    flat = KF._rows(x, kernel)
    return torch.cat([flat.real, flat.imag]).contiguous(), flat.shape[0]


def _merge(y: torch.Tensor, b: int, x: torch.Tensor) -> torch.Tensor:
    return torch.complex(y[:b], y[b:]).reshape(x.shape[:-1] + (y.shape[-1],))


def _strided_planes(planes: torch.Tensor, taps, stride: int, kernel: str
                    ) -> torch.Tensor:
    """The kernel's launch on float32 rows [R, n]: the 'same' FIR of every
    row, kept at outputs 0, stride, 2 stride, ...: [R, ceil(n / stride)]."""
    key, w, pad_l = KF._corr_weights(taps)
    rows, n = planes.shape
    n_out = -(-n // stride)
    y = torch.empty((rows, n_out), dtype=torch.float32, device=planes.device)
    wt = T.on_device(KF._reversed_taps, (key,), None, planes.device)
    err = build.library().ofdm_banded_strided(
        planes.data_ptr(), wt.data_ptr(), y.data_ptr(), rows, n, n_out,
        len(w), stride, pad_l, 0, build.stream_ptr(planes.device))
    build.check(err, kernel)
    policy.count_launch(kernel)
    return y


def _strided_cuda(x: torch.Tensor, taps, stride: int, kernel: str
                  ) -> torch.Tensor:
    planes, b = _planes(x, kernel)
    return _merge(_strided_planes(planes, taps, stride, kernel), b, x)


def _fir_cuda(x: torch.Tensor, taps) -> torch.Tensor:
    return _strided_cuda(x, taps, 1, "banded_fir")


def _decim_cuda(x: torch.Tensor, m: int, taps) -> torch.Tensor:
    if m < 1:
        raise ValueError(f"banded_decim: need m >= 1, got {m}")
    return _strided_cuda(x, taps, m, "banded_decim")


def _interp_cuda(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    if l < 1:
        raise ValueError(f"banded_interp: need l >= 1, got {l}")
    planes, b = _planes(x, "banded_interp")
    key = KF._f64_key(taps)
    g, _, d_max = KF._branch_matrix(key, l)
    n = planes.shape[1]
    y = torch.empty((2 * b, n * l), dtype=torch.float32, device=x.device)
    gt = T.on_device(KF._branch_matrix, (key, l), 0, x.device)
    err = build.library().ofdm_banded_interp(
        planes.data_ptr(), gt.data_ptr(), y.data_ptr(), 2 * b, n, l,
        g.shape[1], d_max, 0, build.stream_ptr(x.device))
    build.check(err, "banded_interp")
    policy.count_launch("banded_interp")
    return _merge(y, b, x)


def _sc_rows(r: torch.Tensor, l: int) -> tuple[torch.Tensor, int]:
    if r.dtype != torch.complex64 or r.dim() < 1:
        raise ValueError(f"banded_sc: need complex64 [..., n], got "
                         f"{r.dtype} {tuple(r.shape)}")
    n = r.shape[-1]
    nd = n - 2 * l + 1
    if l < 1 or nd < 1:
        raise ValueError(f"banded_sc: need 1 <= l and 2l <= n, got l = {l}, "
                         f"n = {n}")
    return r.reshape(-1, n), nd


def _sc_cuda(r: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch sums P's two planes (window l) and R's (window 2l, times
    0.5); the lag products and energies are formed here, elementwise, as
    the reference forms them outside its kernel."""
    flat, nd = _sc_rows(r, l)
    build.check_inputs("banded_sc", flat)
    b, n = flat.shape
    prod = torch.conj(flat[:, :-l]) * flat[:, l:]
    s = torch.cat([prod.real, prod.imag]).contiguous()
    e = (flat.abs() ** 2).contiguous()
    p = torch.empty((2 * b, nd), dtype=torch.float32, device=r.device)
    rr = torch.empty((b, nd), dtype=torch.float32, device=r.device)
    err = build.library().ofdm_banded_sc(
        s.data_ptr(), e.data_ptr(), p.data_ptr(), rr.data_ptr(), b, n, l,
        build.stream_ptr(r.device))
    build.check(err, "banded_sc")
    policy.count_launch("banded_sc")
    lead = r.shape[:-1]
    return (torch.complex(p[:b], p[b:]).reshape(lead + (nd,)),
            rr.reshape(lead + (nd,)))


def _window_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    """Valid-mode window sum along the last axis, [..., n] -> [..., n -
    win + 1]: a correlation with a band of ones."""
    n = x.shape[-1]
    ones = torch.ones((1, 1, win), dtype=torch.float32, device=x.device)
    y = F.conv1d(x.reshape(-1, 1, n).float(), ones)
    return y.reshape(x.shape[:-1] + (n - win + 1,))


def sc_correlate_banded_plain(r: torch.Tensor, l: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    _sc_rows(r, l)
    prod = torch.conj(r[..., :-l]) * r[..., l:]
    p = torch.complex(_window_sum(prod.real, l), _window_sum(prod.imag, l))
    return p, 0.5 * _window_sum(r.abs() ** 2, 2 * l)


def decim_banded_plain(x: torch.Tensor, m: int, taps) -> torch.Tensor:
    """The full-rate 'same' FIR at every m-th sample: ceil(n/m) outputs."""
    return KF.decim_plain(x, 1, taps)[..., ::m]


def fir_banded(x: torch.Tensor, taps, blk: int = 512) -> torch.Tensor:
    """'Same'-aligned real-taps FIR of complex x [..., n] -> [..., n]:
    y[i] = sum_j taps[j] * x[i + half - j], half = (len(taps) - 1) // 2."""
    if policy.use_kernel(x):
        return _fir_cuda(x, taps)
    return KF.decim_plain(x, 1, taps)


def polyphase_interp_banded(x: torch.Tensor, l: int, taps, blk: int = 256
                            ) -> torch.Tensor:
    """L-fold interpolation [..., n] -> [..., n*l]; taps = the prototype
    low-pass (gain L applied here, through the branch matrix)."""
    if policy.use_kernel(x):
        return _interp_cuda(x, l, taps)
    return KF.interp_plain(x, l, taps)


def polyphase_decim_banded(x: torch.Tensor, m: int, taps, blk: int = 512
                           ) -> torch.Tensor:
    """M-fold decimation [..., n] -> [..., ceil(n/m)]: the 'same' FIR at
    samples 0, m, 2m, ..."""
    if policy.use_kernel(x):
        return _decim_cuda(x, m, taps)
    return decim_banded_plain(x, m, taps)


def sc_correlate_banded(r: torch.Tensor, l: int, blk: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """r [..., n] complex64 -> (P [..., nd] c64, R [..., nd] f32),
    nd = n - 2l + 1, any l >= 1."""
    if policy.use_kernel(r):
        return _sc_cuda(r, l)
    return sc_correlate_banded_plain(r, l)
