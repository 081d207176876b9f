"""The banded filter tier (K8): the FIR family and the Schmidl-Cox window
sums as banded matrix products, one hand kernel (csrc/banded.cu, float32
accuracy on the tensor cores, body csrc/banded_body.cuh) beside its plain
versions.

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
launches the kernel once, on the complex64 rows as they lie (the S&C: on r
itself, the lag products and energies formed in the kernel), with nothing
else on the device but the outputs' torch.empty; counted as banded_fir,
banded_decim, banded_interp, banded_sc. A CPU tensor, or any inside
policy.plain_versions(), takes the plain version: kernels/fir.py's exact
float32 correlation (then [..., ::m]), interp_plain, and a direct window
sum (conv1d with a band of ones). research/fir_ilv.py (K13) launches the
same kernel through _strided_launch and _interp_launch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import build, policy
from . import fir as KF


@functools.lru_cache(maxsize=64)
def _weights(key: bytes, device: torch.device) -> tuple[torch.Tensor, int]:
    """The correlation weights of the float32 taps whose bytes are `key`,
    on `device`, and the 'same' alignment's left pad."""
    _, w, pad_l = KF._corr_weights(np.frombuffer(key, np.float32))
    return torch.from_numpy(w.copy()).to(device), pad_l


@functools.lru_cache(maxsize=64)
def _branches(key: bytes, l: int, device: torch.device
              ) -> tuple[torch.Tensor, int, int]:
    """The branch matrix [l, nd] of the float64 taps whose bytes are `key`,
    on `device`, with nd and d_max."""
    taps = np.frombuffer(key, np.float64)
    g, _, d_max = KF._branch_matrix(KF._f64_key(taps), l)
    return torch.from_numpy(g).to(device), g.shape[1], d_max


def _rows(x: torch.Tensor, kernel: str) -> torch.Tensor:
    """x [..., n] as rows [B, n]: complex64, contiguous, on a card."""
    if (x.dtype != torch.complex64 or x.dim() < 1 or not x.is_cuda
            or not x.is_contiguous()):
        raise ValueError(f"{kernel}: need contiguous complex64 [..., n] on "
                         f"a CUDA device, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x if x.dim() == 2 else x.reshape(-1, x.shape[-1])


def _shaped(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return y if x.dim() == 2 else y.reshape(x.shape[:-1] + y.shape[-1:])


def _strided_launch(kernel: str, x: torch.Tensor, taps, stride: int,
                    ceil: bool) -> torch.Tensor:
    """The 'same' FIR of every complex64 row of x [..., n], kept at outputs
    0, stride, 2 stride, ...: [..., ceil(n / stride)] (ceil) or [...,
    n // stride]."""
    if stride < 1:
        raise ValueError(f"{kernel}: need stride >= 1, got {stride}")
    flat = _rows(x, kernel)
    rows, n = flat.shape
    w, pad_l = _weights(np.asarray(taps, np.float32).tobytes(), x.device)
    m = -(-n // stride) if ceil else n // stride
    y = flat.new_empty((rows, m))
    err = build.library().ofdm_banded_strided(
        flat.data_ptr(), w.data_ptr(), y.data_ptr(), rows, n, m, w.numel(),
        stride, pad_l, build.stream_ptr(x.device))
    build.check(err, kernel)
    policy.count_launch(kernel)
    return _shaped(y, x)


def _interp_launch(kernel: str, x: torch.Tensor, l: int, taps
                   ) -> torch.Tensor:
    """L-fold interpolation of every complex64 row of x [..., n]."""
    if l < 1:
        raise ValueError(f"{kernel}: need l >= 1, got {l}")
    flat = _rows(x, kernel)
    rows, n = flat.shape
    g, nd, d_max = _branches(np.asarray(taps, np.float64).tobytes(), l,
                             x.device)
    y = flat.new_empty((rows, n * l))
    err = build.library().ofdm_banded_interp(
        flat.data_ptr(), g.data_ptr(), y.data_ptr(), rows, n, l, nd, d_max,
        build.stream_ptr(x.device))
    build.check(err, kernel)
    policy.count_launch(kernel)
    return _shaped(y, x)


def _fir_cuda(x: torch.Tensor, taps) -> torch.Tensor:
    return _strided_launch("banded_fir", x, taps, 1, True)


def _decim_cuda(x: torch.Tensor, m: int, taps) -> torch.Tensor:
    return _strided_launch("banded_decim", x, taps, m, True)


def _interp_cuda(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    return _interp_launch("banded_interp", x, l, taps)


def _sc_rows(r: torch.Tensor, l: int) -> int:
    """nd = n - 2l + 1 of r [..., n] complex64, raising where nd < 1."""
    if r.dtype != torch.complex64 or r.dim() < 1:
        raise ValueError(f"banded_sc: need complex64 [..., n], got "
                         f"{r.dtype} {tuple(r.shape)}")
    n = r.shape[-1]
    nd = n - 2 * l + 1
    if l < 1 or nd < 1:
        raise ValueError(f"banded_sc: need 1 <= l and 2l <= n, got l = {l}, "
                         f"n = {n}")
    return nd


def _sc_cuda(r: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch from r: P's window l of the lag products and R's window
    2l of the energies (times 0.5), both formed in the kernel."""
    nd = _sc_rows(r, l)
    flat = _rows(r, "banded_sc")
    b, n = flat.shape
    p = flat.new_empty((b, nd))
    rr = flat.new_empty((b, nd), dtype=torch.float32)
    err = build.library().ofdm_banded_sc(
        flat.data_ptr(), p.data_ptr(), rr.data_ptr(), b, n, l,
        build.stream_ptr(r.device))
    build.check(err, "banded_sc")
    policy.count_launch("banded_sc")
    return _shaped(p, r), _shaped(rr, r)


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
