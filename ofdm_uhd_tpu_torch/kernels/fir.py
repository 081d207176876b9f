"""Real-tap FIR, polyphase decimation and interpolation of complex rows:
two hand kernels in each of two tiers, beside their plain versions.

Replaces ofdm_uhd_tpu/kernels/pallas_fir_mxu.py (fir_mxu_pallas and
polyphase_decim_mxu_pallas through _fir_rows_mxu, and
polyphase_interp_mxu_pallas) at both of the reference's filter precisions:
'exact' (Precision.HIGHEST: CUDA source csrc/fir.cu, float32 FMAs) and
'bf16' (Precision.DEFAULT, 1-pass bf16 products with float32 sums:
csrc/fir_bf16.cu, on the tensor cores). The public functions mirror
ofdm_uhd_tpu/kernels/fir.py (fir_filter, polyphase_interp, polyphase_decim,
each with `precision`; the caller picks it through policy.filter_precision)
and the stream's decimations of conv_backend.py (polyphase_decim_stream,
rational_decim_stream, exact only, as the reference's stream); the plain
versions are the counterparts of ofdm_uhd_tpu/kernels/conv_backend.py
(fir_same, polyphase_interp_xla, polyphase_decim_xla and the two stream
forms): a 1-D correlation over the (re, im) float32 planes. The stream's
valid-mode decimation runs on the strided kernel with no left padding; its
rational form (M > 1, an XLA convolution in the reference) stays plain.

The exact strided kernel (csrc/fir_strided.cuh) splits the taps into the
stride's phases and stages each tile of a row as phase planes (pair
planes of float4 at an even stride where the pairs are 16-byte aligned),
copied by producer warps with cp.async into a two-stage ring on mbarriers
while consumer warps sum the tile before, 9 outputs a thread from a
window of samples in registers; a persistent grid walks the (row, tile)
items. tests/test_torch_fir_host.py builds that body with g++ and holds
it against decim_plain and decim_stream_plain on the CPU.

Coefficients are bit-equal to the reference's: fir and decimation take the
taps as float32, reversed (correlation weights); interpolation takes the
branch matrix `_branch_matrix` (float64 times L, cast to float32). The bf16
tier rounds those coefficients and the signal's planes to bf16 (nearest
even) and sums the exact products in float32: its plain versions
(decim_plain_bf16, interp_plain_bf16) compute what the TPU's MXU computes,
not the reference's CPU run, whose dot ignores the precision. Every row is
filtered on its own with zeros past both ends. Sums run in another order
than the reference's banded matmul, so results agree to float32 rounding,
not bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..phy import tables as T
from . import build, policy


@functools.lru_cache(maxsize=32)
def _branch_matrix(taps_key: tuple, l: int) -> tuple[np.ndarray, int, int]:
    """Polyphase branch decomposition of the prototype -> (G [L, D] f32,
    d_min, d_max): y[n*L + p] = sum_d G[p, d - d_min] * x[n - d]."""
    h = np.asarray(taps_key, dtype=np.float64) * l
    nt = len(h)
    half = (nt - 1) // 2
    d_min = -((half + l - 1) // l)
    d_max = (nt - 1 - half) // l
    dd = np.arange(d_min, d_max + 1)
    g = np.zeros((l, len(dd)), dtype=np.float32)
    for p in range(l):
        idx = dd * l + p + half
        ok = (idx >= 0) & (idx < nt)
        g[p, ok] = h[idx[ok]]
    return g, d_min, d_max


def _f64_key(taps) -> tuple:
    """The taps as a hashable float64 cache key (the branch matrix scales
    them in float64, as the reference does)."""
    return tuple(np.asarray(taps, dtype=np.float64).tolist())


def branch_matrix(taps, l: int) -> tuple[np.ndarray, int, int]:
    return _branch_matrix(_f64_key(taps), l)


@functools.lru_cache(maxsize=32)
def _reversed_taps(taps_key: tuple) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(taps_key, np.float32)[::-1])


def _corr_weights(taps) -> tuple[tuple, np.ndarray, int]:
    """(cache key, float32 taps reversed, i.e. the correlation weights,
    left zero pad nt - 1 - half of the 'same' alignment)."""
    key = tuple(np.asarray(taps, dtype=np.float32).tolist())
    nt = len(key)
    return key, _reversed_taps(key), nt - 1 - (nt - 1) // 2


# ------------------------------------------------------------------ plain

def _correlate_planes(x: torch.Tensor, kern: np.ndarray, pad_left: int,
                      pad_right: int, stride: int = 1) -> torch.Tensor:
    """x [..., n] complex -> [2B, C, n_out] float32, B = prod(batch):
    out[b, c, i] = sum_t kern[c, t] * xpad[b, i*stride + t], the re planes
    first, then the im planes."""
    flat = x.reshape(-1, x.shape[-1])
    planes = torch.cat([flat.real, flat.imag]).float()[:, None, :]
    planes = F.pad(planes, (pad_left, pad_right))
    w = torch.from_numpy(np.ascontiguousarray(kern, dtype=np.float32)).to(
        x.device)[:, None, :]
    return F.conv1d(planes, w, stride=stride)


def _merge(planes: torch.Tensor, x: torch.Tensor, n_out: int
           ) -> torch.Tensor:
    b = planes.shape[0] // 2
    return torch.complex(planes[:b], planes[b:]).reshape(
        x.shape[:-1] + (n_out,))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Complex x with each plane rounded to bf16 (nearest even), as
    float32."""
    return torch.complex(x.real.to(torch.bfloat16).float(),
                         x.imag.to(torch.bfloat16).float())


def _bf16_np(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _strided_plain(x: torch.Tensor, w: np.ndarray, m: int, pad_l: int
                   ) -> torch.Tensor:
    n_out = x.shape[-1] // m
    out = _correlate_planes(x, w[None], pad_l, len(w) - 1 - pad_l, stride=m)
    return _merge(out[:, 0, :n_out], x, n_out)


def decim_plain(x: torch.Tensor, m: int, taps) -> torch.Tensor:
    """The 'same' FIR at every m-th sample; m = 1 is fir_filter's plain
    version."""
    _, w, pad_l = _corr_weights(taps)
    return _strided_plain(x, w, m, pad_l)


def decim_plain_bf16(x: torch.Tensor, m: int, taps) -> torch.Tensor:
    """decim_plain with the planes and the taps rounded to bf16 first: the
    exact products of the rounded values, summed in float32."""
    _, w, pad_l = _corr_weights(taps)
    return _strided_plain(_bf16(x), _bf16_np(w), m, pad_l)


def decim_stream_plain(w: torch.Tensor, m: int, taps) -> torch.Tensor:
    """Valid-mode M-fold decimation: y[k] = sum_j taps[j] *
    w[k*m + nt-1 - j], (n_in - nt) // m + 1 outputs."""
    _, wt, _ = _corr_weights(taps)
    n_out = _valid_outputs(w.shape[-1], len(wt), m)
    out = _correlate_planes(w, wt[None], 0, 0, stride=m)
    return _merge(out[:, 0, :n_out], w, n_out)


def interp_plain(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    return _interp_plain(x, l, *branch_matrix(taps, l))


def interp_plain_bf16(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    """interp_plain with the planes and the branch matrix rounded to bf16
    first."""
    g, d_min, d_max = branch_matrix(taps, l)
    return _interp_plain(_bf16(x), l, _bf16_np(g), d_min, d_max)


def _interp_plain(x: torch.Tensor, l: int, g: np.ndarray, d_min: int,
                  d_max: int) -> torch.Tensor:
    n = x.shape[-1]
    # branch p: y_p[q] = sum_d g[p, d] x[q - d], a correlation with g_p
    # reversed; the L branches are output channels, interleaved after
    out = _correlate_planes(x, g[:, ::-1], d_max, -d_min)    # [2B, L, n]
    inter = out.transpose(1, 2).reshape(out.shape[0], n * l)
    return _merge(inter, x, n * l)


# ------------------------------------------------------------------ kernels

def _rows(x: torch.Tensor, kernel: str) -> torch.Tensor:
    if x.dtype != torch.complex64 or x.dim() < 1:
        raise ValueError(f"{kernel}: need complex64 [..., n], got {x.dtype} "
                         f"{tuple(x.shape)}")
    flat = x.reshape(-1, x.shape[-1])
    build.check_inputs(kernel, flat)
    return flat


def _valid_outputs(n_in: int, nt: int, m: int) -> int:
    if n_in < nt:
        raise ValueError(f"valid-mode FIR: {n_in} samples < {nt} taps")
    return (n_in - nt) // m + 1


def _strided_launch(kernel: str, x: torch.Tensor, taps, stride: int,
                    valid: bool) -> torch.Tensor:
    """The 'same' FIR of every row at stride `stride`: [..., n_in] ->
    [..., n_in // stride] (stride 1: fir_filter; stride M: decimation);
    valid=True: no padding, (n_in - nt) // stride + 1 outputs (the
    stream's decimation). kernel: 'fir' (exact) or 'fir_bf16'."""
    flat = _rows(x, kernel)
    key, w, pad_l = _corr_weights(taps)
    if stride < 1 or len(w) < 1:
        raise ValueError(f"{kernel}: need stride >= 1 and taps, got "
                         f"{stride}, {len(w)}")
    rows, n_in = flat.shape
    if valid:
        pad_l, n_out = 0, _valid_outputs(n_in, len(w), stride)
    else:
        n_out = n_in // stride
    y = torch.empty((rows, n_out), dtype=torch.complex64, device=x.device)
    wt = T.on_device(_reversed_taps, (key,), None, x.device)
    launch = getattr(build.library(), _ENTRY[kernel])
    err = launch(flat.data_ptr(), wt.data_ptr(), y.data_ptr(), rows, n_in,
                 n_out, len(w), stride, pad_l, build.stream_ptr(x.device))
    build.check(err, kernel)
    policy.count_launch(kernel)
    return y.reshape(x.shape[:-1] + (n_out,))


def _interp_launch(kernel: str, x: torch.Tensor, l: int, taps
                   ) -> torch.Tensor:
    """L-fold interpolation of every row; kernel: 'interp' (exact) or
    'interp_bf16'."""
    flat = _rows(x, kernel)
    if l < 1:
        raise ValueError(f"{kernel}: need l >= 1, got {l}")
    key = _f64_key(taps)
    g, _, d_max = _branch_matrix(key, l)
    rows, n = flat.shape
    y = torch.empty((rows, n * l), dtype=torch.complex64, device=x.device)
    gt = T.on_device(_branch_matrix, (key, l), 0, x.device)
    launch = getattr(build.library(), _ENTRY[kernel])
    err = launch(flat.data_ptr(), gt.data_ptr(), y.data_ptr(), rows, n, l,
                 g.shape[1], d_max, build.stream_ptr(x.device))
    build.check(err, kernel)
    policy.count_launch(kernel)
    return y.reshape(x.shape[:-1] + (n * l,))


# kernel (counter) -> C entry; the ilv_*_bf16 counters are K13 at the
# reference's DEFAULT precision (research/fir_ilv.py) on the bf16 tier
_ENTRY = {"fir": "ofdm_fir_strided", "fir_bf16": "ofdm_fir_bf16_strided",
          "interp": "ofdm_fir_interp", "interp_bf16": "ofdm_fir_bf16_interp",
          "ilv_fir_bf16": "ofdm_fir_bf16_strided",
          "ilv_decim_bf16": "ofdm_fir_bf16_strided",
          "ilv_interp_bf16": "ofdm_fir_bf16_interp"}


def _strided_cuda(x: torch.Tensor, taps, stride: int, valid: bool = False
                  ) -> torch.Tensor:
    return _strided_launch("fir", x, taps, stride, valid)


def _strided_bf16_cuda(x: torch.Tensor, taps, stride: int) -> torch.Tensor:
    return _strided_launch("fir_bf16", x, taps, stride, False)


def _interp_cuda(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    return _interp_launch("interp", x, l, taps)


def _interp_bf16_cuda(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    return _interp_launch("interp_bf16", x, l, taps)


# ------------------------------------------------------------------ dispatch

def _is_bf16(precision: str) -> bool:
    if precision not in ("exact", "bf16"):
        raise ValueError(f"unknown filter precision {precision!r}")
    return precision == "bf16"


def fir_filter(x: torch.Tensor, taps, precision: str = "exact"
               ) -> torch.Tensor:
    """'Same'-aligned real-taps FIR of complex signals, [..., n] -> [..., n]:
    y[i] = sum_j taps[j] * x[i + half - j], half = (len(taps) - 1) // 2;
    precision 'bf16': the bf16 tier."""
    bf16 = _is_bf16(precision)
    if policy.use_kernel(x):
        return (_strided_bf16_cuda(x, taps, 1) if bf16
                else _strided_cuda(x, taps, 1))
    return (decim_plain_bf16 if bf16 else decim_plain)(x, 1, taps)


def polyphase_interp(x: torch.Tensor, l: int, taps, precision: str = "exact"
                     ) -> torch.Tensor:
    """L-fold polyphase interpolation, [..., n] -> [..., n*l]; taps = the
    prototype low-pass (gain L applied here); precision 'bf16': the bf16
    tier."""
    bf16 = _is_bf16(precision)
    if policy.use_kernel(x):
        return (_interp_bf16_cuda if bf16 else _interp_cuda)(x, l, taps)
    return (interp_plain_bf16 if bf16 else interp_plain)(x, l, taps)


def polyphase_decim(x: torch.Tensor, m: int, taps, precision: str = "exact"
                    ) -> torch.Tensor:
    """M-fold polyphase decimation, [..., n*m] -> [..., n]: the 'same' FIR
    evaluated at every m-th sample only; precision 'bf16': the bf16 tier."""
    bf16 = _is_bf16(precision)
    if policy.use_kernel(x):
        return (_strided_bf16_cuda(x, taps, m) if bf16
                else _strided_cuda(x, taps, m))
    return (decim_plain_bf16 if bf16 else decim_plain)(x, m, taps)


def polyphase_decim_stream(w: torch.Tensor, m: int, taps) -> torch.Tensor:
    """Causal streaming M-fold decimation, valid mode: w [..., C*m + nt-1]
    (the nt-1 carried radio samples, then the chunk) -> [..., C], the
    continuously filtered stream delayed by nt-1 radio samples."""
    if policy.use_kernel(w):
        return _strided_cuda(w, taps, m, valid=True)
    return decim_stream_plain(w, m, taps)


@functools.lru_cache(maxsize=32)
def _rational_kernels(taps_key: tuple, l: int, m: int
                      ) -> tuple[np.ndarray, int]:
    """Per-output-phase kernels [m, K] of the causal rational resampler,
    as conv_backend._rational_kernels builds them: out_k[j] = sum_t
    kern[k, t] * w[j*l + t] for output n = j*m + k."""
    h = np.asarray(taps_key, dtype=np.float64) * m
    nt = len(h)
    s0, gs = [], []
    for k in range(m):
        p = (k * l + nt - 1) % m
        gs.append(h[np.arange(p, nt, m)])           # G_k[d] = h[p + d*m]
        s0.append((k * l + nt - 1 - p) // m)
    kk = max(s0) + 1
    kern = np.zeros((m, kk), dtype=np.float32)
    for k in range(m):
        t = s0[k] - np.arange(len(gs[k]))
        ok = t >= 0
        kern[k, t[ok]] = gs[k][ok]
    return kern, kk


def rational_decim_stream(w: torch.Tensor, l: int, m: int, taps
                          ) -> torch.Tensor:
    """Causal streaming rational resample by M/L (radio -> baseband): w
    [..., C_r + nt-1] -> [..., C_r * m / l], C_r * m divisible by l. At
    m == 1 it is polyphase_decim_stream; m > 1 is a plain convolution on
    every device (an XLA convolution in the reference, not a kernel)."""
    if m == 1:
        return polyphase_decim_stream(w, l, taps)
    key = _f64_key(taps)
    c_r = w.shape[-1] - (len(key) - 1)
    if (c_r * m) % l:
        raise ValueError("radio chunk * M must be a multiple of L")
    c_b = c_r * m // l
    kern, kk = _rational_kernels(key, l, m)
    out = _correlate_planes(w, kern, 0, kk, stride=l)[:, :, : c_b // m]
    inter = out.transpose(1, 2).reshape(out.shape[0], c_b)
    return _merge(inter, w, c_b)
