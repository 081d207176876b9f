"""The FIR family on the interleaved (re, im) layout (K13): the
counterpart of ofdm_uhd_tpu/research/pallas_fir_ilv.py and, through it, of
K7b's general-tap banded row product (kernels/pallas_fir_mxu.py:239
_banded_rows_call).

The reference keeps this tier as a measured dead end (its TPU had no free
bitcast of complex64 to interleaved float32) and routes no user path to
it; neither does the port. Its functions are the exact float32 filters of
kernels/fir.py:

  fir_ilv(x, taps)                 'same' FIR, [..., n] -> [..., n]
  polyphase_decim_ilv(x, m, taps)  [..., n] -> [..., n // m]
  polyphase_interp_ilv(x, l, taps) [..., n] -> [..., n*l]

with the reference's shape handling: a 1-D input is one row, an N-D one
is flattened to rows and restored. The TPU's tiles (the reference's `blk`
and `tr`) do not change the function and have no counterpart.
`precision="highest"` is the reference's default
(jax.lax.Precision.HIGHEST) and runs the float32 kernel;
`precision="default"` is its Precision.DEFAULT, one bf16 pass of the
TPU's MXU: samples and coefficients rounded to bf16, products summed in
float32, the function of the port's bf16 filter tier (kernels/fir.py,
K7-bf16). Any other precision raises.

A CUDA tensor launches csrc/banded.cu, K8's kernel (counted as ilv_fir,
ilv_decim, ilv_interp): it reads the complex64 rows in place as float2,
where torch.view_as_real is the free bitcast the reference's TPU lacked,
de-interleaves them in shared memory, runs the 3xTF32 tensor-core body,
and stores complex64. The reference's taps dilated by 2 (w2[0::2] = w)
are its way of skipping the other component of an interleaved row; the
kernel needs no zero taps. A
CPU tensor, or any inside policy.plain_versions(), takes the port's exact
float32 filters (kernels/fir.py decim_plain, interp_plain).

At "default" a CUDA tensor launches csrc/fir_bf16.cu's entries instead
(ofdm_fir_bf16_strided, ofdm_fir_bf16_interp; counted as ilv_fir_bf16,
ilv_decim_bf16, ilv_interp_bf16): the interleaved rows are the complex64
rows that kernel reads as float2, the reference's dilated zero taps stay
zero in bf16, and its interpolation band is the same branch matrix
(pallas_fir_ilv.py:133-134 calls conv_backend._branch_matrix). A CPU
tensor takes the bf16 plain versions (decim_plain_bf16,
interp_plain_bf16).
"""

from __future__ import annotations

import torch

from ..kernels import banded as KB
from ..kernels import fir as KF
from ..kernels import policy

PRECISIONS = ("highest", "default")


def _is_default(precision: str) -> bool:
    """True for 'default' (bf16 products), False for 'highest'."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"fir_ilv: precision must be 'highest' (float32) or 'default' "
            f"(bf16 products, float32 sums), got {precision!r}")
    return precision == "default"


def _flatten(x: torch.Tensor) -> torch.Tensor:
    """The reference's _flatten: rows [B, n] of a 1-D or N-D input."""
    return x[None] if x.dim() == 1 else x.reshape(-1, x.shape[-1])


def _unflatten(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return y[0] if x.dim() == 1 else y.reshape(x.shape[:-1] + (y.shape[-1],))


def _fir_cuda(x: torch.Tensor, taps) -> torch.Tensor:
    return KB._strided_launch("ilv_fir", x, taps, 1, False)


def _decim_cuda(x: torch.Tensor, m: int, taps) -> torch.Tensor:
    return KB._strided_launch("ilv_decim", x, taps, m, False)


def _interp_cuda(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    return KB._interp_launch("ilv_interp", x, l, taps)


def _fir_bf16_cuda(x: torch.Tensor, taps) -> torch.Tensor:
    return KF._strided_launch("ilv_fir_bf16", x, taps, 1, False)


def _decim_bf16_cuda(x: torch.Tensor, m: int, taps) -> torch.Tensor:
    return KF._strided_launch("ilv_decim_bf16", x, taps, m, False)


def _interp_bf16_cuda(x: torch.Tensor, l: int, taps) -> torch.Tensor:
    return KF._interp_launch("ilv_interp_bf16", x, l, taps)


def fir_ilv(x: torch.Tensor, taps, precision: str = "highest"
            ) -> torch.Tensor:
    """'Same'-aligned real-taps FIR of complex x [..., n] -> [..., n]."""
    bf16 = _is_default(precision)
    if policy.use_kernel(x):
        return _fir_bf16_cuda(x, taps) if bf16 else _fir_cuda(x, taps)
    plain = KF.decim_plain_bf16 if bf16 else KF.decim_plain
    return _unflatten(plain(_flatten(x), 1, taps), x)


def polyphase_decim_ilv(x: torch.Tensor, m: int, taps,
                        precision: str = "highest") -> torch.Tensor:
    """M-fold decimation [..., n] -> [..., n // m]."""
    bf16 = _is_default(precision)
    if policy.use_kernel(x):
        return (_decim_bf16_cuda if bf16 else _decim_cuda)(x, m, taps)
    plain = KF.decim_plain_bf16 if bf16 else KF.decim_plain
    return _unflatten(plain(_flatten(x), m, taps), x)


def polyphase_interp_ilv(x: torch.Tensor, l: int, taps,
                         precision: str = "highest") -> torch.Tensor:
    """L-fold interpolation [..., n] -> [..., n*l]; taps = the prototype
    low-pass (gain L applied here)."""
    bf16 = _is_default(precision)
    if policy.use_kernel(x):
        return (_interp_bf16_cuda if bf16 else _interp_cuda)(x, l, taps)
    plain = KF.interp_plain_bf16 if bf16 else KF.interp_plain
    return _unflatten(plain(_flatten(x), l, taps), x)
