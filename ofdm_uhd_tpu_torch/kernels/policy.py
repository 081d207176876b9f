"""Kernel dispatch by the tensor's device, launch counts, and the
reference's routing by the spec.

Two questions, answered apart:

  * Which algorithm or formulation runs is the spec's choice, as in the
    reference: `choose` (a copy of ofdm_uhd_tpu/kernels/policy.py:96-127,
    with its `_PALLAS_WINS` table) picks, from `kernel_backend`, between
    the reference's Pallas formulations (the fused CP-strip FFT and IFFT +
    CP, the boxcar S&C correlator) and its XLA ones; `filter_precision`
    gives, through it, the filter tier (exact or bf16) of each FIR call,
    since the reference applies spec.filter_precision only where its MXU
    kernel runs; `viterbi_impl`
    (ofdm_uhd_tpu/kernels/policy.py:68-93) picks the Viterbi algorithm
    from the spec and the batch. The windowed decoders can differ from
    the whole-sequence one on frames whose survivors do not merge
    (CRC-failing slots, which the stream still returns), so following the
    reference's choice gives its bits on every slot.
  * Which tier runs that formulation is the input tensor's choice:
      - a CPU tensor takes the kernel's plain PyTorch version;
      - a CUDA tensor launches the hand-written kernel, and a failed build
        or launch raises; it never falls back to the plain version quietly;
      - any other device raises.

`plain_versions()` is the one explicit exception: inside it, CUDA tensors
take the plain versions too, so a caller can time the same chain without
the hand kernels (chip_smoke.py does). Each wrapper adds one to its count
in `launches()` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import contextlib

import torch

# "fir" counts the strided kernel: 'same' FIR and decimation launches;
# "fir_bf16" and "interp_bf16" the bf16 tier's two kernels; "shift_*" the
# shifted-FMA tier of research/shift.py, which no user path runs
# ("shift_sc": its S&C correlator, served by the sccorr kernel); nor runs
# any path "banded_*" (kernels/banded.py, K8), "ilv_*" (research/fir_ilv.py,
# K13, on the same kernel source; "ilv_*_bf16" at the reference's DEFAULT
# precision, on the bf16 tier's) or "deframe" (research/deframe.py, K12);
# "fft_columns" and "fft_rows_t" count the two passes of K3's route above
# one launch, "sc_span" and "sc_stride" the two passes of the S&C split
# route (l > 4096), "viterbi_windowed_warp" K4w's previous body, the A/B
# baseline no path runs
KERNELS = ("localize", "extract", "fft", "fft_columns", "fft_rows_t",
           "viterbi", "viterbi_windowed", "viterbi_windowed_warp",
           "fir", "interp", "fir_bf16", "interp_bf16", "scfront", "cpfft",
           "ifftcp", "sccorr", "halo", "shift_fir", "shift_decim",
           "shift_interp", "shift_sc", "banded_fir", "banded_decim",
           "banded_interp", "banded_sc", "ilv_fir", "ilv_decim",
           "ilv_interp", "ilv_fir_bf16", "ilv_decim_bf16", "ilv_interp_bf16",
           "deframe", "sc_span", "sc_stride")

# the reference's batch crossovers between its Viterbi algorithms
_VITERBI_FUSED_MAX_BATCH = 96
_VITERBI_WINDOWED_MAX_BATCH = 2048


def viterbi_impl(size: int, batch: int | None, requested: str = "auto",
                 mode: str = "scan") -> str:
    """The reference's Viterbi algorithm for a spec's kernel_backend
    (`requested`) and viterbi_mode at a decode batch: 'fused'
    (kernels/viterbi.viterbi_fused), 'windowed' (the XLA windowed decoder)
    or 'scan' (whole sequence). `size`, the trellis length, is unused, as
    in the reference."""
    if requested == "pallas":
        return "fused"
    if requested != "auto":
        return "windowed" if mode == "windowed" else "scan"
    if batch is None:
        return "scan"
    if batch <= _VITERBI_FUSED_MAX_BATCH:
        return "fused"
    if batch <= _VITERBI_WINDOWED_MAX_BATCH:
        return "windowed"
    return "scan"


# The reference's table of the kernels whose Pallas formulation it routes
# under 'auto' (its TPU measurements): predicate(size, n) true -> 'pallas';
# a kernel absent here ('cpfft', 'ifftcp', 'sc_corr', 'sc_front', ...)
# takes its XLA formulation under 'auto'.
_PALLAS_WINS = {
    "fft": lambda size, n: size == 256,
    "fir": lambda size, n: size >= 64,
    "interp": lambda size, n: True,
    "viterbi": lambda size, n: viterbi_impl(size, n) == "fused",
    "extract": lambda size, n: True,
}


def choose(kernel: str, size: int, requested: str, n: int | None = None
           ) -> str:
    """The reference's formulation ('xla' or 'pallas') of one kernel call
    for a spec's kernel_backend (`requested`: 'xla', 'pallas' or 'auto').
    size: the kernel's characteristic size (FFT length, resample factor,
    correlator half-window, trellis length); n: batch or samples per call
    where known."""
    if requested != "auto":
        return requested
    win = _PALLAS_WINS.get(kernel)
    return "pallas" if (win is not None and win(size, n)) else "xla"


def filter_precision(spec, kernel: str, size: int, n: int | None = None
                     ) -> str:
    """The precision of one filter call ('fir' at size = the tap count,
    'interp' / 'decim' at size = the factor; n = samples): the spec's
    filter_precision where the reference routes the call to its Pallas MXU
    kernel (ofdm_uhd_tpu/kernels/fir.py:40-76), 'exact' elsewhere (its XLA
    convolution has no precision). At C4 (L = 8): 'auto' takes the tier
    for the TX interpolation only, 'pallas' for both, 'xla' for neither."""
    if choose(kernel, size, spec.kernel_backend, n) == "pallas":
        return spec.filter_precision
    return "exact"


class _Dispatch:
    """Process-wide dispatch state: the plain-forcing switch and counts."""

    def __init__(self):
        self.forced_plain = False
        self.launches = dict.fromkeys(KERNELS, 0)


_STATE = _Dispatch()


def use_kernel(x: torch.Tensor) -> bool:
    """True -> launch the hand kernel on x; False -> the plain version."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel route for a tensor on {x.device}")
    return not _STATE.forced_plain


def count_launch(kernel: str) -> None:
    _STATE.launches[kernel] += 1


def launches() -> dict[str, int]:
    """Launches per kernel since the last reset_launches()."""
    return dict(_STATE.launches)


def reset_launches() -> None:
    for k in _STATE.launches:
        _STATE.launches[k] = 0


@contextlib.contextmanager
def plain_versions():
    """Route CUDA tensors to the plain PyTorch versions inside the block."""
    prev = _STATE.forced_plain
    _STATE.forced_plain = True
    try:
        yield
    finally:
        _STATE.forced_plain = prev
