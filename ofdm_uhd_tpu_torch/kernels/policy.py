"""Kernel dispatch by the tensor's device, launch counts, and the
reference's choice of Viterbi algorithm.

The reference picked a kernel tier from a global backend string and a
table of TPU measurements. Here the input tensor decides the tier:

  * a CPU tensor takes the kernel's plain PyTorch version;
  * a CUDA tensor launches the hand-written kernel, and a failed build or
    launch raises; it never falls back to the plain version quietly;
  * any other device raises.

`plain_versions()` is the one explicit exception: inside it, CUDA tensors
take the plain versions too, so a caller can time the same chain without
the hand kernels (chip_smoke.py does). Each wrapper adds one to its count
in `launches()` where it launches its kernel, and nowhere else.

The Viterbi *algorithm* is another matter: the reference's windowed
decoders can differ from the whole-sequence one on frames whose survivors
do not merge (CRC-failing slots, which the stream still returns), so the
port takes the reference's choice, from the spec and the batch
(`viterbi_impl`, ofdm_uhd_tpu/kernels/policy.py:68-93), and gives its
bits on every slot; the device then picks the tier of that algorithm.
"""

from __future__ import annotations

import contextlib

import torch

# "fir" counts the strided kernel: 'same' FIR and decimation launches
KERNELS = ("localize", "extract", "fft", "viterbi", "viterbi_windowed",
           "fir", "interp", "scfront")

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
