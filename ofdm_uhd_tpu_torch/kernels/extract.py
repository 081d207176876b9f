"""Frame extraction at detected offsets: hand kernel + plain version.

Replaces ofdm_uhd_tpu/kernels/pallas_extract.py:extract_frames_pallas
(CUDA source: csrc/extract.cu). frames[c, i] = capture[c, s : s +
frame_len] with s = clip(ds[c, i], 0, n) and zeros past n: the
dynamic_slice semantics of the reference, as a bit-exact copy.
"""

from __future__ import annotations

import torch

from . import build, policy


def extract_plain(capture: torch.Tensor, ds: torch.Tensor,
                  frame_len: int) -> torch.Tensor:
    caps, n = capture.shape
    start = ds.long().clamp(0, n)
    padded = torch.cat([capture, capture.new_zeros(caps, frame_len)], dim=-1)
    rows = torch.arange(caps, device=capture.device)[:, None]
    return padded.unfold(-1, frame_len, 1)[rows, start]


def _extract_cuda(capture, ds, frame_len):
    if (capture.dtype != torch.complex64 or ds.dtype != torch.int32
            or capture.dim() != 2 or ds.dim() != 2
            or ds.shape[0] != capture.shape[0]):
        raise ValueError(
            f"extract: need capture c64 [C, n], ds i32 [C, mf]; got "
            f"{capture.dtype} {tuple(capture.shape)}, {ds.dtype} "
            f"{tuple(ds.shape)}")
    build.check_inputs("extract", capture, ds)
    caps, n = capture.shape
    mf = ds.shape[1]
    out = torch.empty((caps, mf, frame_len), dtype=torch.complex64,
                      device=capture.device)
    lib = build.library()
    err = lib.ofdm_extract(capture.data_ptr(), ds.data_ptr(), out.data_ptr(),
                           caps, n, mf, frame_len,
                           build.stream_ptr(capture.device))
    build.check(err, "extract")
    policy.count_launch("extract")
    return out


def extract_frames(capture: torch.Tensor, ds: torch.Tensor,
                   frame_len: int) -> torch.Tensor:
    """capture [C, n] c64, ds [C, mf] i32 -> frames [C, mf, frame_len]."""
    if policy.use_kernel(capture):
        return _extract_cuda(capture, ds, frame_len)
    return extract_plain(capture, ds, frame_len)
