"""Frame extraction by one bulk copy per frame (K12): the counterpart of
ofdm_uhd_tpu/research/pallas_deframe.py (extract_frames_dma).

The reference keeps this kernel as a measured dead end beside its
production extraction (K2, kernels/pallas_extract.py) and routes no user
path to it; neither does the port. Its function is not K2's:

  * an offset d >= 0 is clamped above to n, and samples past n read as
    zeros (as K2 and kernels/extract.py);
  * a negative offset gives an all-zero frame, where K2 clamps it to 0
    (the reference's DMA window starts inside its zero padding). For
    d < -(frame_len rounded up to 128, plus 128) the reference's
    interpret mode reads its padded capture from the end instead, as a
    negative Python index does; the TPU kernel would copy from before the
    buffer there. The port gives zeros for every negative offset
    (tests/test_torch_deframe.py pins both).

  extract_frames_dma(capture, ds, frame_len)
      capture [n] or [C, n] complex64, ds [mf] or [C, mf] int32 ->
      frames [mf, frame_len] or [C, mf, frame_len] (the reference's vmap
      over captures is the leading dimension)

A CUDA tensor launches csrc/deframe.cu (counted as `deframe`); a CPU
tensor, or any inside policy.plain_versions(), takes `deframe_plain`.
"""

from __future__ import annotations

import torch

from ..kernels import build, policy


def _as_rows(capture: torch.Tensor, ds: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    if (capture.dtype != torch.complex64 or ds.dtype != torch.int32
            or capture.dim() not in (1, 2) or ds.dim() != capture.dim()
            or (capture.dim() == 2 and ds.shape[0] != capture.shape[0])):
        raise ValueError(
            f"deframe: need capture c64 [n] or [C, n] and ds i32 [mf] or "
            f"[C, mf]; got {capture.dtype} {tuple(capture.shape)}, "
            f"{ds.dtype} {tuple(ds.shape)}")
    if capture.dim() == 1:
        return capture[None], ds[None]
    return capture, ds


def deframe_plain(capture: torch.Tensor, ds: torch.Tensor, frame_len: int
                  ) -> torch.Tensor:
    """K12's function in PyTorch: frames[c, i] = capture[c, d : d +
    frame_len], d = min(ds[c, i], n), zeros past n; zeros where ds < 0."""
    rows, offs = _as_rows(capture, ds)
    caps, n = rows.shape
    start = offs.long().clamp(max=n)
    padded = torch.cat([rows, rows.new_zeros(caps, frame_len)], dim=-1)
    idx = torch.arange(caps, device=rows.device)[:, None]
    frames = padded.unfold(-1, frame_len, 1)[idx, start.clamp(min=0)]
    frames = torch.where((start < 0)[..., None], frames.new_zeros(()),
                         frames)
    return frames.reshape(ds.shape + (frame_len,))


def _deframe_cuda(capture: torch.Tensor, ds: torch.Tensor, frame_len: int
                  ) -> torch.Tensor:
    rows, offs = _as_rows(capture, ds)
    build.check_inputs("deframe", rows, offs)
    caps, n = rows.shape
    mf = offs.shape[1]
    out = torch.empty((caps, mf, frame_len), dtype=torch.complex64,
                      device=rows.device)
    err = build.library().ofdm_deframe(
        rows.data_ptr(), offs.data_ptr(), out.data_ptr(), caps, n, mf,
        frame_len, build.stream_ptr(rows.device))
    build.check(err, "deframe")
    policy.count_launch("deframe")
    return out.reshape(ds.shape + (frame_len,))


def extract_frames_dma(capture: torch.Tensor, ds: torch.Tensor,
                       frame_len: int) -> torch.Tensor:
    """capture [n] or [C, n] complex64, ds [mf] or [C, mf] int32 -> frames
    [..., mf, frame_len]: K12's extraction (zeros at negative offsets)."""
    if policy.use_kernel(capture):
        return _deframe_cuda(capture, ds, frame_len)
    return deframe_plain(capture, ds, frame_len)
