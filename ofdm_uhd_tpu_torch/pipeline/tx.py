"""Batched TX pipeline: scramble -> FEC -> interleave -> QAM -> frame
build -> IFFT + CP -> polyphase resampling to the radio rate. The
counterpart of ofdm_uhd_tpu/pipeline/tx.py.

In the port the TX is a data generator for tests and the chip smoke run:
it runs on whatever device its input lies on, through the same kernel
dispatch as the RX. On CUDA the IFFT + CP is the fused K5 kernel under
kernel_backend='pallas' (where the reference routes ifft_cp_pallas), else
the FFT kernel's inverse and a concatenation; the interpolation is the
interp kernel, or its bf16 tier with filter_precision='bf16' where the
reference routes its MXU filter kernel (kernel_backend 'pallas' or
'auto').
"""

from __future__ import annotations

import torch

from ..core.spec import WaveformSpec, TAIL_BITS
from ..kernels import fir as KF
from ..kernels import policy
from ..phy import bits as PB
from ..phy import frame as PF
from ..phy import qam as PQ
from ..phy import tables as T


class TxPipeline:
    """payloads [B, payload_bits_per_frame] -> frames
    [B, frame_len_radio]."""

    def __init__(self, spec: WaveformSpec):
        self.spec = spec

    def encode(self, payloads: torch.Tensor) -> torch.Tensor:
        """payloads -> interleaved coded bits [B, coded_bits_per_frame]."""
        return _encode(self.spec, payloads)

    def baseband(self, payloads: torch.Tensor) -> torch.Tensor:
        """payloads -> frames [B, frame_len] before any resampling."""
        spec = self.spec
        syms = PQ.qam_map(_encode(spec, payloads), spec.modulation)
        grid = PF.build_grid(spec, syms.reshape(-1, spec.n_data_syms,
                                                spec.n_data_sc))
        return PF.ofdm_modulate(spec, grid)

    def __call__(self, payloads: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        frames = self.baseband(payloads)
        l, m = spec.resample_l, spec.resample_m
        if l > 1:
            frames = KF.polyphase_interp(
                frames, l, T.resample_filter(l, m),
                precision=policy.filter_precision(spec, "interp", l,
                                                  frames.numel()))
        if m > 1:
            frames = KF.polyphase_decim(
                frames, m, T.resample_filter(l, m),
                precision=policy.filter_precision(spec, "decim", m,
                                                  frames.numel()))
        return frames


def _encode(spec: WaveformSpec, payloads: torch.Tensor) -> torch.Tensor:
    payloads = payloads.to(torch.uint8)
    crc = PB.crc32(payloads)
    body = PB.scramble(torch.cat([payloads, crc], dim=-1))
    tail = body.new_zeros(body.shape[:-1] + (TAIL_BITS,))
    coded = PB.conv_encode(torch.cat([body, tail], dim=-1))
    coded = PB.puncture(coded, spec.fec_rate)
    return PB.interleave(coded, spec.coded_bits_per_sym)
