"""Synthetic capture construction: the counterpart of the repository's
bench_lib.build_capture, with the same arguments and defaults, for
machines without JAX. The frames come from the port's TxPipeline on
`device` (by default the CUDA card; pass device='cpu' for the CPU); the
channel (CFO, phase noise, AWGN, timing offset, idle gaps)
is the NumPy impairment stack of channel/models.py.
"""

from __future__ import annotations

import numpy as np
import torch

from .channel import make_capture
from .core.spec import ChannelSpec, WaveformSpec
from .pipeline.tx import TxPipeline


def build_capture(spec: WaveformSpec, n_frames: int, gap: int, seed: int = 0,
                  snr_db: float = 28.0, cfo: float = 0.8,
                  phase_noise_std: float = 2e-4, timing_offset: int = 100,
                  device: str | torch.device = "cuda"
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Multi-frame capture with channel impairments.

    Returns (capture complex64 [n], payloads uint8 [n_frames, bits]).
    """
    rng = np.random.default_rng(seed)
    payloads = rng.integers(
        0, 2, (n_frames, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = TxPipeline(spec)(torch.from_numpy(payloads).to(device))
    ch = ChannelSpec(snr_db=snr_db, cfo=cfo, phase_noise_std=phase_noise_std,
                     timing_offset=timing_offset)
    cap = make_capture(frames.cpu().numpy(), ch, spec.n_sc, gap=gap,
                       seed=seed)
    return cap.astype(np.complex64), payloads


def to_sc16(caps: np.ndarray) -> np.ndarray:
    """[C, n] complex -> [2, C, n] int16 full-scale planes (UHD sc16), as
    the repository's bench.py converts its captures."""
    planes = np.stack([caps.real, caps.imag])
    scale = 32767.0 / np.max(np.abs(planes))
    return np.round(planes * scale).astype(np.int16)
