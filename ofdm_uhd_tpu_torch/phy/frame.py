"""Frame build/parse, OFDM modulate/demodulate, channel estimation,
one-tap EQ and pilot phase tracking, batched over frames.

The counterpart of ofdm_uhd_tpu/phy/frame.py. Moves between bin
orderings (data/pilot <-> FFT grid <-> occupied) are index gathers and
assignments here; the reference's one-hot selection matmuls give the same
values. The FFTs go through kernels/fft.py (hand kernels on CUDA): the
spec's kernel_backend picks the formulation as the reference does
(kernels/policy.choose), the CP-fused forms (K5) under 'pallas' where the
reference routes them, else the FFT (K3) with a separate CP strip or
insertion.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spec import WaveformSpec
from ..kernels import fft as K1
from ..kernels.policy import choose
from . import tables as T


def _idx(spec: WaveformSpec, key: str, device) -> torch.Tensor:
    return T.on_device(T.frame_tables, (spec,), key, device).long()


def _const(spec: WaveformSpec, key: str, device) -> torch.Tensor:
    return T.on_device(T.frame_tables, (spec,), key, device)


def build_grid(spec: WaveformSpec, data_syms: torch.Tensor) -> torch.Tensor:
    """data_syms [B, n_data_syms, n_data_sc] -> grid [B, n_syms, n_sc] c64."""
    dev = data_syms.device
    b = data_syms.shape[0]
    grid = torch.zeros((b, spec.n_syms, spec.n_sc), dtype=torch.complex64,
                       device=dev)
    grid[:, 0] = _const(spec, "sym_a", dev)
    grid[:, 1] = _const(spec, "sym_b", dev)
    pol = _const(spec, "pilot_polarity", dev).to(torch.complex64)
    grid[:, 2:, _idx(spec, "pilot_bins", dev)] = pol[None, :, None]
    grid[:, 2:, _idx(spec, "data_bins", dev)] = data_syms.to(torch.complex64)
    return grid


def ofdm_modulate(spec: WaveformSpec, grid: torch.Tensor) -> torch.Tensor:
    """grid [B, n_syms, n_sc] -> samples [B, frame_len] (IFFT + CP), with
    the raised-cosine edge taper of spec.tx_window when it is > 0."""
    b = grid.shape[0]
    w = spec.tx_window
    if (w <= 0 and spec.n_sc <= 512 and spec.cp > 0
            and choose("ifftcp", spec.n_sc, spec.kernel_backend) == "pallas"):
        # the reference's fused IFFT + CP insertion (K5): each symbol's row
        # is written with its prefix, no concatenation pass
        return K1.ifft_cp(grid, spec.cp).reshape(b, spec.frame_len)
    x = K1.ifft(grid)
    with_cp = torch.cat([x[..., -spec.cp:], x], dim=-1)      # [B, S, sym_len]
    if w <= 0:
        return with_cp.reshape(b, spec.frame_len)
    ramp = torch.from_numpy(
        (0.5 * (1 - np.cos(np.pi * (np.arange(w) + 0.5) / w))).astype(
            np.float32)).to(grid.device).to(torch.complex64)
    tapered = torch.cat([with_cp[..., :w] * ramp, with_cp[..., w:]], dim=-1)
    main = tapered.reshape(b, spec.frame_len)
    suffix = x[..., :w] * ramp.flip(0)                        # [B, S, w]
    pad = suffix.new_zeros((b, spec.n_syms, spec.sym_len - w))
    sufframe = torch.cat([suffix, pad], dim=-1).reshape(b, spec.frame_len)
    # symbol s's suffix lands at (s+1)*sym_len: shift right one symbol
    shifted = torch.cat([sufframe.new_zeros((b, spec.sym_len)), sufframe],
                        dim=-1)[:, : spec.frame_len]
    return main + shifted


def fft_windows(spec: WaveformSpec, samples: torch.Tensor,
                shift: int = 0) -> torch.Tensor:
    """samples [B, frame_len] -> CP-stripped symbols [B, n_syms, n_sc]
    (contiguous: the FFT kernel's input); `shift` advances the window into
    the CP (absorbed by the EQ)."""
    b = samples.shape[0]
    syms = samples[:, : spec.frame_len].reshape(b, spec.n_syms, spec.sym_len)
    start = spec.cp - shift
    return syms[..., start:start + spec.n_sc].contiguous()


def ofdm_demodulate(spec: WaveformSpec, samples: torch.Tensor,
                    shift: int = 0) -> torch.Tensor:
    """samples [B, frame_len] -> grid [B, n_syms, n_sc] (CP strip + FFT)."""
    if (spec.n_sc <= 512 and spec.sym_len % 8 == 0
            and choose("cpfft", spec.n_sc, spec.kernel_backend) == "pallas"):
        # the reference's fused CP strip + FFT (K5): the symbol rows are
        # read in place, the strip is an offset
        b = samples.shape[0]
        syms = samples[:, : spec.frame_len].reshape(b, spec.n_syms,
                                                    spec.sym_len)
        return K1.cp_strip_fft(syms, spec.cp - shift, spec.n_sc)
    return K1.fft(fft_windows(spec, samples, shift))


def _smooth_occ(h: torch.Tensor, width: int) -> torch.Tensor:
    """Edge-renormalized moving average over the occupied-bin axis, as the
    reference's banded [n_occ, n_occ] matrix product."""
    if width <= 1:
        return h
    n = h.shape[-1]
    den = np.convolve(np.ones(n), np.ones(width), mode="same")
    m = np.zeros((n, n), dtype=np.float32)
    lo = width // 2
    for j in range(n):
        a = max(0, j - lo)
        b = min(n, j + (width - 1 - lo) + 1)
        m[a:b, j] = 1.0 / den[j]
    mt = torch.from_numpy(m).to(h.device)
    return torch.complex(h.real.float() @ mt, h.imag.float() @ mt)


def estimate_channel(spec: WaveformSpec, grid_rx: torch.Tensor) -> torch.Tensor:
    """LS estimate from preamble sym B -> H on occupied bins [B, n_occupied]."""
    dev = grid_rx.device
    y = grid_rx[:, 1, _idx(spec, "occupied_bins", dev)]
    h = y * _const(spec, "sym_b_occ_conj", dev)
    return _smooth_occ(h, spec.chanest_smooth)


def estimate_noise(spec: WaveformSpec, grid_rx: torch.Tensor) -> torch.Tensor:
    """Per-frame noise variance [B] from the guard (noise-only) bins."""
    guard = torch.from_numpy(np.array(spec.guard_bins)).to(grid_rx.device)
    p = grid_rx[..., guard].abs() ** 2                        # [B, S, n_guard]
    return p.sum(dim=(-1, -2)) / (spec.n_syms * len(spec.guard_bins))


def equalize(spec: WaveformSpec, grid_rx: torch.Tensor, h_occ: torch.Tensor,
             eps: float = 1e-12) -> torch.Tensor:
    """One-tap EQ -> equalized occupied bins [B, n_data_syms, n_occupied]
    ('zf' or 'mmse' per spec.eq_mode)."""
    y = grid_rx[:, 2:, _idx(spec, "occupied_bins", grid_rx.device)]
    h = h_occ[:, None, :]
    reg = T.f32_scalar(eps, grid_rx.device)
    if spec.eq_mode == "mmse":
        reg = estimate_noise(spec, grid_rx)[:, None, None] + reg
    return y * torch.conj(h) / (h.abs() ** 2 + reg)


def track_phase(spec: WaveformSpec, eq_occ: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pilot phase tracking (CPE, + phase slope when spec.sfo_track) ->
    (data [B, n_data_syms, n_data_sc], cpe [B, n_data_syms])."""
    dev = eq_occ.device
    t = T.frame_tables(spec)
    pol = _const(spec, "pilot_polarity", dev).to(torch.complex64)
    pilots = (eq_occ[..., _idx(spec, "pilot_positions", dev)]
              * torch.conj(pol)[None, :, None])
    k_pil = _const(spec, "pilot_positions", dev).float()
    if spec.sfo_track and spec.n_pilots >= 2:
        diffs = pilots[..., 1:] * torch.conj(pilots[..., :-1])
        dk = float(np.mean(np.diff(t["pilot_positions"].astype(np.float64))))
        slope = torch.angle(diffs.sum(-1)) / dk               # [B, S]
    else:
        slope = torch.zeros(eq_occ.shape[:2], dtype=torch.float32, device=dev)
    derot = torch.polar(torch.ones_like(pilots.real),
                        -(slope[..., None] * k_pil))
    cpe = torch.angle((pilots * derot).sum(-1))               # [B, S]
    k_data = _const(spec, "data_positions", dev).float()
    corr_phase = cpe[..., None] + slope[..., None] * k_data
    corr = torch.polar(torch.ones_like(corr_phase), -corr_phase)
    data = eq_occ[..., _idx(spec, "data_positions", dev)] * corr
    return data, cpe


def data_csi(spec: WaveformSpec, h_occ: torch.Tensor) -> torch.Tensor:
    """|H|^2 on data bins [B, n_data_sc]: LLR reliability weights."""
    return (h_occ.abs() ** 2)[..., _idx(spec, "data_positions", h_occ.device)]
