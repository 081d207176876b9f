"""Schmidl-Cox sliding correlation and timing metric (plain PyTorch).

The counterpart of ofdm_uhd_tpu/kernels/sync.py's XLA compose, the form
the reference routes at the C3 batch. For each lag d:

    P(d) = sum_{m=0}^{L-1} conj(r[d+m]) * r[d+m+L]
    R(d) = 0.5 * sum_{m=0}^{2L-1} |r[d+m]|^2

The windowed sums use the same PAIRWISE DOUBLING (S_2w[d] = S_w[d] +
S_w[d+w]) in the same order as the reference, not prefix-sum differences,
so M agrees with the reference to a few float32 ulps and the >=
comparisons of detection (threshold, plateau) fall the same way.
"""

from __future__ import annotations

import torch


def _moving_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    """Valid-mode boxcar along the last axis: y[..., d] = sum_{m<win}
    x[..., d+m], length n - win + 1, by doubling over win's binary digits."""
    n = x.shape[-1]
    out_len = n - win + 1
    s = x.float()
    w = 1
    acc = None
    off = 0
    rem = win
    while rem:
        if rem & 1:
            part = s[..., off:off + out_len]
            acc = part if acc is None else acc + part
            off += w
        rem >>= 1
        if rem:
            s = s[..., : s.shape[-1] - w] + s[..., w:]
            w *= 2
    return acc


def sc_correlate(r: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """r [..., n] complex64 -> (P [..., nd] c64, R [..., nd] f32),
    nd = n - 2l + 1."""
    prod = torch.conj(r[..., :-l]) * r[..., l:]
    p_re = _moving_sum(prod.real, l)
    p_im = _moving_sum(prod.imag, l)
    e = r.abs() ** 2
    rr = 0.5 * _moving_sum(e, 2 * l)
    return torch.complex(p_re, p_im), rr


def sc_metric(p: torch.Tensor, rr: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """M(d) = |P|^2 / R^2, zero where R ~ 0 (idle input)."""
    m = p.abs() ** 2 / rr.clamp_min(eps) ** 2
    return torch.where(rr > eps, m, torch.zeros_like(m))
