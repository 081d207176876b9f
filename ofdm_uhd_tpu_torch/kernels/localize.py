"""Per-candidate plateau localization (detection): hand kernel + plain.

Replaces ofdm_uhd_tpu/kernels/pallas_localize.py:localize_pallas (CUDA
source: csrc/localize.cu). For each candidate c, over M[c, c + span) with
reads past nd counting as 0: the first-index peak, the rel-of-peak
plateau [lo, hi], d = max(c + (lo + hi) // 2 - cp // 2, 0) and
eps = angle(P at the peak) / pi. Candidates are clamped to nd, so the
sentinel nd reads an all-zero window. Batched over captures: m, p
[C, nd], cand [C, mf].
"""

from __future__ import annotations

import numpy as np
import torch

from . import build, policy


def localize_plain(m: torch.Tensor, p: torch.Tensor, cand: torch.Tensor,
                   span: int, cp: int, rel: float = 0.9
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    caps, nd = m.shape
    c = cand.long().clamp(0, nd)                             # [C, mf]
    rows = torch.arange(caps, device=m.device)[:, None]
    m_pad = torch.cat([m, m.new_zeros(caps, span)], dim=-1)
    win = m_pad.unfold(-1, span, 1)[rows, c]                 # [C, mf, span]
    iota = torch.arange(span, device=m.device)
    peak = win.amax(-1, keepdim=True)
    peak_off = torch.where(win >= peak, iota, span).amin(-1)
    above = win >= peak * torch.tensor(rel, dtype=torch.float32,
                                       device=m.device)
    lo = torch.where(above, iota, span).amin(-1)
    hi = torch.where(above, iota, -1).amax(-1)
    d = (c + (lo + hi) // 2 - cp // 2).clamp_min(0).to(torch.int32)
    p_pad = torch.cat([p, p.new_zeros(caps, 1)], dim=-1)
    pv = p_pad[rows, (c + peak_off).clamp_max(nd)]
    eps = torch.atan2(pv.imag, pv.real) * torch.tensor(
        np.float32(1.0 / np.pi), device=m.device)
    return d, eps


def _localize_cuda(m, p, cand, span, cp, rel):
    caps, nd = m.shape
    if (m.dtype != torch.float32 or p.dtype != torch.complex64
            or cand.dtype != torch.int32 or p.shape != m.shape
            or cand.dim() != 2 or cand.shape[0] != caps):
        raise ValueError(
            f"localize: need m f32 [C, nd], p c64 [C, nd], cand i32 [C, mf]; "
            f"got {m.dtype} {tuple(m.shape)}, {p.dtype} {tuple(p.shape)}, "
            f"{cand.dtype} {tuple(cand.shape)}")
    build.check_inputs("localize", m, p, cand)
    mf = cand.shape[1]
    d = torch.empty((caps, mf), dtype=torch.int32, device=m.device)
    eps = torch.empty((caps, mf), dtype=torch.float32, device=m.device)
    lib = build.library()
    err = lib.ofdm_localize(m.data_ptr(), p.data_ptr(), cand.data_ptr(),
                            d.data_ptr(), eps.data_ptr(), caps, nd, mf,
                            span, cp // 2, float(np.float32(rel)),
                            build.stream_ptr(m.device))
    build.check(err, "localize")
    policy.count_launch("localize")
    return d, eps


def localize(m: torch.Tensor, p: torch.Tensor, cand: torch.Tensor,
             span: int, cp: int, rel: float = 0.9
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """m [C, nd] f32, p [C, nd] c64, cand [C, mf] i32 ->
    (d [C, mf] i32, eps [C, mf] f32)."""
    if policy.use_kernel(m):
        return _localize_cuda(m, p, cand, span, cp, rel)
    return localize_plain(m, p, cand, span, cp, rel)
