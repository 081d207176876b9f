"""AGC / power normalization: the counterpart of ofdm_uhd_tpu/phy/agc.py.

The S&C metric is level-normalized and the one-tap EQ absorbs static
gain, so this is numeric conditioning: every capture lands at unit mean
power before thresholds and CSI.
"""

from __future__ import annotations

import numpy as np
import torch


def agc_normalize(x: torch.Tensor, target: float = 1.0, eps: float = 1e-20
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scale [..., n] blocks to mean power `target` (per leading index).

    Returns (scaled, gain [...]). Idle blocks (power ~ 0) pass unscaled.
    """
    p = (x.abs() ** 2).mean(dim=-1, keepdim=True)
    gain = torch.where(p > eps, torch.sqrt(target / p.clamp_min(eps)),
                       torch.ones_like(p))
    return x * gain.to(x.dtype), gain[..., 0]


def agc_normalize_np(x: np.ndarray, target: float = 1.0) -> np.ndarray:
    """The float64 golden twin: the whole block to mean power `target`."""
    p = np.mean(np.abs(x) ** 2)
    if p <= 1e-20:
        return x.copy()
    return x * np.sqrt(target / p)
