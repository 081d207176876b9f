"""Golden polyphase resampler (float64 NumPy).

A copy of `ofdm_uhd_tpu/golden/resample.py`: phy/tables.resample_filter
reads `design_lowpass` (tests/test_torch_tables.py), the golden chain
(chain.py) runs `resample`. Prototype: a Kaiser-windowed sinc low-pass,
cutoff pi/max(L, M), odd length, so the integer group delay is sliced off
and a resample by L then by 1/L returns a time-aligned signal.
"""

from __future__ import annotations

import numpy as np


def design_lowpass(l: int, m: int = 1, taps_per_phase: int = 12,
                   beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype for L/M polyphase resampling.

    Odd length 2*half+1 with half even, so the group delay is an integer;
    gain 1/max(L, M) per tap (the caller scales interpolation by L).
    """
    r = max(l, m)
    half = taps_per_phase * r // 2 * 2
    n = np.arange(-half, half + 1)
    h = np.sinc(n / r) / r
    h *= np.kaiser(len(h), beta)
    return h


def upfirdn(h: np.ndarray, x: np.ndarray, l: int, m: int) -> np.ndarray:
    """Insert l-1 zeros, filter with h, keep every m-th sample (full conv)."""
    up = np.zeros(len(x) * l, dtype=x.dtype)
    up[::l] = x
    y = np.convolve(up, h.astype(np.float64) if not np.iscomplexobj(x) else h)
    return y[::m]


def resample(x: np.ndarray, l: int, m: int,
             h: np.ndarray | None = None) -> np.ndarray:
    """Rational L/M resample, group-delay compensated.

    Output length = len(x)*l//m; output[k] ~ x(k*m/l) for bandlimited x.
    """
    if l == 1 and m == 1:
        return x.copy()
    if h is None:
        h = design_lowpass(l, m)
    half = (len(h) - 1) // 2
    up = np.zeros(len(x) * l, dtype=np.complex128)
    up[::l] = x
    y = np.convolve(up, h * l)
    y = y[half: half + len(x) * l]
    return y[::m]


def fir_filter(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """'Same'-aligned FIR (group-delay compensated)."""
    half = (len(h) - 1) // 2
    y = np.convolve(x, h)
    return y[half: half + len(x)]
