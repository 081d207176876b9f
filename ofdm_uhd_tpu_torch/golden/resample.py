"""NumPy resampler prototype the host tables are derived from.

A copy of `design_lowpass` from `ofdm_uhd_tpu/golden/resample.py`
(phy/tables.resample_filter reads it; tests/test_torch_tables.py holds
the result equal to the reference's).
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
