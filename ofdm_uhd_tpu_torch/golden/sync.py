"""Golden Schmidl-Cox timing and CFO synchronization (float64 NumPy).

A copy of `ofdm_uhd_tpu/golden/sync.py`, the same operations in the same
order (tests/test_torch_golden.py holds each function equal to the
reference's):

    P(d) = sum_{m=0}^{L-1} conj(r[d+m]) * r[d+m+L]        (L = n_sc/2)
    R(d) = 0.5 * sum_{m=0}^{2L-1} |r[d+m]|^2
    M(d) = |P(d)|^2 / R(d)^2

R is the symmetric full-window energy (Minn's variant): the second-half
energy alone collapses at a signal-to-silence edge, where |P|^2/R^2 then
spikes above the true plateau. M plateaus over the CP of the first
preamble symbol; the 90%-of-max plateau midpoint gives the timing, and
angle(P)/pi the fractional CFO in subcarrier spacings. The integer CFO
comes from correlating the received sym-B spectrum against the known PN
at integer bin shifts.
"""

from __future__ import annotations

import numpy as np

from ..core.spec import WaveformSpec
from .modem import preamble_freq


def sc_metric(spec: WaveformSpec, r: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
    """(P(d), R(d)) for d = 0 .. len(r)-2L, by cumulative sums."""
    L = spec.n_sc // 2
    n = len(r)
    nd = n - 2 * L + 1
    if nd <= 0:
        return np.zeros(0, complex), np.zeros(0)
    prod = np.conj(r[:-L]) * r[L:]               # [n-L]
    e = np.abs(r) ** 2
    cp = np.concatenate([[0], np.cumsum(prod)])
    ce = np.concatenate([[0], np.cumsum(e)])
    p = cp[L: L + nd] - cp[:nd]
    rr = 0.5 * (ce[2 * L: 2 * L + nd] - ce[:nd])   # full-window energy / 2
    return p, rr


def detect_plateau(m: np.ndarray, threshold: float = 0.5,
                   rel: float = 0.9, span: int | None = None) -> int:
    """Timing from the S&C metric: the midpoint of the region above `rel` x
    peak around the first threshold crossing (the peak searched within
    `span` after it, so a later frame in the same window cannot take the
    argmax). -1 if nothing crosses."""
    if len(m) == 0:
        return -1
    above = np.nonzero(m >= threshold)[0]
    if len(above) == 0:
        return -1
    i0 = int(above[0])
    end = len(m) if span is None else min(i0 + span, len(m))
    peak = i0 + int(np.argmax(m[i0:end]))
    lvl = rel * m[peak]
    lo = peak
    while lo > 0 and m[lo - 1] >= lvl:
        lo -= 1
    hi = peak
    while hi < len(m) - 1 and m[hi + 1] >= lvl:
        hi += 1
    return (lo + hi) // 2


def coarse_sync(spec: WaveformSpec, r: np.ndarray,
                threshold: float = 0.5) -> tuple[int, float]:
    """Detect one frame: (d_hat, eps_frac).

    d_hat: the estimated first sample of the frame (the start of the sym-A
    cyclic prefix), -1 if nothing was detected. M(d) is flat for d in
    [start, start + cp], so the plateau's midpoint lies ~cp/2 after the
    frame start and is moved back by cp/2. eps_frac: the fractional CFO
    in subcarrier spacings, in (-1, 1].
    """
    p, rr = sc_metric(spec, r)
    m = np.where(rr > 1e-12, np.abs(p) ** 2 / np.maximum(rr, 1e-12) ** 2, 0.0)
    d = detect_plateau(m, threshold, span=spec.sym_len)
    if d < 0:
        return -1, 0.0
    d_hat = d - spec.cp // 2
    eps = float(np.angle(p[d])) / np.pi
    return d_hat, eps


def integer_cfo(spec: WaveformSpec, r_frame: np.ndarray,
                search: int = 4) -> int:
    """Integer CFO (subcarrier units) from preamble sym B.

    After the fractional correction, the sym-B window's FFT is correlated
    with the known PN at shifts in [-search, search]; the differential
    (adjacent-bin) correlation removes the unknown channel phase, and the
    true shift maximizes its magnitude.
    """
    _, sym_b = preamble_freq(spec)
    start = spec.sym_len + spec.cp  # sym B window within the frame
    win = r_frame[start: start + spec.n_sc]
    y = np.fft.fft(win, norm="ortho")
    occ = spec.occupied_bins
    ref = sym_b[occ]
    best, best_val = 0, -np.inf
    for s in range(-search, search + 1):
        ys = y[(occ + s) % spec.n_sc]
        d = ys * np.conj(ref)
        val = np.abs(np.sum(d[1:] * np.conj(d[:-1])))
        if val > best_val:
            best, best_val = s, val
    return best


def cfo_correct(r: np.ndarray, eps: float, n_sc: int,
                phase0: float = 0.0) -> np.ndarray:
    """Mix by exp(-j*(2*pi*eps*n/n_sc + phase0))."""
    n = np.arange(len(r))
    return r * np.exp(-1j * (2.0 * np.pi * eps * n / n_sc + phase0))
