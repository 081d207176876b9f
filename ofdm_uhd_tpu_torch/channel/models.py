"""Channel impairment models (host-side NumPy; deterministic via seed).

A copy of `ofdm_uhd_tpu/channel/models.py` (the port cannot import the JAX
package). These double as the "fake radio": synthetic captures with
controlled impairments (AWGN, static multipath, CFO + phase noise).
Same seeds give the same samples as the original
(tests/test_torch_tables.py holds them to the original).
"""

from __future__ import annotations

import numpy as np

from ..core.spec import ChannelSpec


def awgn(x: np.ndarray, snr_db: float, rng: np.random.Generator,
         signal_power: float | None = None) -> np.ndarray:
    """Complex AWGN at the given SNR relative to measured (or given) signal power."""
    p = signal_power if signal_power is not None else float(np.mean(np.abs(x) ** 2))
    n0 = p / (10.0 ** (snr_db / 10.0))
    noise = rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x))
    return x + noise * np.sqrt(n0 / 2.0)


def multipath(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Static multipath FIR channel; tap 0 is the direct path ('same' head)."""
    if len(taps) == 0:
        return x.copy()
    y = np.convolve(x, np.asarray(taps, dtype=np.complex128))
    return y[: len(x)]


def cfo_shift(x: np.ndarray, eps: float, n_sc: int) -> np.ndarray:
    """Carrier frequency offset of eps subcarrier spacings: x * e^{+j2pi eps n/N}."""
    n = np.arange(len(x))
    return x * np.exp(1j * 2.0 * np.pi * eps * n / n_sc)


def phase_noise(x: np.ndarray, std: float, rng: np.random.Generator) -> np.ndarray:
    """Wiener phase noise: phi[n] = phi[n-1] + N(0, std^2)."""
    phi = np.cumsum(rng.standard_normal(len(x)) * std)
    return x * np.exp(1j * phi)


def apply_channel(x: np.ndarray, ch: ChannelSpec, n_sc: int,
                  seed: int = 0) -> np.ndarray:
    """Apply the full impairment stack: multipath -> CFO -> phase noise -> AWGN."""
    rng = np.random.default_rng(seed)
    y = multipath(x, np.asarray(ch.multipath_taps, dtype=np.complex128))
    if ch.cfo != 0.0:
        y = cfo_shift(y, ch.cfo, n_sc)
    if ch.phase_noise_std > 0.0:
        y = phase_noise(y, ch.phase_noise_std, rng)
    # SNR is defined against the clean signal power so noise level does not
    # depend on the (unit-magnitude) phase impairments.
    y = awgn(y, ch.snr_db, rng, signal_power=float(np.mean(np.abs(x) ** 2)))
    return y


def make_capture(frames: np.ndarray, ch: ChannelSpec, n_sc: int,
                 gap: int = 0, seed: int = 0) -> np.ndarray:
    """Build a 'recorded IQ capture': concatenated frames with optional idle
    gaps and a leading timing offset, through the impairment stack.

    frames: [n_frames, frame_len] clean baseband TX frames.
    """
    n_frames, flen = frames.shape
    parts = [np.zeros(ch.timing_offset, dtype=np.complex128)]
    for i in range(n_frames):
        parts.append(frames[i])
        if gap:
            parts.append(np.zeros(gap, dtype=np.complex128))
    x = np.concatenate(parts)
    return apply_channel(x, ch, n_sc, seed=seed)
