"""Golden symbol-domain DSP (float64 NumPy): QAM, pilots and preamble,
OFDM modulate / demodulate, channel estimation, one-tap EQ, common-phase
tracking.

A copy of `ofdm_uhd_tpu/golden/modem.py`, the same operations in the same
order: the host tables are derived from its LUTs, QAM normalisation and
preamble symbols (tests/test_torch_tables.py), and the port's golden
chain (chain.py) runs the rest. tests/test_torch_golden.py holds every
function equal to the reference's.
"""

from __future__ import annotations

import numpy as np

from ..core.spec import MOD_BITS, WaveformSpec
from .bits import lfsr_sequence, pilot_polarity

# Per-axis Gray-coded amplitude LUTs, indexed by the integer formed from the
# axis bits (MSB first). Adjacent amplitudes differ in exactly one bit.
# Generated by the nested recurrence the arithmetic mapper uses
# (phy/qam.py _gray_amplitude):
#   a = s_0 * acc,  acc_i = 2^(nb-i) - s_i * acc  (i = nb-1 .. 1, acc = 1)


def _make_axis_lut(nb: int) -> np.ndarray:
    out = np.empty(1 << nb)
    for idx in range(1 << nb):
        s = [2 * ((idx >> (nb - 1 - k)) & 1) - 1 for k in range(nb)]
        acc = 1.0
        for i in range(nb - 1, 0, -1):
            acc = float(1 << (nb - i)) - s[i] * acc
        out[idx] = s[0] * acc
    return out


_AXIS_LUT = {nb: _make_axis_lut(nb) for nb in (1, 2, 3, 4)}


def _axis_bits(mod: str) -> int:
    return max(MOD_BITS[mod] // 2, 1)


def qam_scale(mod: str) -> float:
    """Normalization so constellation has unit average power."""
    lut = _AXIS_LUT[_axis_bits(mod)]
    axes = 1 if mod == "bpsk" else 2
    return 1.0 / np.sqrt(axes * np.mean(lut**2))


def qam_map(bits: np.ndarray, mod: str) -> np.ndarray:
    """bits [n*bits_per_qam] -> complex symbols [n], Gray-coded, unit power.

    Bit order per symbol: the first half of the bits select the I
    amplitude (MSB first), the second half the Q amplitude. BPSK uses I
    only.
    """
    bpq = MOD_BITS[mod]
    nb = _axis_bits(mod)
    lut = _AXIS_LUT[nb] * qam_scale(mod)
    b = bits.reshape(-1, bpq).astype(np.int64)
    weights = 1 << np.arange(nb - 1, -1, -1)
    i_idx = b[:, :nb] @ weights
    if mod == "bpsk":
        return lut[i_idx].astype(np.complex128)
    q_idx = b[:, nb:] @ weights
    return lut[i_idx] + 1j * lut[q_idx]


def qam_demap_hard(syms: np.ndarray, mod: str) -> np.ndarray:
    """Nearest-point hard decisions -> bits [n*bits_per_qam]."""
    nb = _axis_bits(mod)
    lut = _AXIS_LUT[nb] * qam_scale(mod)

    def axis_bits_of(x):
        idx = np.argmin(np.abs(x[:, None] - lut[None, :]), axis=1)
        return ((idx[:, None] >> np.arange(nb - 1, -1, -1)) & 1
                ).astype(np.uint8)
    i_bits = axis_bits_of(np.real(syms).ravel())
    if mod == "bpsk":
        return i_bits.reshape(-1)
    q_bits = axis_bits_of(np.imag(syms).ravel())
    return np.concatenate([i_bits, q_bits], axis=1).reshape(-1)


def qam_demap_llr(syms: np.ndarray, mod: str,
                  csi: np.ndarray | None = None) -> np.ndarray:
    """Max-log LLRs, llr = log P(b=0)/P(b=1) (positive favours 0).

    Separable per axis for Gray square QAM: for each axis bit,
    llr = min_{levels: bit=1} (x-l)^2 - min_{levels: bit=0} (x-l)^2.
    `csi` (e.g. |H|^2 after one-tap EQ) scales per-symbol reliability.
    Output ordering matches qam_map (I bits then Q bits per symbol).
    """
    nb = _axis_bits(mod)
    lut = _AXIS_LUT[nb] * qam_scale(mod)
    bit_of_level = ((np.arange(len(lut))[:, None]
                     >> np.arange(nb - 1, -1, -1)) & 1)           # [L, nb]

    def axis_llr(x):  # x: [n]
        d2 = (x[:, None] - lut[None, :]) ** 2                    # [n, L]
        llrs = np.empty((len(x), nb))
        for i in range(nb):
            m0 = np.min(np.where(bit_of_level[None, :, i] == 0, d2, np.inf),
                        axis=1)
            m1 = np.min(np.where(bit_of_level[None, :, i] == 1, d2, np.inf),
                        axis=1)
            llrs[:, i] = m1 - m0
        return llrs

    flat = syms.ravel()
    i_llr = axis_llr(np.real(flat))
    if mod == "bpsk":
        out = i_llr
    else:
        q_llr = axis_llr(np.imag(flat))
        out = np.concatenate([i_llr, q_llr], axis=1)
    if csi is not None:
        out = out * csi.ravel()[:, None]
    return out.reshape(-1)


PREAMBLE_SEED_A = 0x2B
PREAMBLE_SEED_B = 0x4E


def _pn_qpsk(n: int, seed: int) -> np.ndarray:
    """Deterministic unit-power QPSK PN sequence from the LFSR."""
    bits = lfsr_sequence(2 * n, seed).astype(np.float64)
    return ((1 - 2 * bits[0::2]) + 1j * (1 - 2 * bits[1::2])) / np.sqrt(2.0)


def preamble_freq(spec: WaveformSpec) -> tuple[np.ndarray, np.ndarray]:
    """Frequency-domain preamble symbols (full n_sc grids, FFT bin order).

    Sym A (Schmidl-Cox): PN on occupied bins with EVEN FFT index only,
    scaled by sqrt(2), so its time signal has two identical halves of
    length n_sc/2. Sym B: PN on all occupied bins, the known symbol for LS
    channel estimation and integer-CFO resolution.
    """
    occ = spec.occupied_bins
    pn_a = _pn_qpsk(len(occ), PREAMBLE_SEED_A)
    pn_b = _pn_qpsk(len(occ), PREAMBLE_SEED_B)
    sym_a = np.zeros(spec.n_sc, dtype=np.complex128)
    even = occ % 2 == 0
    sym_a[occ[even]] = pn_a[even] * np.sqrt(2.0)
    sym_b = np.zeros(spec.n_sc, dtype=np.complex128)
    sym_b[occ] = pn_b
    return sym_a, sym_b


def build_grid(spec: WaveformSpec, data_syms: np.ndarray) -> np.ndarray:
    """Assemble the frequency-domain frame grid [n_syms, n_sc].

    data_syms: [n_data_syms, n_data_sc] complex QAM symbols.
    Pilots carry +1 scaled by a per-symbol LFSR polarity; guards/DC are zero.
    """
    grid = np.zeros((spec.n_syms, spec.n_sc), dtype=np.complex128)
    grid[0], grid[1] = preamble_freq(spec)
    pol = pilot_polarity(spec.n_data_syms)
    grid[2:, spec.pilot_bins] = pol[:, None]
    grid[2:, spec.data_bins] = data_syms
    return grid


def ofdm_modulate(spec: WaveformSpec, grid: np.ndarray) -> np.ndarray:
    """IFFT (ortho) + cyclic prefix -> time-domain frame [frame_len].

    With spec.tx_window = W > 0: windowed OFDM, each symbol with a
    raised-cosine rise over the first W CP samples and a W-sample cyclic
    suffix (body head, RC fall) overlap-added onto the next symbol's CP
    rise; the RX FFT window [cp-shift, cp-shift+N) is untouched as long
    as W + shift <= cp.
    """
    x = np.fft.ifft(grid, norm="ortho", axis=-1)
    with_cp = np.concatenate([x[:, -spec.cp:], x], axis=-1)
    w = spec.tx_window
    if w <= 0:
        return with_cp.reshape(-1)
    if 2 * w > spec.cp:
        raise ValueError("tx_window must be <= cp/2")
    ramp = 0.5 * (1 - np.cos(np.pi * (np.arange(w) + 0.5) / w))
    out = np.zeros(spec.frame_len + w, dtype=np.complex128)
    for s in range(spec.n_syms):
        t0 = s * spec.sym_len
        sym = with_cp[s].copy()
        sym[:w] *= ramp
        out[t0: t0 + spec.sym_len] += sym
        out[t0 + spec.sym_len: t0 + spec.sym_len + w] += x[s, :w] * ramp[::-1]
    return out[: spec.frame_len]


def ofdm_demodulate(spec: WaveformSpec, samples: np.ndarray,
                    shift: int = 0) -> np.ndarray:
    """CP strip + FFT -> grid [n_syms, n_sc].

    `shift` advances the FFT window `shift` samples into the CP (timing
    margin against multipath or late sync); the induced linear phase is
    the same on preamble and data symbols, so the one-tap EQ absorbs it.
    """
    syms = samples[: spec.frame_len].reshape(spec.n_syms, spec.sym_len)
    start = spec.cp - shift
    windows = syms[:, start: start + spec.n_sc]
    return np.fft.fft(windows, norm="ortho", axis=-1)


def smooth_occ(h: np.ndarray, width: int) -> np.ndarray:
    """Edge-renormalized moving average over the occupied-bin axis (odd
    width; 0 or 1 disables): trades a little bias for a ~width-fold noise
    reduction of the per-bin LS estimates."""
    if width <= 1:
        return h
    k = np.ones(width)
    num = np.convolve(h, k, mode="same")
    den = np.convolve(np.ones(len(h)), k, mode="same")
    return num / den


def estimate_channel(spec: WaveformSpec, grid_rx: np.ndarray) -> np.ndarray:
    """LS channel estimate on the occupied bins from preamble sym B,
    H = Y * conj(X) / |X|^2, smoothed across bins by spec.chanest_smooth.
    Returns H over the occupied bins [n_occupied]."""
    _, sym_b = preamble_freq(spec)
    occ = spec.occupied_bins
    x = sym_b[occ]
    h = grid_rx[1, occ] * np.conj(x) / (np.abs(x) ** 2)
    return smooth_occ(h, spec.chanest_smooth)


def estimate_noise(spec: WaveformSpec, grid_rx: np.ndarray) -> float:
    """Noise variance per bin from the guard (noise-only) bins, all symbols."""
    g = grid_rx[:, spec.guard_bins]
    return float(np.mean(np.abs(g) ** 2))


def equalize(spec: WaveformSpec, grid_rx: np.ndarray, h_occ: np.ndarray,
             eps: float = 1e-12) -> np.ndarray:
    """One-tap EQ on the occupied bins of the data symbols.

    spec.eq_mode 'zf': X = Y conj(H)/|H|^2; 'mmse': X = Y conj(H)/(|H|^2+s2)
    with s2 estimated from the guard bins. Returns the equalized
    occupied-bin symbols [n_data_syms, n_occupied].
    """
    occ = spec.occupied_bins
    y = grid_rx[2:, occ]
    reg = eps
    if spec.eq_mode == "mmse":
        reg = estimate_noise(spec, grid_rx) + eps
    return y * np.conj(h_occ) / (np.abs(h_occ) ** 2 + reg)


def track_phase(spec: WaveformSpec, eq_occ: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """Pilot-based per-symbol phase tracking.

    Always a common-phase-error (CPE) rotation; with spec.sfo_track also a
    phase slope across frequency per symbol, from adjacent-pilot phase
    differences (complex-domain, unwrap-free):

        b = angle(sum_p  pil_p * conj(pil_{p-1})) / pilot_spacing
        cpe = angle(sum_p pil_p * conj(expected_p) * e^{-j b k_p})

    Returns (data symbols [n_data_syms, n_data_sc], cpe [n_data_syms]).
    """
    pol = pilot_polarity(spec.n_data_syms)
    pilots = eq_occ[:, spec.pilot_positions] * np.conj(pol[:, None])
    k_pil = spec.pilot_positions.astype(np.float64)
    if spec.sfo_track and spec.n_pilots >= 2:
        diffs = pilots[:, 1:] * np.conj(pilots[:, :-1])
        dk = np.diff(k_pil)
        slope = np.angle(np.sum(diffs, axis=1)) / np.mean(dk)
    else:
        slope = np.zeros(spec.n_data_syms)
    derot = np.exp(-1j * slope[:, None] * k_pil[None, :])
    cpe = np.angle(np.sum(pilots * derot, axis=1))
    k_data = spec.data_positions.astype(np.float64)
    corr = np.exp(-1j * (cpe[:, None] + slope[:, None] * k_data[None, :]))
    data = eq_occ[:, spec.data_positions] * corr
    return data, cpe


def evm_db(measured: np.ndarray, ideal: np.ndarray) -> float:
    """Error vector magnitude in dB relative to ideal constellation power."""
    err = np.mean(np.abs(measured - ideal) ** 2)
    ref = np.mean(np.abs(ideal) ** 2)
    return 10.0 * np.log10(err / ref + 1e-300)
