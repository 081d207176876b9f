"""NumPy symbol-domain helpers the host tables are derived from.

Copies of the table-building part of `ofdm_uhd_tpu/golden/modem.py`: the
Gray-coded axis LUTs, the QAM power normalisation and the preamble
symbols. tests/test_torch_tables.py holds every table built from them
equal to the reference's.
"""

from __future__ import annotations

import numpy as np

from ..core.spec import MOD_BITS, WaveformSpec
from .bits import lfsr_sequence

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
