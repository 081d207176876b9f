"""NumPy bit-layer helpers the host tables are derived from.

Copies of the table-building helpers of `ofdm_uhd_tpu/golden/bits.py`
(LFSR, pilot polarity, CRC-32, puncture mask, interleaver permutation);
tests/test_torch_tables.py holds every table built from them equal to the
reference's. All bit arrays are uint8 arrays of 0/1.
"""

from __future__ import annotations

import numpy as np

from ..core.spec import PUNCTURE

SCRAMBLER_SEED = 0x5D   # fixed non-zero 7-bit seed
PILOT_SEED = 0x7F       # seed for the per-symbol pilot-polarity sequence
CRC32_POLY = 0xEDB88320  # reflected IEEE 802.3 polynomial


def lfsr_sequence(n: int, seed: int = SCRAMBLER_SEED) -> np.ndarray:
    """x^7 + x^4 + 1 LFSR output sequence (the classic data whitener).

    Register holds bits x1..x7 (x7 = oldest). Each step outputs
    x4 XOR x7 and shifts it in at x1.
    """
    state = seed & 0x7F
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        fb = ((state >> 3) ^ (state >> 6)) & 1   # x4 xor x7
        out[i] = fb
        state = ((state << 1) | fb) & 0x7F
    return out


def pilot_polarity(n_syms: int) -> np.ndarray:
    """Per-OFDM-symbol pilot polarity (+1/-1), from the LFSR with its own seed."""
    return 1.0 - 2.0 * lfsr_sequence(n_syms, PILOT_SEED).astype(np.float64)


def _crc_step(crc: int) -> int:
    return (crc >> 1) ^ (CRC32_POLY if crc & 1 else 0)


def crc32_bits(bits: np.ndarray) -> np.ndarray:
    """CRC-32 over a bit array (LSB-first bitwise form); returns 32 bits."""
    crc = 0xFFFFFFFF
    for b in bits:
        crc = _crc_step(crc ^ int(b))
    crc ^= 0xFFFFFFFF
    return np.array([(crc >> i) & 1 for i in range(32)], dtype=np.uint8)


def crc32_matrix(n_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """crc32_bits over GF(2) as crc = M @ bits ^ c (mod 2): (M [32, n], c [32]).

    The register update is linear: feeding bit b_j XORs b_j into the
    register before step j, so its contribution to the final register is
    the step map applied n - j times to the unit register 1. Walking j
    from the end builds every column in O(n) register steps (the
    reference probes each unit vector through the whole CRC, O(n^2)); the
    result is the same matrix (asserted against the reference).
    """
    c = crc32_bits(np.zeros(n_bits, dtype=np.uint8))
    m = np.empty((32, n_bits), dtype=np.uint8)
    shifts = np.arange(32)
    v = _crc_step(1)                  # bit n-1: one step after injection
    for j in range(n_bits - 1, -1, -1):
        m[:, j] = (v >> shifts) & 1
        v = _crc_step(v)
    return m, c


def puncture_mask(rate: str, full_len: int) -> np.ndarray:
    """Boolean keep-mask over the encoder's interleaved (a,b) output."""
    pat, _, _ = PUNCTURE[rate]
    if full_len % len(pat):
        raise ValueError("coded length incompatible with rate")
    return np.tile(pat, full_len // len(pat)).astype(bool)


def interleave_perm(n_cbps: int) -> np.ndarray:
    """Block interleaver permutation over one OFDM symbol's coded bits:
    coded bit k goes to position (n_cbps/16)*(k mod 16) + k//16."""
    if n_cbps % 16:
        raise ValueError("coded bits per symbol must be divisible by 16")
    k = np.arange(n_cbps)
    return (n_cbps // 16) * (k % 16) + k // 16
