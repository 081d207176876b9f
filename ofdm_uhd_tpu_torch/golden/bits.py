"""Golden bit layer (float64 NumPy): scrambler, CRC-32, the K=7
convolutional code and its Viterbi decoder, puncturing, interleaver.

A copy of `ofdm_uhd_tpu/golden/bits.py`, the same operations in the same
order: the host tables are derived from its helpers (LFSR, pilot
polarity, CRC-32, puncture mask, interleaver permutation;
tests/test_torch_tables.py) and the port's golden chain (chain.py) runs
the rest. tests/test_torch_golden.py holds every function equal to the
reference's. All bit arrays are uint8 arrays of 0/1.
"""

from __future__ import annotations

import numpy as np

from ..core.spec import CONV_K, CONV_POLY_A, CONV_POLY_B, PUNCTURE

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


def scramble(bits: np.ndarray, seed: int = SCRAMBLER_SEED) -> np.ndarray:
    """XOR payload bits with the LFSR whitening sequence (involutive)."""
    return (bits ^ lfsr_sequence(len(bits), seed)).astype(np.uint8)


descramble = scramble  # XOR with the same sequence


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


def interleave(coded: np.ndarray, n_cbps: int) -> np.ndarray:
    """Apply per-symbol interleaving to a frame's coded bits [n_syms*n_cbps]."""
    perm = interleave_perm(n_cbps)
    blocks = coded.reshape(-1, n_cbps)
    out = np.empty_like(blocks)
    out[:, perm] = blocks
    return out.reshape(-1)


def deinterleave(bits: np.ndarray, n_cbps: int) -> np.ndarray:
    perm = interleave_perm(n_cbps)
    blocks = bits.reshape(-1, n_cbps)
    return blocks[:, perm].reshape(-1)


def deinterleave_soft(llr: np.ndarray, n_cbps: int) -> np.ndarray:
    """Same permutation applied to per-bit LLRs."""
    perm = interleave_perm(n_cbps)
    blocks = llr.reshape(-1, n_cbps)
    return blocks[:, perm].reshape(-1)


def puncture(coded: np.ndarray, rate: str) -> np.ndarray:
    """Drop the pattern's zero positions (rate 1/2 -> identity)."""
    if rate == "1/2":
        return coded
    return coded[puncture_mask(rate, len(coded))]


def depuncture_llr(llr: np.ndarray, rate: str, full_len: int) -> np.ndarray:
    """Re-insert zero LLRs (erasures) at the punctured positions."""
    if rate == "1/2":
        return llr
    out = np.zeros(full_len, dtype=llr.dtype)
    out[puncture_mask(rate, full_len)] = llr
    return out


def _parity(x: np.ndarray | int):
    """Bit-parity of integer(s) up to 7 bits."""
    x = np.asarray(x)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return (x & 1).astype(np.uint8)


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Rate-1/2 K=7 convolutional encoder, polys 0o133 / 0o171.

    Window w_t packs (b_t .. b_{t-6}) with the current bit at bit 6 (MSB):
    out_a = parity(w & 0o133), out_b = parity(w & 0o171). Output is
    interleaved [a0, b0, a1, b1, ...]. The caller appends TAIL_BITS zeros
    so the trellis terminates in state 0.
    """
    n = len(bits)
    padded = np.concatenate([np.zeros(CONV_K - 1, dtype=np.uint8),
                             bits.astype(np.uint8)])
    w = np.zeros(n, dtype=np.int32)
    for k in range(CONV_K):
        w |= padded[CONV_K - 1 - k: CONV_K - 1 - k + n].astype(
            np.int32) << (6 - k)
    out = np.empty(2 * n, dtype=np.uint8)
    out[0::2] = _parity(w & CONV_POLY_A)
    out[1::2] = _parity(w & CONV_POLY_B)
    return out


def _viterbi_tables():
    """Transition tables for the 64-state trellis.

    State s_t = (b_t, ..., b_{t-5}) with b_t at bit 5. For input b:
    w = (b << 6) | s_prev, next state = w >> 1, outputs from the polys.
    """
    s = np.arange(64, dtype=np.int32)
    tables = {}
    for b in (0, 1):
        w = (b << 6) | s
        tables[b] = {
            "next": w >> 1,
            "out_a": _parity(w & CONV_POLY_A).astype(np.int32),
            "out_b": _parity(w & CONV_POLY_B).astype(np.int32),
        }
    return tables


def viterbi_decode(llr: np.ndarray) -> np.ndarray:
    """Soft-input Viterbi decoder for the rate-1/2 K=7 code.

    `llr` [2*n]: log P(bit=0)/P(bit=1) per coded bit, interleaved (a, b).
    Returns n decoded input bits. The trellis starts and ends in state 0
    (tail-bit terminated): vectorized over the 64 states, a Python loop
    over time. Branch metric (maximize): 0.5 * (1 - 2 * out) * llr.
    """
    llr = np.asarray(llr, dtype=np.float64)
    if llr.ndim != 1 or len(llr) % 2:
        raise ValueError("llr must be one sequence of (a, b) pairs")
    n = len(llr) // 2
    la, lb = llr[0::2], llr[1::2]

    s = np.arange(64)
    # predecessors of state s': p0/p1 with shifted-out bit 0/1
    pred = np.stack([((s & 31) << 1) | 0, ((s & 31) << 1) | 1])  # [2, 64]
    # input bit that produced state s' is bit 5 of s'
    in_bit = (s >> 5).astype(np.uint8)                            # [64]
    # branch outputs for the transition pred[p, s'] --in_bit[s']--> s'
    w = (in_bit[None, :] << 6) | pred                             # [2, 64]
    br_a = _parity(w & CONV_POLY_A).astype(np.float64)
    br_b = _parity(w & CONV_POLY_B).astype(np.float64)

    neg = -1e30
    pm = np.full(64, neg)
    pm[0] = 0.0
    decisions = np.empty((n, 64), dtype=np.uint8)
    for t in range(n):
        bm = 0.5 * ((1.0 - 2.0 * br_a) * la[t] + (1.0 - 2.0 * br_b) * lb[t])
        cand = pm[pred] + bm                                       # [2, 64]
        choice = (cand[1] > cand[0]).astype(np.uint8)              # ties: 0
        decisions[t] = choice
        pm = np.where(choice, cand[1], cand[0])

    # traceback from state 0 (tail-terminated)
    bits = np.empty(n, dtype=np.uint8)
    state = 0
    for t in range(n - 1, -1, -1):
        bits[t] = (state >> 5) & 1
        state = ((state & 31) << 1) | decisions[t, state]
    return bits
