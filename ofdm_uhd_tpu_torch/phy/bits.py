"""Bit layer: scramble, CRC-32, convolutional FEC, Viterbi, interleaver.

The counterpart of ofdm_uhd_tpu/phy/bits.py on [B, n] tensors, bit-exact
with it. The Viterbi decoder is kernels/viterbi.py (hand kernel on CUDA,
its plain version on the CPU). The TPU workarounds of the reference
(one-hot matmuls for gathers and the depuncture scatter) are plain index
operations here; the CRC stays a float32 matmul (exact: TF32 is off and
every sum is far below 2^24).
"""

from __future__ import annotations

import torch

from ..core.spec import CONV_K
from ..kernels.viterbi import viterbi as viterbi_decode  # noqa: F401
from . import tables as T


def scramble(bits: torch.Tensor, seed: int | None = None) -> torch.Tensor:
    """XOR with the whitening LFSR sequence; bits [..., n] uint8."""
    n = bits.shape[-1]
    args = (n,) if seed is None else (n, seed)
    seq = T.on_device(T.scramble_seq, args, None, bits.device)
    return torch.bitwise_xor(bits.to(torch.uint8), seq)


descramble = scramble


def crc32(bits: torch.Tensor) -> torch.Tensor:
    """CRC-32 over [..., n] bits -> [..., 32] bits: (M @ bits + c) mod 2."""
    n = bits.shape[-1]
    m = T.on_device(T.crc_matrix, (n,), 0, bits.device)       # [32, n] u8
    c = T.on_device(T.crc_matrix, (n,), 1, bits.device)
    acc = bits.float() @ m.T.float() + c.float()
    return (acc.to(torch.int32) & 1).to(torch.uint8)


def crc32_check(payload: torch.Tensor, crc_rx: torch.Tensor) -> torch.Tensor:
    """[..., n] payload + [..., 32] received crc -> [...] bool."""
    return torch.all(crc32(payload) == crc_rx.to(torch.uint8), dim=-1)


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """Rate-1/2 K=7 encoder on [..., n] -> [..., 2n], interleaved (a, b)."""
    n = bits.shape[-1]
    lut_a = T.on_device(T.conv_output_luts, (), 0, bits.device)
    lut_b = T.on_device(T.conv_output_luts, (), 1, bits.device)
    b = bits.long()
    padded = torch.nn.functional.pad(b, (CONV_K - 1, 0))      # [..., n+6]
    w = torch.zeros_like(b)
    for k in range(CONV_K):
        w = w | (padded[..., CONV_K - 1 - k: CONV_K - 1 - k + n] << (6 - k))
    return torch.stack([lut_a[w], lut_b[w]], dim=-1).reshape(
        bits.shape[:-1] + (2 * n,))


def interleave(coded: torch.Tensor, n_cbps: int) -> torch.Tensor:
    """Per-symbol block interleave on [..., n_syms*n_cbps]: the row-column
    permutation perm[k] = (n_cbps/16)*(k%16) + k//16 as a transpose."""
    n16 = n_cbps // 16
    blocks = coded.reshape(coded.shape[:-1] + (-1, n16, 16))
    return blocks.transpose(-1, -2).reshape(coded.shape)


def deinterleave(bits: torch.Tensor, n_cbps: int) -> torch.Tensor:
    """Inverse of interleave: the opposite transpose."""
    n16 = n_cbps // 16
    blocks = bits.reshape(bits.shape[:-1] + (-1, 16, n16))
    return blocks.transpose(-1, -2).reshape(bits.shape)


deinterleave_soft = deinterleave


def puncture(coded: torch.Tensor, rate: str) -> torch.Tensor:
    """Drop punctured positions on [..., full]."""
    if rate == "1/2":
        return coded
    kept = T.on_device(T.puncture_kept, (rate, coded.shape[-1]), None,
                       coded.device)
    return coded.index_select(-1, kept.long())


def depuncture_llr(llr: torch.Tensor, rate: str, full_len: int
                   ) -> torch.Tensor:
    """Re-insert zero LLRs at punctured positions."""
    if rate == "1/2":
        return llr
    kept = T.on_device(T.puncture_kept, (rate, full_len), None, llr.device)
    out = llr.new_zeros(llr.shape[:-1] + (full_len,), dtype=torch.float32)
    out[..., kept.long()] = llr.float()
    return out
