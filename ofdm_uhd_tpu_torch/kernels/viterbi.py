"""K=7 rate-1/2 soft Viterbi decoder: hand kernel + plain version.

Replaces ofdm_uhd_tpu/kernels/pallas_viterbi.py:viterbi_pallas in
whole-sequence mode (CUDA source: csrc/viterbi.cu). Both versions are
bit-exact with the reference scan phy/bits.py:viterbi_decode: same
branch metrics without the 0.5 factor, same strict '>' (a tie keeps
predecessor 0), trellis pinned to state 0 at both ends. On the card the
kernel decodes every batch size; the reference's batch-regime routing
between scan, windowed and fused decoders was a TPU measurement.
"""

from __future__ import annotations

import numpy as np
import torch

from ..phy import tables as T
from . import build, policy


def _signs(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """+1/-1 code-bit signs of the p=0 branch into each state [64]; the p=1
    branch is their negation (both polys tap the oldest register bit)."""
    br_a = T.on_device(T.viterbi_tables, (), "br_a", device)
    br_b = T.on_device(T.viterbi_tables, (), "br_b", device)
    return (1.0 - 2.0 * br_a)[0], (1.0 - 2.0 * br_b)[0]


def viterbi_plain(llr: torch.Tensor) -> torch.Tensor:
    """llr [B, 2n] f32 (a/b interleaved, log P(0)/P(1)) -> bits [B, n] u8.

    The ACS loop of phy/bits.py:viterbi_decode over [B, 64] tensors, with
    each step's 64 decisions packed into one int64 word (bit s = state s;
    bit 63 rides the sign, which disjoint-bit sums and `>>` leave exact).
    """
    bsz, n2 = llr.shape
    n = n2 // 2
    dev = llr.device
    sa0, sb0 = _signs(dev)
    la = llr[:, 0::2].float()
    lb = llr[:, 1::2].float()
    states = torch.arange(64, device=dev)
    pred_even = (states & 31) << 1
    pred_odd = pred_even | 1
    weights = torch.from_numpy(
        (np.uint64(1) << np.arange(64, dtype=np.uint64)).view(np.int64)
    ).to(dev)
    pm = torch.full((bsz, 64), -1e30, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    packed = torch.empty((n, bsz), dtype=torch.int64, device=dev)
    for t in range(n):
        bm0 = sa0 * la[:, t, None] + sb0 * lb[:, t, None]      # [B, 64]
        c0 = pm[:, pred_even] + bm0
        c1 = pm[:, pred_odd] - bm0
        choice = c1 > c0                                      # tie -> pred 0
        pm = torch.where(choice, c1, c0)
        packed[t] = (choice * weights).sum(-1)
    bits = torch.empty((n, bsz), dtype=torch.uint8, device=dev)
    state = torch.zeros(bsz, dtype=torch.int64, device=dev)
    for t in range(n - 1, -1, -1):
        bits[t] = (state >> 5) & 1
        state = ((state & 31) << 1) | ((packed[t] >> state) & 1)
    return bits.T.contiguous()


def _viterbi_cuda(llr: torch.Tensor) -> torch.Tensor:
    if llr.dtype != torch.float32 or llr.dim() != 2 or llr.shape[1] % 2:
        raise ValueError(f"viterbi: need float32 [B, 2n], got "
                         f"{llr.dtype} {tuple(llr.shape)}")
    build.check_inputs("viterbi", llr)
    bsz, n = llr.shape[0], llr.shape[1] // 2
    lib = build.library()
    dec = torch.empty((bsz, n, 2), dtype=torch.int32, device=llr.device)
    bits = torch.empty((bsz, n), dtype=torch.uint8, device=llr.device)
    err = lib.ofdm_viterbi(llr.data_ptr(), dec.data_ptr(), bits.data_ptr(),
                           bsz, n, build.stream_ptr(llr.device))
    build.check(err, "viterbi")
    policy.count_launch("viterbi")
    return bits


def viterbi(llr: torch.Tensor) -> torch.Tensor:
    """llr [B, 2n] -> bits [B, n] uint8 (kernel on CUDA, plain on CPU)."""
    if policy.use_kernel(llr):
        return _viterbi_cuda(llr)
    return viterbi_plain(llr)
