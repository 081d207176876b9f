"""The counterpart of ofdm_uhd_tpu/research/viterbi_variants.py: the
reference's three restructurings of its whole-sequence Viterbi decode
(phy/bits.py viterbi_decode), which it keeps as the measured A/B record of
its probe scripts/r5_probe_vit.py and which no path routes:

  viterbi_decode_smaj         path metrics held state-major, [64, B]
  viterbi_decode_radix4       two ACS stages a loop body, the traceback
                              two steps at a time
  viterbi_decode_smaj_radix4  both

Each is a bit-exact twin of viterbi_decode, and so of kernels/viterbi.py
viterbi_plain, which is the port's viterbi_decode: the same float
operations in the same order and the same strict c1 > c0. The layouts are
the reference's answer to the TPU's sublane and lane moves; in eager
PyTorch the state-major form only transposes the metrics and a radix-4
body is two calls of the same step, so each variant here is
viterbi_plain itself. On the card K4 (csrc/viterbi_group.cuh) holds both
ideas: a lane group runs log2(64 / G) trellis steps between exchanges
(radix-4 at G = 16) and spreads the states over its lanes. The
reference's `unroll` argument sets how far XLA unrolls its scan; the
functions here take the LLRs alone.

llr [B, 2n] or [2n] (a/b interleaved, log P(0)/P(1), cast to float32) ->
bits [B, n] or [n] uint8, the start pinned to state 0 and the traceback
from state 0 after the last step. For an odd n the two radix-4 forms decode
with kernels/viterbi.py viterbi (K4 on a CUDA tensor, viterbi_plain on the
CPU), as the reference falls back to viterbi_decode.
"""

from __future__ import annotations

import torch

from ..kernels import viterbi as KV


def _decode(llr: torch.Tensor, radix4: bool) -> torch.Tensor:
    squeeze = llr.dim() == 1
    rows = (llr[None] if squeeze else llr).float().contiguous()
    odd = (rows.shape[1] // 2) % 2
    bits = (KV.viterbi if radix4 and odd else KV.viterbi_plain)(rows)
    return bits[0] if squeeze else bits


def viterbi_decode_smaj(llr: torch.Tensor) -> torch.Tensor:
    """The state-major form: viterbi_plain's bits."""
    return _decode(llr, radix4=False)


def viterbi_decode_radix4(llr: torch.Tensor) -> torch.Tensor:
    """The radix-4 form: viterbi_plain's bits; odd n: the whole-sequence
    decoder."""
    return _decode(llr, radix4=True)


def viterbi_decode_smaj_radix4(llr: torch.Tensor) -> torch.Tensor:
    """State-major and radix-4 together: viterbi_plain's bits; odd n: the
    whole-sequence decoder."""
    return _decode(llr, radix4=True)
