"""QAM mapper/demapper (hard + max-log LLR), Gray-coded, unit power.

The counterpart of ofdm_uhd_tpu/phy/qam.py. The mapper keeps the
reference's arithmetic Gray amplitude (same float32 operations, so the
same symbols bit for bit); the LLR demapper keeps its per-axis squared
distances and takes each bit's minimum over the levels of that bit by
index, which gives the same minima as the reference's masked reductions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.spec import MOD_BITS
from . import tables as T


def _gray_amplitude(bits_axis: torch.Tensor, nb: int) -> torch.Tensor:
    """Gray-coded axis amplitude from [..., nb] bits (MSB first):
    a = s_0 * acc, acc = 2^(nb-i) - s_i * acc (i = nb-1 .. 1, acc0 = 1)."""
    s = 2.0 * bits_axis.float() - 1.0
    acc = torch.ones((), dtype=torch.float32, device=s.device)
    for i in range(nb - 1, 0, -1):
        acc = float(1 << (nb - i)) - s[..., i] * acc
    return s[..., 0] * acc


def qam_map(bits: torch.Tensor, mod: str) -> torch.Tensor:
    """bits [..., n*bits_per_qam] -> complex64 symbols [..., n]."""
    t = T.qam_tables(mod)
    nb = int(t["nb"])
    scale = T.f32_scalar(float(np.float32(np.max(np.abs(t["axis_lut"]))
                                          / ((1 << nb) - 1))), bits.device)
    b = bits.reshape(bits.shape[:-1] + (-1, MOD_BITS[mod]))
    re = _gray_amplitude(b[..., :nb], nb) * scale
    if mod == "bpsk":
        return torch.complex(re, torch.zeros_like(re))
    im = _gray_amplitude(b[..., nb:], nb) * scale
    return torch.complex(re, im)


@functools.lru_cache(maxsize=8)
def _levels(mod: str) -> tuple[np.ndarray, np.ndarray]:
    """Per axis bit i, the levels whose bit i is 0 and 1 -> ([nb, L/2],
    [nb, L/2]) level indices (Gray-coded PAM: half the levels each)."""
    bol = T.qam_tables(mod)["bit_of_level"]                   # [L, nb]
    return tuple(np.stack([np.nonzero(bol[:, i] == v)[0]
                           for i in range(bol.shape[1])]) for v in (0, 1))


def _axis_llr(x: torch.Tensor, lut: torch.Tensor, lv0: torch.Tensor,
              lv1: torch.Tensor) -> torch.Tensor:
    """x [...] real -> [..., nb] max-log LLRs for one I/Q axis."""
    d2 = (x[..., None] - lut) ** 2                            # [..., L]
    return d2[..., lv1].amin(-1) - d2[..., lv0].amin(-1)


def qam_demap_llr(syms: torch.Tensor, mod: str,
                  csi: torch.Tensor | None = None) -> torch.Tensor:
    """symbols [..., n] -> LLRs [..., n*bits_per_qam], llr > 0 favours 0.

    `csi` [..., n] scales per-symbol reliability (|H|^2 after one-tap EQ).
    """
    dev = syms.device
    lut = T.on_device(T.qam_tables, (mod,), "axis_lut", dev)
    lv0 = T.on_device(_levels, (mod,), 0, dev)
    lv1 = T.on_device(_levels, (mod,), 1, dev)
    i_llr = _axis_llr(syms.real.float(), lut, lv0, lv1)
    if mod == "bpsk":
        out = i_llr
    else:
        q_llr = _axis_llr(syms.imag.float(), lut, lv0, lv1)
        out = torch.cat([i_llr, q_llr], dim=-1)               # [..., n, bpq]
    if csi is not None:
        out = out * csi[..., None].float()
    return out.reshape(syms.shape[:-1] + (-1,))


def qam_demap_hard(syms: torch.Tensor, mod: str) -> torch.Tensor:
    """Nearest-point hard decisions -> bits [..., n*bits_per_qam] uint8."""
    nb = int(T.qam_tables(mod)["nb"])
    lut = T.on_device(T.qam_tables, (mod,), "axis_lut", syms.device)
    shifts = torch.arange(nb - 1, -1, -1, device=syms.device)

    def axis_bits(x):
        idx = torch.argmin((x[..., None] - lut).abs(), dim=-1)
        return ((idx[..., None] >> shifts) & 1).to(torch.uint8)

    i_bits = axis_bits(syms.real)
    if mod == "bpsk":
        out = i_bits
    else:
        out = torch.cat([i_bits, axis_bits(syms.imag)], dim=-1)
    return out.reshape(syms.shape[:-1] + (-1,))
