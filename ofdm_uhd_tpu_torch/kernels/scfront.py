"""Schmidl-Cox front end in one pass: hand kernel + plain version.

Replaces ofdm_uhd_tpu/kernels/pallas_scfront.py:sc_frontend_pallas (CUDA
source: csrc/scfront.cu). sc_frontend(r, l) returns (P, M), the S&C
correlation and timing metric of kernels/sync.py, sc_metric(
*sc_correlate_plain(r, l)), without writing the lag product, the energy
or R to device memory.

The kernel keeps the plain version's pairwise-doubling summation order and
unfused float32 arithmetic, so M agrees with the plain version to a few
ulps and detection's >= comparisons fall the same way; the reference's TPU
kernel summed in another order (agreement ~1e-5). Any power-of-two l:
above sync.TILE_MAX_L the sums run by the split route (sync.route).
"""

from __future__ import annotations

import torch

from . import policy
from .sync import sc_correlate_plain, sc_kernels, sc_metric


def sc_frontend_plain(r: torch.Tensor, l: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    p, rr = sc_correlate_plain(r, l)
    return p, sc_metric(p, rr)


def _scfront_cuda(r: torch.Tensor, l: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """K6's launch (sync.route(l): the tile kernel, counted 'scfront', up
    to TILE_MAX_L; the split route's two passes above)."""
    return sc_kernels("scfront", r, l, metric=True)


def sc_frontend(r: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """r [..., n] complex64 -> (P [..., nd] complex64, M [..., nd] f32),
    nd = n - 2l + 1."""
    if policy.use_kernel(r):
        return _scfront_cuda(r, l)
    return sc_frontend_plain(r, l)
