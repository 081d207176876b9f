"""Schmidl-Cox front end in one pass: hand kernel + plain version.

Replaces ofdm_uhd_tpu/kernels/pallas_scfront.py:sc_frontend_pallas (CUDA
source: csrc/scfront.cu). sc_frontend(r, l) returns (P, M), the S&C
correlation and timing metric of kernels/sync.py, sc_metric(
*sc_correlate_plain(r, l)), without writing the lag product, the energy
or R to device memory.

The kernel keeps the plain version's pairwise-doubling summation order and
unfused float32 arithmetic, so M agrees with the plain version to a few
ulps and detection's >= comparisons fall the same way; the reference's TPU
kernel summed in another order (agreement ~1e-5).
"""

from __future__ import annotations

import torch

from . import build, policy
from .sync import sc_correlate_plain, sc_metric, sc_rows


def sc_frontend_plain(r: torch.Tensor, l: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    p, rr = sc_correlate_plain(r, l)
    return p, sc_metric(p, rr)


def _scfront_cuda(r: torch.Tensor, l: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    flat, nd = sc_rows("scfront", r, l)
    rows, n = flat.shape
    p = torch.empty((rows, nd), dtype=torch.complex64, device=r.device)
    m = torch.empty((rows, nd), dtype=torch.float32, device=r.device)
    lib = build.library()
    err = lib.ofdm_scfront(flat.data_ptr(), p.data_ptr(), m.data_ptr(), rows,
                           n, l, build.stream_ptr(r.device))
    build.check(err, "scfront")
    policy.count_launch("scfront")
    lead = r.shape[:-1]
    return p.reshape(lead + (nd,)), m.reshape(lead + (nd,))


def sc_frontend(r: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """r [..., n] complex64 -> (P [..., nd] complex64, M [..., nd] f32),
    nd = n - 2l + 1."""
    if policy.use_kernel(r):
        return _scfront_cuda(r, l)
    return sc_frontend_plain(r, l)
