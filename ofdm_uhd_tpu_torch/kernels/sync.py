"""Schmidl-Cox sliding correlation and timing metric: the boxcar
correlator's hand kernel (K9) + the plain version.

For each lag d:

    P(d) = sum_{m=0}^{L-1} conj(r[d+m]) * r[d+m+L]
    R(d) = 0.5 * sum_{m=0}^{2L-1} |r[d+m]|^2

The plain version, `sc_correlate_plain`, is the counterpart of
ofdm_uhd_tpu/kernels/sync.py's XLA compose: its windowed sums use the same
PAIRWISE DOUBLING (S_2w[d] = S_w[d] + S_w[d+w]) in the same order as the
reference, not prefix-sum differences, so M agrees with the reference to
a few float32 ulps and the >= comparisons of detection (threshold,
plateau) fall the same way.

`sc_correlate` launches K9 on CUDA (csrc/scfront.cu `ofdm_sc_correlate`;
it replaces pallas_sync.py:sc_correlate_mxu, which the reference routes
under kernel_backend='pallas' where the fused front end does not apply).
K9 sums in the plain version's order with unfused float32 arithmetic; for
a power-of-two L the last doubling level is R = 0.5 * (S_L[d] + S_L[d+L]),
the reference kernel's own construction of R.
"""

from __future__ import annotations

import torch

from . import build, policy

MAX_L = 4096    # the block's shared memory holds 6 * (1024 + 2l) floats


def _moving_sum(x: torch.Tensor, win: int) -> torch.Tensor:
    """Valid-mode boxcar along the last axis: y[..., d] = sum_{m<win}
    x[..., d+m], length n - win + 1, by doubling over win's binary digits."""
    n = x.shape[-1]
    out_len = n - win + 1
    s = x.float()
    w = 1
    acc = None
    off = 0
    rem = win
    while rem:
        if rem & 1:
            part = s[..., off:off + out_len]
            acc = part if acc is None else acc + part
            off += w
        rem >>= 1
        if rem:
            s = s[..., : s.shape[-1] - w] + s[..., w:]
            w *= 2
    return acc


def sc_correlate_plain(r: torch.Tensor, l: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    prod = torch.conj(r[..., :-l]) * r[..., l:]
    p_re = _moving_sum(prod.real, l)
    p_im = _moving_sum(prod.imag, l)
    e = r.abs() ** 2
    rr = 0.5 * _moving_sum(e, 2 * l)
    return torch.complex(p_re, p_im), rr


def sc_rows(kernel: str, r: torch.Tensor, l: int
            ) -> tuple[torch.Tensor, int]:
    """Checks shared by the S&C kernels: r [..., n] complex64 as rows
    [B, n] for a power-of-two lag l with nd = n - 2l + 1 >= 1; (rows, nd)."""
    if r.dtype != torch.complex64 or r.dim() < 1:
        raise ValueError(f"{kernel}: need complex64 [..., n], got {r.dtype} "
                         f"{tuple(r.shape)}")
    if l < 1 or l > MAX_L or l & (l - 1):
        raise ValueError(f"{kernel}: the lag must be a power of two in "
                         f"[1, {MAX_L}], got {l}")
    n = r.shape[-1]
    nd = n - 2 * l + 1
    if nd < 1:
        raise ValueError(f"{kernel}: {n} samples hold no window of 2l = "
                         f"{2 * l}")
    flat = r.reshape(-1, n)
    build.check_inputs(kernel, flat)
    return flat, nd


def _sccorr_cuda(r: torch.Tensor, l: int, counter: str = "sccorr"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9's launch, counted under `counter` (research/shift.py's
    sc_correlate_shift counts it as 'shift_sc')."""
    flat, nd = sc_rows(counter, r, l)
    rows, n = flat.shape
    p = torch.empty((rows, nd), dtype=torch.complex64, device=r.device)
    rr = torch.empty((rows, nd), dtype=torch.float32, device=r.device)
    lib = build.library()
    err = lib.ofdm_sc_correlate(flat.data_ptr(), p.data_ptr(), rr.data_ptr(),
                                rows, n, l, build.stream_ptr(r.device))
    build.check(err, counter)
    policy.count_launch(counter)
    lead = r.shape[:-1]
    return p.reshape(lead + (nd,)), rr.reshape(lead + (nd,))


def sc_correlate(r: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """r [..., n] complex64 -> (P [..., nd] c64, R [..., nd] f32),
    nd = n - 2l + 1."""
    if policy.use_kernel(r):
        return _sccorr_cuda(r, l)
    return sc_correlate_plain(r, l)


def sc_metric(p: torch.Tensor, rr: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """M(d) = |P|^2 / R^2, zero where R ~ 0 (idle input)."""
    m = p.abs() ** 2 / rr.clamp_min(eps) ** 2
    return torch.where(rr > eps, m, torch.zeros_like(m))
