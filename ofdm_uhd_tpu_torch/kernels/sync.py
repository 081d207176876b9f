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

Both S&C kernels (K9 here, K6 in scfront.py) take any power-of-two lag
up to MAX_L; `route(l)` gives their launches: one tile launch up to
TILE_MAX_L, the split route's two above it (`split_route`: a span pass
to S_W and a stride pass over the residue chains mod W; its plain
emulation `split_plain` holds the route's bookkeeping to the plain
version on the CPU).
"""

from __future__ import annotations

import torch

from . import build, policy

# the tile route's lags; above, the split route. The tile kernel takes up
# to TILE_KERNEL_MAX_L (csrc/scfront_tile.cuh kMaxLog2L), but its warm-up
# of 2l - 1 positions a segment grows with l: in-kernel on an NVIDIA H100
# (scripts/k6_ab.py, PERF.md) the split route was faster at l = 2048 and
# 4096 in every run, on big_nsc's captures (0.015-0.018 against 0.043 ms
# at 2048) and on rows of C4's length (0.090 against 0.143); at l = 1024
# it was faster on short rows (0.014 against 0.020) but slower on C4's
# (0.101 against 0.083), and at l = 512 no faster
TILE_MAX_L = 1024
TILE_KERNEL_MAX_L = 4096
# the split route's width W (split_width): l / SPLIT_D up to SPAN_W, then
# SPAN_W while the stride pass's D = l / W stays within STRIDE_MAX_D, then
# l / STRIDE_MAX_D up to SPAN_MAX_W (the span pass's rings in shared
# memory, csrc/scfront_split.cuh kMaxLog2W). scripts/k6_ab.py timed W =
# 128 .. 4096 at l = 1024 .. 16384: l / 8 up to 1024 was the fastest or
# within 10% of it at each lag and row length (PERF.md)
SPLIT_D = 8
SPAN_W = 1024
STRIDE_MAX_D = 64
SPAN_MAX_W = 16384
# the largest lag: n_sc / 2 at the FFT route's largest n (kernels/fft.py)
MAX_L = 1 << 23


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


def split_width(l: int) -> int:
    """The split route's width W for a power-of-two lag l (at least 1)."""
    return max(1, min(SPAN_MAX_W, max(min(l // SPLIT_D, SPAN_W),
                                      l // STRIDE_MAX_D)))


def route(l: int) -> list[tuple]:
    """The S&C kernels' launches for a lag l: [("tile",)] up to
    TILE_MAX_L; above, ("span", W) (the leaves and the levels below W: S_W
    of the lag product's planes and the energy) and ("stride", W) (the
    levels from W up on each residue chain mod W, and the epilogue)."""
    if l < 1 or l & (l - 1) or l > MAX_L:
        raise ValueError(f"the S&C lag must be a power of two up to {MAX_L}, "
                         f"got {l}")
    if l <= TILE_MAX_L:
        return [("tile",)]
    w = split_width(l)
    return [("span", w), ("stride", w)]


def sc_rows(kernel: str, r: torch.Tensor, l: int
            ) -> tuple[torch.Tensor, int]:
    """Checks shared by the S&C kernels: r [..., n] complex64 as rows
    [B, n] for a power-of-two lag l with nd = n - 2l + 1 >= 1; (rows, nd)."""
    if r.dtype != torch.complex64 or r.dim() < 1:
        raise ValueError(f"{kernel}: need complex64 [..., n], got {r.dtype} "
                         f"{tuple(r.shape)}")
    if l < 1 or l & (l - 1):
        raise ValueError(f"{kernel}: the lag must be a power of two, got {l}")
    n = r.shape[-1]
    nd = n - 2 * l + 1
    if nd < 1:
        raise ValueError(f"{kernel}: {n} samples hold no window of 2l = "
                         f"{2 * l}")
    flat = r.reshape(-1, n)
    build.check_inputs(kernel, flat)
    return flat, nd


def span_plain(flat: torch.Tensor, l: int, w: int) -> torch.Tensor:
    """The span pass of rows [B, n] at width w: [3, B, n] float32, S_w of
    the lag product's re and im over n - l - w + 1 and of |r|^2 over n - w
    + 1 (zeros past them), by the doubling's levels 1 .. w/2."""
    rows, n = flat.shape
    prod = torch.conj(flat[:, :-l]) * flat[:, l:]
    p = torch.stack((prod.real, prod.imag))
    e = flat.abs() ** 2
    s = 1
    while s < w:
        p = p[..., :-s] + p[..., s:]
        e = e[..., :-s] + e[..., s:]
        s *= 2
    out = flat.new_zeros((3, rows, n), dtype=torch.float32)
    out[:2, :, :p.shape[-1]] = p
    out[2, :, :e.shape[-1]] = e
    return out


def stride_plain(a: torch.Tensor, l: int, w: int, metric: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The stride pass on the span pass's set a [3, B, n] at width w: the
    levels above w on the residue chains y[t, rho] = S_w[rho + t w] (w' =
    1 .. D/2 for P, 1 .. D for the energy, D = l / w), then P [B, nd] and
    M (metric) or R = 0.5 S_2l."""
    _, rows, n = a.shape
    nd = n - 2 * l + 1
    d = l // w
    t = -(-n // w)
    y = torch.nn.functional.pad(a, (0, t * w - n)).reshape(3, rows, t, w)
    p, e = y[:2], y[2]
    s = 1
    while s < 2 * d:
        e = e[..., :-s, :] + e[..., s:, :]
        if s < d:
            p = p[..., :-s, :] + p[..., s:, :]
        s *= 2
    p = p.reshape(2, rows, -1)[..., :nd]
    pc = torch.complex(p[0], p[1])
    rr = 0.5 * e.reshape(rows, -1)[:, :nd]
    return pc, (sc_metric(pc, rr) if metric else rr)


def split_route(flat: torch.Tensor, l: int, metric: bool, span, stride,
                w: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The split route over rows [B, n] at width w (split_width(l) if
    None; any power of two w <= l), each pass by the given function (the
    kernels' or the plain versions above)."""
    w = split_width(l) if w is None else w
    return stride(span(flat, l, w), l, w, metric)


def split_plain(r: torch.Tensor, l: int, metric: bool, w: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The split route through the plain versions of its passes:
    sc_correlate_plain's function (metric=False) or sc_frontend's."""
    flat = r.reshape(-1, r.shape[-1])
    p, q = split_route(flat, l, metric, span_plain, stride_plain, w)
    return p.reshape(r.shape[:-1] + (-1,)), q.reshape(r.shape[:-1] + (-1,))


def _span_cuda(flat: torch.Tensor, l: int, w: int) -> torch.Tensor:
    rows, n = flat.shape
    a = torch.empty((3, rows, n), dtype=torch.float32, device=flat.device)
    err = build.library().ofdm_sc_span(flat.data_ptr(), a.data_ptr(), rows,
                                       n, l, w, build.stream_ptr(flat.device))
    build.check(err, "sc_span")
    policy.count_launch("sc_span")
    return a


def _stride_cuda(a: torch.Tensor, l: int, w: int, metric: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    _, rows, n = a.shape
    nd = n - 2 * l + 1
    p = torch.empty((rows, nd), dtype=torch.complex64, device=a.device)
    q = torch.empty((rows, nd), dtype=torch.float32, device=a.device)
    err = build.library().ofdm_sc_stride(a.data_ptr(), p.data_ptr(),
                                         q.data_ptr(), rows, n, l, w,
                                         int(metric),
                                         build.stream_ptr(a.device))
    build.check(err, "sc_stride")
    policy.count_launch("sc_stride")
    return p, q


def sc_kernels(kernel: str, r: torch.Tensor, l: int, metric: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The S&C kernels on r [..., n]: (P, M) (metric, K6) or (P, R) (K9),
    [..., nd], by route(l). The tile launch is counted under `kernel`,
    the split route's under sc_span and sc_stride."""
    flat, nd = sc_rows(kernel, r, l)
    if route(l)[0][0] == "tile":
        p, q = _tile_cuda(kernel, flat, nd, l, metric)
    else:
        p, q = split_route(flat, l, metric, _span_cuda, _stride_cuda)
    lead = r.shape[:-1]
    return p.reshape(lead + (nd,)), q.reshape(lead + (nd,))


def _tile_cuda(kernel: str, flat: torch.Tensor, nd: int, l: int,
               metric: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the tile kernel (ofdm_scfront for the metric, else
    ofdm_sc_correlate), counted under `kernel`."""
    rows, n = flat.shape
    p = torch.empty((rows, nd), dtype=torch.complex64, device=flat.device)
    q = torch.empty((rows, nd), dtype=torch.float32, device=flat.device)
    lib = build.library()
    entry = lib.ofdm_scfront if metric else lib.ofdm_sc_correlate
    err = entry(flat.data_ptr(), p.data_ptr(), q.data_ptr(), rows, n, l,
                build.stream_ptr(flat.device))
    build.check(err, kernel)
    policy.count_launch(kernel)
    return p, q


def _sccorr_cuda(r: torch.Tensor, l: int, counter: str = "sccorr"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K9's launch, counted under `counter` (research/shift.py's
    sc_correlate_shift counts it as 'shift_sc')."""
    return sc_kernels(counter, r, l, metric=False)


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
