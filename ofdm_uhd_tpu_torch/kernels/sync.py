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

Both S&C kernels (K9 here, K6 in scfront.py) take any power-of-two lag;
`route(l)` gives their launches: one tile launch up to TILE_MAX_L, the
levels route through device memory above it (`levels_route`; its plain
emulation `levels_plain` holds the route's bookkeeping to the plain
version on the CPU).
"""

from __future__ import annotations

import torch

from . import build, policy

# the tile kernel's lags: a block stages 4 (1024 + l) + 2 (1024 + 2l)
# floats in shared memory, which must stay within 227 KB
# (csrc/scfront.cu kMaxTileL)
TILE_MAX_L = 4096


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


def route(l: int) -> list[tuple]:
    """The S&C kernels' launches for a lag l: [("tile",)] up to
    TILE_MAX_L; above, ("leaves",) (the lag product's planes and the
    energy), one ("level", w) per doubling width w = 1, 2, .., l/2 (all
    three planes), and ("out",) (the energy's last level and the
    epilogue)."""
    if l < 1 or l & (l - 1):
        raise ValueError(f"the S&C lag must be a power of two, got {l}")
    if l <= TILE_MAX_L:
        return [("tile",)]
    return levels_plan(l)


def levels_plan(l: int) -> list[tuple]:
    """The levels route's launches for a power-of-two lag l (route(l)
    above TILE_MAX_L; any l for the plain emulation and the tests)."""
    return ([("leaves",)] + [("level", 1 << k)
                             for k in range(l.bit_length() - 1)]
            + [("out",)])


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


def leaves_plain(flat: torch.Tensor, l: int) -> torch.Tensor:
    """The levels route's first planes of rows [B, n]: [3, B, n] float32,
    the lag product's re and im over n - l (zeros past it) and |r|^2."""
    rows, n = flat.shape
    out = flat.new_zeros((3, rows, n), dtype=torch.float32)
    prod = torch.conj(flat[:, :-l]) * flat[:, l:]
    out[0, :, :n - l] = prod.real
    out[1, :, :n - l] = prod.imag
    out[2] = flat.abs() ** 2
    return out


def level_plain(a: torch.Tensor, w: int, len_p: int, len_e: int
                ) -> torch.Tensor:
    """One doubling level of the planes a [3, B, n]: the sums S_2w[j] =
    S_w[j] + S_w[j + w] for j < len_p (P's planes) and j < len_e (the
    energy), in a new set (zeros past them)."""
    b = torch.zeros_like(a)
    b[:2, :, :len_p] = a[:2, :, :len_p] + a[:2, :, w:w + len_p]
    b[2, :, :len_e] = a[2, :, :len_e] + a[2, :, w:w + len_e]
    return b


def out_plain(a: torch.Tensor, l: int, nd: int, metric: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """P [B, nd] and M or R from the planes after log2 l levels: R = 0.5
    (S_l[i] + S_l[i + l]), the energy's last level."""
    p = torch.complex(a[0, :, :nd], a[1, :, :nd])
    rr = 0.5 * (a[2, :, :nd] + a[2, :, l:l + nd])
    return p, (sc_metric(p, rr) if metric else rr)


def levels_route(flat: torch.Tensor, l: int, metric: bool, leaves, level,
                 out) -> tuple[torch.Tensor, torch.Tensor]:
    """levels_plan(l) over rows [B, n], each step by the given functions
    (the kernels' or the plain versions above)."""
    n = flat.shape[1]
    nd = n - 2 * l + 1
    a = leaves(flat, l)
    len_p, len_e = n - l, n
    for step in levels_plan(l):
        if step[0] == "level":
            w = step[1]
            len_p, len_e = len_p - w, len_e - w
            a = level(a, w, len_p, len_e)
    return out(a, l, nd, metric)


def levels_plain(r: torch.Tensor, l: int, metric: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The levels route through the plain versions of its steps:
    sc_correlate_plain's function (metric=False) or sc_frontend's."""
    flat = r.reshape(-1, r.shape[-1])
    p, q = levels_route(flat, l, metric, leaves_plain, level_plain,
                        out_plain)
    return p.reshape(r.shape[:-1] + (-1,)), q.reshape(r.shape[:-1] + (-1,))


def _leaves_cuda(flat: torch.Tensor, l: int) -> torch.Tensor:
    rows, n = flat.shape
    a = torch.empty((3, rows, n), dtype=torch.float32, device=flat.device)
    err = build.library().ofdm_sc_leaves(flat.data_ptr(), a.data_ptr(), rows,
                                         n, l, build.stream_ptr(flat.device))
    build.check(err, "sc_leaves")
    policy.count_launch("sc_leaves")
    return a


def _level_cuda(a: torch.Tensor, w: int, len_p: int, len_e: int
                ) -> torch.Tensor:
    _, rows, n = a.shape
    b = torch.empty_like(a)
    err = build.library().ofdm_sc_level(a.data_ptr(), b.data_ptr(), rows, n,
                                        w, len_p, len_e,
                                        build.stream_ptr(a.device))
    build.check(err, "sc_level")
    policy.count_launch("sc_level")
    return b


def _out_cuda(a: torch.Tensor, l: int, nd: int, metric: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    _, rows, n = a.shape
    p = torch.empty((rows, nd), dtype=torch.complex64, device=a.device)
    q = torch.empty((rows, nd), dtype=torch.float32, device=a.device)
    err = build.library().ofdm_sc_out(a.data_ptr(), p.data_ptr(),
                                      q.data_ptr(), rows, n, l, int(metric),
                                      build.stream_ptr(a.device))
    build.check(err, "sc_out")
    policy.count_launch("sc_out")
    return p, q


def sc_kernels(kernel: str, r: torch.Tensor, l: int, metric: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The S&C kernels on r [..., n]: (P, M) (metric, K6) or (P, R) (K9),
    [..., nd], by route(l). The tile launch is counted under `kernel`,
    the levels route's under sc_leaves, sc_level and sc_out."""
    flat, nd = sc_rows(kernel, r, l)
    if route(l)[0][0] == "tile":
        p, q = _tile_cuda(kernel, flat, nd, l, metric)
    else:
        p, q = levels_route(flat, l, metric, _leaves_cuda, _level_cuda,
                            _out_cuda)
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
