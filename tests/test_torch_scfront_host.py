"""The S&C tile route's body, csrc/scfront_tile.cuh (K6's ofdm_scfront and
K9's ofdm_sc_correlate), and the split route's two passes above it,
csrc/scfront_split.cuh, built for the host with g++ and run on the CPU:
bit for bit equal to a plain C++ pairwise doubling over whole arrays with
the same leaf arithmetic (the previous tile body's algorithm), and within
chip_smoke.py's tolerances of kernels/scfront.py sc_frontend_plain (P
within 1e-5 of max|P|, M within 1e-5) and kernels/sync.py
sc_correlate_plain (R within 1e-5 relative), at l = 1, 2, 8, 32, 128, 512
and 2048.

The body runs unchanged, one std::thread a CUDA thread (lane) of a warp:
a shuffle writes each lane's value into the warp's exchange array and
reads its source lane's between two waits on a std::barrier. The warps of
a block share nothing, so they run one after another; the blocks too. A
warp's ring is its part of a host array filled with NaN before each block
(a read of a value no step stored shows in the output), and the build has
-ffp-contract=off, so no add or multiply is fused. Grids of one or a few
blocks put several work items on each warp, and many segments in a row,
so segments start from warm-up with stale rings. Says nothing of speed.

The split route's passes run the same way: the span pass a warp of
std::threads, the stride pass one CUDA thread after another (its threads
share nothing but their block's shared memory, a column each), its ring
columns NaN-filled before each block. The span pass's set is held bit for
bit against a plain C++ doubling to S_W (kernels/sync.py span_plain's
function), and the stride pass's P and M or R against the whole plain
doubling, at the widths W the route takes at l = 8192 and 16384 and at
small lags and widths (down to W = 1), with ring levels in both passes.

The C++ harness, its build (the fixture `sc_host`) and the tile body's
helpers are in scfront_host_harness.py; the tile body's cases against the
plain doubling (test_tile_body_equals_plain_doubling) are in
test_torch_scfront_host_tile1.py, _tile2.py and _tile3.py.
"""

import numpy as np
import pytest

from .scfront_host_harness import (CARD_SLOTS, SMEM, close_to_torch,
                                   random_rows, run_plain, run_tile,
                                   same_bits, sc_host)  # noqa: F401


@pytest.mark.parametrize("l,warps,grid", [(1, 1, 1), (8, 2, 2), (32, 1, 1),
                                          (128, 3, 1), (512, 1, 1),
                                          (2048, 1, 1)])
def test_segments_walked_by_few_warps(sc_host, l, warps, grid):
    """The shortest segments (a step, 256 outputs), three a row, and one
    to four warps in all: each warp walks several work items of several
    rows, its registers and ring left stale by the item before; a zero
    stretch gives M = 0."""
    seg = 256
    n = 2 * l - 1 + 2 * seg + 77
    z0, z1 = n // 3, n // 3 + 2 * l + 300
    x = random_rows(3, n, seed=l, zero=(z0, z1))
    p, q, plan = run_tile(sc_host, x, l, True, slots=1 << 40, warps=warps,
                      grid=grid)
    assert list(plan) == [seg, 3, 9, plan[3], warps, grid]
    p0, q0 = run_plain(sc_host, x, l, True)
    same_bits(p.view(np.float32), p0.view(np.float32))
    same_bits(q, q0)
    assert not q[:, z0:z1 - 2 * l + 1].any()


@pytest.mark.parametrize("l", [8, 128, 512])
def test_rows_do_not_leak(sc_host, l):
    """Each row alone gives the bits it gets among others."""
    x = random_rows(4, 3 * l + 1500, seed=l + 1)
    p, q, _ = run_tile(sc_host, x, l, True, slots=1 << 40, warps=2,
                   grid=1)
    for k in range(4):
        pk, qk, _ = run_tile(sc_host, x[k:k + 1], l, True, slots=1 << 40)
        same_bits(p[k:k + 1].view(np.float32), pk.view(np.float32))
        same_bits(q[k:k + 1], qk)


def test_plan_fits_rings():
    """The plan's arithmetic, mirrored: rings of w floats a plane for each
    level w >= 256 (none up to l = 128), warps a block cut to what 227 KB
    holds."""
    def ring(lg):
        e = sum(1 << b for b in range(lg + 1) if (1 << b) >= 256)
        p = sum(1 << b for b in range(lg) if (1 << b) >= 256)
        return e + 2 * p
    assert ring(7) == 0 and ring(9) == 256 + 512 + 2 * 256
    assert ring(12) * 4 * 3 <= SMEM < ring(12) * 4 * 4


@pytest.mark.parametrize("l,warps", [(128, 4), (512, 4), (2048, 4),
                                     (4096, 3)])
def test_plan_warps_a_block(sc_host, l, warps):
    x = random_rows(1, 2 * l, seed=3)                 # one output
    p, q, plan = run_tile(sc_host, x, l, True, slots=1)
    assert plan[4] == warps and plan[2] == 1
    p0, q0 = run_plain(sc_host, x, l, True)
    same_bits(q, q0)
    same_bits(p.view(np.float32), p0.view(np.float32))


def test_plan_refuses_what_the_route_does_not_take(sc_host):
    x = np.zeros((1, 20000), np.complex64)
    plan = np.zeros(6, np.int64)
    p = np.zeros(20000, np.complex64)
    q = np.zeros(20000, np.float32)
    for l in (3, 8192):
        assert sc_host.sc_tile_host(x.ctypes.data, p.ctypes.data,
                                    q.ctypes.data, 1, 20000, l, 1,
                                    CARD_SLOTS, SMEM, 0, 0,
                                    plan.ctypes.data) == 1


def _segments(rows, nd, l, slots):
    """plan_segments, mirrored: of the segment lengths (multiples of 256)
    that fill w = 1 .. 64 waves of slots, the one with the least waves x
    (seg + 2l - 1), the longer on a tie."""
    best = None
    span_nd = -(-nd // 256) * 256
    for w in range(1, 65):
        s = w * slots // rows
        if s < 1:
            continue
        seg = min(-(-(-(-nd // s)) // 256) * 256, span_nd)
        items = rows * -(-nd // seg)
        cost = -(-items // slots) * (seg + 2 * l - 1)
        if best is None or (cost, -seg) < best:
            best = (cost, -seg)
    return -best[1] if best else span_nd


@pytest.mark.parametrize("rows,n,l,slots", [
    (8, 4_436_068, 128, 132 * 16),      # C3
    (8, 517_309, 512, 132 * 8),         # C4
    (4, 1_036_480, 128, 132 * 16),      # c5_sharded's shard rows
    (32, 181_860, 32, 132 * 16),        # c2_pallas
    (4, 75_028, 2048, 132 * 4),         # big_nsc at 4096 points
    (3, 700, 8, 1), (50, 300, 1, 7)])
def test_plan_segments(sc_host, rows, n, l, slots):
    """The segments the card's plan gives the paths' shapes: every output
    in exactly one segment, and the cost model's choice."""
    plan = np.zeros(5, np.int64)
    assert sc_host.sc_plan_host(rows, n, l, slots, SMEM,
                                plan.ctypes.data) == 0
    seg, segs, items = plan[:3]
    nd = n - 2 * l + 1
    assert seg % 256 == 0 and segs == -(-nd // seg) and items == rows * segs
    assert (segs - 1) * seg < nd <= segs * seg
    assert seg == _segments(rows, nd, l, slots)


# ---- the split route -------------------------------------------------

CARD_THREADS = 132 * 1024      # the stride pass's threads on the card


def _span(dll, x, l, w, slots=CARD_SLOTS, warps=0, grid=0, smem=SMEM):
    """(set [3, rows, n] NaN where not written, plan) of the span pass."""
    rows, n = x.shape
    x = np.ascontiguousarray(x)
    a = np.full((3, rows, n), np.nan, np.float32)
    plan = np.zeros(6, np.int64)
    err = dll.sc_span_host(x.ctypes.data, a.ctypes.data, rows, n, l, w,
                           slots, smem, warps, grid, plan.ctypes.data)
    assert err == 0
    return a, plan


def _stride(dll, a, l, w, metric, slots=CARD_THREADS, block=0, grid=0,
            smem=SMEM):
    """(P, M or R, plan) of the stride pass on the set a."""
    _, rows, n = a.shape
    nd = n - 2 * l + 1
    p = np.full((rows, nd), np.nan, np.complex64)
    q = np.full((rows, nd), np.nan, np.float32)
    plan = np.zeros(6, np.int64)
    err = dll.sc_stride_host(a.ctypes.data, p.ctypes.data, q.ctypes.data,
                             rows, n, l, w, int(metric), slots, smem, block,
                             grid, plan.ctypes.data)
    assert err == 0
    return p, q, plan


def _span_plain(dll, x, l, w):
    rows, n = x.shape
    a = np.full((3, rows, n), np.nan, np.float32)
    dll.sc_span_plain_host(np.ascontiguousarray(x).ctypes.data, a.ctypes.data,
                           rows, n, l, w)
    return a


def _hold_split(dll, x, l, w, span_kw=None, stride_kw=None, torch_too=True):
    """Both passes on x against the plain doublings, both outputs (M and
    R), bit for bit; the span pass's set over its valid parts (NaN, never
    written, elsewhere)."""
    rows, n = x.shape
    a, _ = _span(dll, x, l, w, **(span_kw or {}))
    a0 = _span_plain(dll, x, l, w)
    assert np.array_equal(np.isnan(a), np.isnan(a0))
    same_bits(a, a0)
    for metric in (True, False):
        p, q, _ = _stride(dll, a, l, w, metric, **(stride_kw or {}))
        p0, q0 = run_plain(dll, x, l, metric)
        same_bits(p.view(np.float32), p0.view(np.float32))
        same_bits(q, q0)
        if torch_too:
            close_to_torch(x, l, metric, p, q)


# (l, w, rows, n): the route's widths at big_nsc's lags (rows of 2l + 777),
# then small lags and widths: W = 1 (a stride pass of every level), W = l
# (a span pass of every level but R's), ring levels in the stride pass (D
# >= 16) and in the span pass (W >= 512)
SPLIT_CASES = [(8192, 256, 2, 2 * 8192 + 777), (8192, 1024, 2, 2 * 8192 + 777),
               (16384, 256, 1, 2 * 16384 + 777),
               (16384, 1024, 1, 2 * 16384 + 777),
               (1, 1, 2, 40), (2, 1, 3, 301), (2, 2, 2, 2500), (8, 2, 2, 200),
               (32, 4, 3, 1003), (64, 64, 2, 900), (128, 16, 2, 3001),
               (256, 8, 2, 2000), (512, 32, 1, 5000), (1024, 512, 1, 4100),
               (2048, 8, 1, 4500)]


@pytest.mark.parametrize("l,w,rows,n", SPLIT_CASES)
def test_split_passes_equal_plain_doubling(sc_host, l, w, rows, n):
    """The span pass's S_W and the stride pass's P and M or R: the plain
    doubling's bits, within tolerance of the PyTorch plain version, every
    output written."""
    x = random_rows(rows, n, seed=l * 5 + w + n)
    _hold_split(sc_host, x, l, w, torch_too=n < 20000)


@pytest.mark.parametrize("l,w,warps,block,grid", [
    (64, 16, 1, 3, 1), (512, 32, 2, 5, 2), (1024, 512, 1, 7, 1),
    (256, 256, 2, 1, 1), (4096, 16, 1, 2, 1)])
def test_split_segments_walked_by_few_walkers(sc_host, l, w, warps, block,
                                              grid):
    """The shortest segments (a step of 256 positions, a batch of 8 chain
    steps) walked by a few warps and a few threads in all: each walker
    takes several work items of several rows, its registers and ring
    columns left stale by the item before (NaN before the first); a zero
    stretch gives M = 0."""
    n = 2 * l + 3 * 256 + 41
    z0, z1 = n // 3, n // 3 + 2 * l + 300
    x = random_rows(3, n, seed=l + w, zero=(z0, z1))
    a, plan = _span(sc_host, x, l, w, slots=1 << 40, warps=warps, grid=grid)
    assert plan[0] == 256 and plan[4] == warps and plan[5] == grid
    assert plan[2] == 3 * -(-(n - w + 1) // 256)
    same_bits(np.nan_to_num(a, nan=7.0),
               np.nan_to_num(_span_plain(sc_host, x, l, w), nan=7.0))
    p, q, splan = _stride(sc_host, a, l, w, True, slots=1 << 40, block=block,
                          grid=grid)
    assert splan[0] == 8 and splan[4] == block and splan[5] == grid
    p0, q0 = run_plain(sc_host, x, l, True)
    same_bits(p.view(np.float32), p0.view(np.float32))
    same_bits(q, q0)
    assert not q[:, z0:z1 - 2 * l + 1].any()


@pytest.mark.parametrize("l,w", [(8, 2), (512, 16), (1024, 512)])
def test_split_rows_do_not_leak(sc_host, l, w):
    """Each row alone gives the bits it gets among others, through both
    passes."""
    x = random_rows(4, 3 * l + 1500, seed=l + w + 1)
    a, _ = _span(sc_host, x, l, w, slots=1 << 40, warps=2, grid=1)
    p, q, _ = _stride(sc_host, a, l, w, True, slots=1 << 40, block=3,
                      grid=1)
    for k in range(4):
        ak, _ = _span(sc_host, x[k:k + 1], l, w)
        same_bits(np.nan_to_num(a[:, k:k + 1], nan=7.0),
                   np.nan_to_num(ak, nan=7.0))
        pk, qk, _ = _stride(sc_host, ak, l, w, True)
        same_bits(p[k:k + 1].view(np.float32), pk.view(np.float32))
        same_bits(q[k:k + 1], qk)


def _chain_ring(lgd):
    """The stride pass's ring floats a thread, mirrored: the levels above
    8 steps, w' floats each, of the energy (up to D) and of both planes
    of the lag product (up to D/2)."""
    e = sum(1 << b for b in range(4, lgd + 1))
    p = sum(1 << b for b in range(4, lgd))
    return e + 2 * p


@pytest.mark.parametrize("l,w,ring,block", [
    (8192, 1024, 0, 256), (16384, 1024, 16, 256), (8192, 256, 80, 256),
    (16384, 256, 208, 256), (1 << 20, 16384, 208, 256),
    (1 << 21, 16384, 464, 64), (1 << 23, 16384, 2000, 16)])
def test_split_plan_rings_and_blocks(sc_host, l, w, ring, block):
    """The stride pass's ring column and threads a block (a power of two,
    as many up to 256 as 227 KB holds columns for), and the span pass's
    rings (the tile body's levels from 256 up, three planes) and warps a
    block, planned for rows of 2l + 1000 samples."""
    lgd = (l // w).bit_length() - 1
    assert _chain_ring(lgd) == ring
    plan = np.zeros(6, np.int64)
    assert sc_host.sc_split_plan_host(2, 2 * l + 1000, l, w, CARD_THREADS,
                                      SMEM, 0, plan.ctypes.data) == 0
    assert plan[3] == ring and plan[4] == block
    assert plan[3] * 4 * plan[4] <= SMEM < plan[3] * 4 * plan[4] * 2 or \
        block == 256
    assert sc_host.sc_split_plan_host(2, 2 * l + 1000, l, w, 132 * 16, SMEM,
                                      1, plan.ctypes.data) == 0
    span_ring = 3 * sum(1 << b for b in range(8, (w.bit_length() - 1)))
    assert plan[3] == span_ring
    assert plan[4] == max(k for k in (1, 2, 3, 4)
                          if k * span_ring * 4 <= SMEM)
    assert plan[1] == -(-(2 * l + 1000 - w + 1) // plan[0])


@pytest.mark.parametrize("l,w", [(8192, 3), (8192, 16384), (8192, 1 << 15),
                                 (8, 16), (4, 2), (3, 1)])
def test_split_plan_refuses_what_the_passes_do_not_take(sc_host, l, w):
    """Widths that are no power of two, above l or above 16384, lags that
    are no power of two, rows with no output."""
    n = 2 * l - 1 if (l, w) == (4, 2) else 2 * l + 100
    plan = np.zeros(6, np.int64)
    for span in (0, 1):
        assert sc_host.sc_split_plan_host(1, n, l, w, 1, SMEM, span,
                                          plan.ctypes.data) == 1
