"""The S&C tile route's body, csrc/scfront_tile.cuh (K6's ofdm_scfront and
K9's ofdm_sc_correlate), built for the host with g++ and run on the CPU:
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
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu_torch.kernels import build, scfront, sync

_HARNESS = r"""
#include <algorithm>
#include <barrier>
#include <limits>
#include <thread>
#include <vector>
#include "scfront_tile.cuh"

// A warp's shuffle: every lane stores its value, all wait, each reads its
// source lane's, all wait again before the array is reused.
struct Exchange {
    float v[32];
    std::barrier<> bar{32};
};

struct HostWarp {
    int lane;
    Exchange* x;
    float shfl(float v, int src) const {
        x->v[lane] = v;
        x->bar.arrive_and_wait();
        const float got = x->v[src];
        x->bar.arrive_and_wait();
        return got;
    }
};

template <int LG, bool kMetric>
static void run_blocks(const float2* r, float2* p, float* q,
                       const sct::Plan& g, long long grid) {
    const float nan = std::numeric_limits<float>::quiet_NaN();
    std::vector<float> smem(g.smem_bytes() / sizeof(float) + 1);
    const long long stride = grid * g.warps;
    for (long long b = 0; b < grid; ++b) {
        std::fill(smem.begin(), smem.end(), nan);
        for (int w = 0; w < g.warps; ++w) {
            Exchange x;
            std::vector<std::thread> lanes;
            for (int lane = 0; lane < 32; ++lane)
                lanes.emplace_back([&, lane, w] {
                    const HostWarp wp{lane, &x};
                    float* ring =
                        smem.data() + static_cast<size_t>(w) * g.ring;
                    for (long long item = b * g.warps + w; item < g.items;
                         item += stride)
                        sct::walk<LG, kMetric>(r, p, q, g, item, ring, wp);
                });
            for (auto& t : lanes) t.join();
        }
    }
}

template <bool kMetric, int LG = 0>
static int run_lg(const float2* r, float2* p, float* q, const sct::Plan& g,
                  long long grid) {
    if constexpr (LG > sct::kMaxLog2L) {
        return 1;
    } else {
        if (g.lg != LG) return run_lg<kMetric, LG + 1>(r, p, q, g, grid);
        run_blocks<LG, kMetric>(r, p, q, g, grid);
        return 0;
    }
}

// plan: seg, segs, items, ring floats, warps a block, grid; warps > 0
// caps the warps a block and grid > 0 sets the blocks (else the card's
// grid: a block for every g.warps work items)
extern "C" int sc_tile_host(const float* r, float* p, float* q, int rows,
                            int n, int l, int metric, long long slots,
                            long long max_smem, int warps, long long grid,
                            long long* plan) {
    sct::Plan g;
    if (!sct::plan_tile(g, n, l, static_cast<size_t>(max_smem))) return 1;
    if (warps > 0 && warps < g.warps) g.warps = warps;
    sct::plan_segments(g, rows, slots);
    if (grid <= 0) grid = (g.items + g.warps - 1) / g.warps;
    plan[0] = g.seg;
    plan[1] = g.segs;
    plan[2] = g.items;
    plan[3] = g.ring;
    plan[4] = g.warps;
    plan[5] = grid;
    const auto* rs = reinterpret_cast<const float2*>(r);
    auto* ps = reinterpret_cast<float2*>(p);
    return metric ? run_lg<true>(rs, ps, q, g, grid)
                  : run_lg<false>(rs, ps, q, g, grid);
}

// plan: seg, segs, items, ring floats, warps a block (no run)
extern "C" int sc_plan_host(int rows, int n, int l, long long slots,
                            long long max_smem, long long* plan) {
    sct::Plan g;
    if (!sct::plan_tile(g, n, l, static_cast<size_t>(max_smem))) return 1;
    sct::plan_segments(g, rows, slots);
    plan[0] = g.seg;
    plan[1] = g.segs;
    plan[2] = g.items;
    plan[3] = g.ring;
    plan[4] = g.warps;
    return 0;
}

// The previous tile body's algorithm over whole rows: the leaves, then
// S_2w[i] = S_w[i] + S_w[i + w] level by level, then write_out.
template <bool kMetric>
static void plain_rows(const float2* r, float2* p, float* q, int rows,
                       int n, int l) {
    const int nd = n - 2 * l + 1;
    std::vector<float> e(n), pr(n), pi(n);
    for (int row = 0; row < rows; ++row) {
        const float2* rr = r + static_cast<size_t>(row) * n;
        for (int j = 0; j < n; ++j) {
            const float mag = hypotf(rr[j].x, rr[j].y);
            e[j] = __fmul_rn(mag, mag);
        }
        for (int j = 0; j < n - l; ++j) {
            const float2 a = rr[j], b = rr[j + l];
            pr[j] = __fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
            pi[j] = __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x));
        }
        int len_e = n, len_p = n - l;
        for (int w = 1; w < 2 * l; w *= 2) {
            len_e -= w;
            for (int j = 0; j < len_e; ++j) e[j] = __fadd_rn(e[j], e[j + w]);
            if (w < l) {
                len_p -= w;
                for (int j = 0; j < len_p; ++j) {
                    pr[j] = __fadd_rn(pr[j], pr[j + w]);
                    pi[j] = __fadd_rn(pi[j], pi[j + w]);
                }
            }
        }
        for (int i = 0; i < nd; ++i)
            sct::write_out<kMetric>(p, q, static_cast<size_t>(row) * nd + i,
                                    pr[i], pi[i], e[i]);
    }
}

extern "C" void sc_plain_host(const float* r, float* p, float* q, int rows,
                              int n, int l, int metric) {
    const auto* rs = reinterpret_cast<const float2*>(r);
    auto* ps = reinterpret_cast<float2*>(p);
    if (metric)
        plain_rows<true>(rs, ps, q, rows, n, l);
    else
        plain_rows<false>(rs, ps, q, rows, n, l);
}
"""

SMEM = 227 * 1024          # shared memory a block may use on the card
CARD_SLOTS = 132 * 16      # 16 warps an SM, the card's at l <= 128
REL_TOL, M_TOL, R_TOL = 1e-5, 1e-5, 1e-5      # chip_smoke.py's


@pytest.fixture(scope="module")
def sc_host(tmp_path_factory):
    """The body built with g++ into a temporary directory, loaded with
    ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the S&C body cannot be built for the "
                    "host")
    out = tmp_path_factory.mktemp("scfront_host")
    src = out / "harness.cpp"
    src.write_text(_HARNESS)
    lib = out / "libscfront_host.so"
    done = subprocess.run(
        [gxx, "-O2", "-std=c++20", "-ffp-contract=off", "-fPIC", "-shared",
         "-I", str(build.CSRC), "-o", str(lib), str(src), "-lpthread"],
        capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.sc_tile_host.argtypes = [p, p, p, i, i, i, i, ll, ll, i, ll,
                                 p]
    dll.sc_plain_host.argtypes = [p, p, p, i, i, i, i]
    dll.sc_plan_host.argtypes = [i, i, i, ll, ll, p]
    return dll


def _rows(rows: int, n: int, seed: int, zero=None) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, n)) + 1j * rng.normal(size=(rows, n))
         ).astype(np.complex64)
    if zero is not None:
        x[:, zero[0]:zero[1]] = 0                   # idle: R = 0, M = 0
    return x


def _run(dll, x, l, metric, slots=CARD_SLOTS, warps=0, grid=0, smem=SMEM):
    """(P, M or R, plan) of the body on x [rows, n]; plan: seg, segs,
    items, ring floats, warps, grid."""
    rows, n = x.shape
    nd = n - 2 * l + 1
    x = np.ascontiguousarray(x)
    p = np.full((rows, nd), np.nan, np.complex64)
    q = np.full((rows, nd), np.nan, np.float32)
    plan = np.zeros(6, np.int64)
    err = dll.sc_tile_host(x.ctypes.data, p.ctypes.data, q.ctypes.data,
                           rows, n, l, int(metric), slots, smem, warps,
                           grid, plan.ctypes.data)
    assert err == 0
    return p, q, plan


def _plain(dll, x, l, metric):
    rows, n = x.shape
    nd = n - 2 * l + 1
    x = np.ascontiguousarray(x)
    p = np.empty((rows, nd), np.complex64)
    q = np.empty((rows, nd), np.float32)
    dll.sc_plain_host(x.ctypes.data, p.ctypes.data, q.ctypes.data, rows, n,
                      l, int(metric))
    return p, q


def _same_bits(a, b):
    assert a.shape == b.shape
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _close_to_torch(x, l, metric, p, q):
    xt = torch.from_numpy(x)
    if metric:
        p0, q0 = scfront.sc_frontend_plain(xt, l)
        assert float(np.abs(q - q0.numpy()).max()) <= M_TOL
    else:
        p0, q0 = sync.sc_correlate_plain(xt, l)
        q0 = q0.numpy()
        rel = np.abs(q - q0) / np.maximum(np.abs(q0), 1e-30)
        assert float(rel.max()) <= R_TOL
    p0 = p0.numpy()
    assert float(np.abs(p - p0).max()) <= REL_TOL * float(np.abs(p0).max())


# (l, rows, n): one segment of a short row, rows shorter than one step
# (256 positions), ragged rows of many segments
CASES = [(1, 2, 40), (1, 3, 3001), (2, 1, 9), (2, 2, 2500), (8, 2, 200),
         (8, 3, 4099), (32, 1, 65), (32, 2, 300), (32, 3, 5003),
         (128, 1, 257), (128, 2, 9001), (512, 2, 1100), (512, 2, 12007),
         (2048, 1, 4097), (2048, 1, 9000)]


@pytest.mark.parametrize("metric", [True, False])
@pytest.mark.parametrize("l,rows,n", CASES)
def test_tile_body_equals_plain_doubling(sc_host, l, rows, n, metric):
    """Segments for 16 warps an SM: the same bits as the plain doubling,
    within tolerance of the PyTorch plain version, every output written."""
    x = _rows(rows, n, seed=l * 7 + n)
    p, q, _ = _run(sc_host, x, l, metric)
    p0, q0 = _plain(sc_host, x, l, metric)
    _same_bits(p.view(np.float32), p0.view(np.float32))
    _same_bits(q, q0)
    _close_to_torch(x, l, metric, p, q)


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
    x = _rows(3, n, seed=l, zero=(z0, z1))
    p, q, plan = _run(sc_host, x, l, True, slots=1 << 40, warps=warps,
                      grid=grid)
    assert list(plan) == [seg, 3, 9, plan[3], warps, grid]
    p0, q0 = _plain(sc_host, x, l, True)
    _same_bits(p.view(np.float32), p0.view(np.float32))
    _same_bits(q, q0)
    assert not q[:, z0:z1 - 2 * l + 1].any()


@pytest.mark.parametrize("l", [8, 128, 512])
def test_rows_do_not_leak(sc_host, l):
    """Each row alone gives the bits it gets among others."""
    x = _rows(4, 3 * l + 1500, seed=l + 1)
    p, q, _ = _run(sc_host, x, l, True, slots=1 << 40, warps=2,
                   grid=1)
    for k in range(4):
        pk, qk, _ = _run(sc_host, x[k:k + 1], l, True, slots=1 << 40)
        _same_bits(p[k:k + 1].view(np.float32), pk.view(np.float32))
        _same_bits(q[k:k + 1], qk)


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
    x = _rows(1, 2 * l, seed=3)                 # one output
    p, q, plan = _run(sc_host, x, l, True, slots=1)
    assert plan[4] == warps and plan[2] == 1
    p0, q0 = _plain(sc_host, x, l, True)
    _same_bits(q, q0)
    _same_bits(p.view(np.float32), p0.view(np.float32))


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
