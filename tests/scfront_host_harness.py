"""The host build of the S&C routes' bodies, csrc/scfront_tile.cuh and
csrc/scfront_split.cuh, that tests/test_torch_scfront_host*.py share: the
C++ harness built with g++ (the module-scoped fixture `sc_host`), the tile
body's run and checks, and the tile test's cases. Those cases lie in three
files (TILE_FILES), the slowest apart, so that pytest-xdist's loadfile
spreads them over workers; test_torch_scfront_host.py describes the
harness.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu_torch.kernels import build, scfront, sync

HARNESS = r"""
#include <algorithm>
#include <barrier>
#include <limits>
#include <thread>
#include <vector>
#include "scfront_split.cuh"

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

// `grid` blocks of `warps` warps, one after another, each warp 32 lanes
// walking work items item, item + grid * warps, .. < items by
// walk(item, ring, wp); a warp's ring is `ring` floats of its block's
// shared memory, NaN before each block.
template <class Walk>
static void run_warps(long long grid, int warps, int ring, long long items,
                      Walk walk) {
    const float nan = std::numeric_limits<float>::quiet_NaN();
    std::vector<float> smem(static_cast<size_t>(ring) * warps + 1);
    const long long stride = grid * warps;
    for (long long b = 0; b < grid; ++b) {
        std::fill(smem.begin(), smem.end(), nan);
        for (int w = 0; w < warps; ++w) {
            Exchange x;
            std::vector<std::thread> lanes;
            for (int lane = 0; lane < 32; ++lane)
                lanes.emplace_back([&, lane, w] {
                    const HostWarp wp{lane, &x};
                    float* own = smem.data() + static_cast<size_t>(w) * ring;
                    for (long long item = b * warps + w; item < items;
                         item += stride)
                        walk(item, own, wp);
                });
            for (auto& t : lanes) t.join();
        }
    }
}

template <int LG, bool kMetric>
static void run_blocks(const float2* r, float2* p, float* q,
                       const sct::Plan& g, long long grid) {
    run_warps(grid, g.warps, g.ring, g.items,
              [&](long long item, float* ring, const HostWarp& wp) {
                  sct::walk<LG, kMetric>(r, p, q, g, item, ring, wp);
              });
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
// ---- the split route ----

template <int LGW = 0>
static int run_span_lg(const float2* r, float* set, const scs::SpanPlan& g,
                       long long grid) {
    if constexpr (LGW > scs::kMaxLog2W) {
        return 1;
    } else {
        if (g.lgw != LGW) return run_span_lg<LGW + 1>(r, set, g, grid);
        run_warps(grid, g.warps, g.ring, g.items,
                  [&](long long item, float* ring, const HostWarp& wp) {
                      scs::span_walk<LGW>(r, set, g, item, ring, wp);
                  });
        return 0;
    }
}

// plan: seg, segs, items, ring floats, warps a block, grid
extern "C" int sc_span_host(const float* r, float* set, int rows, int n,
                            int l, int w, long long slots, long long max_smem,
                            int warps, long long grid, long long* plan) {
    scs::SpanPlan g;
    if (!scs::plan_span(g, rows, n, l, w, static_cast<size_t>(max_smem)))
        return 1;
    if (warps > 0 && warps < g.warps) g.warps = warps;
    scs::plan_span_segments(g, slots);
    if (grid <= 0) grid = (g.items + g.warps - 1) / g.warps;
    plan[0] = g.seg;
    plan[1] = g.segs;
    plan[2] = g.items;
    plan[3] = g.ring;
    plan[4] = g.warps;
    plan[5] = grid;
    return run_span_lg(reinterpret_cast<const float2*>(r), set, g, grid);
}

template <int NR, bool kMetric>
static void run_stride_blocks(const float* set, float2* p, float* q,
                              const scs::StridePlan& g, long long grid) {
    const float nan = std::numeric_limits<float>::quiet_NaN();
    std::vector<float> smem(static_cast<size_t>(g.ring) * g.block + 1);
    const long long stride = grid * g.block;
    for (long long b = 0; b < grid; ++b) {
        std::fill(smem.begin(), smem.end(), nan);
        for (int tid = 0; tid < g.block; ++tid)
            for (long long th = b * g.block + tid; th < g.threads;
                 th += stride)
                scs::stride_walk<NR, kMetric>(set, p, q, g, th,
                                              smem.data() + tid, g.block);
    }
}

template <bool kMetric, int NR = 0>
static int run_stride_nr(const float* set, float2* p, float* q,
                         const scs::StridePlan& g, long long grid) {
    if constexpr (NR > scs::kRegLg + 1) {
        return 1;
    } else {
        if (scs::reg_levels(g.lgd) != NR)
            return run_stride_nr<kMetric, NR + 1>(set, p, q, g, grid);
        run_stride_blocks<NR, kMetric>(set, p, q, g, grid);
        return 0;
    }
}

// plan: seg, segs, threads, ring floats, threads a block, grid
extern "C" int sc_stride_host(const float* set, float* p, float* q, int rows,
                              int n, int l, int w, int metric,
                              long long slots, long long max_smem, int block,
                              long long grid, long long* plan) {
    scs::StridePlan g;
    if (!scs::plan_stride(g, rows, n, l, w, static_cast<size_t>(max_smem)))
        return 1;
    if (block > 0 && block < g.block) g.block = block;
    scs::plan_stride_segments(g, slots);
    if (grid <= 0) grid = (g.threads + g.block - 1) / g.block;
    plan[0] = g.seg;
    plan[1] = g.segs;
    plan[2] = g.threads;
    plan[3] = g.ring;
    plan[4] = g.block;
    plan[5] = grid;
    auto* ps = reinterpret_cast<float2*>(p);
    return metric ? run_stride_nr<true>(set, ps, q, g, grid)
                  : run_stride_nr<false>(set, ps, q, g, grid);
}

// The plan of the stride pass (span = 0: seg, segs, threads, ring floats,
// threads a block) or of the span pass (span = 1: seg, segs, items, ring
// floats, warps a block) for `slots` walkers, without a run.
extern "C" int sc_split_plan_host(int rows, int n, int l, int w,
                                  long long slots, long long max_smem,
                                  int span, long long* plan) {
    if (span) {
        scs::SpanPlan g;
        if (!scs::plan_span(g, rows, n, l, w, static_cast<size_t>(max_smem)))
            return 1;
        scs::plan_span_segments(g, slots);
        plan[0] = g.seg;
        plan[1] = g.segs;
        plan[2] = g.items;
        plan[3] = g.ring;
        plan[4] = g.warps;
        return 0;
    }
    scs::StridePlan g;
    if (!scs::plan_stride(g, rows, n, l, w, static_cast<size_t>(max_smem)))
        return 1;
    scs::plan_stride_segments(g, slots);
    plan[0] = g.seg;
    plan[1] = g.segs;
    plan[2] = g.threads;
    plan[3] = g.ring;
    plan[4] = g.block;
    return 0;
}

// The span pass's set by a plain doubling over whole rows: the leaves,
// then S_2v[i] = S_v[i] + S_v[i + v] for v = 1 .. w/2; the valid parts
// written, the rest of `set` left as it was.
extern "C" void sc_span_plain_host(const float* r, float* set, int rows,
                                   int n, int l, int w) {
    const size_t plane = static_cast<size_t>(rows) * n;
    std::vector<float> e(n), pr(n), pi(n);
    for (int row = 0; row < rows; ++row) {
        const auto* rr = reinterpret_cast<const float2*>(r) +
                         static_cast<size_t>(row) * n;
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
        for (int v = 1; v < w; v *= 2) {
            len_e -= v;
            len_p -= v;
            for (int j = 0; j < len_e; ++j) e[j] = __fadd_rn(e[j], e[j + v]);
            for (int j = 0; j < len_p; ++j) {
                pr[j] = __fadd_rn(pr[j], pr[j + v]);
                pi[j] = __fadd_rn(pi[j], pi[j + v]);
            }
        }
        const size_t at = static_cast<size_t>(row) * n;
        for (int j = 0; j < len_e; ++j) set[2 * plane + at + j] = e[j];
        for (int j = 0; j < len_p; ++j) {
            set[at + j] = pr[j];
            set[plane + at + j] = pi[j];
        }
    }
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
    src.write_text(HARNESS)
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
    dll.sc_span_host.argtypes = [p, p, i, i, i, i, ll, ll, i, ll, p]
    dll.sc_stride_host.argtypes = [p, p, p, i, i, i, i, i, ll, ll, i, ll, p]
    dll.sc_span_plain_host.argtypes = [p, p, i, i, i, i]
    dll.sc_split_plan_host.argtypes = [i, i, i, i, ll, ll, i, p]
    return dll


def random_rows(rows: int, n: int, seed: int, zero=None) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, n)) + 1j * rng.normal(size=(rows, n))
         ).astype(np.complex64)
    if zero is not None:
        x[:, zero[0]:zero[1]] = 0                   # idle: R = 0, M = 0
    return x


def run_tile(dll, x, l, metric, slots=CARD_SLOTS, warps=0, grid=0,
             smem=SMEM):
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


def run_plain(dll, x, l, metric):
    rows, n = x.shape
    nd = n - 2 * l + 1
    x = np.ascontiguousarray(x)
    p = np.empty((rows, nd), np.complex64)
    q = np.empty((rows, nd), np.float32)
    dll.sc_plain_host(x.ctypes.data, p.ctypes.data, q.ctypes.data, rows, n,
                      l, int(metric))
    return p, q


def same_bits(a, b):
    assert a.shape == b.shape
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def close_to_torch(x, l, metric, p, q):
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


# (l, rows, n, metric): one segment of a short row, rows shorter than one
# step (256 positions), ragged rows of many segments; each with the metric
# M (K6) and with R (K9)
TILE_CASES = [(l, rows, n, metric) for l, rows, n in [
    (1, 2, 40), (1, 3, 3001), (2, 1, 9), (2, 2, 2500), (8, 2, 200),
    (8, 3, 4099), (32, 1, 65), (32, 2, 300), (32, 3, 5003),
    (128, 1, 257), (128, 2, 9001), (512, 2, 1100), (512, 2, 12007),
    (2048, 1, 4097), (2048, 1, 9000)] for metric in (True, False)]
# test_torch_scfront_host_tile<k>.py -> its cases: the two 12007-sample
# cases, the slowest, in files of their own with the short ones (1) and
# the next slowest (2)
_SLOW_2 = [(512, 2, 12007, True), (128, 2, 9001, True),
           (2048, 1, 9000, True), (32, 3, 5003, False)]
_SHORT = [c for c in TILE_CASES if c[2] <= 1100]
TILE_FILES = {
    1: [(512, 2, 12007, False)] + _SHORT,
    2: _SLOW_2,
    3: [c for c in TILE_CASES if c not in _SHORT and c not in _SLOW_2
        and c != (512, 2, 12007, False)],
}
assert sorted(sum(TILE_FILES.values(), [])) == sorted(TILE_CASES)


def hold_tile(dll, l, rows, n, metric):
    """Segments for 16 warps an SM: the same bits as the plain doubling,
    within tolerance of the PyTorch plain version, every output written."""
    x = random_rows(rows, n, seed=l * 7 + n)
    p, q, _ = run_tile(dll, x, l, metric)
    p0, q0 = run_plain(dll, x, l, metric)
    same_bits(p.view(np.float32), p0.view(np.float32))
    same_bits(q, q0)
    close_to_torch(x, l, metric, p, q)
