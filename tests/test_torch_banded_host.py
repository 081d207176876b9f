"""The banded tier's bodies (K8 and K13, csrc/banded_body.cuh), built for
the host with g++ and run on the CPU: the strided FIR and decimation, the
polyphase interpolation and the S&C window sums, each within REL_TOL of
max|y| (R: R_TOL sample by sample) of the plain versions in
kernels/fir.py and kernels/banded.py, at strides 1, 2, 3 and 8, 3 to 194
taps, ragged rows, 1, 2 and 5 rows, a persistent grid of 1-7 blocks, and
S&C windows l = 1, 16 and 128.

The bodies run unchanged, one std::thread a CUDA thread of a block: the
producer warp copies (a plain copy here), the consumer warps split and
sum. The ring's mbarriers are a mutex and a condition variable each, the
consumers' named barrier and the block's barrier a std::barrier each,
shared memory a host array filled with NaN before each block (a read of
a word the block did not write shows in the output), and the blocks of
the persistent grid run one after another. The tensor-core product is a
software model of mma.sync m16n8k8 .tf32: each lane leaves its fragments
in its warp's exchange (two slots used in turn), one std::barrier of the
warp's 32 lanes, then each lane sums its own outputs from the fragments
of the PTX ISA's layout, the operands' low 13 bits ignored; TF32 rounding
is to nearest, ties away, 10 mantissa bits. Two or three consumer warps a
block (the card's: 8) and a few SMs in the plan give several items a row
and several tasks a warp. That checks the spans, the phase of the 16-byte
copies, the split planes and their padded rows, the fragments, the
k-step shares and the stores before any card sees the source; it says
nothing of speed.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu_torch.kernels import banded, build, fir
from ofdm_uhd_tpu_torch.phy.tables import resample_filter

_HARNESS = r"""
#include <algorithm>
#include <barrier>
#include <condition_variable>
#include <cstdint>
#include <limits>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#include "banded_body.cuh"

// An mbarrier: `count` arrivals complete a phase; a wait for parity P
// returns once a phase of parity P has completed since the last one of
// the other parity (PTX's try_wait.parity).
struct HostBar {
    std::mutex m;
    std::condition_variable cv;
    int count = 0, pending = 0;
    unsigned phase = 0;
    void init(int c) {
        count = pending = c;
        phase = 0;
    }
    void arrive() {
        std::lock_guard<std::mutex> lock(m);
        if (--pending == 0) {
            pending = count;
            ++phase;
            cv.notify_all();
        }
    }
    void wait(unsigned parity) {
        std::unique_lock<std::mutex> lock(m);
        cv.wait(lock, [&] { return (phase & 1u) != parity; });
    }
};

// The ring's barriers: the copies are plain copies here, so a producer's
// arrival on "full" is due at once.
struct HostPipe {
    HostBar full[2], empty[2];
    void init(int producers, int consumers) {
        for (int s = 0; s < 2; ++s) {
            full[s].init(producers);
            empty[s].init(consumers);
        }
    }
    void arrive_full(int s) { full[s].arrive(); }
    void arrive_empty(int s) { empty[s].arrive(); }
    void wait_full(int s, unsigned parity) { full[s].wait(parity); }
    void wait_empty(int s, unsigned parity) { empty[s].wait(parity); }
};

// A warp's exchange for the tensor-core product
struct HostWarp {
    std::barrier<> bar{32};
    struct Frag {
        uint32_t a[4], b0, b1;
    } slot[2][32];
};
thread_local HostWarp* tl_warp = nullptr;
thread_local int tl_lane = 0, tl_turn = 0;
long long g_mmas = 0;
std::mutex g_count;

static float tf32_value(uint32_t u) {
    u &= 0xffffe000u;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

// d += A B over the warp: A[r][k] from lane (r % 8) * 4 + k % 4, its
// register (r / 8) + 2 (k / 4); B[k][c] from lane c * 4 + k % 4, b0 for
// k < 4, b1 above; products exact in float, summed in order of k.
void bandk::host_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                     uint32_t b1) {
    HostWarp& w = *tl_warp;
    auto& s = w.slot[tl_turn];
    for (int i = 0; i < 4; ++i) s[tl_lane].a[i] = a[i];
    s[tl_lane].b0 = b0;
    s[tl_lane].b1 = b1;
    w.bar.arrive_and_wait();
    const int g = tl_lane >> 2, t = tl_lane & 3;
    for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i >> 1), c = 2 * t + (i & 1);
        float sum = d[i];
        for (int k = 0; k < 8; ++k) {
            const auto& fa = s[(r & 7) * 4 + (k & 3)];
            const auto& fb = s[c * 4 + (k & 3)];
            sum += tf32_value(fa.a[(r >> 3) + 2 * (k >> 2)]) *
                   tf32_value(k < 4 ? fb.b0 : fb.b1);
        }
        d[i] = sum;
    }
    tl_turn ^= 1;
    if (tl_lane == 0) {
        std::lock_guard<std::mutex> lock(g_count);
        ++g_mmas;
    }
}

// plan: tiles, groups, item_in, item_out, items, raw, smem, nb, warps
static void report(const bandk::Plan& g, long long* plan) {
    const long long v[9] = {g.tiles, g.groups, g.item_in, g.item_out,
                            g.items, g.raw, g.smem, g.nb, g.warps};
    std::copy(v, v + 9, plan);
}

template <int kKind, int NB>
static void run_blocks(const bandk::Args& a, const bandk::Plan& g,
                       int grid) {
    const float nan = std::numeric_limits<float>::quiet_NaN();
    std::vector<float4> smem(g.smem / sizeof(float4) + 1);
    for (long long b = 0; b < grid; ++b) {
        std::fill(smem.begin(), smem.end(), float4{nan, nan, nan, nan});
        auto* sm = reinterpret_cast<unsigned char*>(smem.data());
        HostPipe pipe;
        std::barrier<> all(g.threads()), consumers(32 * g.warps);
        std::vector<std::unique_ptr<HostWarp>> warps;
        for (int w = 0; w < g.warps; ++w)
            warps.push_back(std::make_unique<HostWarp>());
        std::vector<std::thread> threads;
        for (int t = 0; t < g.threads(); ++t)
            threads.emplace_back([&, t] {
                tl_warp = t < 32 * g.warps ? warps[t / 32].get() : nullptr;
                tl_lane = t & 31;
                tl_turn = 0;
                bandk::band_block<kKind, NB>(
                    a, g, sm, b, grid, t, pipe,
                    [&] { all.arrive_and_wait(); },
                    [&] { consumers.arrive_and_wait(); });
            });
        for (auto& th : threads) th.join();
    }
}

extern "C" long long band_mmas() { return g_mmas; }

extern "C" int band_strided_host(const float* x, const float* w, float* y,
                                 int rows, int n_in, int n_out, int nt,
                                 int s, int pad, int warps, int sms,
                                 int grid, long long max_smem,
                                 long long goal, long long* plan) {
    bandk::Plan g;
    bandk::Args a{};
    if (!bandk::rows_at(x, a) ||
        !bandk::plan_strided(g, rows, n_in, n_out, nt, s, pad, warps, sms,
                             max_smem, goal))
        return 1;
    report(g, plan);
    if (!y) return 0;
    a.coef = w;
    a.y = reinterpret_cast<float2*>(y);
    run_blocks<bandk::kStrided, bandk::kNbStrided>(a, g, grid);
    return 0;
}

extern "C" int band_interp_host(const float* x, const float* gm, float* y,
                                int rows, int n, int l, int nd, int d_max,
                                int warps, int sms, int grid,
                                long long max_smem, long long goal,
                                long long* plan) {
    bandk::Plan g;
    bandk::Args a{};
    if (!bandk::rows_at(x, a) ||
        !bandk::plan_interp(g, rows, n, l, nd, d_max, warps, sms, max_smem,
                            goal))
        return 1;
    report(g, plan);
    if (!y) return 0;
    a.coef = gm;
    a.y = reinterpret_cast<float2*>(y);
    if (g.nb == 1) run_blocks<bandk::kInterp, 1>(a, g, grid);
    else if (g.nb == 2) run_blocks<bandk::kInterp, 2>(a, g, grid);
    else run_blocks<bandk::kInterp, 4>(a, g, grid);
    return 0;
}

extern "C" int band_sc_host(const float* x, float* p, float* r, int rows,
                            int n, int l, int warps, int sms, int grid,
                            long long max_smem, long long goal,
                            long long* plan) {
    bandk::Plan g;
    bandk::Args a{};
    if (!bandk::rows_at(x, a) ||
        !bandk::plan_sc(g, rows, n, l, warps, sms, max_smem, goal))
        return 1;
    report(g, plan);
    if (!p) return 0;
    a.y = reinterpret_cast<float2*>(p);
    a.r = r;
    run_blocks<bandk::kSc, bandk::kNbSc>(a, g, grid);
    return 0;
}
"""

WARPS = 2             # consumer warps a block (the card's: 8)
SMS = 3               # SMs the plan spreads the items over (the card's: 132)
SMEM = 227 * 1024     # shared memory a block may use on the card
GOAL = 113 * 1024     # the plan's goal: two blocks an SM
REL_TOL = 1e-5        # chip_smoke.py's REL_TOL and R_TOL
R_TOL = 1e-5


@pytest.fixture(scope="module")
def band_host(tmp_path_factory):
    """The bodies built with g++ into a temporary directory, loaded with
    ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the banded bodies cannot be built for "
                    "the host")
    out = tmp_path_factory.mktemp("banded_host")
    src = out / "harness.cpp"
    src.write_text(_HARNESS)
    lib = out / "libbanded_host.so"
    done = subprocess.run(
        [gxx, "-O2", "-std=c++20", "-fPIC", "-shared", "-I",
         str(build.CSRC), "-o", str(lib), str(src), "-lpthread"],
        capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.band_strided_host.argtypes = [p, p, p] + [i] * 9 + [ll, ll, p]
    dll.band_interp_host.argtypes = [p, p, p] + [i] * 8 + [ll, ll, p]
    dll.band_sc_host.argtypes = [p, p, p] + [i] * 6 + [ll, ll, p]
    dll.band_mmas.restype = ll
    return dll


def _taps(nt: int, l: int = 8) -> np.ndarray:
    if nt == 3:
        return np.asarray([0.25, 0.5, 0.25], np.float32)
    if nt == 193:
        return np.asarray(resample_filter(l, 1), np.float32)
    return np.random.default_rng(nt).normal(size=nt).astype(np.float32)


def _aligned(shape, dtype, offset: int = 0) -> np.ndarray:
    """An array whose first element lies `offset` elements past a 16-byte
    boundary, NaN-filled where it is float."""
    dt = np.dtype(dtype)
    n = int(np.prod(shape)) + offset + 16
    buf = np.empty(n, dt)
    skip = (-buf.ctypes.data % 16) // dt.itemsize
    out = buf[skip + offset: skip + offset + int(np.prod(shape))]
    if dt.kind in "fc":
        out[...] = np.nan
    return out.reshape(shape)


def _rows(rows: int, n: int, seed: int, offset: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = _aligned((rows, n), np.complex64, offset)
    x[...] = (rng.normal(size=(rows, n))
              + 1j * rng.normal(size=(rows, n))).astype(np.complex64)
    return x


def _plan(plan) -> dict:
    return dict(zip(("tiles", "groups", "item_in", "item_out", "items",
                     "raw", "smem", "nb", "warps"), plan.tolist()))


def _strided(dll, x, taps, s, n_out=None, grid=3, warps=WARPS, sms=SMS,
             max_smem=SMEM, goal=GOAL):
    """The strided body on x [rows, n_in] -> (y [rows, n_out], plan);
    n_out defaults to n_in // s (K13), K8 asks for ceil(n_in / s)."""
    rows, n_in = x.shape
    _, w, pad = fir._corr_weights(taps)
    n_out = n_in // s if n_out is None else n_out
    y = _aligned((rows, n_out), np.complex64)
    plan = np.zeros(9, np.int64)
    assert dll.band_strided_host(
        x.ctypes.data, w.ctypes.data, y.ctypes.data, rows, n_in, n_out,
        len(w), s, pad, warps, sms, grid, max_smem, goal,
        plan.ctypes.data) == 0
    return y, _plan(plan)


def _interp(dll, x, l, taps, grid=3, warps=WARPS, sms=SMS):
    rows, n = x.shape
    g, _, d_max = fir.branch_matrix(taps, l)
    g = np.ascontiguousarray(g, np.float32)
    y = _aligned((rows, n * l), np.complex64)
    plan = np.zeros(9, np.int64)
    assert dll.band_interp_host(
        x.ctypes.data, g.ctypes.data, y.ctypes.data, rows, n, l, g.shape[1],
        d_max, warps, sms, grid, SMEM, GOAL, plan.ctypes.data) == 0
    return y, _plan(plan)


def _sc(dll, x, l, grid=3, warps=WARPS, sms=SMS):
    rows, n = x.shape
    nd = n - 2 * l + 1
    p = _aligned((rows, nd), np.complex64)
    r = _aligned((rows, nd), np.float32)
    plan = np.zeros(9, np.int64)
    assert dll.band_sc_host(x.ctypes.data, p.ctypes.data, r.ctypes.data,
                            rows, n, l, warps, sms, grid, SMEM, GOAL,
                            plan.ctypes.data) == 0
    return p, r, _plan(plan)


def _close(got, want):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= REL_TOL * float(np.abs(want).max()), err


def _sc_close(p, r, x, l):
    p0, r0 = banded.sc_correlate_banded_plain(torch.from_numpy(x.copy()), l)
    _close(p, p0.numpy())
    rel = np.abs(r - r0.numpy()) / np.maximum(np.abs(r0.numpy()), 1e-30)
    assert float(rel.max()) <= R_TOL, float(rel.max())


def _decim_plain(x, s, taps, n_out):
    y = fir.decim_plain(torch.from_numpy(x.copy()), 1, taps)[..., ::s]
    return y[..., :n_out].numpy()


@pytest.mark.parametrize("ntaps", [3, 8, 193, 194])
@pytest.mark.parametrize("stride", [1, 2, 3, 8])
def test_strided_on_host_matches_plain(band_host, stride, ntaps):
    """Two rows of stride * 701 + 5 samples (n_in no multiple of the
    stride, of 2 or of 16): several items a row, the last ragged, K13's n
    // m outputs and K8's ceil(n / m), against the full-rate FIR kept at
    every m-th sample."""
    taps = _taps(ntaps)
    x = _rows(2, stride * 701 + 5, seed=stride * 1000 + ntaps)
    for n_out in (x.shape[1] // stride, -(-x.shape[1] // stride)):
        got, plan = _strided(band_host, x, taps, stride, n_out)
        assert plan["items"] >= 2 * 2 and plan["nb"] == 1
        _close(got, _decim_plain(x, stride, taps, n_out))


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("stride,ntaps", [(1, 193), (8, 193), (3, 8)])
def test_strided_rows(band_host, stride, ntaps, rows):
    """One and five rows of an odd length: the rows after the first start
    8 bytes off a 16-byte boundary, so pairs straddle the rows' ends."""
    taps = _taps(ntaps)
    x = _rows(rows, stride * 500 + 3, seed=rows + stride)
    got, _ = _strided(band_host, x, taps, stride)
    _close(got, _decim_plain(x, stride, taps, x.shape[1] // stride))


@pytest.mark.parametrize("grid", [1, 2, 7])
@pytest.mark.parametrize("kind", ["strided", "interp", "sc"])
def test_persistent_grid_walks_every_item(band_host, kind, grid):
    """More items than blocks: one block walks all of them, or a few share
    them unevenly; each block's ring turns over several times."""
    if kind == "strided":
        x = _rows(3, 8 * 760 + 7, seed=grid)
        got, plan = _strided(band_host, x, _taps(193), 8, grid=grid, sms=9)
        _close(got, _decim_plain(x, 8, _taps(193), x.shape[1] // 8))
    elif kind == "interp":
        x = _rows(3, 400, seed=grid)
        got, plan = _interp(band_host, x, 8, _taps(193), grid=grid, sms=20)
        _close(got, fir.interp_plain(torch.from_numpy(x.copy()), 8,
                                     _taps(193)).numpy())
    else:
        x = _rows(3, 5000, seed=grid)
        p, r, plan = _sc(band_host, x, 16, grid=grid)
        _sc_close(p, r, x, 16)
    assert plan["items"] > grid


@pytest.mark.parametrize("offset", [0, 1])
def test_rows_off_a_16_byte_boundary(band_host, offset):
    """x one sample past a 16-byte boundary: the producer copies from the
    boundary before it and the split starts one sample into the stage."""
    x = _rows(2, 8 * 1000 + 1, seed=offset, offset=offset)
    got, _ = _strided(band_host, x, _taps(193), 8)
    _close(got, _decim_plain(x, 8, _taps(193), x.shape[1] // 8))
    p, r, _ = _sc(band_host, x, 128)
    _sc_close(p, r, x, 128)


@pytest.mark.parametrize("ntaps", [3, 193])
@pytest.mark.parametrize("l", [2, 3, 8, 12, 40])
def test_interp_on_host_matches_plain(band_host, l, ntaps):
    """Interpolation by 2, 3, 8, 12 (two blocks of branches) and 40 (five
    blocks: two groups of four, the second mostly empty), rows of an odd
    length."""
    taps = _taps(ntaps, l)
    x = _rows(2, 517, seed=l + ntaps)
    got, plan = _interp(band_host, x, l, taps)
    assert plan["nb"] == {2: 1, 3: 1, 8: 1, 12: 2, 40: 4}[l]
    _close(got, fir.interp_plain(torch.from_numpy(x.copy()), l,
                                 taps).numpy())


@pytest.mark.parametrize("rows", [1, 2, 5])
@pytest.mark.parametrize("l", [1, 16, 128])
def test_sc_on_host_matches_plain(band_host, l, rows):
    """The S&C window sums: P within REL_TOL of max|P|, R within R_TOL
    sample by sample, at windows of 1 (each k-step's band partly empty),
    16 and 128, rows of an odd length."""
    x = _rows(rows, 6 * l + 2011, seed=l * 10 + rows)
    p, r, _ = _sc(band_host, x, l)
    _sc_close(p, r, x, l)


@pytest.mark.parametrize("n", [257, 301, 1100])
def test_sc_long_halos(band_host, n):
    """l > n / 4: one or a few outputs a row and a halo of 2l beside
    them."""
    l = 100
    x = _rows(2, n, seed=n)
    p, r, plan = _sc(band_host, x, l)
    assert plan["raw"] > plan["item_in"]
    _sc_close(p, r, x, l)


@pytest.mark.parametrize("kind", ["strided", "interp", "sc"])
def test_rows_never_leak(band_host, kind):
    """Each row alone gives the bits it gets among others (one SM in the
    plan, so that the rows do not change the item size)."""
    x = _rows(4, 2 * 700 + 1, seed=7)

    def run(rows):
        if kind == "strided":
            return (_strided(band_host, rows, _taps(193), 2, sms=1)[0],)
        if kind == "interp":
            return (_interp(band_host, rows, 8, _taps(193), sms=1)[0],)
        return _sc(band_host, rows, 16, sms=1)[:2]

    every = run(x)
    for k in range(4):
        alone = run(np.ascontiguousarray(x[k:k + 1]))
        for a, b in zip(alone, every):
            assert np.array_equal(a.view(np.uint32), b[k:k + 1].view(
                np.uint32))


def test_three_warps_share_tasks(band_host):
    """Three consumer warps: tasks do not divide among them evenly."""
    x = _rows(2, 4 * 3000 + 3, seed=33)
    got, _ = _strided(band_host, x, _taps(193), 4, warps=3)
    _close(got, _decim_plain(x, 4, _taps(193), x.shape[1] // 4))
    p, r, _ = _sc(band_host, x, 128, warps=3)
    _sc_close(p, r, x, 128)


def _card_plan(dll, kind):
    """The card's plan (8 consumer warps, 132 SMs) at C4's decimation [8,
    4,138,472] by 8, C4's TX interpolation [32, 16128] by 8, and the S&C
    over C3's captures [8, 4,436,068] at l = 128."""
    plan = np.zeros(9, np.int64)
    none = ctypes.c_void_p(0)
    x = _rows(1, 2, seed=0)      # any 16-byte aligned pointer
    if kind == "decim":
        _, w, pad = fir._corr_weights(_taps(193))
        assert dll.band_strided_host(x.ctypes.data, w.ctypes.data, none, 8,
                                     4_138_472, 517_309, 193, 8, pad, 8,
                                     132, 1, SMEM, GOAL,
                                     plan.ctypes.data) == 0
    elif kind == "interp":
        assert dll.band_interp_host(x.ctypes.data, none, none, 32, 16128, 8,
                                    25, 12, 8, 132, 1, SMEM, GOAL,
                                    plan.ctypes.data) == 0
    else:
        assert dll.band_sc_host(x.ctypes.data, none, none, 8, 4_436_068,
                                128, 8, 132, 1, SMEM, GOAL,
                                plan.ctypes.data) == 0
    return _plan(plan)


@pytest.mark.parametrize("kind", ["decim", "interp", "sc"])
def test_card_plans_stage_little_halo(band_host, kind):
    """At C4 and C3's S&C an item stages at most 1.25x its own inputs,
    within the two-blocks-an-SM goal, every warp with a task: the
    decimation's eight warps share a tile's k-steps, the interpolation's
    and the S&C's each take whole tiles (four of 2048 outputs at C3)."""
    p = _card_plan(band_host, kind)
    assert p["raw"] <= 1.25 * p["item_in"] + 1
    assert p["smem"] <= GOAL
    assert p["tiles"] * p["groups"] >= p["warps"]
    assert p["warps"] == (4 if kind == "sc" else 8)


def test_mma_count_matches_the_band(band_host):
    """The products the model ran: at stride 8 with 193 taps a tile spans
    B_0's ceil((7 * 8 + 193) / 8) = 32 k-steps, two planes, three products
    a step; at S&C window l = 16 the four column blocks of a tile run at
    every k-step of each window, (31 + 16) / 8 -> 6 for the lag product's
    two planes and (31 + 32) / 8 -> 8 for the energy's, two products each
    (a band of ones has no low part)."""
    x = _rows(1, 8 * 512, seed=5)
    before = band_host.band_mmas()
    _, plan = _strided(band_host, x, _taps(193), 8, sms=1, grid=1)
    tiles = plan["items"] * plan["tiles"]
    assert band_host.band_mmas() - before == tiles * 32 * 2 * 3
    x = _rows(1, 4096, seed=6)
    before = band_host.band_mmas()
    _, _, plan = _sc(band_host, x, 16, sms=1, grid=1)
    tiles = plan["items"] * plan["tiles"]
    assert band_host.band_mmas() - before == tiles * 4 * (6 + 6 + 8) * 2
