"""The shifted-FMA tier's body (K11, csrc/shift_body.cuh), built for the
host with g++ and run on the CPU: the 'same' FIR and the phase-split
decimation (the phase kind) and the branch-row interpolation, each within
REL_TOL of max|y| of kernels/fir.py's decim_plain and interp_plain, at
strides 1, 2, 3 and 8, interpolation by 2 and 8, 3 to 194 taps, 1, 2 and 5
rows, ragged lengths, rows and outputs 8 bytes off a 16-byte boundary, a
persistent grid of 1-7 blocks and tiles cut at each row edge; rows never
leak, a row's outputs alone and in a batch are the same bits, and nothing
is written outside the outputs.

The body runs unchanged, one std::thread a CUDA thread of a block: the
producer warp copies (the bulk copy a plain copy here), the consumer warps
split, sum and store (the bulk store a plain copy). The ring's mbarriers
are a mutex and a condition variable each, the consumers' named barrier
and the block's barrier a std::barrier each, shared memory a host array
filled with NaN before each block (a read of a word the block did not
write shows in the output), and the blocks of the persistent grid run one
after another. Two consumer warps a block (the card's: up to 4) and a few
SMs in the plan give several items a row and several a block. That checks
the spans, the phase of the 16-byte copies and stores, the split planes
and their skew, the table of taps, the windows and the stores before any
card sees the source; it says nothing of speed.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu_torch.kernels import build, fir
from ofdm_uhd_tpu_torch.phy.tables import resample_filter

_HARNESS = r"""
#include <algorithm>
#include <barrier>
#include <condition_variable>
#include <cstdint>
#include <limits>
#include <mutex>
#include <thread>
#include <vector>
#include "shift_body.cuh"

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
    int stages = 0;
    HostBar full[shiftk::kMaxStages], empty[shiftk::kMaxStages];
    void init(int producers, int consumers) {
        for (int s = 0; s < stages; ++s) {
            full[s].init(producers);
            empty[s].init(consumers);
        }
    }
    void arrive_full(int s) { full[s].arrive(); }
    void arrive_empty(int s) { empty[s].arrive(); }
    void wait_full(int s, unsigned parity) { full[s].wait(parity); }
    void wait_empty(int s, unsigned parity) { empty[s].wait(parity); }
};

// Blocks an SM holds at `threads` threads and `smem` bytes, a model of the
// card (a launch asks the occupancy API): the SM's 228 KB of shared
// memory at ~1 KB more a block than it asks, 2048 threads, 32 blocks, and
// 65,536 registers at 96 a thread.
static int model_per_sm(int threads, int smem) {
    int per = static_cast<int>(233472 / (smem + 1024));
    per = per < 2048 / threads ? per : 2048 / threads;
    per = per < 32 ? per : 32;
    return per < 65536 / (threads * 96) ? per : 65536 / (threads * 96);
}

// plan: tile, warps, stages, items, items_row, span, smem, r
static void report(const shiftk::Plan& g, long long* plan) {
    const long long v[8] = {g.tile, g.warps, g.stages, g.items,
                            g.items_row, g.span, g.smem, g.r};
    std::copy(v, v + 8, plan);
}

template <int kKind, int R>
static void run_blocks(const shiftk::Args& a, const shiftk::Plan& g,
                       int grid) {
    const float nan = std::numeric_limits<float>::quiet_NaN();
    std::vector<float4> smem(g.smem / sizeof(float4) + 1);
    for (long long b = 0; b < grid; ++b) {
        std::fill(smem.begin(), smem.end(), float4{nan, nan, nan, nan});
        auto* sm = reinterpret_cast<unsigned char*>(smem.data());
        HostPipe pipe;
        pipe.stages = g.stages;
        std::barrier<> all(g.threads()), consumers(g.consumers());
        std::vector<std::thread> threads;
        for (int t = 0; t < g.threads(); ++t)
            threads.emplace_back([&, t] {
                shiftk::shift_block<kKind, R>(
                    a, g, sm, b, grid, t, pipe,
                    [&] { all.arrive_and_wait(); },
                    [&] { consumers.arrive_and_wait(); });
            });
        for (auto& th : threads) th.join();
    }
}

template <int kKind>
static int run_r(const shiftk::Args& a, const shiftk::Plan& g, int grid) {
    switch (g.r) {
        case 3: run_blocks<kKind, 3>(a, g, grid); return 0;
        case 5: run_blocks<kKind, 5>(a, g, grid); return 0;
        case 7: run_blocks<kKind, 7>(a, g, grid); return 0;
        case 9: run_blocks<kKind, 9>(a, g, grid); return 0;
        default: return 2;
    }
}

extern "C" int shift_phase_host(const float* x, const float* w, float* y,
                                int rows, int n_in, int n_out, int nt,
                                int m, int pad, int r, int warps, int sms,
                                int grid, long long max_smem,
                                long long* plan) {
    shiftk::Plan g;
    shiftk::Args a{};
    if (!shiftk::args_at(x, w, y ? y : const_cast<float*>(x), a) ||
        !shiftk::plan_phase(g, rows, n_in, n_out, nt, m, pad, r, warps, sms,
                            max_smem, model_per_sm))
        return 1;
    report(g, plan);
    if (!y) return 0;
    return g.kind == shiftk::kFir ? run_r<shiftk::kFir>(a, g, grid)
                                  : run_r<shiftk::kDecim>(a, g, grid);
}

extern "C" int shift_interp_host(const float* x, const float* gm, float* y,
                                 int rows, int n, int l, int nd, int d_max,
                                 int r, int warps, int sms, int grid,
                                 long long max_smem, long long* plan) {
    shiftk::Plan g;
    shiftk::Args a{};
    if (!shiftk::args_at(x, gm, y ? y : const_cast<float*>(x), a) ||
        !shiftk::plan_interp(g, rows, n, l, nd, d_max, r, warps, sms,
                             max_smem, model_per_sm))
        return 1;
    report(g, plan);
    if (!y) return 0;
    return run_r<shiftk::kInterp>(a, g, grid);
}
"""

WARPS = 2             # consumer warps a block, most (the card's: 4)
SMS = 3               # SMs the plan spreads the items over (the card's: 132)
SMEM = 232448         # shared memory a block may use on the card
REL_TOL = 1e-5        # chip_smoke.py's REL_TOL
R_FIR, R_DECIM, R_INTERP = 9, 5, 9    # shift.cu's kRFir, kRDecim, kRInterp
GUARD = 4             # NaN samples kept before and after the outputs


@pytest.fixture(scope="module")
def shift_host(tmp_path_factory):
    """The body built with g++ into a temporary directory, loaded with
    ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the shift body cannot be built for the "
                    "host")
    out = tmp_path_factory.mktemp("shift_host")
    src = out / "harness.cpp"
    src.write_text(_HARNESS)
    lib = out / "libshift_host.so"
    done = subprocess.run(
        [gxx, "-O2", "-std=c++20", "-fPIC", "-shared", "-I",
         str(build.CSRC), "-o", str(lib), str(src), "-lpthread"],
        capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.shift_phase_host.argtypes = [p, p, p] + [i] * 10 + [ll, p]
    dll.shift_interp_host.argtypes = [p, p, p] + [i] * 9 + [ll, p]
    return dll


def _taps(nt: int, l: int = 8) -> np.ndarray:
    if nt == 3:
        return np.asarray([0.25, 0.5, 0.25], np.float32)
    if nt == 193:
        return np.asarray(resample_filter(l, 1), np.float32)
    return np.random.default_rng(nt).normal(size=nt).astype(np.float32)


def _aligned(n: int, dtype, offset: int = 0) -> np.ndarray:
    """A flat array of n elements whose first lies `offset` elements past
    a 16-byte boundary, NaN-filled."""
    dt = np.dtype(dtype)
    buf = np.empty(n + offset + 16, dt)
    skip = (-buf.ctypes.data % 16) // dt.itemsize
    out = buf[skip + offset: skip + offset + n]
    out[...] = np.nan
    if dt.kind == "c":
        out.imag = np.nan
    return out


def _rows(rows: int, n: int, seed: int, offset: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = _aligned(rows * n, np.complex64, offset).reshape(rows, n)
    x[...] = (rng.normal(size=(rows, n))
              + 1j * rng.normal(size=(rows, n))).astype(np.complex64)
    return x


def _plan(plan) -> dict:
    return dict(zip(("tile", "warps", "stages", "items", "items_row",
                     "span", "smem", "r"), plan.tolist()))


def _outputs(rows: int, n_out: int, offset: int):
    """The output rows, GUARD NaN samples before and after them."""
    flat = _aligned(rows * n_out + 2 * GUARD, np.complex64, offset)
    return flat, flat[GUARD:GUARD + rows * n_out].reshape(rows, n_out)


def _guards_kept(flat):
    assert np.isnan(flat[:GUARD].view(np.float32)).all()
    assert np.isnan(flat[-GUARD:].view(np.float32)).all()


def _phase(dll, x, taps, m, r=None, grid=3, warps=WARPS, sms=SMS,
           y_off=0):
    """The phase kind on x [rows, n_in] -> (y [rows, n_in // m], plan)."""
    rows, n_in = x.shape
    _, w, pad = fir._corr_weights(taps)
    n_out = n_in // m
    r = r or (R_FIR if m == 1 else R_DECIM)
    flat, y = _outputs(rows, n_out, y_off)
    plan = np.zeros(8, np.int64)
    assert dll.shift_phase_host(
        x.ctypes.data, w.ctypes.data, y.ctypes.data, rows, n_in, n_out,
        len(w), m, pad, r, warps, sms, grid, SMEM, plan.ctypes.data) == 0
    _guards_kept(flat)
    return y, _plan(plan)


def _interp(dll, x, l, taps, r=R_INTERP, grid=3, warps=WARPS, sms=SMS,
            y_off=0):
    rows, n = x.shape
    g, _, d_max = fir.branch_matrix(taps, l)
    g = np.ascontiguousarray(g, np.float32)
    flat, y = _outputs(rows, n * l, y_off)
    plan = np.zeros(8, np.int64)
    assert dll.shift_interp_host(
        x.ctypes.data, g.ctypes.data, y.ctypes.data, rows, n, l, g.shape[1],
        d_max, r, warps, sms, grid, SMEM, plan.ctypes.data) == 0
    _guards_kept(flat)
    return y, _plan(plan)


def _close(got, want):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= REL_TOL * float(np.abs(want).max()), err


def _decim_plain(x, m, taps):
    return fir.decim_plain(torch.from_numpy(x.copy()), m, taps).numpy()


def _interp_plain(x, l, taps):
    return fir.interp_plain(torch.from_numpy(x.copy()), l, taps).numpy()


@pytest.mark.parametrize("ntaps", [3, 8, 193, 194])
@pytest.mark.parametrize("m", [1, 2, 3, 8])
def test_phase_on_host_matches_plain(shift_host, m, ntaps):
    """Two rows of m * 1301 + 5 samples (n_in no multiple of the stride, of
    2 or of 16): several items a row, the last ragged, n // m outputs."""
    taps = _taps(ntaps)
    x = _rows(2, m * 1301 + 5, seed=m * 1000 + ntaps)
    got, plan = _phase(shift_host, x, taps, m)
    assert plan["items_row"] >= 2
    _close(got, _decim_plain(x, m, taps))


@pytest.mark.parametrize("ntaps", [3, 193])
@pytest.mark.parametrize("l", [2, 8])
def test_interp_on_host_matches_plain(shift_host, l, ntaps):
    """Interpolation by 2 and 8 on rows of an odd length, several items a
    row."""
    taps = _taps(ntaps, l)
    x = _rows(2, 1517, seed=l + ntaps)
    got, plan = _interp(shift_host, x, l, taps)
    assert plan["items_row"] >= 2
    _close(got, _interp_plain(x, l, taps))


@pytest.mark.parametrize("r", [3, 5, 7, 9])
def test_outputs_a_thread(shift_host, r):
    """Every odd kR the harness builds: the window's turns and the tap
    chunks (kR in 4, 8 or 12 floats) at the FIR, the decimation by 8 and
    the interpolation by 8."""
    taps = _taps(193)
    x = _rows(2, 8 * 700 + 3, seed=r)
    for m in (1, 8):
        got, plan = _phase(shift_host, x, taps, m, r=r)
        assert plan["r"] == r
        _close(got, _decim_plain(x, m, taps))
    xi = _rows(2, 900, seed=r + 1)
    got, _ = _interp(shift_host, xi, 8, taps, r=r)
    _close(got, _interp_plain(xi, 8, taps))


@pytest.mark.parametrize("rows", [1, 2, 5])
@pytest.mark.parametrize("m,ntaps", [(1, 193), (8, 193), (3, 8), (2, 3)])
def test_phase_rows(shift_host, m, ntaps, rows):
    """One, two and five rows of an odd length: the rows after the first
    start 8 bytes off a 16-byte boundary, and so do their outputs at an odd
    output count, so spans and stores straddle the rows' ends."""
    taps = _taps(ntaps)
    x = _rows(rows, m * 701 + 3, seed=rows + m)
    got, _ = _phase(shift_host, x, taps, m)
    _close(got, _decim_plain(x, m, taps))


@pytest.mark.parametrize("rows", [1, 2, 5])
@pytest.mark.parametrize("l", [2, 8])
def test_interp_rows(shift_host, l, rows):
    taps = _taps(193, l)
    x = _rows(rows, 503, seed=rows * l)
    got, _ = _interp(shift_host, x, l, taps)
    _close(got, _interp_plain(x, l, taps))


@pytest.mark.parametrize("x_off,y_off", [(0, 1), (1, 0), (1, 1)])
def test_rows_off_a_16_byte_boundary(shift_host, x_off, y_off):
    """x or y one sample past a 16-byte boundary: the producer copies from
    the boundary before it and the sums start one sample into the stage;
    the bulk store starts at the second output and the first goes alone."""
    taps = _taps(193)
    x = _rows(2, 8 * 1000 + 1, seed=x_off + 2 * y_off, offset=x_off)
    for m in (1, 2, 8):
        got, _ = _phase(shift_host, x, taps, m, y_off=y_off)
        _close(got, _decim_plain(x, m, taps))
    got, _ = _interp(shift_host, x[:, :777].copy(), 8, taps, y_off=y_off)
    _close(got, _interp_plain(x[:, :777], 8, taps))


@pytest.mark.parametrize("grid", [1, 2, 7])
@pytest.mark.parametrize("kind", ["fir", "decim", "interp"])
def test_persistent_grid_walks_every_item(shift_host, kind, grid):
    """More items than blocks: one block walks all of them, or a few share
    them unevenly; each block's ring (and its two output buffers) turns
    over several times."""
    taps = _taps(193)
    if kind == "interp":
        x = _rows(3, 1000, seed=grid)
        got, plan = _interp(shift_host, x, 8, taps, grid=grid, sms=20)
        _close(got, _interp_plain(x, 8, taps))
    else:
        m = 1 if kind == "fir" else 8
        x = _rows(3, 8 * 1500 + 7, seed=grid)
        got, plan = _phase(shift_host, x, taps, m, grid=grid, sms=9)
        _close(got, _decim_plain(x, m, taps))
    assert plan["items"] > grid * plan["stages"]


@pytest.mark.parametrize("kind", ["fir", "decim", "interp"])
def test_tile_cut_at_each_row_edge(shift_host, kind):
    """Rows whose last item holds 1, 2 or 3 outputs (a lone output at an
    odd or even flat index, a pair), a row shorter than a tile, and rows
    of exactly whole tiles."""
    taps = _taps(193)
    m = {"fir": 1, "decim": 8, "interp": 1}[kind]
    tile = (_interp(shift_host, _rows(1, 64, 0), 8, taps) if kind == "interp"
            else _phase(shift_host, _rows(1, 64 * m, 0), taps, m))[1]["tile"]
    for n_out in (tile + 1, tile + 2, 2 * tile + 3, tile // 2 + 1, tile,
                  2 * tile):
        if kind == "interp":
            x = _rows(3, n_out, seed=n_out)
            got, _ = _interp(shift_host, x, 8, taps)
            _close(got, _interp_plain(x, 8, taps))
        else:
            x = _rows(3, n_out * m + m - 1, seed=n_out)
            got, _ = _phase(shift_host, x, taps, m)
            _close(got, _decim_plain(x, m, taps))


@pytest.mark.parametrize("kind", ["fir", "decim", "interp"])
def test_rows_never_leak(shift_host, kind):
    """Each row alone gives the bits it gets among others, whatever the
    plan makes of the batch's item count (one SM, then the card's 132)."""
    taps = _taps(193)
    x = _rows(4, 8 * 700 + 1, seed=7)

    def run(rows, sms):
        if kind == "interp":
            return _interp(shift_host, rows[:, :701].copy(), 8, taps,
                           sms=sms)[0]
        return _phase(shift_host, rows, taps, 1 if kind == "fir" else 8,
                      sms=sms)[0]

    for sms in (1, 132):
        every = run(x, sms)
        for k in range(4):
            alone = run(np.ascontiguousarray(x[k:k + 1]), 1)
            assert np.array_equal(alone.view(np.uint32),
                                  every[k:k + 1].view(np.uint32))


def test_rows_are_zero_outside(shift_host):
    """A row of zeros between two rows of large values filters to zeros:
    no sample of a neighbouring row enters its span."""
    taps = _taps(193)
    x = _rows(3, 8 * 400 + 5, seed=3)
    x[0] *= 1e6
    x[2] *= 1e6
    x[1] = 0
    for m in (1, 8):
        got, _ = _phase(shift_host, x, taps, m)
        assert not np.abs(got[1]).any()
    got, _ = _interp(shift_host, x[:, :401].copy(), 8, taps)
    assert not np.abs(got[1]).any()


def _card_plan(dll, kind, rows, n, nt=193, m=8):
    """The card's plan (4 consumer warps at most, 132 SMs)."""
    plan = np.zeros(8, np.int64)
    none = ctypes.c_void_p(0)
    x = _rows(1, 2, seed=0)      # any 16-byte aligned pointer
    if kind == "interp":
        g, _, d_max = fir.branch_matrix(_taps(nt, m), m)
        assert dll.shift_interp_host(x.ctypes.data, none, none, rows, n, m,
                                     g.shape[1], d_max, R_INTERP, 4, 132, 1,
                                     SMEM, plan.ctypes.data) == 0
    else:
        _, w, pad = fir._corr_weights(_taps(nt))
        assert dll.shift_phase_host(x.ctypes.data, w.ctypes.data, none, rows,
                                    n, n // m, nt, m, pad,
                                    R_FIR if m == 1 else R_DECIM, 4, 132, 1,
                                    SMEM, plan.ctypes.data) == 0
    return _plan(plan)


@pytest.mark.parametrize("case", [
    ("fir", 1, 1 << 20, 193, 1), ("fir", 1, 1 << 20, 3, 1),
    ("decim", 1, 1 << 20, 193, 8), ("decim", 8, 4_138_472, 193, 8),
    ("interp", 1, 1 << 17, 193, 8), ("interp", 32, 16128, 193, 8)])
def test_card_plans_give_every_sm_two_items(shift_host, case):
    """At the shift phase's shapes (2^20 and C4's) the card's plan gives
    every one of 132 SMs at least two items, within a block's shared
    memory, at two or three stages."""
    kind, rows, n, nt, m = case
    p = _card_plan(shift_host, kind, rows, n, nt, m)
    assert p["items"] >= 2 * 132
    assert p["smem"] <= SMEM and p["stages"] in (2, 3)


def test_plan_refuses_what_shared_memory_cannot_hold(shift_host):
    """A decimation by 64 with 4096 taps stages 64 samples an output and a
    halo of 63 outputs: not even one warp's tile and two stages fit."""
    x = _rows(1, 2, seed=0)
    w = np.ones(4096, np.float32)
    plan = np.zeros(8, np.int64)
    assert shift_host.shift_phase_host(
        x.ctypes.data, w.ctypes.data, ctypes.c_void_p(0), 2, 1000, 15,
        4096, 64, 2048, R_DECIM, 4, 132, 1, SMEM, plan.ctypes.data) == 1
