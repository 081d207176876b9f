"""K7's exact interpolation body, csrc/fir_interp.cuh, built for the host
with g++ and run on the CPU: within 1e-5 of max|y| of kernels/fir.py's
interp_plain at l = 1, 2, 3, 8 and 40 (more branches than a block has
threads), with the resampler's filters (nd = 25 branch taps, the
25-tap body), shorter branches (the 8- and 16-tap bodies), 26-32 taps
(the 32-tap body, zero taps past nd) and branches above the register
limit (the 32-tap body in chunks), ragged rows and 1-5 rows.

The body runs unchanged, one std::thread a CUDA thread of a block, the
block's barrier a std::barrier, its cp.async copies plain copies, shared
memory a host array filled with NaN before each block (a read of a
sample or tap the block did not stage shows in the output), the blocks
of the persistent grid one after another, each walking its work items
through the two stages. Blocks of 24 and 40 threads (the card's: 128)
put several tiles in a row. That checks the tiling, the halo, the
window, the taps' chunks, the stages and the stores' indices before any
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

torch.set_num_threads(2)

_HARNESS = r"""
#include <algorithm>
#include <barrier>
#include <limits>
#include <thread>
#include <vector>
#include "fir_interp.cuh"

// plan: taps, chunks, q-blocks, inputs a tile, tiles, work items, bytes
static void report(const fii::Plan& g, long long* plan) {
    plan[0] = g.taps;
    plan[1] = g.chunks;
    plan[2] = g.qb;
    plan[3] = g.tq;
    plan[4] = g.tiles;
    plan[5] = g.work;
    plan[6] = static_cast<long long>(g.smem_bytes());
}

// the persistent grid's blocks one after another, each walking its items
template <int ND>
static void run_blocks(const float2* x, const float* g, float2* y,
                       const fii::Plan& p, long long grid) {
    const float nan = std::numeric_limits<float>::quiet_NaN();
    std::vector<float4> smem(p.smem_bytes() / sizeof(float4) + 1);
    for (long long b = 0; b < grid; ++b) {
        std::fill(smem.begin(), smem.end(), float4{nan, nan, nan, nan});
        float* sm = reinterpret_cast<float*>(smem.data());
        std::barrier<> all(p.threads);
        std::vector<std::thread> threads;
        for (int t = 0; t < p.threads; ++t)
            threads.emplace_back([&, t] {
                fii::interp_block<ND>(x, g, y, p, sm, b, grid, t,
                                      [&] { all.arrive_and_wait(); });
            });
        for (auto& th : threads) th.join();
    }
}

extern "C" int fir_interp_plan(int rows, int n, int l, int nd, int d_max,
                               int threads, long long max_smem,
                               long long* plan) {
    fii::Plan p;
    if (!fii::plan_interp(p, rows, n, l, nd, d_max, threads,
                          static_cast<size_t>(max_smem)))
        return 1;
    report(p, plan);
    return 0;
}

extern "C" int interp_host(const float* x, const float* g, float* y,
                           int rows, int n, int l, int nd, int d_max,
                           int threads, int grid, long long max_smem,
                           long long* plan) {
    fii::Plan p;
    if (!fii::plan_interp(p, rows, n, l, nd, d_max, threads,
                          static_cast<size_t>(max_smem)))
        return 1;
    report(p, plan);
    const auto* xs = reinterpret_cast<const float2*>(x);
    auto* ys = reinterpret_cast<float2*>(y);
    switch (p.taps) {
        case 8: run_blocks<8>(xs, g, ys, p, grid); break;
        case 16: run_blocks<16>(xs, g, ys, p, grid); break;
        case 25: run_blocks<25>(xs, g, ys, p, grid); break;
        default: run_blocks<fii::kMaxTaps>(xs, g, ys, p, grid);
    }
    return 0;
}
"""

THREADS = 24        # threads a block here (the card's: 128)
GRID = 3            # blocks of the persistent grid here (the card's: those
                    # it holds at once)
KQ = 12             # inputs a thread sums (fii::kQ)
SMEM = 227 * 1024   # shared memory a block may use on the card


@pytest.fixture(scope="module")
def interp_host(tmp_path_factory):
    """The body built with g++ into a temporary directory, loaded with
    ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the interpolation body cannot be built "
                    "for the host")
    out = tmp_path_factory.mktemp("interp_host")
    src = out / "harness.cpp"
    src.write_text(_HARNESS)
    lib = out / "libinterp_host.so"
    done = subprocess.run(
        [gxx, "-O2", "-std=c++20", "-fPIC", "-shared", "-I",
         str(build.CSRC), "-o", str(lib), str(src), "-lpthread"],
        capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.interp_host.argtypes = [p, p, p, i, i, i, i, i, i, i, ll, p]
    dll.fir_interp_plan.argtypes = [i, i, i, i, i, i, ll, p]
    return dll


def _taps(l: int, nt: int | None) -> np.ndarray:
    """The resampler's prototype for l (None), or nt seeded taps."""
    if nt is None:
        return np.asarray(resample_filter(l, 1), np.float32)
    return np.random.default_rng(nt + l).normal(size=nt).astype(np.float32)


def _rows(rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, n))
            + 1j * rng.normal(size=(rows, n))).astype(np.complex64)


def _run(dll, x, l, taps, threads=THREADS, grid=GRID):
    """The host-built body on x [rows, n] by a persistent grid of at most
    `grid` blocks -> (y [rows, n * l], plan)."""
    x = np.ascontiguousarray(x, np.complex64)
    rows, n = x.shape
    g, _, d_max = fir.branch_matrix(taps, l)
    g = np.ascontiguousarray(g, np.float32)
    y = np.full((rows, n * l), np.nan, np.complex64)
    plan = np.zeros(7, np.int64)
    assert dll.fir_interp_plan(rows, n, l, g.shape[1], d_max, threads,
                               SMEM, plan.ctypes.data) == 0
    assert dll.interp_host(x.ctypes.data, g.ctypes.data, y.ctypes.data,
                           rows, n, l, g.shape[1], d_max, threads,
                           min(grid, int(plan[5])), SMEM,
                           plan.ctypes.data) == 0
    return y, plan


def _close(got, want):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


def _plain(x, l, taps):
    return fir.interp_plain(torch.from_numpy(x), l, taps).numpy()


def _nd(l, taps):
    return fir.branch_matrix(taps, l)[0].shape[1]


# (l, taps): the resampler's filters (nd = 25) and seeded taps for the
# other bodies: nd 2 and 5 (8 taps), 13 (16), 29 (32, three zero taps),
# 32, and 33, 41 and 71 (chunks of 32: two and three)
CASES = [(1, None), (2, None), (3, None), (8, None), (2, 3), (8, 33),
         (3, 37), (2, 57), (2, 63), (8, 256), (2, 81), (8, 321), (3, 210)]


@pytest.mark.parametrize("tail", [0, 5])
@pytest.mark.parametrize("rows", [1, 2, 5])
@pytest.mark.parametrize("l,nt", CASES)
def test_body_on_host_matches_plain(interp_host, l, nt, rows, tail):
    """Rows of 3 tiles plus `tail` inputs (a ragged last tile, whose
    threads hold part of their 12 inputs); every row is also run alone and
    must equal its row of the batch bit for bit (rows do not leak)."""
    taps = _taps(l, nt)
    qb = max(THREADS // l, 1)
    n = 3 * qb * KQ + tail
    x = _rows(rows, n, seed=l * 1000 + len(taps) + rows + tail)
    got, plan = _run(interp_host, x, l, taps)
    nd = _nd(l, taps)
    want_taps = 8 if nd <= 8 else 16 if nd <= 16 else 25 if nd <= 25 else 32
    assert plan[0] == want_taps and plan[1] == -(-nd // want_taps)
    assert plan[3] == qb * KQ and plan[4] == -(-n // (qb * KQ))
    _close(got, _plain(x, l, taps))
    if rows > 1:
        one, _ = _run(interp_host, x[1:2], l, taps)
        np.testing.assert_array_equal(one[0], got[1])


@pytest.mark.parametrize("l,nt", [(40, 100), (40, 2000), (25, 30)])
def test_more_branches_than_threads(interp_host, l, nt):
    """l above the block's 24 threads: one q-block a tile, each thread
    taking several branches (items) of it; at 2000 taps nd = 51 (two
    chunks)."""
    taps = _taps(l, nt)
    x = _rows(2, 31, seed=l + nt)
    got, plan = _run(interp_host, x, l, taps)
    assert plan[2] == 1 and plan[3] == KQ
    _close(got, _plain(x, l, taps))


@pytest.mark.parametrize("n", [1, 4, 9, 10])
def test_rows_shorter_than_the_branches(interp_host, n):
    """Rows of 1-10 inputs under 25 branch taps: every output's window
    runs past both ends of its row."""
    taps = _taps(8, None)
    x = _rows(3, n, seed=n)
    got, _ = _run(interp_host, x, 8, taps, threads=40)
    _close(got, _plain(x, 8, taps))


def test_card_block_at_c4(interp_host):
    """The card's block (128 threads: 16 q-blocks of 8 branches, 192
    inputs a tile) on two of C4's TX frames [2, 16128] by 8 (193 taps, nd
    = 25): 84 tiles a row, 16,640 bytes of shared memory (the taps at a
    stride of 28 floats, two stages of 216 samples and the tile's 1536
    outputs), 7 blocks walking the 168 work items."""
    taps = _taps(8, None)
    x = _rows(2, 16128, seed=8)
    got, plan = _run(interp_host, x, 8, taps, threads=128, grid=7)
    taps_n, chunks, qb, tq, tiles, work, smem = plan.tolist()
    assert (taps_n, chunks, qb, tq, tiles, work) == (25, 1, 16, 192, 84,
                                                     168)
    assert smem == 4 * 8 * 28 + 8 * (2 * (192 + 24) + 192 * 8) <= SMEM
    _close(got, _plain(x, 8, taps))


@pytest.mark.parametrize("grid", [1, 2, 5])
def test_persistent_grid_walks_every_item(interp_host, grid):
    """More work items (3 rows x 4 tiles) than blocks: one block walks
    all of them through both stages, or a few share them unevenly."""
    taps = _taps(8, None)
    x = _rows(3, 4 * 3 * KQ - 2, seed=grid)
    got, plan = _run(interp_host, x, 8, taps, grid=grid)
    assert plan[5] == 12
    _close(got, _plain(x, 8, taps))
