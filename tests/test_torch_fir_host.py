"""K7's exact strided FIR body, csrc/fir_strided.cuh, built for the host
with g++ and run on the CPU: within 1e-5 of max|y| of kernels/fir.py's
decim_plain ('same' FIR and decimation) and decim_stream_plain (the
stream's valid mode), at strides 1, 2, 3 and 8, 3 to 194 taps, ragged
rows, 1, 2 and 5 rows.

The body runs unchanged, one std::thread a CUDA thread of a block: the
producer threads copy (a plain copy here), the consumer threads sum. The
ring's mbarriers are a mutex and a condition variable each, the
consumers' named barrier and the block's barrier a std::barrier each,
shared memory a host array filled with NaN before each block (a read of
a sample the block did not stage shows in the output), and the blocks of
the persistent grid run one after another, each walking its work items.
Two consumer groups of 20 threads (one to four in one test) split each
tile's taps, 8 producers copy, and grids of 1-7 blocks put several tiles
in a row and more work items than blocks. That checks the phase split,
the pair planes, the de-interleaving copy, the halo, the window, the
tail chunk and the ring's stages and barriers before any card sees the
source; it says nothing of speed.
"""

import ctypes
import importlib.util
import shutil
import subprocess
from pathlib import Path

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
#include "fir_strided.cuh"

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
    int stages = 1;
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

// plan: stages, threads, tile, items, shared memory bytes, pair planes
static void report(const firk::Plan& g, long long* plan) {
    plan[0] = g.stages;
    plan[1] = g.threads;
    plan[2] = g.tile;
    plan[3] = g.items;
    plan[4] = static_cast<long long>(g.smem_bytes());
    plan[5] = g.pairs;
}

extern "C" int fir_plan_host(int rows, int n_in, int n_out, int nt,
                             int stride, int pad_left, int groups, int per,
                             int producers, int stages, int aligned16,
                             long long max_smem, long long* plan) {
    firk::Plan g;
    if (!firk::plan_strided(g, rows, n_in, n_out, nt, stride, pad_left,
                            groups, per, producers, stages, aligned16 != 0,
                            static_cast<size_t>(max_smem)))
        return 1;
    report(g, plan);
    return 0;
}

template <int S>
static void run_blocks(const float2* xs, const float* w, float2* ys,
                       const firk::Plan& g, int grid) {
    const float nan = std::numeric_limits<float>::quiet_NaN();
    std::vector<float4> smem(g.smem_bytes() / sizeof(float4) + 1);
    for (long long b = 0; b < grid; ++b) {
        std::fill(smem.begin(), smem.end(), float4{nan, nan, nan, nan});
        float* sm = reinterpret_cast<float*>(smem.data());
        HostPipe pipe;
        pipe.stages = S;
        std::barrier<> all(g.block()), consumers(g.consumers);
        std::vector<std::thread> threads;
        for (int t = 0; t < g.block(); ++t)
            threads.emplace_back([&, t] {
                firk::strided_block<S>(
                    xs, w, ys, g, sm, b, grid, t, pipe,
                    [&] { all.arrive_and_wait(); },
                    [&] { consumers.arrive_and_wait(); });
            });
        for (auto& th : threads) th.join();
    }
}

extern "C" int fir_strided_host(const float* x, const float* w, float* y,
                                int rows, int n_in, int n_out, int nt,
                                int stride, int pad_left, int groups,
                                int per, int producers, int stages, int grid,
                                long long max_smem, long long* plan) {
    firk::Plan g;
    const bool aligned16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (!firk::plan_strided(g, rows, n_in, n_out, nt, stride, pad_left,
                            groups, per, producers, stages, aligned16,
                            static_cast<size_t>(max_smem)))
        return 1;
    report(g, plan);
    const auto* xs = reinterpret_cast<const float2*>(x);
    auto* ys = reinterpret_cast<float2*>(y);
    if (g.stages == 2)
        run_blocks<2>(xs, w, ys, g, grid);
    else
        run_blocks<1>(xs, w, ys, g, grid);
    return 0;
}
"""

GROUPS = 2          # consumer groups that split a tile's taps (firk::)
PER = 20            # threads a consumer group (the card's: 128)
PRODUCERS = 8       # producer threads a block (the card's: 64)
STAGES = 2          # stages of the ring (firk::kStages)
KR = 9              # outputs a thread (firk::kR)
SMEM = 227 * 1024   # shared memory a block may use on the card


@pytest.fixture(scope="module")
def fir_host(tmp_path_factory):
    """The body built with g++ into a temporary directory, loaded with
    ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the FIR body cannot be built for the "
                    "host")
    out = tmp_path_factory.mktemp("fir_host")
    src = out / "harness.cpp"
    src.write_text(_HARNESS)
    lib = out / "libfir_host.so"
    done = subprocess.run(
        [gxx, "-O2", "-std=c++20", "-fPIC", "-shared", "-I",
         str(build.CSRC), "-o", str(lib), str(src), "-lpthread"],
        capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.fir_plan_host.argtypes = [i, i, i, i, i, i, i, i, i, i, i, ll, p]
    dll.fir_strided_host.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, i,
                                     i, ll, p]
    return dll


def _taps(nt: int) -> np.ndarray:
    if nt == 3:
        return np.asarray([0.25, 0.5, 0.25], np.float32)
    if nt == 193:
        return np.asarray(resample_filter(8, 1), np.float32)
    return np.random.default_rng(nt).normal(size=nt).astype(np.float32)


def _rows(rows: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, n))
            + 1j * rng.normal(size=(rows, n))).astype(np.complex64)


def _run(dll, x, taps, stride, valid, grid, groups=GROUPS, per=PER,
         producers=PRODUCERS, stages=STAGES, max_smem=SMEM):
    """The host-built body on x [rows, n_in] ('same' or valid mode) ->
    (y, plan: stages, threads, tile, items, bytes)."""
    x = np.ascontiguousarray(x, np.complex64)
    rows, n_in = x.shape
    _, w, pad_l = fir._corr_weights(taps)
    if valid:
        pad_l, n_out = 0, (n_in - len(w)) // stride + 1
    else:
        n_out = n_in // stride
    y = np.full((rows, n_out), np.nan, np.complex64)
    plan = np.zeros(6, np.int64)
    assert dll.fir_strided_host(
        x.ctypes.data, w.ctypes.data, y.ctypes.data, rows, n_in, n_out,
        len(w), stride, pad_l, groups, per, producers, stages, grid,
        max_smem, plan.ctypes.data) == 0
    return y, plan


def _close(got, want):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


def _plain(x, taps, stride, valid):
    xt = torch.from_numpy(x)
    if valid:
        return fir.decim_stream_plain(xt, stride, taps).numpy()
    return fir.decim_plain(xt, stride, taps).numpy()


def _pairs(stride, ntaps, valid, rows, n_in):
    """Whether the plan takes pair planes (the pairs of phases 2q, 2q + 1
    16-byte aligned in every row): an even stride up to the taps, an even
    left pad, an even row length or one row."""
    pad = 0 if valid else ntaps - 1 - (ntaps - 1) // 2
    return (stride % 2 == 0 and stride <= ntaps and pad % 2 == 0
            and (n_in % 2 == 0 or rows == 1))


@pytest.mark.parametrize("tail", [5, 6])
@pytest.mark.parametrize("rows", [1, 2, 5])
@pytest.mark.parametrize("valid", [False, True], ids=["same", "valid"])
@pytest.mark.parametrize("ntaps", [3, 8, 193, 194])
@pytest.mark.parametrize("stride", [1, 2, 3, 8])
def test_body_on_host_matches_plain(fir_host, stride, ntaps, valid, rows,
                                    tail):
    """Rows of stride * 797 + tail samples: n_in is no multiple of the
    stride (nor, at tail 5, of 2), and the outputs (797 'same') fill four
    180-output tiles (two groups of 20 threads, 9 outputs each) and part
    of a fifth, whose last thread holds a part of its 9 outputs. At an
    even stride the plan stages pair planes wherever the pairs are 16-byte
    aligned, else phase planes. Three blocks walk the rows' tiles; every
    row is also run alone and must equal its row of the batch bit for bit
    (rows do not leak)."""
    taps = _taps(ntaps)
    n_in = stride * 797 + tail
    x = _rows(rows, n_in, seed=stride * 1000 + ntaps + rows + tail)
    got, plan = _run(fir_host, x, taps, stride, valid, grid=3)
    assert plan[0] == STAGES and plan[2] == PER * KR
    assert plan[3] >= 2 * rows          # several tiles a row
    assert plan[5] == _pairs(stride, ntaps, valid, rows, n_in)
    _close(got, _plain(x, taps, stride, valid))
    if rows > 1:
        one, _ = _run(fir_host, x[1:2], taps, stride, valid, grid=2)
        np.testing.assert_array_equal(one[0], got[1])


@pytest.mark.parametrize("grid", [1, 2, 7])
@pytest.mark.parametrize("stride", [1, 8])
def test_persistent_grid_walks_every_item(fir_host, stride, grid):
    """More work items (5 rows x 6 tiles) than blocks: one block walks all
    of them, or a few blocks share them unevenly."""
    taps = _taps(193)
    x = _rows(5, stride * 1000 + 3, seed=grid)
    got, plan = _run(fir_host, x, taps, stride, False, grid=grid)
    assert plan[3] == 30 and plan[3] > grid
    _close(got, _plain(x, taps, stride, False))


@pytest.mark.parametrize("ntaps", [3, 8, 193])
@pytest.mark.parametrize("stride", [1, 3, 8])
@pytest.mark.parametrize("groups,per", [(1, 40), (3, 12), (4, 10)])
def test_groups_split_the_taps(fir_host, groups, per, stride, ntaps):
    """One to four groups share each tile's taps, split by the taps' order
    over all phases to within a chunk of 9 (at 3 taps and four groups one
    group has none); the groups' sums are added in order."""
    taps = _taps(ntaps)
    x = _rows(2, stride * 400 + 11, seed=groups * 100 + stride + ntaps)
    got, plan = _run(fir_host, x, taps, stride, False, grid=2,
                     groups=groups, per=per)
    assert plan[2] == per * KR
    _close(got, _plain(x, taps, stride, False))


@pytest.mark.parametrize("valid", [False, True], ids=["same", "valid"])
@pytest.mark.parametrize("stride,ntaps", [(2, 19), (8, 73), (8, 75),
                                          (4, 37)])
def test_pair_planes_at_odd_full(fir_host, stride, ntaps, valid):
    """Pair planes where a phase of the last full-length pair has one tap
    fewer than its partner (an odd count of full-length phases) and nd =
    10, one step past a chunk of 9: the pair's second chunk holds one
    step, which a miscounted pair would drop."""
    taps = _taps(ntaps)
    x = _rows(2, stride * 700 + 2, seed=ntaps + stride)
    got, plan = _run(fir_host, x, taps, stride, valid, grid=2)
    assert plan[5] == _pairs(stride, ntaps, valid, 2, x.shape[1])
    _close(got, _plain(x, taps, stride, valid))


@pytest.mark.parametrize("stride", [1, 3])
def test_row_shorter_than_the_taps(fir_host, stride):
    """'Same' rows of 100 samples under 193 taps: every output's window
    runs past both ends of its row."""
    taps = _taps(193)
    x = _rows(2, 100, seed=stride)
    got, _ = _run(fir_host, x, taps, stride, False, grid=2)
    _close(got, _plain(x, taps, stride, False))


def _smem(stride: int, nt: int, threads: int, stages: int,
          groups: int = GROUPS, pairs: bool = False) -> int:
    """Shared-memory bytes of a plan, as firk::plan_strided lays it out:
    the taps in chunks of 9 padded to 12 floats a phase and one chunk of
    zeros, each group's sums of the tile, `stages` stages of planes (phase
    planes of whole 16-float2 rows, or pair planes of whole 8-float4 rows,
    plus a skew), and two 8-byte barriers a stage."""
    phases = min(stride, nt)
    nd = -(-nt // stride) if stride < nt else 1
    es, row = (2, 8) if pairs else (1, 16)
    planes = phases // es
    skew = -(-row // planes) if planes > 1 else 0
    lp = -(-(threads * KR + nd - 1) // row) * row + skew
    up4 = lambda n: -(-n // 4) * 4                      # noqa: E731
    return 4 * ((phases * -(-nd // KR) + 1) * 12
                + groups * up4(2 * threads * KR)
                + stages * up4(2 * es * planes * lp)) + 16 * stages


@pytest.mark.parametrize("stride", [1, 2, 8])
def test_one_stage_and_a_narrow_tile(fir_host, stride):
    """A shared-memory budget just under two stages of one thread's tile:
    the plan falls back to one stage of the widest tile that fits, narrower
    than the block, and the idle threads still copy and wait."""
    taps = _taps(194)
    budget = _smem(stride, 194, 1, 2) - 4
    threads = max(t for t in range(1, PER + 1)
                  if _smem(stride, 194, t, 1) <= budget)
    assert 2 <= threads < PER
    x = _rows(2, stride * 500 + 7, seed=stride + 50)
    got, plan = _run(fir_host, x, taps, stride, False, grid=2,
                     max_smem=budget)
    assert plan.tolist()[:2] == [1, threads]
    assert plan[4] == _smem(stride, 194, threads, 1)
    _close(got, _plain(x, taps, stride, False))


def test_stride_above_the_taps(fir_host):
    """Stride 16 over 5 taps: 5 phase planes with one tap each, the other
    11 phases neither staged nor summed."""
    taps = _taps(8)[:5]
    x = _rows(2, 16 * 300 + 9, seed=16)
    got, _ = _run(fir_host, x, taps, 16, False, grid=2)
    _close(got, _plain(x, taps, 16, False))
    got, _ = _run(fir_host, x, taps, 16, True, grid=2)
    _close(got, _plain(x, taps, 16, True))


def test_plan_at_c4(fir_host):
    """The card's plan (two consumer groups of 128 threads, 128 producers,
    two stages) at C4's decimation [8, 4,138,472] -> 517,309 (pair planes:
    stride 8, left pad 96, rows of an even length) and its baseband FIR [8,
    517,309] (one phase plane): two stages of 1152-output tiles within 227
    KB."""
    plan = np.zeros(6, np.int64)
    for n_in, stride, pad in ((4_138_472, 8, 96), (517_309, 1, 96)):
        assert fir_host.fir_plan_host(8, n_in, n_in // stride, 193, stride,
                                      pad, 2, 128, 128, 2, 1, SMEM,
                                      plan.ctypes.data) == 0
        stages, threads, tile, items, smem, pairs = plan.tolist()
        assert (stages, threads, tile, pairs) == (2, 128, 1152, stride == 8)
        assert items == 8 * -(-(n_in // stride) // 1152)
        assert smem == _smem(stride, 193, 128, 2, pairs=pairs) <= SMEM


def test_ablation_variants_apply_to_the_body():
    """scripts/k7_ablation.py's variants (each a text substitution of
    fir_strided.cuh) still find the source they change, once each."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "k7_ablation.py"
    spec = importlib.util.spec_from_file_location("k7_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    header = (build.CSRC / mod.HEADER).read_text()
    assert mod.VARIANTS["as_built"] == ((), True)
    for name, (subs, _) in mod.VARIANTS.items():
        assert (mod.variant_source(header, subs) != header) == bool(subs), name
