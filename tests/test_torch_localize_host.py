"""K1's warp body, csrc/localize_warp.cuh, built for the host with g++ and
run on the CPU: d exactly and eps within 1e-6 of kernels/localize.py's
localize_plain, and eps bit for bit the body's own angle of P at the
plain version's peak (so a wrong peak index shows even where two P
samples have close angles), at the spans of C2 (80), C3 (288) and C4
(1152), at spans inside a template's masked tail and at spans above 1152
that take the block body (one slot a block), on windows with ties at the peak and at the
plateau's edges, windows that run past nd, sentinel slots and mixed
captures.

The body runs unchanged, one std::thread a lane of a warp, __shfl_sync
and __reduce_min/max_sync a slot a lane and a std::barrier, the warps of
a launch one after another. That checks the slots a warp takes, the
masked windows, the sentinels' result, the first-index tie-break and the
speculative P before any card sees the source; it says nothing of speed.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu_torch.kernels import build, localize

torch.set_num_threads(2)

_HARNESS = r"""
#include <barrier>
#include <deque>
#include <thread>
#include <vector>
#include "localize_warp.cuh"

// A lane's view of the warp: a shuffle or a reduction writes the lane's
// value into a slot, waits for every lane, and reads; two slot arrays in
// turn, so that a lane rewrites one only after the next barrier
struct HostWarp {
    std::barrier<>* bar;
    unsigned (*slots)[32];
    int lane;
    mutable int turn = 0;
    void exchange(unsigned v) const {
        slots[turn][lane] = v;
        bar->arrive_and_wait();
    }
    unsigned shfl(unsigned v, int src) const {
        exchange(v);
        const unsigned got = slots[turn][src];
        turn ^= 1;
        return got;
    }
    int reduce_min(int v) const {
        exchange(static_cast<unsigned>(v));
        int r = static_cast<int>(slots[turn][0]);
        for (int i = 1; i < 32; ++i)
            r = lzk::imin(r, static_cast<int>(slots[turn][i]));
        turn ^= 1;
        return r;
    }
    int reduce_max(int v) const {
        exchange(static_cast<unsigned>(v));
        int r = static_cast<int>(slots[turn][0]);
        for (int i = 1; i < 32; ++i)
            r = lzk::imax(r, static_cast<int>(slots[turn][i]));
        turn ^= 1;
        return r;
    }
};

// 32 lanes walk the launch's warps in order
template <class Body>
static void run_warps(long long warps, Body body) {
    std::barrier<> bar(32);
    unsigned slots[2][32];
    std::vector<std::thread> lanes;
    for (int lane = 0; lane < 32; ++lane)
        lanes.emplace_back([&, lane] {
            HostWarp warp{&bar, slots, lane};
            for (long long w = 0; w < warps; ++w) body(warp, lane, w);
        });
    for (auto& t : lanes) t.join();
}

// localize_block's launch: `warps` warps a block, a slot a block, every
// thread walking the blocks in order, with a barrier between two blocks
// (each block on the card has shared memory of its own); __syncthreads a
// std::barrier
static void block_launch(const lzk::Args& a, long long total, int warps) {
    std::barrier<> all(32 * warps);
    std::deque<std::barrier<>> bars;
    for (int w = 0; w < warps; ++w) bars.emplace_back(32);
    std::vector<unsigned> slots(2 * 32 * warps);
    lzk::BlockSmem sm;
    std::vector<std::thread> threads;
    for (int tid = 0; tid < 32 * warps; ++tid)
        threads.emplace_back([&, tid] {
            const int w = tid / 32;
            HostWarp warp{&bars[w],
                          reinterpret_cast<unsigned (*)[32]>(&slots[64 * w]),
                          tid % 32};
            for (long long slot = 0; slot < total; ++slot) {
                lzk::localize_block(a, warp, [&] { all.arrive_and_wait(); },
                                    sm, tid, warps, slot);
                all.arrive_and_wait();
            }
        });
    for (auto& t : threads) t.join();
}

// localize_kernel's launch: row_stride(mf) warps a row, warp k of row r
// taking slots k, k + S, .. of it
template <int W>
static void rows_launch(const lzk::Args& a) {
    const int stride = lzk::row_stride(a.mf);
    run_warps(static_cast<long long>(a.caps) * stride,
              [&](const HostWarp& warp, int lane, long long w) {
        lzk::localize_row_slots<W>(a, warp, lane, w / stride,
                                   static_cast<int>(w % stride));
    });
}

// the launch of localize.cu: W of the span's template, or localize_block
// at `warps` warps a block (the card's: 16); returns W (0: the block body)
extern "C" int localize_host(const float* m, const float* p, const int* cand,
                             int* d, float* eps, int caps, int nd, int mf,
                             int span, int cp_half, float rel, int warps) {
    const lzk::Args a{m, reinterpret_cast<const float2*>(p), cand, d, eps,
                      caps, nd, mf, span, cp_half, rel};
    const long long total = static_cast<long long>(caps) * mf;
    const int w = lzk::window_loads(span);
    switch (w) {
        case 3: rows_launch<3>(a); break;
        case 9: rows_launch<9>(a); break;
        case 36: rows_launch<36>(a); break;
        default: block_launch(a, total, warps);
    }
    return w;
}

extern "C" int row_stride_host(int mf) { return lzk::row_stride(mf); }

extern "C" float eps_host(float re, float im) { return lzk::eps_of(re, im); }
"""

CP = {80: 16, 288: 32, 1152: 128}     # C2's, C3's and C4's cyclic prefix
BLOCK_WARPS = 2     # warps a block of the block body (the card's: 16)


@pytest.fixture(scope="module")
def k1_host(tmp_path_factory):
    """The K1 body built with g++ (no contraction: -ffp-contract=off) into
    a temporary directory, loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the K1 body cannot be built for the host")
    out = tmp_path_factory.mktemp("k1_host")
    src = out / "harness.cpp"
    src.write_text(_HARNESS)
    lib = out / "libk1_host.so"
    done = subprocess.run(
        [gxx, "-O2", "-std=c++20", "-ffp-contract=off", "-fPIC", "-shared",
         "-I", str(build.CSRC), "-o", str(lib), str(src), "-lpthread"],
        capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.localize_host.argtypes = [p, p, p, p, p, i, i, i, i, i, f, i]
    dll.localize_host.restype = i
    dll.row_stride_host.argtypes = [i]
    dll.row_stride_host.restype = i
    dll.eps_host.argtypes = [f, f]
    dll.eps_host.restype = f
    return dll


def _run(dll, m, p, cand, span, cp, rel=0.9, warps=BLOCK_WARPS):
    """The host-built body -> (d, eps, W of its template, 0 the block
    body, run at `warps` warps a block)."""
    m = np.ascontiguousarray(m, np.float32)
    p = np.ascontiguousarray(p, np.complex64)
    cand = np.ascontiguousarray(cand, np.int32)
    caps, nd = m.shape
    mf = cand.shape[1]
    d = np.full((caps, mf), -7, np.int32)
    eps = np.full((caps, mf), np.nan, np.float32)
    w = dll.localize_host(m.ctypes.data, p.ctypes.data, cand.ctypes.data,
                          d.ctypes.data, eps.ctypes.data, caps, nd, mf,
                          span, cp // 2, float(np.float32(rel)), warps)
    return d, eps, w


def _check(dll, m, p, cand, span, cp, rel=0.9, warps=BLOCK_WARPS):
    """d exact and eps within 1e-6 of localize_plain; eps bit for bit the
    body's angle of P at the plain version's peak (first-index argmax of
    the window, zeros past nd)."""
    d, eps, w = _run(dll, m, p, cand, span, cp, rel, warps)
    d_p, eps_p = localize.localize_plain(
        torch.from_numpy(m), torch.from_numpy(p),
        torch.from_numpy(cand.astype(np.int32)), span, cp, rel)
    np.testing.assert_array_equal(d, d_p.numpy())
    assert float(np.abs(eps - eps_p.numpy()).max()) <= 1e-6
    caps, nd = m.shape
    m_pad = np.concatenate([m, np.zeros((caps, span), np.float32)], 1)
    p_pad = np.concatenate([p, np.zeros((caps, 1), np.complex64)], 1)
    for r in range(caps):
        for s, c in enumerate(np.clip(cand[r], 0, nd)):
            g = min(c + int(np.argmax(m_pad[r, c:c + span])), nd)
            want = dll.eps_host(float(p_pad[r, g].real),
                                float(p_pad[r, g].imag))
            assert np.float32(want).tobytes() == eps[r, s].tobytes(), (r, s)
    return w


def _capture(caps, nd, seed, levels=8):
    """Metric rows of few levels (many ties at every peak) in [0, 1], with
    plateaus of one value and edges at exactly 0.9 * peak in float32, and
    complex P."""
    rng = np.random.default_rng(seed)
    m = (rng.integers(0, levels, (caps, nd)) / levels).astype(np.float32)
    for r in range(caps):
        for start in rng.integers(0, max(nd - 40, 1), 6):
            m[r, start:start + 30] = 1.0
            m[r, start + 30:start + 33] = np.float32(0.9) * np.float32(1.0)
            m[r, max(start - 2, 0):start] = np.nextafter(
                np.float32(0.9), np.float32(0))
    p = (rng.normal(size=(caps, nd))
         + 1j * rng.normal(size=(caps, nd))).astype(np.complex64)
    return m, p


def _candidates(caps, nd, mf, found, seed, span):
    """Per row the first `found[r]` slots ascending offsets (some within a
    span of nd, so their windows run past it, one negative), the rest the
    sentinel nd, and one offset past nd (clamped to it)."""
    rng = np.random.default_rng(seed)
    cand = np.full((caps, mf), nd, np.int64)
    for r in range(caps):
        k = found[r]
        if k == 0:
            continue
        pos = np.sort(rng.integers(0, nd, k))
        pos[-1] = max(nd - span // 3, 0)
        pos[0] = -5 if k > 2 else pos[0]
        cand[r, :k] = pos
        if k < mf:
            cand[r, -1] = nd + 17
    return cand.astype(np.int32)


@pytest.mark.parametrize("span,want_w", [(80, 3), (288, 9), (1152, 36),
                                         (200, 9), (33, 3), (1500, 0),
                                         (2400, 0)])
@pytest.mark.parametrize("caps", [1, 3])
def test_body_on_host_matches_plain(k1_host, span, want_w, caps):
    """Found and sentinel slots mixed in each row, a different number of
    found slots a capture, 37 slots a row (no multiple of a warp's
    slots); 200 and 33 sit in the masked tail of the 9- and 3-load
    templates, 1500 and 2400 take the block body (at 2 warps of 18 loads
    a thread, rounds of 1152 samples: two and three rounds)."""
    cp = CP.get(span, 16)
    nd = 6 * span + 311
    m, p = _capture(caps, nd, seed=span + caps)
    cand = _candidates(caps, nd, 37, [20, 37, 1][:caps], seed=span, span=span)
    assert _check(k1_host, m, p, cand, span, cp) == want_w


@pytest.mark.parametrize("span", [80, 288, 1152, 1500])
def test_sentinel_slots(k1_host, span):
    """Rows of sentinels only (cand = nd, or past nd): each gives the
    result of a window of zeros, as the plain version does: the peak at
    offset 0, the plateau [0, span - 1], so d = max(nd + (span - 1) // 2 -
    cp // 2, 0), and P = 0, so eps = angle(0) / pi = 0."""
    cp = CP.get(span, 16)
    for nd in (3 * span, 10):
        m, p = _capture(2, nd, seed=nd)
        cand = np.full((2, 11), nd, np.int32)
        cand[1, ::3] = nd + 5
        d, eps, _ = _run(k1_host, m, p, cand, span, cp)
        np.testing.assert_array_equal(
            d, np.full((2, 11), max(nd + (span - 1) // 2 - cp // 2, 0)))
        np.testing.assert_array_equal(eps, np.zeros((2, 11), np.float32))
        _check(k1_host, m, p, cand, span, cp)


@pytest.mark.parametrize("span", [80, 288, 1152])
def test_windows_past_nd(k1_host, span):
    """Every window runs past nd (candidates in the last span of the row,
    the last at nd - 1): the samples past nd count as zeros, also where
    the row ends on a rising metric, so the peak lies at the row's end."""
    cp = CP[span]
    nd = 2 * span + 5
    m, p = _capture(2, nd, seed=span)
    m[1, -40:] = np.linspace(0.1, 0.95, 40, dtype=np.float32)
    cand = np.arange(nd - span, nd, max(span // 17, 1), dtype=np.int32)
    cand = np.stack([cand, cand[::-1].copy()])
    cand[:, -1] = nd - 1
    _check(k1_host, m, p, cand, span, cp)


@pytest.mark.parametrize("span", [80, 288])
def test_ties_in_every_lane(k1_host, span):
    """Windows of two levels, so every lane's first maximum ties with
    others: the warp's first-index peak (and P there) must be the
    plain version's; and a window of one value, whose plateau is all of
    it and whose peak is its first sample."""
    cp = CP[span]
    nd = 4 * span
    rng = np.random.default_rng(span)
    m = rng.integers(0, 2, (2, nd)).astype(np.float32)
    m[1, :] = 0.5
    p = (rng.normal(size=(2, nd)) + 1j * rng.normal(size=(2, nd))).astype(
        np.complex64)
    cand = np.sort(rng.integers(0, nd, (2, 45)), axis=1).astype(np.int32)
    _check(k1_host, m, p, cand, span, cp)


@pytest.mark.parametrize("rel", [0.5, 0.9, 1.0])
def test_plateau_thresholds(k1_host, rel):
    """The plateau at rel * peak (the float32 product) for another rel,
    and rel = 1, where only the peak's ties are on the plateau."""
    m, p = _capture(2, 2000, seed=int(rel * 10))
    cand = _candidates(2, 2000, 29, [29, 12], seed=5, span=288)
    _check(k1_host, m, p, cand, 288, 32, rel)


def test_row_stride_in_the_body(k1_host):
    """A warp takes 4 slots of a row, S = ceil(mf / 4) apart: C3's 4120
    slots a row in 1030 warps, C4's 152 in 38, c2_pallas's 536 in 134."""
    assert [k1_host.row_stride_host(mf) for mf in (4120, 152, 536, 37, 1,
                                                   3)] == [1030, 38, 134,
                                                           10, 1, 1]


@pytest.mark.parametrize("order", ["reversed", "shuffled", "all_found"])
@pytest.mark.parametrize("span", [80, 288, 1152])
def test_any_order_of_candidates(k1_host, span, order):
    """Candidates in another order than the detector's (found first,
    ascending): sentinels first, shuffled, or every slot found, so a warp
    takes up to four found slots in turn."""
    cp = CP[span]
    nd = 5 * span + 77
    m, p = _capture(2, nd, seed=span)
    cand = _candidates(2, nd, 23, [9, 23], seed=span + 1, span=span)
    rng = np.random.default_rng(span)
    if order == "reversed":
        cand = cand[:, ::-1].copy()
    elif order == "shuffled":
        cand = np.stack([rng.permutation(row) for row in cand])
    else:
        cand = np.sort(rng.integers(0, nd, cand.shape), 1).astype(np.int32)
    _check(k1_host, m, p, cand, span, cp)


@pytest.mark.parametrize("levels", [2, 8])
@pytest.mark.parametrize("warps", [1, 3])
@pytest.mark.parametrize("span", [1153, 4608])
def test_block_body_warps(k1_host, span, warps, levels):
    """The block body (spans above 1152: big_nsc 4096's 4608, and one past
    the last template) at 1 and 3 warps a block: each warp's first maximum
    and plateau bounds meet in shared memory, ties at the peak across
    warps (two levels) resolved to the first index."""
    nd = 3 * span + 101
    m, p = _capture(2, nd, seed=span + warps, levels=levels)
    cand = _candidates(2, nd, 9, [7, 2], seed=warps, span=span)
    assert _check(k1_host, m, p, cand, span, 512, warps=warps) == 0


def test_ab_variants_apply_to_the_bodies():
    """scripts/k1_interp_ab.py's variants (text substitutions of
    localize_warp.cuh and fir_interp.cuh) still find the source they
    change, once each, and each names the kernel whose files it copies."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "scripts" / "k1_interp_ab.py"
    spec = importlib.util.spec_from_file_location("k1_interp_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, (kernel, subs, _) in mod.VARIANTS.items():
        assert set(subs) <= set(mod.FILES[kernel]), name
        assert mod.kernel_of(name) == kernel
        for f, pairs in subs.items():
            text = (build.CSRC / f).read_text()
            assert mod.substituted(text, pairs, f) != text, name
    assert mod.kernel_of("against") == "localize"
    assert mod.kernel_of("interp_against") == "interp"
    assert set(mod.BLOCK_VARIANTS) <= set(mod.VARIANTS)
