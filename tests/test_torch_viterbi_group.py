"""K4's body, csrc/viterbi_group.cuh, built for the host with g++ and run on
the CPU: bit for bit against kernels/viterbi.py viterbi_plain (which
tests/test_torch_bits.py holds to the reference scan), for every group
size the kernel takes. Also the group size k4_group picks for the batches
of the port's paths.

The body runs unchanged, one std::thread a lane of a warp (32 threads,
32 / G sequences), a std::barrier for the __syncwarp between each
regroup's stores and loads, the warp's shared memory as a host array,
__shfl_sync (the traceback's at G = 16, and G = 32's butterfly every
step) as a slot a lane and a barrier, the warps of a launch one after
another. That checks the layouts (the state
each lane holds at each phase, the branch signs, the regroup, the
survivor records and the traceback) before any card sees the source; it
says nothing of speed.
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofdm_uhd_tpu.phy import bits as ref_bits
from ofdm_uhd_tpu_torch.kernels import build
from ofdm_uhd_tpu_torch.kernels import viterbi as KV
from ofdm_uhd_tpu_torch.phy import bits

torch.set_num_threads(2)

_HARNESS = r"""
#include <barrier>
#include <cstddef>
#include <thread>
#include <vector>
#include "viterbi_group.cuh"

// one std::thread a lane of a warp, a std::barrier for __syncwarp, and
// __shfl_sync as a slot a lane and a barrier; two slot arrays in turn, so
// that a lane rewrites one only after the next barrier, which every lane
// reaches after its read
template <class Body>
static void run_warp(Body body) {
    std::barrier<> bar(32);
    unsigned slots[2][32];
    std::vector<std::thread> lanes;
    for (int lane = 0; lane < 32; ++lane)
        lanes.emplace_back([&, lane] {
            int turn = 0;
            auto sync = [&] { bar.arrive_and_wait(); };
            auto shfl = [&](unsigned x, int src_lane) {
                slots[turn][lane] = x;
                bar.arrive_and_wait();
                const unsigned got = slots[turn][src_lane];
                turn ^= 1;
                return got;
            };
            body(lane, sync, shfl);
        });
    for (auto& t : lanes) t.join();
}

template <int M>
static void decode(const float* llr, uint8_t* bits, int batch, int n) {
    using L = vit::GroupLayout<M>;
    const size_t records = vit::record_stride(n, vit::kRecordSteps);
    std::vector<unsigned> rec(static_cast<size_t>(batch) * records * 64);
    const int warps = (batch + L::kGroups - 1) / L::kGroups;
    for (int w = 0; w < warps; ++w) {
        alignas(16) static uint2 buf[2 * L::kGroups * L::kGroupPairs];
        run_warp([&](int lane, auto sync, auto shfl) {
            const int q = lane / L::kLanes;
            const long long seq = static_cast<long long>(w) * L::kGroups + q;
            const bool live = seq < batch;
            const size_t row = static_cast<size_t>(live ? seq : batch - 1);
            vit::decode_group<M>(
                reinterpret_cast<const float2*>(llr) + row * n,
                rec.data() + row * records * 64, bits + row * n, n,
                lane % L::kLanes, q, buf, L::kGroups * L::kGroupPairs, live,
                true, sync, [&](unsigned x, int src) {
                    return shfl(x, q * L::kLanes + src);
                });
        });
    }
}

static void decode_butterfly(const float* llr, uint8_t* bits, int batch,
                             int n) {
    const size_t records = vit::record_stride(n, vit::kButterflyRecord);
    std::vector<unsigned> rec(static_cast<size_t>(batch) * records * 64);
    static vit::ButterflySmem sm;
    for (int b = 0; b < batch; ++b)
        run_warp([&](int lane, auto sync, auto shfl) {
            vit::decode_butterfly(
                reinterpret_cast<const float2*>(llr) + static_cast<size_t>(b) * n,
                rec.data() + b * records * 64, bits + static_cast<size_t>(b) * n,
                n, lane, true, true, sm, sync, shfl);
        });
}

extern "C" int vit_group_host(const float* llr, uint8_t* bits, int batch,
                              int n, int group) {
    switch (group) {
        case 4: decode<4>(llr, bits, batch, n); return 0;
        case 8: decode<3>(llr, bits, batch, n); return 0;
        case 16: decode<2>(llr, bits, batch, n); return 0;
        case 32: decode_butterfly(llr, bits, batch, n); return 0;
        default: return 1;
    }
}
"""


@pytest.fixture(scope="module")
def k4_host(tmp_path_factory):
    """The K4 body built with g++ (plain float operations, no contraction:
    -ffp-contract=off) into a temporary directory, loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the K4 body cannot be built for the host")
    out = tmp_path_factory.mktemp("k4_host")
    src = out / "harness.cpp"
    src.write_text(_HARNESS)
    lib = out / "libk4_host.so"
    done = subprocess.run(
        [gxx, "-O2", "-std=c++20", "-ffp-contract=off",
         "-fno-strict-aliasing", "-fPIC", "-shared", "-I", str(build.CSRC),
         "-o", str(lib), str(src), "-lpthread"],
        capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.vit_group_host.argtypes = [p, p, i, i, i]
    dll.vit_group_host.restype = ctypes.c_int
    return dll


def _decode(dll, llr: np.ndarray, group: int) -> np.ndarray:
    llr = np.ascontiguousarray(llr, dtype=np.float32)
    rows, n = llr.shape[0], llr.shape[1] // 2
    got = np.full((rows, n), 7, np.uint8)
    assert dll.vit_group_host(llr.ctypes.data, got.ctypes.data, rows, n,
                              group) == 0
    return got


def _batch(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """[5, 2n] float32 LLRs: two rows of tail-terminated codewords through
    BPSK + AWGN at 5 dB (their info bits returned), two of Gaussian noise,
    one of integers in [-2, 2], whose metric ties test the strict '>'.
    Five rows leave the last warp part empty at G = 4, 8 and 16."""
    rng = np.random.default_rng(seed)
    info = rng.integers(0, 2, (2, n)).astype(np.uint8)
    info[:, -min(6, n):] = 0
    coded = bits.conv_encode(torch.from_numpy(info)).numpy()
    sigma = 10 ** (-5.0 / 20)
    y = (1.0 - 2.0 * coded) + sigma * rng.normal(size=coded.shape)
    llr = np.concatenate([2 * y / sigma**2,
                          rng.normal(scale=3.0, size=(2, 2 * n)),
                          rng.integers(-2, 3, (1, 2 * n))])
    return llr.astype(np.float32), info


# n: shorter than a round of two regroups, a partial record at every group
# size, lengths around the 24-step records, C3's 6912 (a multiple of every
# cycle) and 1003 (a multiple of none: 1003 = 1 mod 2, 3 mod 4, 1 mod 3)
SHORT_NS = [1, 2, 5, 7, 23, 24, 25, 49, 100, 1003]


@pytest.mark.parametrize("group", KV.K4_GROUPS)
@pytest.mark.parametrize("n", SHORT_NS)
def test_k4_body_on_host_matches_plain(k4_host, group, n):
    llr, info = _batch(n, seed=n + group)
    got = _decode(k4_host, llr, group)
    want = KV.viterbi_plain(torch.from_numpy(llr)).numpy()
    np.testing.assert_array_equal(got, want)
    if n >= 24:
        np.testing.assert_array_equal(got[:2], info)


@pytest.mark.parametrize("group", [8, 16, 32])
def test_k4_body_on_host_matches_plain_at_c3_length(k4_host, group):
    """C3's trellis, 6912 steps, at the group sizes of the paths' big and
    small batches."""
    llr, info = _batch(6912, seed=group)
    got = _decode(k4_host, llr, group)
    np.testing.assert_array_equal(
        got, KV.viterbi_plain(torch.from_numpy(llr)).numpy())
    np.testing.assert_array_equal(got[:2], info)


def test_k4_body_on_host_matches_reference_scan(k4_host):
    """The host-built body against the reference's scan
    (ofdm_uhd_tpu/phy/bits.py viterbi_decode) itself, at G = 8."""
    llr, _ = _batch(100, seed=3)
    want = np.asarray(ref_bits.viterbi_decode(jnp.asarray(llr)))
    np.testing.assert_array_equal(_decode(k4_host, llr, 8), want)



# the K4 batches of the port's paths on an H100 (132 SMs): C3's 8208
# slots, C4's 272, c2_pallas's 4160, and big_nsc's 24 at n_sc 16384 and
# 32768
K4_BATCHES = {"c3": 8208, "c4": 272, "c2_pallas": 4160, "big_nsc": 24}


def test_k4_group_at_the_paths_batches():
    got = {k: KV.k4_group(b, 132) for k, b in K4_BATCHES.items()}
    assert got == {"c3": 4, "c4": 32, "c2_pallas": 16, "big_nsc": 32}
    for b in (1, 100, 10_000, 1_000_000):
        assert KV.k4_group(b, 132) in KV.K4_GROUPS
