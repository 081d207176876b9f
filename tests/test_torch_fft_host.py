"""csrc/fft.cu built for the host with g++ and run on the CPU: the passes
of K3's route above one launch and the one-launch plan at 8192 points,
each against its plain step in kernels/fft.py.

The kernels run unchanged through a stand-in for the CUDA runtime: one
std::thread per CUDA thread of a block, a std::barrier for
__syncthreads, shared memory as static storage, the blocks of a launch
one after another. That checks the indexing (strided column loads, the
interleaved exchanges, the row pass's tile and its natural-order store)
before any card sees the source; it says nothing of speed.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ofdm_uhd_tpu_torch.kernels import build, fft

_RUNTIME = r"""
#pragma once
#include <barrier>
#include <functional>
#include <thread>
#include <vector>
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
inline int cudaGetLastError() { return 0; }
template <class F> int cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
    return 0;
}
inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* host_barrier = nullptr;
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __ldg(p) (*(p))
namespace host {
inline void launch(long long grid, int block, std::function<void()> body) {
    for (long long b = 0; b < grid; ++b) {
        std::barrier<> bar(block);
        host_barrier = &bar;
        std::vector<std::thread> ts;
        for (int t = 0; t < block; ++t)
            ts.emplace_back([&, t] {
                threadIdx.x = t;
                blockIdx.x = static_cast<unsigned>(b);
                body();
            });
        for (auto& th : ts) th.join();
    }
}
}  // namespace host
"""

_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<(.*?),(.*?),.*?>>>\((.*?)\);", re.S)


def _host_source(src: str) -> str:
    """fft.cu for the stand-in runtime: shared memory static, each
    kernel<<<grid, block, smem, stream>>>(args) a host::launch."""
    src = src.replace("extern __shared__ float2 dyn_smem[];",
                      "static float2 dyn_smem[1 << 15];")
    src = src.replace("__shared__", "static")
    src, n = _LAUNCH.subn(lambda m: f"host::launch({m.group(2)}, "
                          f"{m.group(3)}, [&] {{ {m.group(1)}"
                          f"({m.group(4)}); }});", src)
    assert n == 3, n            # fft_cp_kernel, the column and row passes
    return src


@pytest.fixture(scope="module")
def host_fft(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: fft.cu cannot be built for the host")
    out = tmp_path_factory.mktemp("fft_host")
    (out / "cuda_runtime.h").write_text(_RUNTIME)
    src = out / "fft_host.cpp"
    src.write_text(_host_source((build.CSRC / "fft.cu").read_text()))
    lib = out / "libfft_host.so"
    done = subprocess.run([gxx, "-O1", "-std=c++20", "-fPIC", "-shared",
                           "-I", str(out), "-I", str(build.CSRC), "-o",
                           str(lib), str(src), "-lpthread"],
                          capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ofdm_fft.argtypes = [p, p, p, i, i, i, p]
    dll.ofdm_fft_columns.argtypes = [p, p, p, p, i, i, i, i, p]
    dll.ofdm_fft_rows_t.argtypes = [p, p, p, i, i, i, i, p]
    return dll


def _rows(rows, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(rows, n))
            + 1j * rng.normal(size=(rows, n))).astype(np.complex64)


def _close(got, want):
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err


def _ptr(a):
    return a.ctypes.data


# the route's splits at 16384 and 65536, the columns' C = 1 shape of
# 2^24 (4096 x 16: one column a block), and the row pass at 2 and 1 rows
# a block (n2 = 2048, 4096)
SPLITS = [(32, 512), (128, 512), (4096, 16), (4, 2048), (2, 4096)]


@pytest.mark.parametrize("inverse", [0, 1])
@pytest.mark.parametrize("n1,n2", SPLITS)
def test_passes_on_host_match_plain(host_fft, n1, n2, inverse):
    """The column pass (its twiddles included) and the row pass on two
    seeded rows: within 1e-5 of max|y| of columns_plain and rows_t_plain."""
    x = _rows(2, n1 * n2, n1)
    tw = fft.route_twiddle_table(n1, n2)
    y = np.zeros_like(x)
    assert host_fft.ofdm_fft_columns(
        _ptr(x), _ptr(y), _ptr(fft.twiddle_table(n1)), _ptr(tw), 2,
        n1.bit_length() - 1, n2.bit_length() - 1, inverse, None) == 0
    _close(y, fft.columns_plain(torch.from_numpy(x), n1, n2,
                                torch.from_numpy(tw), bool(inverse)).numpy())
    z = np.zeros_like(x)
    assert host_fft.ofdm_fft_rows_t(
        _ptr(x), _ptr(z), _ptr(fft.twiddle_table(n2)), 2,
        n1.bit_length() - 1, n2.bit_length() - 1, inverse, None) == 0
    _close(z, fft.rows_t_plain(torch.from_numpy(x), n1, n2,
                               bool(inverse)).numpy())


@pytest.mark.parametrize("inverse", [0, 1])
def test_route_on_host_equals_torch_fft(host_fft, inverse):
    """route(16384)'s two launches, one after the other: torch.fft's
    transform (norm='ortho') within 1e-5 of max|y|."""
    n = 16384
    (_, n1, n2), _ = fft.route(n)
    x = _rows(3, n, 5)
    mid, y = np.zeros_like(x), np.zeros_like(x)
    assert host_fft.ofdm_fft_columns(
        _ptr(x), _ptr(mid), _ptr(fft.twiddle_table(n1)),
        _ptr(fft.route_twiddle_table(n1, n2)), 3, n1.bit_length() - 1,
        n2.bit_length() - 1, inverse, None) == 0
    assert host_fft.ofdm_fft_rows_t(
        _ptr(mid), _ptr(y), _ptr(fft.twiddle_table(n2)), 3,
        n1.bit_length() - 1, n2.bit_length() - 1, inverse, None) == 0
    f = torch.fft.ifft if inverse else torch.fft.fft
    _close(y, f(torch.from_numpy(x), norm="ortho").numpy())


@pytest.mark.parametrize("inverse", [0, 1])
def test_one_launch_8192_on_host(host_fft, inverse):
    """K3's one-launch plan at 8192 points (512 threads, four passes):
    fft_plain within 1e-5 of max|y| on three seeded rows."""
    n = 8192
    x = _rows(3, n, 9)
    y = np.zeros_like(x)
    assert host_fft.ofdm_fft(_ptr(x), _ptr(y), _ptr(fft.twiddle_table(n)),
                             3, 13, inverse, None) == 0
    _close(y, fft.fft_plain(torch.from_numpy(x), bool(inverse)).numpy())


def test_row_pass_refuses_a_partial_block(host_fft):
    """n1 = 2 at n2 = 512 leaves a block's 8 rows in two transforms: the
    entry refuses it rather than store past them."""
    x = np.zeros((1, 1024), np.complex64)
    assert host_fft.ofdm_fft_rows_t(_ptr(x), _ptr(x),
                                    _ptr(fft.twiddle_table(512)), 1, 1, 9,
                                    0, None) != 0
