// Real-tap FIR over complex rows: the 'same' FIR and M-fold decimation
// (one strided kernel) and L-fold polyphase interpolation.
//
// Replaces: ofdm_uhd_tpu/kernels/pallas_fir_mxu.py, K7: fir_mxu_pallas and
// polyphase_decim_mxu_pallas (both through _fir_rows_mxu), and
// polyphase_interp_mxu_pallas. The TPU kernels cast the FIR as two banded
// matmuls per row block (the MXU was the only unit fast enough, at 2.7-6.6x
// MAC inflation). Here the direct form costs 2 FMAs per tap and output with
// no inflation, and each input sample is read from device memory about
// once: a block stages its tile's input span and the taps in shared memory,
// then each thread sums its output's taps in order (fmaf) out of shared
// memory. On an H100 80GB HBM3 (700 W) the C4 decimation (8 x 517k outputs,
// 193 taps: 3.2 GFLOP, 265 MB read) takes about 1.7 ms: 178 GB/s and
// 1.9 TFLOP/s, a few percent of either peak, so neither memory nor
// arithmetic bounds it. What does is not measured yet.
//
// Rows never leak: each row is filtered on its own, with zeros read before
// its start and past its end. Offsets into the rows are size_t.
#include "ofdm_kernels.h"

namespace {

constexpr int kThreads = 256;     // threads per block
constexpr int kTileOut = 256;     // strided kernel: outputs per block
constexpr int kTileIn = 256;      // interp kernel: input samples per block

// out[r, i] = sum_t w[t] * xp[r, i*stride + t], xp = row r with pad_left
// zeros in front and zeros past its end; i < n_out.
__global__ void __launch_bounds__(kThreads)
fir_strided_kernel(const float2* __restrict__ x, const float* __restrict__ w,
                   float2* __restrict__ y, int n_in, int n_out, int nt,
                   int stride, int pad_left, int tiles) {
    extern __shared__ float smem[];
    float* ws = smem;                                      // [nt]
    float2* xs = reinterpret_cast<float2*>(smem + ((nt + 1) & ~1));
    const int row = blockIdx.x / tiles;
    const int o0 = (blockIdx.x - row * tiles) * kTileOut;
    const int span = (kTileOut - 1) * stride + nt;
    const long long first = static_cast<long long>(o0) * stride - pad_left;
    const float2* xr = x + static_cast<size_t>(row) * n_in;
    for (int t = threadIdx.x; t < nt; t += kThreads) ws[t] = w[t];
    for (int j = threadIdx.x; j < span; j += kThreads) {
        const long long s = first + j;
        xs[j] = (s >= 0 && s < n_in) ? xr[s] : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
    const int i = o0 + threadIdx.x;
    if (i >= n_out) return;
    const float2* xi = xs + threadIdx.x * stride;
    float re = 0.0f, im = 0.0f;
    for (int t = 0; t < nt; ++t) {
        const float c = ws[t];
        const float2 v = xi[t];
        re = fmaf(c, v.x, re);
        im = fmaf(c, v.y, im);
    }
    y[static_cast<size_t>(row) * n_out + i] = make_float2(re, im);
}

// out[r, k] = sum_{d=d_min}^{d_max} g[k mod l, d - d_min] * x[r, k/l - d],
// zeros outside the row; outputs written in sample order (k < n * l).
__global__ void __launch_bounds__(kThreads)
fir_interp_kernel(const float2* __restrict__ x, const float* __restrict__ g,
                  float2* __restrict__ y, int n, int l, int nd, int d_max,
                  int tiles) {
    extern __shared__ float smem[];
    float* gs = smem;                      // [l, nd], each branch reversed
    float2* xs = reinterpret_cast<float2*>(smem + ((l * nd + 1) & ~1));
    const int row = blockIdx.x / tiles;
    const int q0 = (blockIdx.x - row * tiles) * kTileIn;
    const int span = kTileIn + nd - 1;
    const float2* xr = x + static_cast<size_t>(row) * n;
    for (int j = threadIdx.x; j < l * nd; j += kThreads) {
        const int p = j / nd, t = j - p * nd;
        gs[j] = g[p * nd + (nd - 1 - t)];
    }
    for (int j = threadIdx.x; j < span; j += kThreads) {
        const int s = q0 - d_max + j;      // xs[j] = x[q0 - d_max + j]
        xs[j] = (s >= 0 && s < n) ? xr[s] : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
    const size_t n_out = static_cast<size_t>(n) * l;
    const size_t k0 = static_cast<size_t>(q0) * l;
    float2* yr = y + static_cast<size_t>(row) * n_out;
    // consecutive threads take consecutive outputs: coalesced stores
    for (int kl = threadIdx.x; kl < kTileIn * l; kl += kThreads) {
        if (k0 + kl >= n_out) break;
        const int q = kl / l, p = kl - q * l;
        const float* gp = gs + p * nd;
        const float2* xq = xs + q;
        float re = 0.0f, im = 0.0f;
        for (int t = 0; t < nd; ++t) {
            const float c = gp[t];
            const float2 v = xq[t];
            re = fmaf(c, v.x, re);
            im = fmaf(c, v.y, im);
        }
        yr[k0 + kl] = make_float2(re, im);
    }
}

// Dynamic shared memory above the default 48 KB needs the opt-in.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace

OFDM_API int ofdm_fir_strided(const float2* x, const float* w, float2* y,
                              int rows, int n_in, int n_out, int nt,
                              int stride, int pad_left, void* stream) {
    if (rows <= 0 || n_out <= 0) return 0;
    const int tiles = (n_out + kTileOut - 1) / kTileOut;
    const size_t smem = sizeof(float) * ((nt + 1) & ~1)
        + sizeof(float2) * static_cast<size_t>((kTileOut - 1) * stride + nt);
    cudaError_t err = allow_smem(fir_strided_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fir_strided_kernel<<<rows * tiles, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        x, w, y, n_in, n_out, nt, stride, pad_left, tiles);
    return static_cast<int>(cudaGetLastError());
}

OFDM_API int ofdm_fir_interp(const float2* x, const float* g, float2* y,
                             int rows, int n, int l, int nd, int d_max,
                             void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    const int tiles = (n + kTileIn - 1) / kTileIn;
    const size_t smem = sizeof(float) * ((l * nd + 1) & ~1)
        + sizeof(float2) * static_cast<size_t>(kTileIn + nd - 1);
    cudaError_t err = allow_smem(fir_interp_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fir_interp_kernel<<<rows * tiles, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        x, g, y, n, l, nd, d_max, tiles);
    return static_cast<int>(cudaGetLastError());
}
