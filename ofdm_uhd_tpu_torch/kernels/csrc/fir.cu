// Real-tap FIR over complex rows: the 'same' FIR and M-fold decimation
// (one strided kernel) and L-fold polyphase interpolation.
//
// Replaces: ofdm_uhd_tpu/kernels/pallas_fir_mxu.py, K7: fir_mxu_pallas and
// polyphase_decim_mxu_pallas (both through _fir_rows_mxu), and
// polyphase_interp_mxu_pallas. The TPU kernels cast the FIR as two banded
// matmuls per row block (the MXU was the only unit fast enough, at 2.7-6.6x
// MAC inflation). Here the direct form costs 2 FMAs per tap and output with
// no inflation, and each input sample is read from device memory about
// once.
//
// The strided kernel (ofdm_fir_strided; its body is fir_strided.cuh, which
// sets out the design). Its bound on this card is bytes: the C4 decimation
// (8 x 4,138,472 samples in, 517,309 outputs a row, 193 taps) moves 265 MB
// in and 33 MB out, 0.089 ms at 3.35 TB/s, against 1.6 G FMAs, 0.048 ms
// of float32; the stride-1 FIR at C4's baseband is bound by those FMAs.
// The previous body staged each 256-output tile as interleaved float2 and
// summed one output a thread, reading xs[thread * stride + t]: at stride 8
// neighbouring lanes sat 64 B apart, an 8-way bank conflict, ~17
// shared-memory wavefronts a warp and tap. Those wavefronts, not bytes or
// FMAs, set its time (1.6 ms at C4 on an H100 80GB HBM3, 700 W, 18x the
// bound). This body splits the taps into the stride's phases, keeps 9
// outputs a thread and a sliding window of samples in registers (18 FMAs
// a shared load; 36 on pair planes), reads every plane without a bank
// conflict, and leaves the copy to producer warps that stage the next
// tile by cp.async while consumer warps sum the current one. There (C4,
// same card) the copy alone takes a little longer than the sums alone,
// and neither reaches its peak: the copy moves ~1.8 TB/s (cp.async
// requests in flight), the sums issue FMAs at about a third of the
// float32 rate (scripts/k7_ablation.py).
//
// The interpolation kernel stages its tile's inputs and its branch matrix
// in shared memory, and consecutive threads sum consecutive outputs.
//
// Rows never leak: each row is filtered on its own, with zeros read before
// its start and past its end. Offsets into the rows are size_t.
#include "ofdm_kernels.h"
#include "fir_strided.cuh"

namespace {

constexpr int kThreads = 256;     // interp kernel: threads per block
constexpr int kTileIn = 256;      // interp kernel: input samples per block
constexpr size_t kMaxSmem = 227 * 1024;   // shared memory a block may use

// The strided FIR: one block's share of the persistent grid, S stages.
constexpr int kStridedThreads =
    firk::kGroups * firk::kGroupThreads + firk::kProducers;

template <int S>
__global__ void __launch_bounds__(kStridedThreads)
fir_strided_kernel(const float2* __restrict__ x, const float* __restrict__ w,
                   float2* __restrict__ y, const firk::Plan g) {
    extern __shared__ float4 fir_ring_smem[];
    float* smem = reinterpret_cast<float*>(fir_ring_smem);
    firk::DevicePipe pipe{
        reinterpret_cast<unsigned long long*>(smem + g.ring_floats()), S};
    const int consumers = g.consumers;
    firk::strided_block<S>(
        x, w, y, g, smem, blockIdx.x, gridDim.x, threadIdx.x, pipe,
        [] { __syncthreads(); },
        [consumers] {
            asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
        });
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

// A grid of as many blocks as fit on the card at once, at most one a work
// item.
template <int S>
int launch_strided(const float2* x, const float* w, float2* y,
                   const firk::Plan& g, cudaStream_t stream) {
    const size_t smem = g.smem_bytes();
    cudaError_t err = allow_smem(fir_strided_kernel<S>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fir_strided_kernel<S>, g.block(), smem)) !=
            cudaSuccess)
        return static_cast<int>(err);
    const long long fit =
        static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const long long grid = g.items < fit ? g.items : fit;
    fir_strided_kernel<S><<<static_cast<unsigned>(grid), g.block(), smem,
                            stream>>>(x, w, y, g);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

OFDM_API int ofdm_fir_strided(const float2* x, const float* w, float2* y,
                              int rows, int n_in, int n_out, int nt,
                              int stride, int pad_left, void* stream) {
    if (rows <= 0 || n_out <= 0) return 0;
    firk::Plan g;
    const bool aligned16 = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (!firk::plan_strided(g, rows, n_in, n_out, nt, stride, pad_left,
                            firk::kGroups, firk::kGroupThreads,
                            firk::kProducers, firk::kStages, aligned16,
                            kMaxSmem))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return g.stages == 2 ? launch_strided<2>(x, w, y, g, s)
                         : launch_strided<1>(x, w, y, g, s);
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
