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
// The interpolation kernel (ofdm_fir_interp; its body is fir_interp.cuh,
// which sets out the design) is bound by bytes at C4's TX ([32, 16128] by
// 8, 193 taps: 4 MB in, 33 MB out, 0.011 ms); a thread sums 12 inputs
// of one branch from its taps and a window of samples in registers, and a
// persistent grid stages the next tile by cp.async while it sums.
//
// Rows never leak: each row is filtered on its own, with zeros read before
// its start and past its end. Offsets into the rows are size_t.
#include "ofdm_kernels.h"
#include "fir_strided.cuh"
#include "fir_interp.cuh"

namespace {

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

// The interpolation: a persistent grid walking the rows' tiles
// (fir_interp.cuh), ND taps a chunk.
template <int ND>
__global__ void __launch_bounds__(fii::kThreads)
fir_interp_kernel(const float2* __restrict__ x, const float* __restrict__ g,
                  float2* __restrict__ y, const fii::Plan p) {
    extern __shared__ float4 interp_smem[];
    fii::interp_block<ND>(x, g, y, p, reinterpret_cast<float*>(interp_smem),
                          blockIdx.x, gridDim.x, threadIdx.x,
                          [] { __syncthreads(); });
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

// As many blocks as fit on the card at once, at most one a work item.
template <int ND>
int launch_interp(const float2* x, const float* g, float2* y,
                  const fii::Plan& p, void* stream) {
    const size_t smem = p.smem_bytes();
    cudaError_t err = allow_smem(fir_interp_kernel<ND>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fir_interp_kernel<ND>, fii::kThreads, smem)) !=
            cudaSuccess)
        return static_cast<int>(err);
    const long long fit =
        static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const long long grid = p.work < fit ? p.work : fit;
    fir_interp_kernel<ND><<<static_cast<unsigned>(grid), fii::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(x, g, y, p);
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
    fii::Plan p;
    if (!fii::plan_interp(p, rows, n, l, nd, d_max, fii::kThreads, kMaxSmem))
        return static_cast<int>(cudaErrorInvalidValue);
    switch (p.taps) {
        case 8: return launch_interp<8>(x, g, y, p, stream);
        case 16: return launch_interp<16>(x, g, y, p, stream);
        case 25: return launch_interp<25>(x, g, y, p, stream);
        default: return launch_interp<fii::kMaxTaps>(x, g, y, p, stream);
    }
}
