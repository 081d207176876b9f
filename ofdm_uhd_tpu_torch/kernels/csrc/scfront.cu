// Schmidl-Cox front end in one pass: the lag product, the energy, both
// window sums and (ofdm_scfront) the timing metric, per row (capture).
//
//   P[i] = sum_{m<l} conj(r[i+m]) r[i+m+l]
//   R[i] = 0.5 sum_{m<2l} |r[i+m]|^2
//   M[i] = |P[i]|^2 / max(R[i], 1e-12)^2, 0 where R[i] <= 1e-12
//
// for i < nd = n - 2l + 1. ofdm_scfront writes P (complex64) and M
// (float32), and R stays on chip; ofdm_sc_correlate writes P and R.
//
// Replaces:
//   ofdm_scfront (K6): ofdm_uhd_tpu/kernels/pallas_scfront.py:
//     sc_frontend_pallas (_scfront_kernel). That kernel summed its windows
//     with an in-row lane prefix, which agrees with the plain compose only
//     to ~1e-5.
//   ofdm_sc_correlate (K9): ofdm_uhd_tpu/kernels/pallas_sync.py:
//     sc_correlate_mxu, which sums the three boxcars (Re and Im of the lag
//     product, and the energy) as a banded matmul with a ones band on the
//     MXU (pallas_fir_mxu.py:_banded_rows_call, K7b) and builds R from two
//     shifted l-sums, R = 0.5 (S_l[i] + S_l[i+l]). On this card a ones-band
//     matmul is wasted tensor work on a memory-bound sum; the last doubling
//     level below computes the same R.
// Detection compares M against its threshold and plateau with >=, so both
// kernels keep the plain version's order instead (kernels/sync.py:
// pairwise doubling, S_2w[i] = S_w[i] + S_w[i+w]), with every add and
// multiply written as __fadd_rn / __fmul_rn so that nothing is contracted
// into an FMA. The energy is |r| squared with |r| = hypotf, as r.abs() **
// 2 computes it on the card.
//
// The tile route (l <= 4096, kernels/sync.py route): csrc/scfront_tile.cuh,
// one warp walking a long segment of a row with all three planes in
// registers, each doubling level a shuffle (w < 32), a register of the
// same lane (w < 256) or a per-warp ring in shared memory (w >= 256); see
// its note. Bound on this card: memory. A C3 dispatch reads 35.5M
// complex64 and writes 12 B per output (284 + 426 MB, 0.212 ms); at C2
// (l = 32, 32 captures of ~182k samples) a call moves ~117 MB, so it is
// short enough that its launch shows.
//
// Above l = 4096 (n_sc >= 16384: DVB-T2's 16K and 32K modes) the same sums
// run through device memory in 2 + log2 l launches (the levels route,
// kernels/sync.py route): ofdm_sc_leaves writes the lag product's two
// planes and the energy, ofdm_sc_level doubles all three planes once
// (S_2w[i] = S_w[i] + S_w[i + w], w = 1 .. l/2, into the other of two
// plane sets, since a block would otherwise overwrite S_w[i + w] before
// another block reads it), and ofdm_sc_out takes the energy's last level,
// R = 0.5 (S_l[i] + S_l[i + l]), and writes P and M or R with the tile
// route's epilogue (sct::write_out). Same adds in the same order, so both
// routes give the same bits. Each level reads and writes ~3 planes, so at
// l = 8192 the route moves ~15x the tile route's bytes.
#include "ofdm_kernels.h"
#include "scfront_tile.cuh"

namespace {

constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory a block
constexpr double kSlotsPerWarp = 1.0;     // work items a resident warp
                                          // (scripts/k6_ab.py varies it)

// A warp for sct::walk: its lane and the shuffle of all 32 lanes.
struct DeviceWarp {
    int lane;
    __device__ __forceinline__ float shfl(float v, int src) const {
        return __shfl_sync(0xffffffffu, v, src);
    }
};

// kMetric: the second output q is M (ofdm_scfront), else R. Each warp
// walks work items (row, segment) item += the grid's warps.
template <int LG, bool kMetric>
__global__ void __launch_bounds__(sct::kWarps * 32)
scfront_kernel(const float2* __restrict__ r, float2* __restrict__ p_out,
               float* __restrict__ q_out, const sct::Plan g) {
    extern __shared__ float sm[];
    const int warp = threadIdx.x / 32;
    const DeviceWarp wp{static_cast<int>(threadIdx.x & 31)};
    float* ring = sm + static_cast<size_t>(warp) * g.ring;
    const long long stride = static_cast<long long>(gridDim.x) * g.warps;
    for (long long item = static_cast<long long>(blockIdx.x) * g.warps + warp;
         item < g.items; item += stride)
        sct::walk<LG, kMetric>(r, p_out, q_out, g, item, ring, wp);
}

// The levels route's planes: set [3, rows, n] floats, plane 0 / 1 the lag
// product's re / im (valid over n - l, then shorter by each level's w),
// plane 2 the energy (valid over n).
constexpr int kLevelThreads = 256;

__global__ void __launch_bounds__(kLevelThreads)
sc_leaves_kernel(const float2* __restrict__ r, float* __restrict__ set,
                 int rows, int n, int l) {
    const size_t plane = static_cast<size_t>(rows) * n;
    const size_t total = plane;
    for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
         k < total; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int s = static_cast<int>(k % n);
        const float2 a = r[k];
        const float mag = hypotf(a.x, a.y);
        set[2 * plane + k] = __fmul_rn(mag, mag);
        if (s < n - l) {
            const float2 b = r[k + l];
            set[k] = __fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
            set[plane + k] = __fsub_rn(__fmul_rn(a.x, b.y),
                                       __fmul_rn(a.y, b.x));
        }
    }
}

__global__ void __launch_bounds__(kLevelThreads)
sc_level_kernel(const float* __restrict__ a, float* __restrict__ b, int rows,
                int n, int w, int len_p, int len_e) {
    const size_t plane = static_cast<size_t>(rows) * n;
    for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
         k < plane; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const int j = static_cast<int>(k % n);
        if (j < len_e)
            b[2 * plane + k] = __fadd_rn(a[2 * plane + k], a[2 * plane + k + w]);
        if (j < len_p) {
            b[k] = __fadd_rn(a[k], a[k + w]);
            b[plane + k] = __fadd_rn(a[plane + k], a[plane + k + w]);
        }
    }
}

template <bool kMetric>
__global__ void __launch_bounds__(kLevelThreads)
sc_out_kernel(const float* __restrict__ a, float2* __restrict__ p_out,
              float* __restrict__ q_out, int rows, int n, int l, int nd) {
    const size_t plane = static_cast<size_t>(rows) * n;
    const size_t total = static_cast<size_t>(rows) * nd;
    for (size_t k = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
         k < total; k += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const size_t row = k / nd;
        const size_t at = row * n + (k - row * nd);
        sct::write_out<kMetric>(p_out, q_out, k, a[at], a[plane + at],
                                __fadd_rn(a[2 * plane + at],
                                          a[2 * plane + at + l]));
    }
}

unsigned grid_for(size_t total) {
    const size_t blocks = (total + kLevelThreads - 1) / kLevelThreads;
    return static_cast<unsigned>(blocks < (1u << 20) ? blocks : (1u << 20));
}

// The grid for one lag: segments for as many warps as the card holds at
// once at this kernel's registers and shared memory (kSlotsPerWarp work
// items a resident warp), a block for every g.warps of them.
template <int LG, bool kMetric>
int launch_tile(const float2* r, float2* p, float* q, sct::Plan& g, int rows,
                cudaStream_t stream) {
    const size_t smem = g.smem_bytes();
    cudaError_t err;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             scfront_kernel<LG, kMetric>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess)
        return static_cast<int>(err);
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, scfront_kernel<LG, kMetric>, g.warps * 32, smem)) !=
            cudaSuccess)
        return static_cast<int>(err);
    sct::plan_segments(g, rows, static_cast<long long>(
        static_cast<double>(sms) * (per_sm > 0 ? per_sm : 1) * g.warps *
        kSlotsPerWarp));
    const long long blocks = (g.items + g.warps - 1) / g.warps;
    scfront_kernel<LG, kMetric><<<static_cast<unsigned>(blocks),
                                  g.warps * 32, smem, stream>>>(r, p, q, g);
    return static_cast<int>(cudaGetLastError());
}

template <bool kMetric, int LG = 0>
int launch_lg(const float2* r, float2* p, float* q, sct::Plan& g, int rows,
              cudaStream_t stream) {
    if constexpr (LG > sct::kMaxLog2L) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (g.lg == LG)
            return launch_tile<LG, kMetric>(r, p, q, g, rows, stream);
        return launch_lg<kMetric, LG + 1>(r, p, q, g, rows, stream);
    }
}

template <bool kMetric>
int launch(const float2* r, float2* p, float* q, int rows, int n, int l,
           void* stream) {
    if (rows <= 0 || n - 2 * l + 1 <= 0) return 0;
    sct::Plan g;
    if (!sct::plan_tile(g, n, l, kMaxSmem))
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_lg<kMetric>(r, p, q, g, rows,
                              static_cast<cudaStream_t>(stream));
}

}  // namespace

OFDM_API int ofdm_scfront(const float2* r, float2* p, float* m, int rows,
                          int n, int l, void* stream) {
    return launch<true>(r, p, m, rows, n, l, stream);
}

OFDM_API int ofdm_sc_correlate(const float2* r, float2* p, float* rr,
                               int rows, int n, int l, void* stream) {
    return launch<false>(r, p, rr, rows, n, l, stream);
}

OFDM_API int ofdm_sc_leaves(const float2* r, float* set, int rows, int n,
                            int l, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (l < 1 || l >= n) return static_cast<int>(cudaErrorInvalidValue);
    sc_leaves_kernel<<<grid_for(static_cast<size_t>(rows) * n),
                       kLevelThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        r, set, rows, n, l);
    return static_cast<int>(cudaGetLastError());
}

OFDM_API int ofdm_sc_level(const float* a, float* b, int rows, int n, int w,
                           int len_p, int len_e, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (w < 1 || len_p < 0 || len_e < 0 || len_p + w > n || len_e + w > n)
        return static_cast<int>(cudaErrorInvalidValue);
    sc_level_kernel<<<grid_for(static_cast<size_t>(rows) * n), kLevelThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
        a, b, rows, n, w, len_p, len_e);
    return static_cast<int>(cudaGetLastError());
}

OFDM_API int ofdm_sc_out(const float* set, float2* p, float* q, int rows,
                         int n, int l, int metric, void* stream) {
    const int nd = n - 2 * l + 1;
    if (rows <= 0 || nd <= 0) return 0;
    const unsigned grid = grid_for(static_cast<size_t>(rows) * nd);
    const auto s = static_cast<cudaStream_t>(stream);
    if (metric)
        sc_out_kernel<true><<<grid, kLevelThreads, 0, s>>>(set, p, q, rows, n,
                                                           l, nd);
    else
        sc_out_kernel<false><<<grid, kLevelThreads, 0, s>>>(set, p, q, rows,
                                                            n, l, nd);
    return static_cast<int>(cudaGetLastError());
}
