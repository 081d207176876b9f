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
// The tile route (l <= 1024, kernels/sync.py route; the kernel takes up to
// 4096): csrc/scfront_tile.cuh,
// one warp walking a long segment of a row with all three planes in
// registers, each doubling level a shuffle (w < 32), a register of the
// same lane (w < 256) or a per-warp ring in shared memory (w >= 256); see
// its note. Bound on this card: memory. A C3 dispatch reads 35.5M
// complex64 and writes 12 B per output (284 + 426 MB, 0.212 ms); at C2
// (l = 32, 32 captures of ~182k samples) a call moves ~117 MB, so it is
// short enough that its launch shows.
//
// Above (n_sc >= 4096, with DVB-T2's 16K and 32K modes) the same sums run
// by the split route in two launches (kernels/sync.py route; the body
// csrc/scfront_split.cuh, see its note): ofdm_sc_span walks the leaves and
// the levels up to a width W as the tile body does and writes S_W of the
// three planes, and ofdm_sc_stride runs the levels above W on each residue
// chain i mod W, one thread a chain, and writes P and M or R with the tile
// route's epilogue (sct::write_out). Same adds in the same order, so both
// routes give the same bits. ~44 B a sample in all, where the levels route
// it replaces above 4096 (2 + log2 l launches, each level reading and
// writing all three planes through device memory) moved ~15x the tile
// route's bytes at l = 8192. At l = 2048 and 4096 the split route also
// beats the tile kernel, whose warm-up of 2l - 1 positions a segment
// grows with l (PERF.md).
#include "ofdm_kernels.h"
#include "scfront_split.cuh"

namespace {

constexpr size_t kMaxSmem = 227 * 1024;   // dynamic shared memory a block
constexpr double kSlotsPerWarp = 1.0;     // work items a resident warp
                                          // of the tile and span walks
                                          // (scripts/k6_ab.py varies it)
constexpr double kStrideSlots = 1.0;      // ... a resident thread of the
                                          // stride pass (the same)

// A warp for sct::walk and scs::span_walk: its lane and the shuffle of
// all 32 lanes.
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

// The blocks of `kernel` the card holds at once at `threads` threads and
// `smem` bytes of dynamic shared memory a block (after allowing it
// above 48 KB), at least one an SM.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            long long& blocks) {
    cudaError_t err;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess)
        return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, threads, smem)) != cudaSuccess)
        return err;
    blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    return cudaSuccess;
}

// The grid for one lag: segments for as many warps as the card holds at
// once at this kernel's registers and shared memory (kSlotsPerWarp work
// items a resident warp), a block for every g.warps of them.
template <int LG, bool kMetric>
int launch_tile(const float2* r, float2* p, float* q, sct::Plan& g, int rows,
                cudaStream_t stream) {
    const size_t smem = g.smem_bytes();
    long long resident = 0;
    const cudaError_t err = resident_blocks(scfront_kernel<LG, kMetric>,
                                            g.warps * 32, smem, resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    sct::plan_segments(g, rows, static_cast<long long>(
        static_cast<double>(resident) * g.warps * kSlotsPerWarp));
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

// ---- the split route (csrc/scfront_split.cuh) ------------------------

// The span pass: each warp walks work items (row, segment), item += the
// grid's warps.
template <int LGW>
__global__ void __launch_bounds__(sct::kWarps * 32)
sc_span_kernel(const float2* __restrict__ r, float* __restrict__ set,
               const scs::SpanPlan g) {
    extern __shared__ float sm[];
    const int warp = threadIdx.x / 32;
    const DeviceWarp wp{static_cast<int>(threadIdx.x & 31)};
    float* ring = sm + static_cast<size_t>(warp) * g.ring;
    const long long stride = static_cast<long long>(gridDim.x) * g.warps;
    for (long long item = static_cast<long long>(blockIdx.x) * g.warps + warp;
         item < g.items; item += stride)
        scs::span_walk<LGW>(r, set, g, item, ring, wp);
}

template <int LGW = 0>
int launch_span(const float2* r, float* set, scs::SpanPlan& g,
                cudaStream_t stream) {
    if constexpr (LGW > scs::kMaxLog2W) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (g.lgw != LGW) return launch_span<LGW + 1>(r, set, g, stream);
        const size_t smem = g.smem_bytes();
        long long resident = 0;
        const cudaError_t err = resident_blocks(sc_span_kernel<LGW>,
                                                g.warps * 32, smem, resident);
        if (err != cudaSuccess) return static_cast<int>(err);
        scs::plan_span_segments(g, static_cast<long long>(
            static_cast<double>(resident) * g.warps * kSlotsPerWarp));
        const long long blocks = (g.items + g.warps - 1) / g.warps;
        sc_span_kernel<LGW><<<static_cast<unsigned>(blocks), g.warps * 32,
                              smem, stream>>>(r, set, g);
        return static_cast<int>(cudaGetLastError());
    }
}

// The stride pass: work items (row, segment, residue), the residue
// fastest, th += the grid's threads (the launch gives each thread one); a
// thread's ring is its column of the block's shared memory.
template <int NR, bool kMetric>
__global__ void __launch_bounds__(scs::kStrideBlock)
sc_stride_kernel(const float* __restrict__ set, float2* __restrict__ p_out,
                 float* __restrict__ q_out, const scs::StridePlan g) {
    extern __shared__ float sm[];
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long th =
             static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         th < g.threads; th += stride)
        scs::stride_walk<NR, kMetric>(set, p_out, q_out, g, th,
                                      sm + threadIdx.x, blockDim.x);
}

template <bool kMetric, int NR = 0>
int launch_stride(const float* set, float2* p, float* q, scs::StridePlan& g,
                  cudaStream_t stream) {
    if constexpr (NR > scs::kRegLg + 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else {
        if (scs::reg_levels(g.lgd) != NR)
            return launch_stride<kMetric, NR + 1>(set, p, q, g, stream);
        const size_t smem = g.smem_bytes();
        long long resident = 0;
        const cudaError_t err = resident_blocks(sc_stride_kernel<NR, kMetric>,
                                                g.block, smem, resident);
        if (err != cudaSuccess) return static_cast<int>(err);
        scs::plan_stride_segments(g, static_cast<long long>(
            static_cast<double>(resident) * g.block * kStrideSlots));
        const long long blocks = (g.threads + g.block - 1) / g.block;
        sc_stride_kernel<NR, kMetric><<<static_cast<unsigned>(blocks),
                                        g.block, smem, stream>>>(set, p, q,
                                                                 g);
        return static_cast<int>(cudaGetLastError());
    }
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

OFDM_API int ofdm_sc_span(const float2* r, float* set, int rows, int n,
                          int l, int w, void* stream) {
    if (rows <= 0 || n - 2 * l + 1 <= 0) return 0;
    scs::SpanPlan g;
    if (!scs::plan_span(g, rows, n, l, w, kMaxSmem))
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_span(r, set, g, static_cast<cudaStream_t>(stream));
}

OFDM_API int ofdm_sc_stride(const float* set, float2* p, float* q, int rows,
                            int n, int l, int w, int metric, void* stream) {
    if (rows <= 0 || n - 2 * l + 1 <= 0) return 0;
    scs::StridePlan g;
    if (!scs::plan_stride(g, rows, n, l, w, kMaxSmem))
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    return metric ? launch_stride<true>(set, p, q, g, s)
                  : launch_stride<false>(set, p, q, g, s);
}
