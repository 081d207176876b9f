// Schmidl-Cox plateau localization, one candidate per warp.
//
// Replaces: ofdm_uhd_tpu/kernels/pallas_localize.py:localize_pallas
// (_localize_kernel). For each candidate c (clamped to nd) it reads the
// metric window M[c, c + span), values past nd counting as 0, and finds
//   * the peak by first-index argmax,
//   * the plateau [lo, hi]: first and last offsets with M >= rel * peak,
//   * d = max(c + (lo + hi) / 2 - cp_half, 0), emitted as int32 (the TPU
//     kernel packs d into float32, exact only below 2^24),
//   * eps = atan2(Im P, Re P) / pi at the peak sample.
//
// Bound on this card: neither. A C3 dispatch has 8 x 4120 candidates and
// reads ~1.2 KB of metric each (a 38 MB gather out of L2/HBM), so the
// kernel is a few microseconds of launch and load latency. Design: a warp
// owns a candidate; each lane reads every 32nd sample of the window
// (coalesced), keeps its first maximum, and warp shuffles reduce the
// (value, first index) pair; a second pass over the same window (now in
// L1) reduces the plateau bounds with __reduce_min/max_sync. Lane 0 reads
// P at the peak and writes both outputs. rel * peak is __fmul_rn, the
// float32 product the TPU kernel computes.
#include <cmath>

#include "ofdm_kernels.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
localize_kernel(const float* __restrict__ m, const float2* __restrict__ p,
                const int* __restrict__ cand, int* __restrict__ d_out,
                float* __restrict__ eps_out, int caps, int nd, int mf,
                int span, int cp_half, float rel) {
    const int idx = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (idx >= caps * mf) return;
    const int cap = idx / mf;
    const float* mrow = m + static_cast<size_t>(cap) * nd;
    const int c = min(max(cand[idx], 0), nd);

    float best = -INFINITY;
    int best_i = span;
    for (int i = lane; i < span; i += 32) {
        const int g = c + i;
        const float v = g < nd ? mrow[g] : 0.0f;
        if (v > best) { best = v; best_i = i; }    // first max of the lane
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best, off);
        const int oi = __shfl_xor_sync(kFull, best_i, off);
        if (ov > best || (ov == best && oi < best_i)) { best = ov; best_i = oi; }
    }
    const float thr = __fmul_rn(rel, best);
    int lo = span, hi = -1;
    for (int i = lane; i < span; i += 32) {
        const int g = c + i;
        const float v = g < nd ? mrow[g] : 0.0f;
        if (v >= thr) { lo = min(lo, i); hi = max(hi, i); }
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    if (lane == 0) {
        d_out[idx] = max(c + (lo + hi) / 2 - cp_half, 0);
        const int g = c + best_i;
        const float2 pv = g < nd ? p[static_cast<size_t>(cap) * nd + g]
                                 : make_float2(0.0f, 0.0f);
        const float inv_pi = static_cast<float>(1.0 / 3.14159265358979323846);
        eps_out[idx] = __fmul_rn(atan2f(pv.y, pv.x), inv_pi);
    }
}

}  // namespace

OFDM_API int ofdm_localize(const float* m, const float2* p, const int* cand,
                           int* d, float* eps, int caps, int nd, int mf,
                           int span, int cp_half, float rel, void* stream) {
    const int total = caps * mf;
    if (total <= 0) return 0;
    const int blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
    localize_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        m, p, cand, d, eps, caps, nd, mf, span, cp_half, rel);
    return static_cast<int>(cudaGetLastError());
}
