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
// pairwise doubling, S_2w[i] = S_w[i] + S_w[i+w]): a block stages its
// tile's leaves in shared memory and doubles them level by level, one
// barrier per level, with every add and multiply written as __fadd_rn /
// __fmul_rn so that nothing is contracted into an FMA. The energy is
// |r| squared with |r| = hypotf, as r.abs() ** 2 computes it on the card.
//
// Bound on this card: memory. A C3 dispatch reads 35.5M complex64 and
// writes 12 B per output (284 + 426 MB); the tree costs ~26 shared-memory
// adds per output at l = 128. The tile of kTile outputs stages
// kTile + 2l - 1 samples, so the input is read (kTile + 2l) / kTile times,
// mostly from L2. l must be a power of two (the wrapper checks). At C2
// (l = 32, 32 captures of ~182k samples) a call moves ~117 MB, so it is
// short enough that its launch shows.
#include "ofdm_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;           // outputs per block

// kMetric: the second output q is M (ofdm_scfront), else R.
template <bool kMetric>
__global__ void __launch_bounds__(kThreads)
scfront_kernel(const float2* __restrict__ r, float2* __restrict__ p_out,
               float* __restrict__ q_out, int n, int nd, int l, int tiles) {
    extern __shared__ float sm[];
    const int lp = kTile + l - 1;     // lag-product leaves a tile needs
    const int le = kTile + 2 * l - 1; // energy leaves
    // ping-pong buffers: one level reads a*, writes b*, then they swap
    float* pa_re = sm;
    float* pa_im = pa_re + lp;
    float* pb_re = pa_im + lp;
    float* pb_im = pb_re + lp;
    float* ea = pb_im + lp;
    float* eb = ea + le;

    const int row = blockIdx.x / tiles;
    const int i0 = (blockIdx.x - row * tiles) * kTile;
    const float2* rr = r + static_cast<size_t>(row) * n;
    const float2 zero = make_float2(0.0f, 0.0f);
    for (int j = threadIdx.x; j < le; j += kThreads) {
        const int s = i0 + j;
        const float2 a = s < n ? rr[s] : zero;
        const float mag = hypotf(a.x, a.y);
        ea[j] = __fmul_rn(mag, mag);
        if (j < lp) {
            const float2 b = s + l < n ? rr[s + l] : zero;
            // conj(a) * b = (a.x b.x + a.y b.y) + i (a.x b.y - a.y b.x)
            pa_re[j] = __fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
            pa_im[j] = __fsub_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x));
        }
    }
    __syncthreads();
    // log2(l) levels for P's window l, log2(2l) for R's window 2l
    int len_p = lp, len_e = le;
    for (int w = 1; w < 2 * l; w *= 2) {
        const bool do_p = w < l;
        if (do_p) len_p -= w;
        len_e -= w;
        for (int j = threadIdx.x; j < len_e; j += kThreads) {
            eb[j] = __fadd_rn(ea[j], ea[j + w]);
            if (do_p && j < len_p) {
                pb_re[j] = __fadd_rn(pa_re[j], pa_re[j + w]);
                pb_im[j] = __fadd_rn(pa_im[j], pa_im[j + w]);
            }
        }
        __syncthreads();
        float* t = ea; ea = eb; eb = t;
        if (do_p) {
            t = pa_re; pa_re = pb_re; pb_re = t;
            t = pa_im; pa_im = pb_im; pb_im = t;
        }
    }
    const size_t base = static_cast<size_t>(row) * nd;
    for (int j = threadIdx.x; j < kTile; j += kThreads) {
        const int i = i0 + j;
        if (i >= nd) break;
        const float pr = pa_re[j], pi = pa_im[j];
        const float rsum = __fmul_rn(0.5f, ea[j]);
        p_out[base + i] = make_float2(pr, pi);
        if constexpr (kMetric) {
            const float eps = 1e-12f;
            const float mag = hypotf(pr, pi);
            const float den = fmaxf(rsum, eps);
            const float m = __fdiv_rn(__fmul_rn(mag, mag),
                                      __fmul_rn(den, den));
            q_out[base + i] = rsum > eps ? m : 0.0f;
        } else {
            q_out[base + i] = rsum;
        }
    }
}

template <bool kMetric>
int launch(const float2* r, float2* p, float* q, int rows, int n, int l,
           void* stream) {
    const int nd = n - 2 * l + 1;
    if (rows <= 0 || nd <= 0) return 0;
    const int tiles = (nd + kTile - 1) / kTile;
    const size_t smem = sizeof(float)
        * (4 * static_cast<size_t>(kTile + l - 1)
           + 2 * static_cast<size_t>(kTile + 2 * l - 1));
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            scfront_kernel<kMetric>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    scfront_kernel<kMetric><<<rows * tiles, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        r, p, q, n, nd, l, tiles);
    return static_cast<int>(cudaGetLastError());
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
