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
//
// The tile needs 4(kTile + l) + 2(kTile + 2l) floats of shared memory,
// 155 KB at l = 4096 and 287 KB at l = 8192, past the 227 KB a block may
// have, so the tile route takes l <= 4096 (kernels/sync.py TILE_MAX_L).
// Above it (n_sc >= 16384: DVB-T2's 16K and 32K modes) the same sums run
// through device memory in 2 + log2 l launches (the levels route,
// kernels/sync.py route): ofdm_sc_leaves writes the lag product's two
// planes and the energy, ofdm_sc_level doubles all three planes once
// (S_2w[i] = S_w[i] + S_w[i + w], w = 1 .. l/2, into the other of two
// plane sets, since a block would otherwise overwrite S_w[i + w] before
// another block reads it), and ofdm_sc_out takes the energy's last level,
// R = 0.5 (S_l[i] + S_l[i + l]), and writes P and M or R with the tile
// kernel's epilogue. Same adds in the same order, so both routes give the
// same bits. Each level reads and writes ~3 planes, so at l = 8192 the
// route moves ~15x the tile kernel's bytes.
#include "ofdm_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;           // outputs per block
constexpr int kMaxTileL = 4096;       // the tile's shared memory <= 227 KB

// The epilogue shared by both routes: P, and M or R, from the window sums.
template <bool kMetric>
__device__ __forceinline__ void write_out(float2* p_out, float* q_out,
                                          size_t at, float pr, float pi,
                                          float esum) {
    const float rsum = __fmul_rn(0.5f, esum);
    p_out[at] = make_float2(pr, pi);
    if constexpr (kMetric) {
        const float eps = 1e-12f;
        const float mag = hypotf(pr, pi);
        const float den = fmaxf(rsum, eps);
        const float m = __fdiv_rn(__fmul_rn(mag, mag), __fmul_rn(den, den));
        q_out[at] = rsum > eps ? m : 0.0f;
    } else {
        q_out[at] = rsum;
    }
}

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
        write_out<kMetric>(p_out, q_out, base + i, pa_re[j], pa_im[j], ea[j]);
    }
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
        write_out<kMetric>(p_out, q_out, k, a[at], a[plane + at],
                           __fadd_rn(a[2 * plane + at],
                                     a[2 * plane + at + l]));
    }
}

unsigned grid_for(size_t total) {
    const size_t blocks = (total + kLevelThreads - 1) / kLevelThreads;
    return static_cast<unsigned>(blocks < (1u << 20) ? blocks : (1u << 20));
}

template <bool kMetric>
int launch(const float2* r, float2* p, float* q, int rows, int n, int l,
           void* stream) {
    const int nd = n - 2 * l + 1;
    if (rows <= 0 || nd <= 0) return 0;
    if (l > kMaxTileL) return static_cast<int>(cudaErrorInvalidValue);
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
