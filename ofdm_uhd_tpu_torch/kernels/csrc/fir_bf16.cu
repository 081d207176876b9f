// The bf16 filter tier: the strided real-tap FIR ('same' FIR at stride 1,
// M-fold decimation at stride M) and L-fold polyphase interpolation of
// complex rows, with products of bf16-rounded samples and taps summed in
// float32 on the tensor cores (mma.sync m16n8k16, bf16 -> f32).
//
// Replaces: ofdm_uhd_tpu/kernels/pallas_fir_mxu.py, K7 at
// Precision.DEFAULT (1-pass bf16 products, f32 sums): fir_mxu_pallas
// (:134) and polyphase_decim_mxu_pallas (:154) through _fir_rows_mxu /
// _mxu_kernel (pallas_call at :116), and polyphase_interp_mxu_pallas (:176,
// pallas_call at :220). The TPU form stores dense banded matrices A, B and
// runs rows @ A + next_rows @ B on the MXU, at 2.7-6.6x the multiply-adds
// the filter needs. Here no banded matrix exists in device memory:
//
//   strided: a warp takes 16 chunks of a row's outputs as the MMA's M rows
//     and 8 consecutive outputs [j0, j0 + 8) of each chunk as its N
//     columns; K runs only over the band of inputs those outputs touch,
//     u in [j0*s, (j0+7)*s + nt), in steps of 16. A is the chunks' samples
//     (bf16, staged in shared memory), B the Toeplitz entries w[u - n*s],
//     zero outside the band, which do not depend on j0: one table of B
//     fragments per block serves every output group and both planes.
//     Extra multiply-adds: 16 * ceil((7s + nt) / 16) / nt, at C4 (193 taps)
//     1.33x at stride 8 (256 / 193) and 1.08x at stride 1 (208 / 193).
//   interpolation: M = 16 consecutive input positions q, N = 8 branches p,
//     K = the branch length nd padded to a multiple of 16 (25 -> 32 at C4,
//     1.28x). A is the Hankel tile x[q0 + m + k], B the reversed branch
//     matrix transposed, in shared memory. At L = 8 the 16 x 8 result is
//     128 outputs in sample order.
//
// Rounding: samples and coefficients to bf16 by __float2bfloat16_rn (round
// to nearest even, as torch's .to(torch.bfloat16)); the products are exact
// in float32 and the tensor cores sum them in float32, in another order
// than the plain version's convolution.
//
// Bound on an H100 SXM: the bytes (complex64 in and out, each once, at
// 3.35 TB/s) against the useful multiply-adds (4 nt flops a complex output
// at 989 TFLOP/s dense bf16), the larger: bytes. At C4 the decimation of 8
// captures x 4,138,468 radio samples moves 298 MB, 0.089 ms. This first
// version stages every input through shared memory and feeds each MMA
// from there (no ldmatrix, wgmma, TMA or pipelining yet). On an H100 80GB
// HBM3 (700 W), measured by chip_smoke.py, the C4 decimation takes 0.17 ms
// inside the kernel (1.9x the bound; the exact fir.cu kernel 1.6 ms) and
// the TX interpolation of [32, 16128] 0.016 ms (bound 0.011 ms).
//
// Rows never leak: each row is filtered on its own, with zeros read before
// its start and past its end; ragged tiles are masked at the store.
// Offsets into the rows are size_t.
#include "ofdm_kernels.h"

#include <cuda_bf16.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 16;            // strided: chunks per block (MMA M)
constexpr int kTileQ = 256;            // interp: input positions per block
constexpr size_t kMaxSmem = 232448;    // a block's dynamic shared memory

__device__ __forceinline__ unsigned short bf16_bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo,
                                          unsigned short hi) {
    return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint2 b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

// The B fragment of `lane` holds rows k = 2t, 2t+1 (b.x) and 2t+8, 2t+9
// (b.y) of column n = lane / 4, t = lane % 4; coef(k, n) gives the value.
template <typename Coef>
__device__ __forceinline__ uint2 b_fragment(int lane, Coef coef) {
    const int n = lane >> 2, k = 2 * (lane & 3);
    return make_uint2(pack2(bf16_bits(coef(k, n)), bf16_bits(coef(k + 1, n))),
                      pack2(bf16_bits(coef(k + 8, n)),
                            bf16_bits(coef(k + 9, n))));
}

// out[r, i] = sum_t bf16(w[t]) * bf16(xp[r, i*stride + t]), xp = row r with
// pad_left zeros in front and zeros past its end; i < n_out. A block takes
// kChunks chunks of nc consecutive outputs of one row; chunk m's inputs
// from its first output's band start, span of them, sit in shared memory
// at row m of planes [kChunks][2 * lsw] (bf16 pairs as 32-bit words; lsw =
// 4 mod 8 words, so the 8 chunks of one A load fall in distinct banks).
__global__ void __launch_bounds__(kThreads)
fir_bf16_strided_kernel(const float2* __restrict__ x,
                        const float* __restrict__ w, float2* __restrict__ y,
                        int n_in, int n_out, int nt, int stride, int pad_left,
                        int nc, int span, int lsw, int ksteps, int tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint2* btab = reinterpret_cast<uint2*>(smem);          // [ksteps][32]
    unsigned short* xre =
        reinterpret_cast<unsigned short*>(btab + ksteps * 32);
    unsigned short* xim = xre + kChunks * 2 * lsw;
    const int row = blockIdx.x / tiles;
    const long long o0 =
        static_cast<long long>(blockIdx.x - row * tiles) * kChunks * nc;
    for (int e = threadIdx.x; e < ksteps * 32; e += kThreads) {
        const int kk = e >> 5;
        btab[e] = b_fragment(e & 31, [&](int k, int n) {
            const int u = 16 * kk + k - n * stride;        // tap index
            return (u >= 0 && u < nt) ? w[u] : 0.0f;
        });
    }
    const float2* xr = x + static_cast<size_t>(row) * n_in;
    for (int m = 0; m < kChunks; ++m) {
        const long long first = (o0 + static_cast<long long>(m) * nc) * stride
                                - pad_left;
        unsigned short* rre = xre + m * 2 * lsw;
        unsigned short* rim = xim + m * 2 * lsw;
        for (int j = threadIdx.x; j < span; j += kThreads) {
            const long long s = first + j;
            const float2 v = (s >= 0 && s < n_in) ? xr[s]
                                                  : make_float2(0.0f, 0.0f);
            rre[j] = bf16_bits(v.x);
            rim[j] = bf16_bits(v.y);
        }
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t* wre = reinterpret_cast<const uint32_t*>(xre);
    const uint32_t* wim = reinterpret_cast<const uint32_t*>(xim);
    const int lo = g * lsw, hi = (g + 8) * lsw;             // A rows g, g+8
    float2* yr = y + static_cast<size_t>(row) * n_out;
    for (int grp = warp; grp < nc / 8; grp += kWarps) {
        const int j0 = grp * 8;
        float dre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float dim[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        // word of the pair (2t, 2t+1) at k-step 0: j0*stride is even
        const int base = (j0 * stride) / 2 + t;
        for (int kk = 0; kk < ksteps; ++kk) {
            const uint2 b = btab[kk * 32 + lane];
            const int o = base + 8 * kk;
            mma_bf16(dre, wre[lo + o], wre[hi + o], wre[lo + o + 4],
                     wre[hi + o + 4], b);
            mma_bf16(dim, wim[lo + o], wim[hi + o], wim[lo + o + 4],
                     wim[hi + o + 4], b);
        }
        // d[0], d[1]: chunk g, outputs j0 + 2t, +1; d[2], d[3]: chunk g+8
        for (int h = 0; h < 2; ++h) {
            const long long i = o0 + static_cast<long long>(g + 8 * h) * nc
                                + j0 + 2 * t;
            for (int c = 0; c < 2; ++c) {
                if (i + c < n_out) {
                    yr[i + c] = make_float2(dre[2 * h + c], dim[2 * h + c]);
                }
            }
        }
    }
}

// y[r, q*l + p] = sum_t bf16(grev[p, t]) * bf16(xp[r, q + t]), grev = the
// branch matrix g [l, nd] with each branch reversed, xp = row r with d_max
// zeros in front; q < n. A block takes kTileQ positions q of one row, in
// MMA tiles of 16 q x 8 branches (l > 8: several tiles of branches).
__global__ void __launch_bounds__(kThreads)
fir_bf16_interp_kernel(const float2* __restrict__ x,
                       const float* __restrict__ g, float2* __restrict__ y,
                       int n, int l, int nd, int d_max, int ksteps, int ntn,
                       int tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint2* btab = reinterpret_cast<uint2*>(smem);      // [ntn][ksteps][32]
    const int span = kTileQ + 16 * ksteps;
    unsigned short* xre =
        reinterpret_cast<unsigned short*>(btab + ntn * ksteps * 32);
    unsigned short* xim = xre + span;
    const int row = blockIdx.x / tiles;
    const int q0 = (blockIdx.x - row * tiles) * kTileQ;
    for (int e = threadIdx.x; e < ntn * ksteps * 32; e += kThreads) {
        const int kk = (e >> 5) % ksteps, nb = (e >> 5) / ksteps;
        btab[e] = b_fragment(e & 31, [&](int k, int n) {
            const int p = nb * 8 + n, tt = 16 * kk + k;
            return (p < l && tt < nd) ? g[p * nd + (nd - 1 - tt)] : 0.0f;
        });
    }
    const float2* xr = x + static_cast<size_t>(row) * n;
    for (int j = threadIdx.x; j < span; j += kThreads) {
        const long long s = static_cast<long long>(q0) - d_max + j;
        const float2 v = (s >= 0 && s < n) ? xr[s] : make_float2(0.0f, 0.0f);
        xre[j] = bf16_bits(v.x);
        xim[j] = bf16_bits(v.y);
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, t2 = 2 * (lane & 3);
    const size_t n_out = static_cast<size_t>(n) * l;
    float2* yr = y + static_cast<size_t>(row) * n_out;
    for (int mt = warp; mt < kTileQ / 16; mt += kWarps) {
        const int qb = mt * 16;
        if (q0 + qb >= n) break;
        for (int nb = 0; nb < ntn; ++nb) {
            float dre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            float dim[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int kk = 0; kk < ksteps; ++kk) {
                const uint2 b = btab[(nb * ksteps + kk) * 32 + lane];
                // A[m, k] = xs[qb + 16kk + m + k] (Hankel): row g+8 at k
                // equals row g at k+8, so three pairs fill the four words
                const int o = qb + 16 * kk + gq + t2;
                const uint32_t r0 = pack2(xre[o], xre[o + 1]);
                const uint32_t r1 = pack2(xre[o + 8], xre[o + 9]);
                const uint32_t r2 = pack2(xre[o + 16], xre[o + 17]);
                mma_bf16(dre, r0, r1, r1, r2, b);
                const uint32_t i0 = pack2(xim[o], xim[o + 1]);
                const uint32_t i1 = pack2(xim[o + 8], xim[o + 9]);
                const uint32_t i2 = pack2(xim[o + 16], xim[o + 17]);
                mma_bf16(dim, i0, i1, i1, i2, b);
            }
            // d[0], d[1]: q = qb + gq, branches t2, t2+1; d[2], d[3]: q + 8
            for (int h = 0; h < 2; ++h) {
                const int q = q0 + qb + gq + 8 * h;
                if (q >= n) continue;
                for (int c = 0; c < 2; ++c) {
                    const int p = nb * 8 + t2 + c;
                    if (p < l) {
                        yr[static_cast<size_t>(q) * l + p] =
                            make_float2(dre[2 * h + c], dim[2 * h + c]);
                    }
                }
            }
        }
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

OFDM_API int ofdm_fir_bf16_strided(const float2* x, const float* w, float2* y,
                                   int rows, int n_in, int n_out, int nt,
                                   int stride, int pad_left, void* stream) {
    if (rows <= 0 || n_out <= 0) return 0;
    if (nt < 1 || stride < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int ksteps = (7 * stride + nt + 15) / 16;
    // the widest chunk (outputs, a multiple of 8) whose planes fit
    for (int nc = 64; nc >= 8; nc /= 2) {
        const int span = (nc - 8) * stride + 16 * ksteps;
        const int lsw = (span / 2 + 3) / 8 * 8 + 4;     // >= span / 2, 4 mod 8
        const size_t smem = sizeof(uint2) * ksteps * 32
            + sizeof(uint32_t) * 2 * kChunks * static_cast<size_t>(lsw);
        if (smem > kMaxSmem) continue;
        cudaError_t err = allow_smem(fir_bf16_strided_kernel, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        const int tiles = (n_out + kChunks * nc - 1) / (kChunks * nc);
        fir_bf16_strided_kernel<<<rows * tiles, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
            x, w, y, n_in, n_out, nt, stride, pad_left, nc, span, lsw,
            ksteps, tiles);
        return static_cast<int>(cudaGetLastError());
    }
    return static_cast<int>(cudaErrorInvalidValue);    // band too wide
}

OFDM_API int ofdm_fir_bf16_interp(const float2* x, const float* g, float2* y,
                                  int rows, int n, int l, int nd, int d_max,
                                  void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (l < 1 || nd < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int ksteps = (nd + 15) / 16, ntn = (l + 7) / 8;
    const size_t smem = sizeof(uint2) * ntn * ksteps * 32
        + sizeof(unsigned short) * 2 * (kTileQ + 16 * ksteps);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = allow_smem(fir_bf16_interp_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (n + kTileQ - 1) / kTileQ;
    fir_bf16_interp_kernel<<<rows * tiles, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        x, g, y, n, l, nd, d_max, ksteps, ntn, tiles);
    return static_cast<int>(cudaGetLastError());
}
