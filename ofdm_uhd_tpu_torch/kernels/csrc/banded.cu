// The banded filter tier at float32 accuracy on the tensor cores (3xTF32):
// the strided real-tap correlation ('same' FIR at stride 1, M-fold
// decimation at stride M, valid-mode window sums), L-fold polyphase
// interpolation, and the Schmidl-Cox window sums, over float32 planes or
// interleaved complex64 rows.
//
// Replaces two TPU kernels that express a filter as a banded matrix
// product on the MXU:
//   K8, ofdm_uhd_tpu/kernels/pallas_fir.py (_banded_kernel, pallas_call at
//     :102): fir_pallas (:133), polyphase_interp_pallas (:150),
//     polyphase_decim_pallas (:174), and pallas_sync.py:40
//     sc_correlate_pallas on its _moving_sum_pallas (:25). Batch rows of
//     (re, im) planes on the MXU's rows, y_j = x_j @ A + head_j @ B with
//     dense banded A, B; jnp.dot at its default precision, which the
//     reference's tests hold to float32 (atol 1e-4 against the XLA
//     backend). Entry points ofdm_banded_strided / ofdm_banded_interp with
//     interleaved = 0, and ofdm_banded_sc.
//   K13, ofdm_uhd_tpu/research/pallas_fir_ilv.py (fir_ilv_pallas :63,
//     polyphase_decim_ilv_pallas :108, polyphase_interp_ilv_pallas :155)
//     on K7b's general-tap _banded_rows_call (pallas_fir_mxu.py:239,
//     pallas_call at :259) at Precision.HIGHEST: the same filters on the
//     interleaved (re, im) layout, with the taps dilated by 2 (w2[0::2] =
//     w) so that one real correlation serves both components. Entry points
//     ofdm_banded_strided / ofdm_banded_interp with interleaved = 1: the
//     kernel reads complex64 in place as float2 (the free bitcast the TPU
//     lacked, pallas_fir_ilv.py:8-21), de-interleaves into two planes in
//     shared memory, and stores float2. It needs no dilated taps: the zero
//     taps were the TPU's way of skipping the other component, which the
//     de-interleaving does here.
//
// The MMA core (the scheme of fir_bf16.cu): no banded matrix exists in
// device memory.
//   strided: a warp takes 16 chunks of a row's outputs as the MMA's M rows
//     and 8 consecutive outputs [j0, j0 + 8) of each chunk as its N
//     columns; K runs only over the band of inputs those outputs touch,
//     u in [j0*s, (j0+7)*s + nt), in steps of 8. A is the chunks' samples
//     staged in shared memory, B the Toeplitz entries w[u - n*s], zero
//     outside the band, independent of j0: one table of B fragments per
//     block serves every output group and plane (a band of ones, the S&C
//     window, is computed in registers instead). Only the outputs kept
//     are computed (the decimation's stride).
//   interpolation: M = 16 consecutive input positions q, N = 8 branches p,
//     K = the branch length nd padded to a multiple of 8; A is the Hankel
//     tile x[q0 + m + k], B the branch matrix with each branch reversed.
//     The result is written in sample order, y[q*L + p].
// Float32 accuracy from TF32 (mma.sync m16n8k8 .tf32, f32 sums): each
// operand splits as hi = rna_tf32(v), lo = rna_tf32(v - hi), and a product
// is lo(a)hi(b) + hi(a)lo(b) + hi(a)hi(b), the small terms first; the
// dropped lo*lo and the rounding of lo are ~2^-22 of |a b|. A band of
// ones has lo = 0: two products. Each k-step's products are summed in a
// zeroed MMA accumulator and then added to the output's float32 sum on
// the CUDA cores, so the tensor cores' own accumulation never spans more
// than 8 taps.
//
// Bound on an H100 SXM: the bytes (the rows in and out once, at 3.35
// TB/s) against the useful multiply-adds times 3 (TF32 products at 495
// TFLOP/s dense), the larger: bytes at C4 (the decimation of 8 x
// 4,138,472 complex64 samples moves 298 MB, 0.089 ms; its products take
// ~0.02 ms). This first version stages each block's inputs into shared
// memory by asynchronous 4-byte copies (cp.async, the planes of a complex
// row de-interleaved on the way, zeros outside the row), then feeds the
// MMAs from there (no ldmatrix, wgmma, TMA or pipelining of the staging
// with the MMAs yet); its times are in PERF.md.
//
// Rows never leak: each row is filtered on its own, with zeros read before
// its start and past its end; ragged tiles are masked at the store.
// Offsets into the rows are size_t.
#include "ofdm_kernels.h"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 16;              // strided: chunks per block (MMA M)
constexpr int kTileQ = 256;              // interp: input positions a block
constexpr size_t kMaxSmem = 232448;      // a block's dynamic shared memory
constexpr size_t kSmemGoal = 80 * 1024;  // strided: two blocks or more an SM

// v rounded to TF32 (nearest, ties away), low 13 bits cleared
__device__ __forceinline__ uint32_t tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
    return r & 0xffffe000u;
}

// Asynchronous 4-byte copy from global to shared memory (cp.async); src-size
// 0 where !in: nothing is read and the word is zeroed.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
    asm volatile(
        "cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
        :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
           "l"(src), "r"(in ? 4 : 0) : "memory");
}

// Wait for this thread's copies, then for the block's.
__device__ __forceinline__ void copies_done() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
}

// hi and lo TF32 parts of v: v = hi + lo + O(2^-22 |v|)
__device__ __forceinline__ uint2 split(float v) {
    const uint32_t hi = tf32(v);
    return make_uint2(hi, tf32(v - __uint_as_float(hi)));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A * B at float32 accuracy. a: this lane's A fragment (rows g,
// g+8 at columns t, t+4: a[0] (g, t), a[1] (g+8, t), a[2] (g, t+4), a[3]
// (g+8, t+4)); b: the B fragment's hi parts (x: row t, y: row t+4 of
// column g) and lo parts (z, w); kOnes: b is a band of ones (lo = 0).
template <bool kOnes>
__device__ __forceinline__ void step3(float (&acc)[4], const float (&a)[4],
                                      uint4 b) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint2 s = split(a[i]);
        hi[i] = s.x;
        lo[i] = s.y;
    }
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32(d, lo, b.x, b.y);
    if (!kOnes) mma_tf32(d, hi, b.z, b.w);
    mma_tf32(d, hi, b.x, b.y);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

// The B fragment of `lane` at k-step kk: rows k = t and t + 4 of column
// n = lane / 4, t = lane % 4; coef(k, n) gives the value.
template <typename Coef>
__device__ __forceinline__ uint4 b_fragment(int lane, int kk, Coef coef) {
    const int n = lane >> 2, k = 8 * kk + (lane & 3);
    const uint2 r0 = split(coef(k, n)), r1 = split(coef(k + 4, n));
    return make_uint4(r0.x, r1.x, r0.y, r1.y);
}

// One strided problem: out[r, i] = scale * sum_t w[t] * xp[r, i*stride +
// t], xp = row r with pad_left zeros in front and zeros past n_in, i <
// n_out; w = nullptr: a band of nt ones. The launch fills nc (outputs a
// chunk, a multiple of 8), span (inputs a chunk), lsw (a chunk's plane
// stride, 4 mod 8 floats, so the 8 chunks of one A load fall in distinct
// banks), ksteps and tiles (blocks a row).
struct Strided {
    const void* x;
    const float* w;
    void* y;
    int rows, n_in, n_out, nt, stride, pad_left;
    float scale;
    int nc, span, lsw, ksteps, tiles;
};

// kPlanes 1: float rows; 2: complex64 rows (float2), de-interleaved into
// two planes. A launch holds one or two problems (the S&C's P and R):
// blocks [0, first_blocks) take `a`, the rest `b`.
template <int kPlanes, bool kOnes>
__global__ void __launch_bounds__(kThreads)
banded_strided_kernel(Strided a, Strided b, int first_blocks) {
    extern __shared__ __align__(16) unsigned char smem[];
    const bool second = static_cast<int>(blockIdx.x) >= first_blocks;
    const Strided s = second ? b : a;
    const int blk = blockIdx.x - (second ? first_blocks : 0);
    uint4* btab = reinterpret_cast<uint4*>(smem);          // [ksteps][32]
    float* planes = reinterpret_cast<float*>(btab + (kOnes ? 0
                                                     : s.ksteps * 32));
    const int plane = kChunks * s.lsw;
    const int row = blk / s.tiles;
    const long long o0 =
        static_cast<long long>(blk - row * s.tiles) * kChunks * s.nc;
    const int nt = s.nt, stride = s.stride;
    if (!kOnes) {
        for (int e = threadIdx.x; e < s.ksteps * 32; e += kThreads) {
            btab[e] = b_fragment(e & 31, e >> 5, [&](int k, int n) {
                const int u = k - n * stride;              // tap index
                return (u >= 0 && u < nt) ? s.w[u] : 0.0f;
            });
        }
    }
    const float* xf = static_cast<const float*>(s.x);
    for (int m = 0; m < kChunks; ++m) {
        const long long first =
            (o0 + static_cast<long long>(m) * s.nc) * stride - s.pad_left;
        float* dst = planes + m * s.lsw;
        for (int j = threadIdx.x; j < s.span; j += kThreads) {
            const long long k = first + j;
            const bool in = k >= 0 && k < s.n_in;
            const size_t at = kPlanes * (static_cast<size_t>(row) * s.n_in
                                         + (in ? k : 0));
            copy4(dst + j, xf + at, in);
            if (kPlanes == 2) copy4(dst + plane + j, xf + at + 1, in);
        }
    }
    copies_done();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int lo = g * s.lsw, hi = (g + 8) * s.lsw;        // A rows g, g+8
    for (int grp = warp; grp < s.nc / 8; grp += kWarps) {
        const int j0 = grp * 8;
        float acc[kPlanes][4] = {};
        const int base = j0 * stride + t;
        for (int kk = 0; kk < s.ksteps; ++kk) {
            uint4 bf;
            if (kOnes) {
                // B[k][n] = 1 where 0 <= k - n*stride < nt
                const int u = 8 * kk + t - g * stride;
                const uint32_t one = 0x3f800000u;
                bf = make_uint4(u >= 0 && u < nt ? one : 0u,
                                u + 4 >= 0 && u + 4 < nt ? one : 0u, 0u, 0u);
            } else {
                bf = btab[kk * 32 + lane];
            }
            const int o = base + 8 * kk;
#pragma unroll
            for (int p = 0; p < kPlanes; ++p) {
                const float* pl = planes + p * plane;
                const float av[4] = {pl[lo + o], pl[hi + o], pl[lo + o + 4],
                                     pl[hi + o + 4]};
                step3<kOnes>(acc[p], av, bf);
            }
        }
        // acc[.][0], [1]: chunk g, outputs j0 + 2t, +1; [2], [3]: chunk g+8
        for (int h = 0; h < 2; ++h) {
            const long long i0 = o0 + static_cast<long long>(g + 8 * h) * s.nc
                                 + j0 + 2 * t;
            for (int c = 0; c < 2; ++c) {
                const long long i = i0 + c;
                if (i >= s.n_out) continue;
                const size_t at = static_cast<size_t>(row) * s.n_out + i;
                if constexpr (kPlanes == 2) {
                    static_cast<float2*>(s.y)[at] =
                        make_float2(s.scale * acc[0][2 * h + c],
                                    s.scale * acc[1][2 * h + c]);
                } else {
                    static_cast<float*>(s.y)[at] = s.scale * acc[0][2 * h + c];
                }
            }
        }
    }
}

// y[r, q*l + p] = sum_t grev[p, t] * xp[r, q + t], grev = the branch
// matrix g [l, nd] with each branch reversed, xp = row r with d_max zeros
// in front; q < n. A block takes kTileQ positions q of one row, in MMA
// tiles of 16 q x 8 branches (l > 8: several tiles of branches).
template <int kPlanes>
__global__ void __launch_bounds__(kThreads)
banded_interp_kernel(const void* __restrict__ x, const float* __restrict__ g,
                     void* __restrict__ y, int n, int l, int nd, int d_max,
                     int ksteps, int ntn, int tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint4* btab = reinterpret_cast<uint4*>(smem);      // [ntn][ksteps][32]
    const int span = kTileQ + 8 * ksteps;
    float* planes = reinterpret_cast<float*>(btab + ntn * ksteps * 32);
    const int row = blockIdx.x / tiles;
    const int q0 = (blockIdx.x - row * tiles) * kTileQ;
    for (int e = threadIdx.x; e < ntn * ksteps * 32; e += kThreads) {
        const int kk = (e >> 5) % ksteps, nb = (e >> 5) / ksteps;
        btab[e] = b_fragment(e & 31, kk, [&](int k, int c) {
            const int p = nb * 8 + c;
            return (p < l && k < nd) ? g[p * nd + (nd - 1 - k)] : 0.0f;
        });
    }
    const float* xf = static_cast<const float*>(x);
    for (int j = threadIdx.x; j < span; j += kThreads) {
        const long long k = static_cast<long long>(q0) - d_max + j;
        const bool in = k >= 0 && k < n;
        const size_t at = kPlanes * (static_cast<size_t>(row) * n
                                     + (in ? k : 0));
        copy4(planes + j, xf + at, in);
        if (kPlanes == 2) copy4(planes + span + j, xf + at + 1, in);
    }
    copies_done();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, t = lane & 3;
    const size_t n_out = static_cast<size_t>(n) * l;
    for (int mt = warp; mt < kTileQ / 16; mt += kWarps) {
        const int qb = mt * 16;
        if (q0 + qb >= n) break;
        for (int nb = 0; nb < ntn; ++nb) {
            float acc[kPlanes][4] = {};
            for (int kk = 0; kk < ksteps; ++kk) {
                const uint4 bf = btab[(nb * ksteps + kk) * 32 + lane];
                // A[m, k] = xs[qb + 8kk + m + k] (Hankel)
                const int o = qb + 8 * kk + gq + t;
#pragma unroll
                for (int p = 0; p < kPlanes; ++p) {
                    const float* pl = planes + p * span;
                    const float av[4] = {pl[o], pl[o + 8], pl[o + 4],
                                         pl[o + 12]};
                    step3<false>(acc[p], av, bf);
                }
            }
            // [0], [1]: q = qb + gq, branches 2t, 2t+1; [2], [3]: q + 8
            for (int h = 0; h < 2; ++h) {
                const int q = q0 + qb + gq + 8 * h;
                if (q >= n) continue;
                for (int c = 0; c < 2; ++c) {
                    const int p = nb * 8 + 2 * t + c;
                    if (p >= l) continue;
                    const size_t at = row * n_out
                                      + static_cast<size_t>(q) * l + p;
                    if constexpr (kPlanes == 2) {
                        static_cast<float2*>(y)[at] = make_float2(
                            acc[0][2 * h + c], acc[1][2 * h + c]);
                    } else {
                        static_cast<float*>(y)[at] = acc[0][2 * h + c];
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

// Fill a problem's tiling: the widest chunk (outputs, a multiple of 8)
// whose block stays within kSmemGoal, else the narrowest that fits at all.
// Returns its shared memory, 0 where none fits (a band too wide).
size_t plan(Strided& s, int planes, bool ones) {
    s.ksteps = (7 * s.stride + s.nt + 7) / 8;
    const size_t table = ones ? 0 : sizeof(uint4) * 32 * s.ksteps;
    size_t smem = 0;
    for (int nc = 64; nc >= 8; nc /= 2) {
        const int span = (nc - 8) * s.stride + 8 * s.ksteps;
        const int lsw = (span + 7) / 8 * 8 + 4;          // > span, 4 mod 8
        const size_t need = table
            + sizeof(float) * planes * kChunks * static_cast<size_t>(lsw);
        if (need > kMaxSmem) continue;
        s.nc = nc;
        s.span = span;
        s.lsw = lsw;
        smem = need;
        if (need <= kSmemGoal) break;
    }
    if (smem == 0) return 0;
    s.tiles = (s.n_out + kChunks * s.nc - 1) / (kChunks * s.nc);
    return smem;
}

template <int kPlanes, bool kOnes>
int launch_strided(Strided a, Strided b, int first_blocks, int blocks,
                   size_t smem, void* stream) {
    auto kernel = banded_strided_kernel<kPlanes, kOnes>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        a, b, first_blocks);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

OFDM_API int ofdm_banded_strided(const void* x, const float* w, void* y,
                                 int rows, int n_in, int n_out, int nt,
                                 int stride, int pad_left, int interleaved,
                                 void* stream) {
    if (rows <= 0 || n_out <= 0) return 0;
    if (nt < 1 || stride < 1) return static_cast<int>(cudaErrorInvalidValue);
    Strided s{x, w, y, rows, n_in, n_out, nt, stride, pad_left, 1.0f};
    const int planes = interleaved ? 2 : 1;
    const size_t smem = plan(s, planes, false);
    if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = rows * s.tiles;
    return interleaved
        ? launch_strided<2, false>(s, s, blocks, blocks, smem, stream)
        : launch_strided<1, false>(s, s, blocks, blocks, smem, stream);
}

OFDM_API int ofdm_banded_interp(const void* x, const float* g, void* y,
                                int rows, int n, int l, int nd, int d_max,
                                int interleaved, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (l < 1 || nd < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int ksteps = (nd + 7) / 8, ntn = (l + 7) / 8;
    const int planes = interleaved ? 2 : 1;
    const size_t smem = sizeof(uint4) * ntn * ksteps * 32
        + sizeof(float) * planes * (kTileQ + 8 * ksteps);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (n + kTileQ - 1) / kTileQ;
    cudaError_t err;
    if (interleaved) {
        err = allow_smem(banded_interp_kernel<2>, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        banded_interp_kernel<2><<<rows * tiles, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
            x, g, y, n, l, nd, d_max, ksteps, ntn, tiles);
    } else {
        err = allow_smem(banded_interp_kernel<1>, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        banded_interp_kernel<1><<<rows * tiles, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
            x, g, y, n, l, nd, d_max, ksteps, ntn, tiles);
    }
    return static_cast<int>(cudaGetLastError());
}

OFDM_API int ofdm_banded_sc(const float* s, const float* e, float* p,
                            float* rr, int rows, int n, int l,
                            void* stream) {
    const int nd = n - 2 * l + 1;
    if (rows <= 0 || nd <= 0) return 0;
    if (l < 1) return static_cast<int>(cudaErrorInvalidValue);
    // P's planes: window l over the lag products' [2 rows, n - l]; R: half
    // the window-2l sum over the energies [rows, n]
    Strided a{s, nullptr, p, 2 * rows, n - l, nd, l, 1, 0, 1.0f};
    Strided b{e, nullptr, rr, rows, n, nd, 2 * l, 1, 0, 0.5f};
    const size_t smem_a = plan(a, 1, true), smem_b = plan(b, 1, true);
    if (smem_a == 0 || smem_b == 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int first = a.rows * a.tiles;
    return launch_strided<1, true>(a, b, first, first + b.rows * b.tiles,
                                   smem_a > smem_b ? smem_a : smem_b, stream);
}
