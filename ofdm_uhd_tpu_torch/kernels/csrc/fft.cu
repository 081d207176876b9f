// Batched orthonormal FFT / IFFT along rows, complex64, for power-of-two
// lengths 2..8192 in one launch (the chain uses N = 256 on RX and TX at C3
// and C5, 1024 at C4, 64 at C2), its two CP-fused forms, and the two
// passes of the route above 8192 points.
//
// Replaces:
//   ofdm_fft (K3): ofdm_uhd_tpu/kernels/pallas_fft.py:185 fft_pallas
//     (_build_fft :82, _direct_kernel :75);
//   ofdm_fft_cp (K5): pallas_fft.py:191 cp_strip_fft_pallas and :204
//     ifft_cp_pallas (_build_fused :108). The TPU kernel folds the CP
//     strip into zero rows of a dense [sym_len, n] DFT matrix, and the CP
//     insertion into n + cp columns, so that its MXU reads the raw symbol
//     rows and writes the prefixed rows in one pass.
// The TPU's dense DFT is O(N^2) work that this card's f32 units should not
// do, so both are an FFT here; K5 keeps what the TPU form saved, the extra
// passes over device memory: the strip is an offset and a row stride on
// the load (no contiguous copy of the windows), and the CP is a second
// store of the row's last cp outputs from the same registers (no
// concatenation pass). K3 is the case of contiguous rows and no CP, so
// K5 on contiguous windows gives K3's bits.
//
// Bound on this card: memory. A row reads and writes 8 B a sample against
// 5 N log2 N flops, ~5 flops a byte at N = 256, far under the f32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20): at C3 ([114912, 256]) 16 B a sample is
// 0.1405 ms at 3.35 TB/s. The previous body (a radix-2 FFT in shared
// memory: a bit-reversed scatter on the load, log2 N stages of one
// butterfly a thread between barriers, the twiddle table copied into
// every block) ran K3 at C3 in 0.454 ms and K5 RX at c3_pallas in 0.479
// (torch.fft.fft 0.338 and 0.359; NVIDIA H100 80GB HBM3, 700 W): ~150 B
// of shared-memory traffic a sample held it at 31% of its bound.
//
// Design: a self-sorting Stockham FFT with the data in registers. An
// N-point transform (N >= 32) is shared by T = N / 16 threads, thread t
// holding the 16 samples t + T m (m < 16) in registers; a block of 256
// threads holds 4096 / N transforms. The plan is a compile-time constant
// per log2 N: radix-16 passes, then one pass of the remaining radix
// (32 = 16x2, 64 = 16x4, 128 = 16x8, 256 = 16x16, 512 = 16x16x2,
// 1024 = 16x16x4, 2048 = 16x16x8, 4096 = 16x16x16, one transform a
// block; N <= 16 is one pass a thread). Each
// pass is E / R radix-R DFTs a thread, written out in registers (16 as
// 4x4, 8 as 4x2; the +-i rotations swaps and sign flips, the (1 +- i) /
// sqrt 2 ones an add and a scale), after its inputs are multiplied by
// the pass's twiddles. Between two passes the transform goes once
// through shared memory: every pass reads sample t + T m of thread t,
// so the first pass loads straight from device memory (all 16 loads
// issued before the first use, neighbouring threads on neighbouring
// addresses) and the last stores in natural order, coalesced, with the
// 1/sqrt N scale folded in; there is no bit reversal. The exchange pads
// one float2 every 16 (index i at i + i / 16), which keeps both the
// strided writes (stride 16 in the first pass) and the reads free of bank
// conflicts for every plan. N = 256 is 2 passes, 1 exchange and 1
// barrier; N = 1024 3 passes, 2 exchanges and 3 barriers. Twiddles: the
// wrapper's table (kernels/fft.py twiddle_table) holds, for each pass
// after the first, exp(-2 pi i q r / (NS R)) at [(r - 1) NS + q] (NS the
// points already transformed, q < NS, 0 < r < R), from float64 cast to
// complex64, read through __ldg (coalesced, L1-resident). The inverse
// conjugates its input and output; no __sincosf.
//
// Why this plan: 16 samples a thread is the widest radix whose DFT stays
// in registers with 2 blocks an SM or more (ptxas: 78 registers at
// N = 256, so 3 blocks; 116-128 at 512-4096, so 2; no spills), and with
// 16 a thread one padding serves every plan. Measured by chip_smoke.py
// (NVIDIA H100 80GB HBM3, 700 W), in-kernel: K3 at C3 0.160 ms (88% of
// its bound; the previous body 0.429 in the same run), K5 RX at
// c3_pallas 0.163, both at the time of cuFFT's own transform
// (torch.fft.fft with norm="backward", 0.160 and 0.165) and half that of
// torch.fft.fft(norm="ortho"), 0.323 and 0.327, which scales in a second
// pass. At C4 (N = 1024, [3808, 1024]) 0.025 ms, 74% of the bound, where
// cuFFT's transform takes 0.024: the same share as N = 256 at the same
// bytes (c5_sharded, 0.023), so what is left there is the run's size
// (ramp and tail over ~3.6 waves of blocks), not the plan. N <= 32, which
// no path runs, is not tuned: there a warp spans 16 or more transforms,
// so each load instruction uses part of every sector it touches.
//
// N = 8192 is one launch too: a transform of 512 threads, one a block,
// its exchanges (68 KB) in dynamic shared memory.
//
// Above one launch (kernels/fft.py route) a transform is N = N1 N2 in two
// launches, each reading and writing every row once, with no transpose
// launch: a column pass (ofdm_fft_columns) takes the N1-point transforms
// over each row's [N1, N2] view at element stride N2, multiplies them by
// W_N^(n2 k1) and stores them in place of their inputs' layout; a row pass
// (ofdm_fft_rows_t) takes the N2-point transforms of the rows that leaves
// and stores Z[k1, k2] at X[k1 + N1 k2] through a shared tile, so that the
// output is in natural order. Both passes run the same Stockham body; the
// designs of their loads and stores are at the kernels. Each pass moves
// the row once, so the route's floor is twice one launch's bytes. The
// five-launch route this replaces (a transpose, K3 on rows of N1, a
// transpose with the twiddles, K3 on rows of N2, a transpose) moved the
// row five times. Measured by chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W),
// in-kernel on 2^23 samples: 8192 in one launch 0.057 ms (two passes
// 0.100; the one-pass byte bound 0.040); 16384-65536 in two passes
// 0.101-0.103 at N2 = 512, 0.104-0.107 at 1024, 0.11-0.22 at 2048 and
// 4096 (fewer rows a block, shorter store runs); the five launches took
// 0.239-0.243, torch.fft.fft(norm="ortho") 0.101-0.154.
#include <cmath>

#include "ofdm_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLog2N = 13;       // one launch of K3 (512 threads at 13)
constexpr int kMaxPassLog2N = 12;   // each pass of the two-pass route

constexpr float kR2 = 0.70710678118654752f;    // 1 / sqrt(2)
constexpr float kC16 = 0.92387953251128674f;   // cos(pi / 8)
constexpr float kS16 = 0.38268343236508978f;   // sin(pi / 8)

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
    return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// v * exp(-2 pi i e / r) for r dividing 16; e and r are constants once the
// loops around the call are unrolled, so the switch folds away.
__device__ __forceinline__ float2 rotate(float2 v, int e, int r) {
    const int k = (e * (16 / r)) & 15;         // sixteenths of a turn
    switch (k) {
    case 0: return v;
    case 4: return make_float2(v.y, -v.x);                        // -i
    case 8: return make_float2(-v.x, -v.y);                       // -1
    case 12: return make_float2(-v.y, v.x);                       // +i
    case 2: return make_float2(kR2 * (v.x + v.y), kR2 * (v.y - v.x));
    case 6: return make_float2(kR2 * (v.y - v.x), -kR2 * (v.x + v.y));
    case 10: return make_float2(-kR2 * (v.x + v.y), kR2 * (v.x - v.y));
    case 14: return make_float2(kR2 * (v.x - v.y), kR2 * (v.x + v.y));
    default: break;
    }
    // odd sixteenths: cos and sin of 2 pi k / 16 from cos and sin of pi/8
    float c, s;
    switch (k) {
    case 1: c = kC16; s = kS16; break;
    case 3: c = kS16; s = kC16; break;
    case 5: c = -kS16; s = kC16; break;
    case 7: c = -kC16; s = kS16; break;
    case 9: c = -kC16; s = -kS16; break;
    case 11: c = -kS16; s = -kC16; break;
    case 13: c = kS16; s = -kC16; break;
    default: c = kC16; s = -kS16; break;       // 15
    }
    return make_float2(v.x * c + v.y * s, v.y * c - v.x * s);
}

// In-place DFT of a[0..R), natural order in and out, in registers.
template <int R>
struct Dft;

template <>
struct Dft<2> {
    static __device__ __forceinline__ void run(float2 (&a)[2]) {
        const float2 d = csub(a[0], a[1]);
        a[0] = cadd(a[0], a[1]);
        a[1] = d;
    }
};

template <>
struct Dft<4> {
    static __device__ __forceinline__ void run(float2 (&a)[4]) {
        const float2 s0 = cadd(a[0], a[2]), d0 = csub(a[0], a[2]);
        const float2 s1 = cadd(a[1], a[3]), d1 = csub(a[1], a[3]);
        const float2 d1i = make_float2(d1.y, -d1.x);          // -i d1
        a[0] = cadd(s0, s1);
        a[2] = csub(s0, s1);
        a[1] = cadd(d0, d1i);
        a[3] = csub(d0, d1i);
    }
};

// R = 4 * R2 (8, 16): n = R2 n1 + n2, k = k1 + 4 k2; DFT-4 over n1, the
// rotations exp(-2 pi i n2 k1 / R), DFT-R2 over n2.
template <int R>
struct Dft {
    static __device__ __forceinline__ void run(float2 (&a)[R]) {
        constexpr int R2 = R / 4;
        float2 b[R2][4];
#pragma unroll
        for (int n2 = 0; n2 < R2; ++n2) {
            float2 c[4];
#pragma unroll
            for (int n1 = 0; n1 < 4; ++n1) c[n1] = a[R2 * n1 + n2];
            Dft<4>::run(c);
#pragma unroll
            for (int k1 = 0; k1 < 4; ++k1) b[n2][k1] = rotate(c[k1], n2 * k1, R);
        }
#pragma unroll
        for (int k1 = 0; k1 < 4; ++k1) {
            float2 d[R2];
#pragma unroll
            for (int n2 = 0; n2 < R2; ++n2) d[n2] = b[n2][k1];
            Dft<R2>::run(d);
#pragma unroll
            for (int k2 = 0; k2 < R2; ++k2) a[k1 + 4 * k2] = d[k2];
        }
    }
};

// The plan for N = 2^L: E samples a thread, T threads a transform, passes
// of radix 16 and then the remaining radix. A block has kThreads threads,
// or T where one transform needs more (N = 8192: 512).
template <int L>
struct Plan {
    static constexpr int N = 1 << L;
    static constexpr int E = N < 16 ? N : 16;
    static constexpr int T = N / E;
    static constexpr int kPasses = (L + 3) / 4;
    static constexpr int kBlock = T > kThreads ? T : kThreads;
    static constexpr int kPerBlock = kBlock / T;       // transforms a block
    static constexpr int kStride = N + N / 16;         // padded, in shared
    // the exchanges' float2s a block; above 48 KB only as dynamic memory
    static constexpr int kSmem = kPasses > 1 ? kPerBlock * kStride : 1;
    static constexpr bool kDynamic = kSmem * 8 > 48 * 1024;
    __host__ __device__ static constexpr int radix(int p) {
        return p + 1 < kPasses ? 16 : N >> (4 * (kPasses - 1));
    }
    __host__ __device__ static constexpr int ns(int p) { return 1 << (4 * p); }
    // the pass's twiddles in the table: 15 NS for each earlier radix-16
    // pass after the first
    __host__ __device__ static constexpr int tw_offset(int p) {
        return p <= 1 ? 0 : tw_offset(p - 1) + 15 * ns(p - 1);
    }
};

// Pass p: thread t's butterflies j = t + b T (b < E / R) take v[b + r E/R],
// r < R, times exp(-2 pi i (j % NS) r / (NS R)), into a DFT-R.
template <int L, int P>
__device__ __forceinline__ void fft_pass(float2 (&v)[Plan<L>::E], int t,
                                         const float2* __restrict__ tw) {
    using Pl = Plan<L>;
    constexpr int E = Pl::E, T = Pl::T, R = Pl::radix(P), NS = Pl::ns(P);
#pragma unroll
    for (int b = 0; b < E / R; ++b) {
        float2 a[R];
#pragma unroll
        for (int r = 0; r < R; ++r) a[r] = v[b + r * (E / R)];
        if constexpr (NS > 1) {
            const float2* w = tw + Pl::tw_offset(P) + (t + b * T) % NS;
#pragma unroll
            for (int r = 1; r < R; ++r) a[r] = cmul(a[r], __ldg(w + (r - 1) * NS));
        }
        Dft<R>::run(a);
#pragma unroll
        for (int r = 0; r < R; ++r) v[b + r * (E / R)] = a[r];
    }
}

// Where sample i of a transform lies in shared memory, from its base: a
// padded row, one float2 skipped every 16 (Pad: K3, K5 and the row pass),
// or the C columns of a block interleaved, sample i of column c at i C + c
// (Cols<C>: the column pass, whose neighbouring lanes hold neighbouring
// columns).
struct Pad {
    static __device__ __forceinline__ int at(int i) { return i + (i >> 4); }
};

template <int C>
struct Cols {
    static __device__ __forceinline__ int at(int i) { return i * C; }
};

// After pass p: output r of butterfly j goes to (j / NS) NS R + j % NS +
// r NS of the transform (Stockham's self-sorting order); thread t then
// reads back samples t + T m. s is the transform's base in shared memory.
template <int L, int P, class Lay>
__device__ __forceinline__ void exchange(float2 (&v)[Plan<L>::E], int t,
                                         float2* s) {
    using Pl = Plan<L>;
    constexpr int E = Pl::E, T = Pl::T, R = Pl::radix(P), NS = Pl::ns(P);
#pragma unroll
    for (int b = 0; b < E / R; ++b) {
        const int j = t + b * T;
        const int d = (j / NS) * NS * R + j % NS;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int i = d + r * NS;
            s[Lay::at(i)] = v[b + r * (E / R)];
        }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < E; ++m) {
        const int i = t + T * m;
        v[m] = s[Lay::at(i)];
    }
}

template <int L, int P, class Lay = Pad>
__device__ __forceinline__ void fft_passes(float2 (&v)[Plan<L>::E], int t,
                                           float2* s,
                                           const float2* __restrict__ tw) {
    fft_pass<L, P>(v, t, tw);
    if constexpr (P + 1 < Plan<L>::kPasses) {
        if constexpr (P > 0) __syncthreads();    // the last reads are done
        exchange<L, P, Lay>(v, t, s);
        fft_passes<L, P + 1, Lay>(v, t, s, tw);
    }
}

// The block's exchange memory: static up to 48 KB, else dynamic (the
// launch sets its size).
template <int L>
__device__ __forceinline__ float2* plan_smem() {
    using Pl = Plan<L>;
    if constexpr (Pl::kDynamic) {
        extern __shared__ float2 dyn_smem[];
        return dyn_smem;
    } else {
        __shared__ float2 smem[Pl::kSmem];
        return smem;
    }
}

// Row r's input is x[r * in_stride + in_off, + N); its output row is
// y[r * (N + cp), + N + cp): the transform's last cp samples, then all N.
// K3 is the case in_stride = N, in_off = 0, cp = 0.
template <int L>
__global__ void __launch_bounds__(Plan<L>::kBlock,
                                  Plan<L>::kBlock > kThreads ? 1 : 2)
fft_cp_kernel(const float2* __restrict__ x, float2* __restrict__ y,
              const float2* __restrict__ tw, int rows, int inverse,
              float scale, int in_stride, int in_off, int cp) {
    using Pl = Plan<L>;
    constexpr int N = Pl::N, E = Pl::E, T = Pl::T;
    float2* smem = plan_smem<L>();
    const int t = threadIdx.x % T;
    const int tr = threadIdx.x / T;
    const int row = blockIdx.x * Pl::kPerBlock + tr;
    const bool live = row < rows;    // the last block's spare transforms
                                     // still meet every barrier
    const float conj = inverse ? -1.0f : 1.0f;
    float2 v[E];
    if (live) {
        const float2* src =
            x + static_cast<size_t>(row) * in_stride + in_off + t;
#pragma unroll
        for (int m = 0; m < E; ++m) v[m] = src[m * T];
    } else {
#pragma unroll
        for (int m = 0; m < E; ++m) v[m] = make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int m = 0; m < E; ++m) v[m].y *= conj;
    fft_passes<L, 0>(v, t, smem + tr * Pl::kStride, tw);
    if (!live) return;
    float2* dst = y + static_cast<size_t>(row) * (N + cp) + cp;
    const float im = conj * scale;
#pragma unroll
    for (int m = 0; m < E; ++m) {
        const int k = t + T * m;
        const float2 o = make_float2(v[m].x * scale, v[m].y * im);
        dst[k] = o;
        if (k >= N - cp) dst[k - N] = o;          // the TX prefix
    }
}


// The two-pass route above one launch (kernels/fft.py route): N = N1 N2,
// each row x viewed [N1, N2], n = N2 n1 + n2, and
//   X[k1 + N1 k2] = sum_n2 W_N2^(n2 k2) W_N^(n2 k1) sum_n1 x[N2 n1 + n2] W_N1^(n1 k1).
//
// Column pass: column n2 of each row (N1 samples, element stride N2) is
// transformed over n1 by the Plan<L1> body, output k1 multiplied by
// W_N^(n2 k1) (the wrapper's table, laid out [k1, n2] as the pass reads it)
// and stored at [k1, n2] of the same layout, so that no transpose follows.
// A block holds C = 256 / T adjacent columns of one row and its lanes run
// along the columns (lane c of column col0 + c, then t): every load and
// store of a warp covers whole sectors while C >= 4 (N1 <= 1024), and at
// N1 <= 16 (T = 1) a thread holds its whole column, so the pass never
// touches shared memory. Above, the exchanges interleave the columns
// (Cols<C>), so that a half-warp's lanes hit 16 neighbouring banks.
template <int L1>
__global__ void __launch_bounds__(kThreads)
fft_columns_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                   const float2* __restrict__ tw,
                   const float2* __restrict__ wn, int groups, int log2n2,
                   int inverse, float scale) {
    using Pl = Plan<L1>;
    constexpr int N1 = Pl::N, E = Pl::E, T = Pl::T, C = kThreads / T;
    __shared__ float2 smem[Pl::kPasses > 1 ? C * N1 : 1];
    const int n2 = 1 << log2n2;
    const int c = threadIdx.x % C;
    const int t = threadIdx.x / C;
    const int row = blockIdx.x / groups;
    const int col = (blockIdx.x - row * groups) * C + c;
    const bool live = col < n2;    // columns past N2 still meet every barrier
    const float conj = inverse ? -1.0f : 1.0f;
    const size_t base = (static_cast<size_t>(row) << (L1 + log2n2)) + col;
    float2 v[E];
    if (live) {
#pragma unroll
        for (int m = 0; m < E; ++m)
            v[m] = x[base + (static_cast<size_t>(t + T * m) << log2n2)];
    } else {
#pragma unroll
        for (int m = 0; m < E; ++m) v[m] = make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int m = 0; m < E; ++m) v[m].y *= conj;
    fft_passes<L1, 0, Cols<C>>(v, t, smem + c, tw);
    if (!live) return;
    const float im = conj * scale;
#pragma unroll
    for (int m = 0; m < E; ++m) {
        const size_t k1 = static_cast<size_t>(t + T * m) << log2n2;
        const float2 o = cmul(v[m], __ldg(wn + k1 + col));
        y[base + k1] = make_float2(o.x * scale, o.y * im);
    }
}

// Row pass: row k1 of the column pass's output (N2 contiguous samples) is
// transformed by the Plan<L2> body and Z[k1, k2] is stored at X[k1 + N1 k2].
// A block holds P = kPerBlock transforms, rows k1_0 .. k1_0 + P - 1 of one
// row (N1 % P == 0), and stores them through a shared tile laid out
// [k2][P]: lane q of the block writes output q % P of k2 = q / P, so each
// warp's store is 32 / P runs of P adjacent samples, whole 32-byte sectors
// from P = 4 (N2 <= 1024; the route's N2 = 512 gives 64-byte runs). The
// tile (index q padded by q / 16, free of bank conflicts for P = 8, 4 and
// 2) takes the exchange memory once the last exchange is read.
template <int L2>
__global__ void __launch_bounds__(kThreads, 2)
fft_rows_t_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                  const float2* __restrict__ tw, int log2n1, int inverse,
                  float scale) {
    using Pl = Plan<L2>;
    constexpr int N2 = Pl::N, E = Pl::E, T = Pl::T, P = Pl::kPerBlock;
    constexpr int kTileLen = P * N2;                  // = kThreads * E
    __shared__ float2 smem[kTileLen + kTileLen / 16];
    const int t = threadIdx.x % T;
    const int tr = threadIdx.x / T;
    const size_t g0 = static_cast<size_t>(blockIdx.x) * P;  // b N1 + k1_0
    const float conj = inverse ? -1.0f : 1.0f;
    float2 v[E];
    const float2* src = x + ((g0 + tr) << L2) + t;
#pragma unroll
    for (int m = 0; m < E; ++m) v[m] = src[m * T];
#pragma unroll
    for (int m = 0; m < E; ++m) v[m].y *= conj;
    fft_passes<L2, 0>(v, t, smem + tr * Pl::kStride, tw);
    if constexpr (Pl::kPasses > 1) __syncthreads();   // exchange reads done
    const float im = conj * scale;
#pragma unroll
    for (int m = 0; m < E; ++m) {
        const int q = (t + T * m) * P + tr;
        smem[q + (q >> 4)] = make_float2(v[m].x * scale, v[m].y * im);
    }
    __syncthreads();
    const size_t b = g0 >> log2n1;
    const size_t k1_0 = g0 & ((size_t{1} << log2n1) - 1);
    float2* dst = y + (b << (log2n1 + L2)) + k1_0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
        const int q = threadIdx.x + kThreads * i;
        dst[(static_cast<size_t>(q / P) << log2n1) + q % P] = smem[q + (q >> 4)];
    }
}
float ortho_scale(int log2n) {
    return static_cast<float>(
        1.0 / std::sqrt(static_cast<double>(1 << log2n)));
}

template <int L>
int launch(const float2* x, float2* y, const float2* tw, int rows,
           int inverse, int in_stride, int in_off, int cp,
           cudaStream_t stream) {
    using Pl = Plan<L>;
    constexpr int per = Pl::kPerBlock;
    int smem = 0;
    if constexpr (Pl::kDynamic) {
        smem = Pl::kSmem * static_cast<int>(sizeof(float2));
        const cudaError_t err = cudaFuncSetAttribute(
            fft_cp_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    fft_cp_kernel<L><<<(rows + per - 1) / per, Pl::kBlock, smem, stream>>>(
        x, y, tw, rows, inverse, ortho_scale(L), in_stride, in_off, cp);
    return static_cast<int>(cudaGetLastError());
}

int launch_any(const float2* x, float2* y, const float2* tw, int rows,
               int log2n, int inverse, int in_stride, int in_off, int cp,
               void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    switch (log2n) {
    case 1: return launch<1>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 2: return launch<2>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 3: return launch<3>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 4: return launch<4>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 5: return launch<5>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 6: return launch<6>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 7: return launch<7>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 8: return launch<8>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 9: return launch<9>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 10: return launch<10>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 11: return launch<11>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 12: return launch<12>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    case 13: return launch<13>(x, y, tw, rows, inverse, in_stride, in_off, cp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The route's passes over `rows` rows of N = 2^(log2n1 + log2n2); l is the
// pass's own transform (L1 for the column pass, L2 for the row pass).
struct Route {
    const float2* x;
    float2* y;
    const float2* tw;      // the pass's plan table
    const float2* wn;      // the column pass's W_N^(n2 k1), [k1, n2]
    int rows, log2n1, log2n2, inverse;
    cudaStream_t stream;
};

template <int L1>
int launch_columns(const Route& r) {
    constexpr int C = kThreads / Plan<L1>::T;
    const long long groups = ((1LL << r.log2n2) + C - 1) / C;
    const long long blocks = r.rows * groups;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    fft_columns_kernel<L1><<<static_cast<unsigned>(blocks), kThreads, 0,
                             r.stream>>>(
        r.x, r.y, r.tw, r.wn, static_cast<int>(groups), r.log2n2, r.inverse,
        ortho_scale(L1));
    return static_cast<int>(cudaGetLastError());
}

template <int L2>
int launch_rows_t(const Route& r) {
    constexpr int P = Plan<L2>::kPerBlock;
    if ((1 << r.log2n1) % P) return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (static_cast<long long>(r.rows) << r.log2n1) / P;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    fft_rows_t_kernel<L2><<<static_cast<unsigned>(blocks), kThreads, 0,
                            r.stream>>>(r.x, r.y, r.tw, r.log2n1, r.inverse,
                                        ortho_scale(L2));
    return static_cast<int>(cudaGetLastError());
}

// One of the two passes at its transform's log2 l in 1..kMaxPassLog2N.
template <template <int> class Pass>
int launch_pass(int l, const Route& r) {
    switch (l) {
    case 1: return Pass<1>::run(r);
    case 2: return Pass<2>::run(r);
    case 3: return Pass<3>::run(r);
    case 4: return Pass<4>::run(r);
    case 5: return Pass<5>::run(r);
    case 6: return Pass<6>::run(r);
    case 7: return Pass<7>::run(r);
    case 8: return Pass<8>::run(r);
    case 9: return Pass<9>::run(r);
    case 10: return Pass<10>::run(r);
    case 11: return Pass<11>::run(r);
    case 12: return Pass<12>::run(r);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <int L>
struct ColumnsPass {
    static int run(const Route& r) { return launch_columns<L>(r); }
};

template <int L>
struct RowsTPass {
    static int run(const Route& r) { return launch_rows_t<L>(r); }
};

bool route_ok(int rows, int log2n1, int log2n2) {
    return rows > 0 && log2n1 >= 1 && log2n1 <= kMaxPassLog2N
        && log2n2 >= 1 && log2n2 <= kMaxPassLog2N;
}

}  // namespace

OFDM_API int ofdm_fft(const float2* x, float2* y, const float2* twiddles,
                      int rows, int log2n, int inverse, void* stream) {
    if (rows <= 0) return 0;
    if (log2n < 1 || log2n > kMaxLog2N)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_any(x, y, twiddles, rows, log2n, inverse, 1 << log2n, 0, 0,
                      stream);
}

OFDM_API int ofdm_fft_cp(const float2* x, float2* y, const float2* twiddles,
                         int rows, int log2n, int inverse, int in_stride,
                         int in_off, int cp, void* stream) {
    if (rows <= 0) return 0;
    if (log2n < 1 || log2n > kMaxPassLog2N || cp < 0 || cp > (1 << log2n)
            || in_off < 0 || in_stride < in_off + (1 << log2n))
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_any(x, y, twiddles, rows, log2n, inverse, in_stride, in_off,
                      cp, stream);
}

OFDM_API int ofdm_fft_columns(const float2* x, float2* y,
                              const float2* twiddles,
                              const float2* route_twiddles, int rows,
                              int log2n1, int log2n2, int inverse,
                              void* stream) {
    if (rows <= 0) return 0;
    if (!route_ok(rows, log2n1, log2n2))
        return static_cast<int>(cudaErrorInvalidValue);
    const Route r{x, y, twiddles, route_twiddles, rows, log2n1, log2n2,
                  inverse, static_cast<cudaStream_t>(stream)};
    return launch_pass<ColumnsPass>(log2n1, r);
}

OFDM_API int ofdm_fft_rows_t(const float2* x, float2* y,
                             const float2* twiddles, int rows, int log2n1,
                             int log2n2, int inverse, void* stream) {
    if (rows <= 0) return 0;
    if (!route_ok(rows, log2n1, log2n2))
        return static_cast<int>(cudaErrorInvalidValue);
    const Route r{x, y, twiddles, nullptr, rows, log2n1, log2n2, inverse,
                  static_cast<cudaStream_t>(stream)};
    return launch_pass<RowsTPass>(log2n2, r);
}
