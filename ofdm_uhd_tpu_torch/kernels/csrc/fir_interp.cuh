// The exact L-fold polyphase interpolation of complex rows (K7's
// ofdm_fir_interp):
//   y[r, k] = sum_{d=d_min}^{d_max} g[k mod l, d - d_min] * x[r, k/l - d],
// zeros outside the row, n * l outputs a row; g is the branch matrix [l,
// nd] (kernels/fir.py branch_matrix). fir.cu launches it on the card; the
// same source compiles on the host (g++, without CUDA) so that
// tests/test_torch_interp_host.py can hold it against kernels/fir.py's
// interp_plain, one std::thread a CUDA thread.
//
// Branch p is a correlation of the row with h_p = g[p] reversed:
// y[r, q*l + p] = sum_{t < nd} h_p[t] * x[r, q - d_max + t].
//
// What held the previous body: shared-memory loads. It staged a tile's
// inputs and one output a thread read both a tap and a sample from shared
// memory for every two FMAs: at C4's TX ([32, 16128] by 8, nd = 25) ~6.5
// M warp-wide loads, ~25 us at one a clock on 132 SMs, against 11 us of
// bytes and ~6 us of FMAs.
//
// This body gives a thread one branch p and kQ = 12 consecutive inputs
// q: the branch's taps in registers (a compile-time count ND: 8, 16, 25 or
// 32, zeros past nd) and a sliding window of samples, so each sample
// loaded from shared memory feeds up to kQ outputs. The loads are 16 bytes
// wide, two samples or four taps each: 18 + 7 shared loads for kQ * ND =
// 300 complex FMAs at nd = 25. Each output sums its taps in the order t =
// 0, 1, .. as before, so the outputs are the previous body's bits. Above
// 32 taps the same body walks the branch in chunks of 32 taps, each
// chunk's taps loaded from shared memory into registers.
//
// Lanes: consecutive threads take consecutive branches of one q-block, so
// the l lanes of one q read the same samples (one broadcast); the
// q-blocks of a warp, 12 samples (24 words) apart, and the branches'
// taps, a stride of 4 mod 8 words apart, read their 16-byte groups from
// distinct banks. The sums go to the tile's outputs in shared memory, in
// sample order, and consecutive threads store consecutive pairs of
// samples of them (16 bytes each where the tile starts 16-byte aligned):
// whole lines.
//
// Inputs: a persistent grid (the blocks the card holds at once) walks
// the (row, tile) work items; a block stages the next item's inputs by
// cp.async into the second of two stages while it sums the current one,
// so the copy's latency hides behind the sums. The inputs are 1/l of the
// bytes (the outputs, stored straight from registers, are the rest).
#pragma once

#include "fir_strided.cuh"     // FIR_HD; on the host, float2

namespace fii {

constexpr int kQ = 12;           // consecutive inputs a thread sums (even)
constexpr int kThreads = 128;    // threads a block
constexpr int kMaxTaps = 32;     // taps of a branch held in registers

// Everything a launch needs, computed once on the host by plan_interp.
struct Plan {
    int n, l, nd, d_max;
    int taps;         // ND: the taps a chunk (8, 16, 25 or 32)
    int chunks;       // ceil(nd / taps): 1 up to 32 taps
    int stride;       // floats between two branches' taps (4 mod 8)
    int qb;           // q-blocks a tile: max(1, threads / l)
    int tq;           // inputs a tile: qb * kQ
    int items;        // (branch, q-block) pairs a tile: qb * l
    int threads;
    int tiles;        // tiles a row
    long long work;   // rows * tiles: the persistent grid's work items
    int lp;           // samples a stage holds: the tq + chunks * taps - 1
                      // a tile reads, rounded up to even
    int tap_floats;   // l * stride, rounded up to a multiple of 4

    // the taps, two stages of inputs, a tile's outputs (tq * l float2)
    size_t smem_bytes() const {
        return sizeof(float) * static_cast<size_t>(tap_floats) +
               sizeof(float2) * (2 * static_cast<size_t>(lp) +
                                 static_cast<size_t>(tq) * l);
    }
};

// ND, the taps a chunk, for nd taps a branch
inline int body_taps(int nd) {
    return nd <= 8 ? 8 : nd <= 16 ? 16 : nd <= 25 ? 25 : kMaxTaps;
}

// The plan of a launch of `threads` threads a block; false where the
// arguments are out of range or the shared memory exceeds max_smem.
inline bool plan_interp(Plan& g, int rows, int n, int l, int nd, int d_max,
                        int threads, size_t max_smem) {
    if (rows < 1 || n < 1 || l < 1 || nd < 1 || threads < 1) return false;
    g.n = n;
    g.l = l;
    g.nd = nd;
    g.d_max = d_max;
    g.taps = body_taps(nd);
    g.chunks = (nd + g.taps - 1) / g.taps;
    g.stride = (g.chunks * g.taps + 3) / 8 * 8 + 4;
    g.qb = threads / l > 1 ? threads / l : 1;
    g.tq = g.qb * kQ;
    g.items = g.qb * l;
    g.threads = threads;
    g.tiles = (n + g.tq - 1) / g.tq;
    g.work = static_cast<long long>(rows) * g.tiles;
    g.lp = (g.tq + g.chunks * g.taps) & ~1;
    const long long taps = static_cast<long long>(l) * g.stride;
    if (taps > (1 << 24)) return false;
    g.tap_floats = static_cast<int>((taps + 3) & ~3LL);
    return g.smem_bytes() <= max_smem;
}

FIR_HD void copy_commit() {     // close this thread's group of copies
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;" ::: "memory");
#endif
}

FIR_HD void copy_wait_prior() { // all but this thread's last group landed
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
#endif
}

// Stage work item w's inputs, xs[j] = x[row, q0 - d_max + j] (zeros
// outside the row), by cp.async; one group of copies a thread
FIR_HD void stage(const float2* __restrict__ x, const Plan& g, float2* xs,
                  long long w, int tid) {
    const long long row = w / g.tiles;
    const long long q0 = (w - row * g.tiles) * g.tq;
    const float2* xr = x + row * g.n;
    for (int j = tid; j < g.lp; j += g.threads) {
        const long long s = q0 - g.d_max + j;
        const bool ok = s >= 0 && s < g.n;
        firk::copy8(xs + j, ok ? xr + s : xr, ok);
    }
    copy_commit();
}

// Work item w's sums from its stage xs into its outputs os, in sample
// order (os[k] = y[row, q0 * l + k])
template <int ND>
FIR_HD void sum_tile(const float* gs, const float2* xs, float2* os,
                     const Plan& g, int tid) {
    constexpr int kTapLoads = (ND + 3) / 4;
    constexpr int kPairs = (kQ + ND) / 2;     // kQ + ND - 1 samples, paired
    const int width = g.chunks * ND;
    for (int item = tid; item < g.items; item += g.threads) {
        const int b = item / g.l, p = item - b * g.l;
        const int qs = b * kQ;            // the thread's first input
        float re[kQ], im[kQ];
#pragma unroll
        for (int q = 0; q < kQ; ++q) re[q] = im[q] = 0.0f;
        for (int c = 0; c * ND < width; ++c) {
            // the chunk's taps, four a 16-byte load (zeros past nd)
            float h[kTapLoads * 4];
            const float4* hp = reinterpret_cast<const float4*>(
                gs + p * g.stride + c * ND);
#pragma unroll
            for (int u = 0; u < kTapLoads; ++u) {
                const float4 v = hp[u];
                h[4 * u] = v.x;
                h[4 * u + 1] = v.y;
                h[4 * u + 2] = v.z;
                h[4 * u + 3] = v.w;
            }
            // the window, two samples a 16-byte load
            const float4* wp =
                reinterpret_cast<const float4*>(xs + qs + c * ND);
#pragma unroll
            for (int jj = 0; jj < kPairs; ++jj) {
                const float4 v = wp[jj];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int j = 2 * jj + e;
                    const float sx = e ? v.z : v.x, sy = e ? v.w : v.y;
#pragma unroll
                    for (int q = 0; q < kQ; ++q) {
                        const int t = j - q;
                        if (t >= 0 && t < ND) {
                            re[q] = fmaf(h[t], sx, re[q]);
                            im[q] = fmaf(h[t], sy, im[q]);
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
            float2 v;
            v.x = re[q];
            v.y = im[q];
            os[(qs + q) * g.l + p] = v;
        }
    }
}

// Work item w's outputs from os to y: consecutive threads, consecutive
// samples, whole lines
FIR_HD void store_tile(const float2* os, float2* y, const Plan& g,
                       long long w, int tid) {
    const long long row = w / g.tiles;
    const long long q0 = (w - row * g.tiles) * g.tq;
    const long long left = g.n - q0;
    const int count = static_cast<int>(left < g.tq ? left : g.tq) * g.l;
    const long long base = (row * g.n + q0) * g.l;
    float2* yt = y + base;
    if (base % 2 == 0) {              // 16-byte aligned: two samples a store
        const float4* o4 = reinterpret_cast<const float4*>(os);
        float4* y4 = reinterpret_cast<float4*>(yt);
        for (int k = tid; k < count / 2; k += g.threads) y4[k] = o4[k];
        if (count % 2 != 0 && tid == 0) yt[count - 1] = os[count - 1];
    } else {
        for (int k = tid; k < count; k += g.threads) yt[k] = os[k];
    }
}

// One block of a persistent grid of `grid` blocks: it stages the
// branches' taps once, then walks work items block, block + grid, ..,
// each a tile of one row, staging the next item's inputs (cp.async, two
// stages) while it sums the current one. sync() is a barrier of the
// block; smem holds smem_bytes().
template <int ND, class Sync>
FIR_HD void interp_block(const float2* __restrict__ x,
                         const float* __restrict__ gm,
                         float2* __restrict__ y, const Plan& g, float* smem,
                         long long block, long long grid, int tid,
                         Sync sync) {
    float* gs = smem;                     // [l, stride]: h_p, zeros past nd
    float2* xs = reinterpret_cast<float2*>(smem + g.tap_floats);
    float2* os = xs + 2 * g.lp;           // [tq, l] outputs
    for (int j = tid; j < g.l * g.stride; j += g.threads) {
        const int p = j / g.stride, t = j - p * g.stride;
        gs[j] = t < g.nd ? gm[p * g.nd + (g.nd - 1 - t)] : 0.0f;
    }
    if (block < g.work) stage(x, g, xs, block, tid);
    int cur = 0;
    for (long long w = block; w < g.work; w += grid, cur ^= 1) {
        if (w + grid < g.work) {
            stage(x, g, xs + (cur ^ 1) * g.lp, w + grid, tid);
            copy_wait_prior();
        } else {
            firk::copy_wait_all();
        }
        sync();                           // item w's stage has landed
        sum_tile<ND>(gs, xs + cur * g.lp, os, g, tid);
        sync();          // its outputs are in place; its stage may refill
        store_tile(os, y, g, w, tid);
    }
}

}  // namespace fii
