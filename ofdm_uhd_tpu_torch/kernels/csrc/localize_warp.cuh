// The Schmidl-Cox plateau localizer's warp body (K1's ofdm_localize).
// localize.cu launches it on the card; the same source compiles on the
// host (g++, without CUDA) so that tests/test_torch_localize_host.py can
// hold it against kernels/localize.py's localize_plain, one std::thread a
// lane, the warp's shuffles and reductions a std::barrier and an array.
//
// For each candidate slot, c = cand clamped to [0, nd], over the window
// M[c, c + span) with reads past nd counting as 0:
//   * the peak by first-index argmax,
//   * the plateau [lo, hi]: first and last offsets with M >= rel * peak
//     (rel * peak is the float32 product, __fmul_rn),
//   * d = max(c + (lo + hi) / 2 - cp_half, 0) as int32,
//   * eps = atan2f(Im P, Re P) * (float)(1 / pi) at the peak sample.
//
// What holds it on this card: memory latency, not bytes. A found window
// is span floats (1.1 KB at C3) read once; the whole gather at C3 is ~10
// MB, ~3 us of HBM. The work is a few dependent round trips a candidate
// (its index, its window, P at the peak), so the design cuts them:
//   * Sentinels. The detector pads each row's candidates with c = nd,
//     about three slots in four at C3. A window at nd is all zeros: peak
//     index 0, plateau [0, span - 1], P = 0. The lane that read such a
//     slot's index writes that result (write_sentinel) with no load.
//   * Slots. A warp takes kRowSlots = 4 slots of one row, one from each
//     quarter of it (k, k + S, k + 2S, k + 3S, S = ceil(mf / 4)): lanes
//     0..3 read their indices with one load, and the warp then takes the
//     found ones in turn. The detector pads a row to 4 * max_frames + 16
//     slots and lists the found ones first, so where every frame is found
//     once a warp finds about one, and the pad slots cost a quarter of
//     the warps a slot a warp would (on an H100 80GB HBM3 at 700 W,
//     32,960 warps that only read an index and write a pad slot's result
//     take 5.7 us at C3's shape, 8240 take 3.6; scripts/k1_interp_ab.py).
//     Any order of candidates gives the same result, only more slowly.
//   * Loads first. A lane holds W = ceil(span / 32) samples of the window
//     in registers (a compile-time array, masked past the span: W = 3, 9,
//     36 for spans up to 96, 288 and 1152, so C2's 80, C3's 288 and C4's
//     1152) and issues all W loads before its first compare. The
//     plateau's pass reads the same registers.
//   * P ahead of the argmax. Each lane loads P at its own first maximum
//     before the warp's shuffles; the global first-index maximum is the
//     first maximum of the lane that holds it, so that lane's P is the
//     one kept, and the load overlaps the shuffles and the plateau pass.
// Spans above 1152 (big_nsc's symbols, 4608 to 36,864) take
// localize_block: one slot a block, whose threads read the window in
// rounds of kBlockLoads loads each, meet in shared memory, and read the
// window again (from the cache) for the plateau. Those paths have few
// slots (tens), so a slot gets many lanes.
//
// The warp's operations go through `Warp` (shfl of 32 bits from a lane,
// reduce_min / reduce_max of an int over the warp), which every lane
// calls the same number of times: branches around them are uniform.
#pragma once

#include <cmath>
#include <cstring>

#if defined(__CUDACC__)
#define LZK_HD __host__ __device__ __forceinline__
#else
#define LZK_HD inline
struct float2 { float x, y; };
#endif

namespace lzk {

constexpr int kLanes = 32;
constexpr int kRowSlots = 4;       // slots a warp takes, a quarter apart
constexpr int kWarpsPerBlock = 8;  // warps a block of localize_row_slots
constexpr int kBlockWarps = 16;    // warps a block of localize_block
constexpr int kBlockLoads = 18;    // loads a thread has in flight there

struct Args {
    const float* m;       // [caps, nd] metric
    const float2* p;      // [caps, nd] correlation
    const int* cand;      // [caps, mf] candidate offsets
    int* d;               // [caps, mf]
    float* eps;           // [caps, mf]
    int caps, nd, mf, span, cp_half;
    float rel;
};

// W, the window's loads a lane, for a span: 3, 9 or 36; 0 above 1152
// (localize_block)
LZK_HD int window_loads(int span) {
    const int w = (span + kLanes - 1) / kLanes;
    return w <= 3 ? 3 : w <= 9 ? 9 : w <= 36 ? 36 : 0;
}

LZK_HD float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
    return __fmul_rn(a, b);
#else
    return a * b;
#endif
}

LZK_HD unsigned float_bits(float f) {
#if defined(__CUDA_ARCH__)
    return __float_as_uint(f);
#else
    unsigned u;
    std::memcpy(&u, &f, sizeof u);
    return u;
#endif
}

LZK_HD float bits_float(unsigned u) {
#if defined(__CUDA_ARCH__)
    return __uint_as_float(u);
#else
    float f;
    std::memcpy(&f, &u, sizeof f);
    return f;
#endif
}

LZK_HD int imin(int a, int b) { return a < b ? a : b; }
LZK_HD int imax(int a, int b) { return a > b ? a : b; }

// angle(P) / pi, as the TPU kernel rounds it
LZK_HD float eps_of(float re, float im) {
    const float inv_pi = static_cast<float>(1.0 / 3.14159265358979323846);
    return mul_rn(atan2f(im, re), inv_pi);
}

LZK_HD float metric(const Args& a, const float* row, int c, int i) {
    const int g = c + i;
    return g < a.nd ? row[g] : 0.0f;
}

LZK_HD float2 corr(const Args& a, const float2* row, int c, int i) {
    const int g = c + i;
    if (g < a.nd) return row[g];
    float2 z;
    z.x = z.y = 0.0f;
    return z;
}

// The result of a window of zeros (a slot at c = nd), with no load
LZK_HD void write_sentinel(const Args& a, long long slot) {
    a.d[slot] = imax(a.nd + (a.span - 1) / 2 - a.cp_half, 0);
    a.eps[slot] = eps_of(0.0f, 0.0f);
}

// (value, offset) of the first maximum, reduced over the warp: a larger
// value wins, and of equal values the smaller offset
template <class Warp>
LZK_HD void argmax_warp(const Warp& warp, int lane, float& best, int& bi) {
    for (int off = kLanes / 2; off > 0; off >>= 1) {
        const float ov = bits_float(warp.shfl(float_bits(best), lane ^ off));
        const int oi = static_cast<int>(
            warp.shfl(static_cast<unsigned>(bi), lane ^ off));
        if (ov > best || (ov == best && oi < bi)) {
            best = ov;
            bi = oi;
        }
    }
}

// The slots a warp takes: slot k + i * S of its row for i < kRowSlots, S
// = ceil(mf / kRowSlots)
LZK_HD int row_stride(int mf) { return (mf + kRowSlots - 1) / kRowSlots; }

// One found slot's window of W loads a lane (span <= 32 * W), at c < nd;
// lane 0 writes the result
template <int W, class Warp>
LZK_HD void localize_window(const Args& a, const Warp& warp, int lane,
                            long long slot, int c) {
    const size_t cap = static_cast<size_t>(slot / a.mf);
    const float* mrow = a.m + cap * a.nd;
    // every load of the window before any compare
    float v[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int i = lane + kLanes * j;
        v[j] = i < a.span ? metric(a, mrow, c, i) : 0.0f;
    }
    // the lane's first maximum, and P there
    float best = -INFINITY;
    int bi = a.span;
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int i = lane + kLanes * j;
        if (i < a.span && v[j] > best) {
            best = v[j];
            bi = i;
        }
    }
    const float2 pv = corr(a, a.p + cap * a.nd, c, bi);
    argmax_warp(warp, lane, best, bi);
    // the plateau from the same registers
    const float thr = mul_rn(a.rel, best);
    int lo = a.span, hi = -1;
#pragma unroll
    for (int j = 0; j < W; ++j) {
        const int i = lane + kLanes * j;
        if (i < a.span && v[j] >= thr) {
            lo = imin(lo, i);
            hi = i;
        }
    }
    lo = warp.reduce_min(lo);
    hi = warp.reduce_max(hi);
    // P of the lane that holds the peak
    const int owner = bi & (kLanes - 1);
    const float re = bits_float(warp.shfl(float_bits(pv.x), owner));
    const float im = bits_float(warp.shfl(float_bits(pv.y), owner));
    if (lane == 0) {
        a.d[slot] = imax(c + (lo + hi) / 2 - a.cp_half, 0);
        a.eps[slot] = eps_of(re, im);
    }
}

// Warp k of row r (k < row_stride(mf)): lanes 0..kRowSlots-1 read the
// indices of slots k, k + S, .. with one load and write the sentinels;
// then the warp takes the found ones in turn
template <int W, class Warp>
LZK_HD void localize_row_slots(const Args& a, const Warp& warp, int lane,
                               long long r, int k) {
    const int stride = row_stride(a.mf);
    int mine = a.nd;
    if (lane < kRowSlots && k + lane * stride < a.mf) {
        const long long slot = r * a.mf + k + lane * stride;
        mine = imin(imax(a.cand[slot], 0), a.nd);
        if (mine == a.nd) write_sentinel(a, slot);
    }
    for (int i = 0; i < kRowSlots; ++i) {
        const int c = static_cast<int>(
            warp.shfl(static_cast<unsigned>(mine), i));
        if (c < a.nd)                 // found (uniform): past mf reads nd
            localize_window<W>(a, warp, lane, r * a.mf + k + i * stride, c);
    }
}

// Per-warp partial results of a block's slot (localize_block)
struct BlockSmem {
    float best[kBlockWarps];
    int bi[kBlockWarps];
    float2 pv[kBlockWarps];
    int lo[kBlockWarps];
    int hi[kBlockWarps];
};

// One slot a block of `warps` <= kBlockWarps warps, any span: thread tid
// takes the window's samples tid, tid + 32 * warps, .. in rounds of
// kBlockLoads loads; the warps' first maxima and plateau bounds meet in
// shared memory (sync(): a barrier of the block); the plateau's pass
// reads the window again
template <class Warp, class Sync>
LZK_HD void localize_block(const Args& a, const Warp& warp, Sync sync,
                           BlockSmem& sm, int tid, int warps,
                           long long slot) {
    const int lane = tid % kLanes, wid = tid / kLanes;
    const long long total = static_cast<long long>(a.caps) * a.mf;
    if (slot >= total) return;
    const int c = imin(imax(a.cand[slot], 0), a.nd);   // every thread
    if (c == a.nd) {
        if (tid == 0) write_sentinel(a, slot);
        return;
    }
    const size_t cap = static_cast<size_t>(slot / a.mf);
    const float* mrow = a.m + cap * a.nd;
    const int step = kLanes * warps;
    const int round = step * kBlockLoads;
    float best = -INFINITY;
    int bi = a.span;
    for (int base = 0; base < a.span; base += round) {
        float v[kBlockLoads];
#pragma unroll
        for (int j = 0; j < kBlockLoads; ++j) {
            const int i = base + tid + step * j;
            v[j] = i < a.span ? metric(a, mrow, c, i) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kBlockLoads; ++j) {
            const int i = base + tid + step * j;
            if (i < a.span && v[j] > best) {
                best = v[j];
                bi = i;
            }
        }
    }
    float2 pv = corr(a, a.p + cap * a.nd, c, bi);
    argmax_warp(warp, lane, best, bi);
    // P of the lane holding the warp's peak; where no lane of the warp
    // holds a sample (bi = span), every lane read the same P
    const int owner = bi % step - wid * kLanes;
    if (bi < a.span) {
        pv.x = bits_float(warp.shfl(float_bits(pv.x), owner));
        pv.y = bits_float(warp.shfl(float_bits(pv.y), owner));
    }
    if (lane == 0) {
        sm.best[wid] = best;
        sm.bi[wid] = bi;
        sm.pv[wid] = pv;
    }
    sync();
    int top = 0;                      // the block's first maximum
    for (int w = 1; w < warps; ++w)
        if (sm.best[w] > sm.best[top] ||
            (sm.best[w] == sm.best[top] && sm.bi[w] < sm.bi[top]))
            top = w;
    const float thr = mul_rn(a.rel, sm.best[top]);
    int lo = a.span, hi = -1;
    for (int base = 0; base < a.span; base += round) {
        float v[kBlockLoads];
#pragma unroll
        for (int j = 0; j < kBlockLoads; ++j) {
            const int i = base + tid + step * j;
            v[j] = i < a.span ? metric(a, mrow, c, i) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kBlockLoads; ++j) {
            const int i = base + tid + step * j;
            if (i < a.span && v[j] >= thr) {
                lo = imin(lo, i);
                hi = i;
            }
        }
    }
    lo = warp.reduce_min(lo);
    hi = warp.reduce_max(hi);
    if (lane == 0) {
        sm.lo[wid] = lo;
        sm.hi[wid] = hi;
    }
    sync();
    if (tid == 0) {
        for (int w = 1; w < warps; ++w) {
            lo = imin(lo, sm.lo[w]);
            hi = imax(hi, sm.hi[w]);
        }
        a.d[slot] = imax(c + (lo + hi) / 2 - a.cp_half, 0);
        a.eps[slot] = eps_of(sm.pv[top].x, sm.pv[top].y);
    }
}

}  // namespace lzk
