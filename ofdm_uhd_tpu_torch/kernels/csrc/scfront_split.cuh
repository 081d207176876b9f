// The S&C split route's two passes: K6's and K9's sums (csrc/scfront.cu
// launches them) at a power-of-two lag l above the tile route's
// (kernels/sync.py route), in two launches. The sums, the leaves and the
// epilogue are the tile route's (csrc/scfront_tile.cuh): S_w is the
// plain version's pairwise doubling, S_2w[i] = S_w[i] + S_w[i + w], every
// add __fadd_rn in that tree, so the bits are the tile route's and the
// plain version's.
//
// The identity. For a power of two W <= l, the levels at widths w >= W
// only ever add S_w[i] and S_w[i + w], which lie in the same residue
// class i mod W. So above S_W the doubling is an independent doubling of
// each residue chain y_rho[t] = S_W[rho + tW], at widths w' = w / W.
//
//   1. span pass (span_walk): one warp walks a segment of a row as the
//      tile body does, the leaves (|r[x]|^2 and conj(r[x]) r[x + l], the
//      second factor read again from the row) and the levels w = 1 ..
//      W/2 of all three planes in lag form, and writes S_W into a set
//      [3, rows, n] float32: planes 0 / 1 the lag product's re / im over
//      len_p = n - l - W + 1 positions, plane 2 the energy over len_e = n
//      - W + 1 (the rest is not written). A segment's warm-up is W - 1
//      positions; W <= 256 needs no ring (sct::delay).
//   2. stride pass (stride_walk): one thread walks a segment of one
//      residue chain, kK steps at a time in registers, 32 adjacent
//      residues a warp, so every load and store is a 128-byte row. In lag
//      form along t it runs the levels w' = 1 .. D/2 of the lag product
//      (D = l / W), whose leaf at step t is the chain's value at t - D
//      (read again, as the tile body reads r[x - l]), and w' = 1 .. D of
//      the energy, the last being R's level; then sct::write_out. A delay
//      by w' <= kK is a register of the thread (w' values kept from the
//      batch before); above, a ring of w' values in the thread's own
//      column of shared memory (no barrier). A segment's warm-up is 2D - 1
//      steps.
//
// Bound on this card: bytes. The span pass reads 8 B a sample and writes
// 12 B a position, the stride pass reads 12 B a position (from L2, where
// the set fits: 14-28 MB at DVB-T2's 16K and 32K modes) and writes 12 B an
// output, against the levels route's 24 B a position a level it replaces
// (2 + log2 l launches through device memory).
//
// Rows never leak: both passes read their own row only, zeros past its
// valid lengths. The source compiles on the host too (g++,
// -ffp-contract=off), as the tile body does: tests/
// test_torch_scfront_host.py holds both passes bit for bit against a
// plain C++ doubling.
#pragma once

#include "scfront_tile.cuh"

namespace scs {

constexpr int kMaxLog2W = 14;     // W <= 16384: the span pass's rings fit
constexpr int kRegLg = 3;
constexpr int kK = 1 << kRegLg;   // chain steps a thread holds in registers
constexpr int kStrideBlock = 256; // threads a block of the stride pass,
                                  // at most

// ---- pass 1: the span pass -------------------------------------------

struct SpanPlan {
    int rows, n, l, w, lgw;
    int len_e, len_p;  // S_W's valid lengths: the energy, the lag product
    int ring;          // floats of a warp's rings
    int warps;         // warps a block
    int seg;           // positions a work item (a multiple of kSpan)
    int segs;          // work items a row
    long long items;   // rows * segs
    size_t smem_bytes() const {
        return sizeof(float) * static_cast<size_t>(ring) * warps;
    }
};

inline bool pow2(int v) { return v >= 1 && !(v & (v - 1)); }

inline int log2_of(int v) {
    int lg = 0;
    while ((1 << lg) < v) ++lg;
    return lg;
}

// The span pass's rows of n samples at lag l, width w (powers of two, w
// <= l, w <= 2^kMaxLog2W, at least one output n - 2l + 1): as many warps a
// block, up to sct::kWarps, as max_smem holds rings for.
inline bool plan_span(SpanPlan& g, int rows, int n, int l, int w,
                      size_t max_smem) {
    if (!pow2(l) || !pow2(w) || w > l || w > (1 << kMaxLog2W) ||
        n - 2 * l + 1 < 1 || rows < 1)
        return false;
    g.rows = rows;
    g.n = n;
    g.l = l;
    g.w = w;
    g.lgw = log2_of(w);
    g.len_e = n - w + 1;
    g.len_p = n - l - w + 1;
    g.ring = 3 * sct::ring_before(g.lgw);
    g.warps = sct::kWarps;
    while (g.warps > 1 && g.smem_bytes() > max_smem) --g.warps;
    g.seg = g.segs = 0;
    g.items = 0;
    return g.smem_bytes() <= max_smem;
}

inline void plan_span_segments(SpanPlan& g, long long slots) {
    g.seg = static_cast<int>(sct::seg_length(g.rows, g.len_e, g.w - 1, slots,
                                             sct::kSpan));
    g.segs = (g.len_e + g.seg - 1) / g.seg;
    g.items = static_cast<long long>(g.rows) * g.segs;
}

// One work item of the span pass: positions [i0, i1) of S_W of one row,
// walked by one warp from x = i0 to i1 + W - 2. `ring` is the warp's own
// shared memory (SpanPlan::ring floats), `wp` its lane and shuffle.
template <int LGW, class Warp>
SCT_HD void span_walk(const float2* r, float* set, const SpanPlan& g,
                      long long item, float* ring, const Warp& wp) {
    using sct::kSpan;
    using sct::kV;
    constexpr int W = 1 << LGW;
    const long long row = item / g.segs;
    const int i0 = static_cast<int>(item - row * g.segs) * g.seg;
    const int i1 = i0 + g.seg < g.len_e ? i0 + g.seg : g.len_e;
    const int n = g.n, l = g.l;
    const float2* rr = r + static_cast<size_t>(row) * n;
    const size_t plane = static_cast<size_t>(g.rows) * n;
    float* se = set + 2 * plane + static_cast<size_t>(row) * n;
    float* sre = set + static_cast<size_t>(row) * n;
    float* sim = sre + plane;
    const float2 zero = make_float2(0.0f, 0.0f);
    float ce[sct::carry_before(LGW) + 1], cre[sct::carry_before(LGW) + 1],
        cim[sct::carry_before(LGW) + 1];
#pragma unroll
    for (int t = 0; t < sct::carry_before(LGW) + 1; ++t)
        ce[t] = cre[t] = cim[t] = 0.0f;
    float* ring_e = ring;
    float* ring_re = ring + sct::ring_before(LGW);
    float* ring_im = ring_re + sct::ring_before(LGW);
    const int steps = (i1 - i0 + W - 1 + kSpan - 1) / kSpan;
    for (int c = 0; c < steps; ++c) {
        const int xb = i0 + c * kSpan + wp.lane;
        // r[x] and r[x + l], every load of the step issued before its
        // arithmetic (interleaved with it, the pass took 1.3-1.5 times
        // as long at l = 8192 and 16384)
        float2 rlo[kV], rhi[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) {
            const int x = xb + 32 * j;
            rlo[j] = x < n ? rr[x] : zero;
            rhi[j] = x < n - l ? rr[x + l] : zero;
        }
        // the leaves at x: |r[x]|^2 and conj(r[x]) r[x + l]
        float e[kV], pr[kV], pi[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) {
            const float2 lo = rlo[j], hi = rhi[j];
            const float mag = hypotf(lo.x, lo.y);
            e[j] = __fmul_rn(mag, mag);
            pr[j] = __fadd_rn(__fmul_rn(lo.x, hi.x), __fmul_rn(lo.y, hi.y));
            pi[j] = __fsub_rn(__fmul_rn(lo.x, hi.y), __fmul_rn(lo.y, hi.x));
        }
        sct::levels<0, LGW>(e, ce, ring_e, c, wp);
        sct::levels<0, LGW>(pr, cre, ring_re, c, wp);
        sct::levels<0, LGW>(pi, cim, ring_im, c, wp);
        // position x now holds S_W[x - W + 1] of each plane
#pragma unroll
        for (int j = 0; j < kV; ++j) {
            const int i = xb + 32 * j - (W - 1);
            if (i >= i0 && i < i1) {
                se[i] = e[j];
                if (i < g.len_p) {
                    sre[i] = pr[j];
                    sim[i] = pi[j];
                }
            }
        }
    }
}

// ---- pass 2: the stride pass -----------------------------------------

struct StridePlan {
    int rows, n, nd, l, w;
    int lgd;           // log2 D, D = l / w
    int len_e, len_p;  // S_W's valid lengths (the span pass's)
    int nu;            // chain outputs a residue, at most: ceil(nd / w)
    int ring;          // floats of a thread's ring column
    int block;         // threads a block
    int seg;           // chain outputs a work item (a multiple of kK)
    int segs;          // work items a chain
    long long threads; // rows * segs * w, one work item each
    size_t smem_bytes() const {
        return sizeof(float) * static_cast<size_t>(ring) * block;
    }
};

// Ring floats of one plane whose levels are w' = 1 .. 2^(nb - 1): those
// above kK, each w' values.
SCT_CX int chain_ring_floats(int nb) {
    return nb > kRegLg + 1 ? (1 << nb) - (1 << (kRegLg + 1)) : 0;
}

// The template's register levels: min(lgd, kRegLg + 1).
inline int reg_levels(int lgd) { return lgd < kRegLg + 1 ? lgd : kRegLg + 1; }

// The stride pass's rows (the span pass's set at width w) at lag l: as
// many threads a block, a power of two up to kStrideBlock, as max_smem
// holds ring columns for.
inline bool plan_stride(StridePlan& g, int rows, int n, int l, int w,
                        size_t max_smem) {
    if (!pow2(l) || !pow2(w) || w > l || w > (1 << kMaxLog2W) ||
        n - 2 * l + 1 < 1 || rows < 1)
        return false;
    g.rows = rows;
    g.n = n;
    g.nd = n - 2 * l + 1;
    g.l = l;
    g.w = w;
    g.lgd = log2_of(l / w);
    g.len_e = n - w + 1;
    g.len_p = n - l - w + 1;
    g.nu = (g.nd + w - 1) / w;
    // the energy's levels 1 .. D, the product's 1 .. D/2
    g.ring = chain_ring_floats(g.lgd + 1) + 2 * chain_ring_floats(g.lgd);
    g.block = kStrideBlock;
    while (g.block > 1 && g.smem_bytes() > max_smem) g.block /= 2;
    g.seg = g.segs = 0;
    g.threads = 0;
    return g.smem_bytes() <= max_smem;
}

// Segments of the rows * w chains for `slots` threads on the card at
// once: a thread walks seg + 2D - 1 steps an item (sct::seg_length).
inline void plan_stride_segments(StridePlan& g, long long slots) {
    const long long chains = static_cast<long long>(g.rows) * g.w;
    g.seg = static_cast<int>(sct::seg_length(chains, g.nu,
                                             (2LL << g.lgd) - 1, slots, kK));
    g.segs = (g.nu + g.seg - 1) / g.seg;
    g.threads = chains * g.segs;
}

// A delay by WP <= kK steps in registers: d[j] = the value WP steps
// before v[j], from this batch or the WP values kept from the one before.
template <int WP>
SCT_HD void batch_delay(const float (&v)[kK], float (&d)[kK], float* carry) {
#pragma unroll
    for (int j = 0; j < WP; ++j) d[j] = carry[j];
#pragma unroll
    for (int j = WP; j < kK; ++j) d[j] = v[j - WP];
#pragma unroll
    for (int t = 0; t < WP; ++t) carry[t] = v[kK - WP + t];
}

// Levels B .. NB - 1 (w' = 2^B .. <= kK) of one plane, in registers.
template <int B, int NB>
SCT_HD void reg_levels_of(float (&v)[kK], float* carry) {
    if constexpr (B < NB) {
        float d[kK];
        batch_delay<(1 << B)>(v, d, carry + (1 << B) - 1);
#pragma unroll
        for (int j = 0; j < kK; ++j) v[j] = __fadd_rn(d[j], v[j]);
        reg_levels_of<B + 1, NB>(v, carry);
    }
}

// Levels kRegLg + 1 .. nb - 1 (w' = 2 kK ..) of one plane, each a ring of
// w' values (w' / kK batches) in the thread's column `col` of shared
// memory (element k at col[k * stride]), from float `off` of the column;
// c: the batch. Returns the column's next free float.
SCT_HD int ring_levels_of(float (&v)[kK], float* col, int stride, int off,
                          int nb, int c) {
    for (int b = kRegLg + 1; b < nb; ++b) {
        const int q = 1 << (b - kRegLg);
        float* cell = col + static_cast<size_t>(off + (c & (q - 1)) * kK) *
                                stride;
#pragma unroll
        for (int j = 0; j < kK; ++j) {
            const float d = cell[static_cast<size_t>(j) * stride];
            cell[static_cast<size_t>(j) * stride] = v[j];
            v[j] = __fadd_rn(d, v[j]);
        }
        off += q * kK;
    }
    return off;
}

// One work item of the stride pass: chain outputs [u0, u1) of residue rho
// of one row, i = rho + u w, walked by one thread from step t = u0 to u1
// + 2D - 2. NR = reg_levels(g.lgd); `col` is the thread's column of
// shared memory (StridePlan::ring floats, element k at col[k * stride]).
template <int NR, bool kMetric>
SCT_HD void stride_walk(const float* set, float2* p_out, float* q_out,
                        const StridePlan& g, long long th, float* col,
                        int stride) {
    constexpr int NE = NR < kRegLg + 1 ? NR + 1 : kRegLg + 1;
    const int w = g.w;
    const int rho = static_cast<int>(th % w);
    const long long rest = th / w;
    const long long row = rest / g.segs;
    const int u0 = static_cast<int>(rest - row * g.segs) * g.seg;
    const int u1 = u0 + g.seg < g.nu ? u0 + g.seg : g.nu;
    const int lag2 = (2 << g.lgd) - 1;
    const size_t plane = static_cast<size_t>(g.rows) * g.n;
    const float* se = set + 2 * plane + static_cast<size_t>(row) * g.n;
    const float* sre = set + static_cast<size_t>(row) * g.n;
    const float* sim = sre + plane;
    const size_t out = static_cast<size_t>(row) * g.nd;
    float ce[(1 << NE)], cre[(1 << NR)], cim[(1 << NR)];
#pragma unroll
    for (int t = 0; t < (1 << NE); ++t) ce[t] = 0.0f;
#pragma unroll
    for (int t = 0; t < (1 << NR); ++t) cre[t] = cim[t] = 0.0f;
    const int steps = (u1 - u0 + lag2 + kK - 1) / kK;
    for (int c = 0; c < steps; ++c) {
        const int t0 = u0 + c * kK;
        // S_W at rho + t w (the energy) and at rho + t w - l (the product:
        // its chain value D steps back), every load of the batch first
        float e[kK], pr[kK], pi[kK];
#pragma unroll
        for (int j = 0; j < kK; ++j) {
            const long long ie = rho + static_cast<long long>(t0 + j) * w;
            const long long ip = ie - g.l;
            e[j] = ie < g.len_e ? se[ie] : 0.0f;
            const bool in = ip >= 0 && ip < g.len_p;
            pr[j] = in ? sre[ip] : 0.0f;
            pi[j] = in ? sim[ip] : 0.0f;
        }
        reg_levels_of<0, NE>(e, ce);
        int off = ring_levels_of(e, col, stride, 0, g.lgd + 1, c);
        reg_levels_of<0, NR>(pr, cre);
        off = ring_levels_of(pr, col, stride, off, g.lgd, c);
        reg_levels_of<0, NR>(pi, cim);
        ring_levels_of(pi, col, stride, off, g.lgd, c);
        // step t now holds S_l of the product and S_2l of the energy at
        // chain output u = t - 2D + 1
#pragma unroll
        for (int j = 0; j < kK; ++j) {
            const int u = t0 + j - lag2;
            const long long i = rho + static_cast<long long>(u) * w;
            if (u >= u0 && u < u1 && i < g.nd)
                sct::write_out<kMetric>(p_out, q_out, out + i, pr[j], pi[j],
                                        e[j]);
        }
    }
}

}  // namespace scs
