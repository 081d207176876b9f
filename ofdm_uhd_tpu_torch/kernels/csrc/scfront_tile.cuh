// The S&C tile route's body: K6's ofdm_scfront and K9's ofdm_sc_correlate
// (csrc/scfront.cu launches it), for a power-of-two lag l <= 4096. Per row
// of n complex samples r, for i < nd = n - 2l + 1,
//
//   P[i] = S_l of the lag product conj(r[j]) r[j+l], over j = i .. i+l-1
//   R[i] = 0.5 S_2l of the energy |r[j]|^2, over j = i .. i+2l-1
//
// where S_w is the plain version's pairwise doubling, S_2w[i] = S_w[i] +
// S_w[i + w] (kernels/sync.py), every add __fadd_rn in that tree, the
// leaves hypotf^2 and __fmul_rn products, and write_out the epilogue of
// both routes. The same source compiles on the host (g++, without CUDA) so
// that tests/test_torch_scfront_host.py can hold it, one std::thread a
// CUDA thread, bit for bit against a plain C++ doubling.
//
// Lag form. A level adds, at each position x, the value w positions back:
// T[x] = S_w[x - w] + S_w[x] = S_2w[x - w] (IEEE addition commutes, so the
// tree and the bits are the doubling's). After the energy's log2(2l)
// levels position x holds S_2l[x - 2l + 1], and after the lag product's
// log2(l) levels, with the product of r[x - l] and r[x] as the leaf at x,
// S_l[x - 2l + 1] as well: output i is ready when r[i + 2l - 1] arrives.
// So every operand comes from the left, and a warp can walk a row left to
// right with nothing but the levels' recent past as state.
//
// Layout. A warp walks a segment of outputs [i0, i1) of one row in steps of
// kSpan = 32 kV positions, from x = i0 to i1 + 2l - 2; at step c lane k
// holds positions i0 + c kSpan + k + 32 j, j < kV, of all three planes (the
// energy, the product's re and im) in registers. A delay by w (a level's
// left operand, and the product's r[x - l]) is
//   w < 32:          one shuffle a register, lane k - w mod 32; the lanes
//                    k < w take register j - 1, and register 0 the last
//                    register of the step before, kept in one register;
//   32 <= w < kSpan: register j - w/32 of the same lane, w/32 kept from
//                    the step before: no traffic at all;
//   w >= kSpan:      a ring of w / kSpan steps in the warp's shared
//                    memory, each lane its own column (conflict-free, no
//                    barrier): one store and one load a register;
//   the product's r[x - l] at l >= kSpan is read again from the row (L1
//   or L2; it arrived l positions earlier).
// A segment's first 2l - 1 positions are warm-up: their outputs belong to
// the segment before and are not written (zero state there only feeds
// those). No block barrier anywhere, and the halo is read once a segment
// instead of once every 1024 outputs. The launch sizes the segments for
// the warps the card holds at once (plan_segments), so a long row walks
// in one wave and a short one at a large lag in few, short segments.
//
// Replaces the previous tile body, which staged a 1024-output tile and its
// 2l - 1 halo in shared memory and doubled all three planes there, one
// barrier a level: ~84 four-byte shared accesses an output at l = 128 (C3),
// ~0.36-0.40 ms of shared-memory bandwidth on 132 SMs against a 0.212 ms
// byte bound. Here C3 (l = 128) takes 15 shuffles an output (5 levels a
// plane below w = 32) and no shared memory; C4 (l = 512) adds 7 ring
// levels (w = 256, 512). Bound on this card: bytes, 8 B read a sample and
// 12 B written an output, once the segments are long against 2l; the
// arithmetic (two hypotf, the lag product, the adds, the metric's
// division) is ~1100 issue slots a step of 256 outputs, close behind.
//
// Rows never leak: a segment reads its own row only, zeros past its end.
#pragma once

#include <math.h>
#include <cstddef>

#if defined(__CUDACC__)
// device code only (the rounding intrinsics are __device__), except the
// constexpr helpers, which the host's plan uses too
#define SCT_HD __device__ __forceinline__
#define SCT_CX __host__ __device__ constexpr
#else
// Host build (g++ -ffp-contract=off): the CUDA types and intrinsics it
// uses, each one IEEE operation in float32
#define SCT_HD inline
#define SCT_CX constexpr
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
#endif

namespace sct {

constexpr int kV = 8;              // positions a lane holds, 32 apart
constexpr int kSpan = 32 * kV;     // positions a warp takes a step
constexpr int kWarps = 4;          // warps a block, where the rings fit
constexpr int kMaxLog2L = 12;      // l <= 4096 (kernels/sync.py
                                   // TILE_KERNEL_MAX_L; the route takes
                                   // the tile up to TILE_MAX_L)

// Registers a delay by w keeps from one step to the next, and the floats
// of its ring in shared memory.
SCT_CX int carry_floats(int w) {
    return w < 32 ? 1 : (w < kSpan ? w / 32 : 0);
}
SCT_CX int ring_floats(int w) { return w < kSpan ? 0 : w; }
// ... of the levels w = 1, 2, .., 2^(b-1) of one plane
SCT_CX int carry_before(int b) {
    int s = 0;
    for (int i = 0; i < b; ++i) s += carry_floats(1 << i);
    return s;
}
SCT_CX int ring_before(int b) {
    int s = 0;
    for (int i = 0; i < b; ++i) s += ring_floats(1 << i);
    return s;
}
// a warp's rings at log2 l = lg: the energy's lg + 1 levels, then each of
// the product's planes' lg levels
SCT_CX int warp_ring_floats(int lg) {
    return ring_before(lg + 1) + 2 * ring_before(lg);
}

// The epilogue shared by both routes: P, and M or R, from the window sums.
template <bool kMetric>
SCT_HD void write_out(float2* p_out, float* q_out, size_t at, float pr,
                      float pi, float esum) {
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

// Everything a launch needs, computed once on the host by plan_tile and
// plan_segments.
struct Plan {
    int n, nd, l, lg;
    int ring;         // floats of a warp's rings
    int warps;        // warps a block
    int seg;          // outputs a work item (a multiple of kSpan)
    int segs;         // work items a row
    long long items;  // rows * segs
    size_t smem_bytes() const {
        return sizeof(float) * static_cast<size_t>(ring) * warps;
    }
};

// The lag and the block for rows of n samples at lag l (a power of two up
// to 4096): as many warps a block, up to kWarps, as max_smem holds rings
// for. False if l is not such a lag or there is no output.
inline bool plan_tile(Plan& g, int n, int l, size_t max_smem) {
    if (l < 1 || (l & (l - 1)) || l > (1 << kMaxLog2L)) return false;
    g.n = n;
    g.l = l;
    g.nd = n - 2 * l + 1;
    if (g.nd < 1) return false;
    g.lg = 0;
    while ((1 << g.lg) < l) ++g.lg;
    g.ring = warp_ring_floats(g.lg);
    g.warps = kWarps;
    while (g.warps > 1 && g.smem_bytes() > max_smem) --g.warps;
    g.seg = g.segs = 0;
    g.items = 0;
    return g.smem_bytes() <= max_smem;
}

// The segment length for `units` runs of `len` outputs each, walked by
// `slots` walkers on the card at once, each segment a multiple of
// `quantum` with a warm-up of `halo` before it: of the lengths that fill
// 1, 2, .. 64 waves of slots, the one with the least waves x (seg + halo)
// (the longer on a tie). The split route's passes plan with it too.
inline long long seg_length(long long units, long long len, long long halo,
                            long long slots, long long quantum) {
    const long long whole = (len + quantum - 1) / quantum * quantum;
    long long best = -1, pick = whole;
    if (slots < 1) slots = 1;
    for (long long w = 1; w <= 64; ++w) {
        const long long s = w * slots / units;     // segments a run
        if (s < 1) continue;
        long long seg = (len + s - 1) / s;
        seg = (seg + quantum - 1) / quantum * quantum;
        if (seg > whole) seg = whole;
        const long long items = units * ((len + seg - 1) / seg);
        const long long cost = (items + slots - 1) / slots * (seg + halo);
        if (best < 0 || cost < best || (cost == best && seg > pick)) {
            best = cost;
            pick = seg;
        }
    }
    return pick;
}

// The segments of `rows` rows for `slots` warps on the card at once: a
// warp walks seg + 2l - 1 positions an item (seg_length).
inline void plan_segments(Plan& g, int rows, long long slots) {
    g.seg = static_cast<int>(seg_length(rows, g.nd, 2LL * g.l - 1, slots,
                                        kSpan));
    g.segs = (g.nd + g.seg - 1) / g.seg;
    g.items = static_cast<long long>(rows) * g.segs;
}

// A delay by W of one plane: d[j] = the value W positions left of v[j]
// (position x0 + lane + 32 j of step c), from this step, the registers
// kept from the step before (carry) or the ring.
template <int W, class Warp>
SCT_HD void delay(const float (&v)[kV], float (&d)[kV], float* carry,
                  float* ring, int c, const Warp& wp) {
    if constexpr (W < 32) {
        float rot[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j)
            rot[j] = wp.shfl(v[j], (wp.lane - W) & 31);
        const bool wrap = wp.lane < W;
        d[0] = wrap ? carry[0] : rot[0];
#pragma unroll
        for (int j = 1; j < kV; ++j) d[j] = wrap ? rot[j - 1] : rot[j];
        carry[0] = rot[kV - 1];
    } else if constexpr (W < kSpan) {
        constexpr int s = W / 32;
#pragma unroll
        for (int j = 0; j < s; ++j) d[j] = carry[j];
#pragma unroll
        for (int j = s; j < kV; ++j) d[j] = v[j - s];
#pragma unroll
        for (int t = 0; t < s; ++t) carry[t] = v[kV - s + t];
    } else {
        constexpr int q = W / kSpan;
        float* col = ring + (c & (q - 1)) * kSpan + wp.lane;
#pragma unroll
        for (int j = 0; j < kV; ++j) {
            d[j] = col[32 * j];
            col[32 * j] = v[j];
        }
    }
}

// Levels B .. NB - 1 (w = 2^B ..) of one plane in lag form.
template <int B, int NB, class Warp>
SCT_HD void levels(float (&v)[kV], float* carry, float* ring, int c,
                   const Warp& wp) {
    if constexpr (B < NB) {
        float d[kV];
        delay<(1 << B)>(v, d, carry + carry_before(B),
                        ring + ring_before(B), c, wp);
#pragma unroll
        for (int j = 0; j < kV; ++j) v[j] = __fadd_rn(d[j], v[j]);
        levels<B + 1, NB>(v, carry, ring, c, wp);
    }
}

// One work item: a segment of one row, walked by one warp. `ring` is the
// warp's own shared memory (Plan::ring floats); `wp` gives the lane and
// the warp's shuffle, wp.shfl(v, src): lane src's v.
template <int LG, bool kMetric, class Warp>
SCT_HD void walk(const float2* r, float2* p_out, float* q_out,
                 const Plan& g, long long item, float* ring,
                 const Warp& wp) {
    constexpr int L = 1 << LG;
    constexpr int kLag = 2 * L - 1;
    const long long row = item / g.segs;
    const int i0 = static_cast<int>(item - row * g.segs) * g.seg;
    const int i1 = i0 + g.seg < g.nd ? i0 + g.seg : g.nd;
    const int n = g.n;
    const float2* rr = r + static_cast<size_t>(row) * n;
    const size_t out = static_cast<size_t>(row) * g.nd;
    const float2 zero = make_float2(0.0f, 0.0f);
    // the levels' and the r delay's registers from the step before
    float ce[carry_before(LG + 1) + 1], cre[carry_before(LG) + 1],
        cim[carry_before(LG) + 1], cax[carry_floats(L) + 1],
        cay[carry_floats(L) + 1];
#pragma unroll
    for (int t = 0; t < carry_before(LG + 1) + 1; ++t) ce[t] = 0.0f;
#pragma unroll
    for (int t = 0; t < carry_before(LG) + 1; ++t) cre[t] = cim[t] = 0.0f;
#pragma unroll
    for (int t = 0; t < carry_floats(L) + 1; ++t) cax[t] = cay[t] = 0.0f;
    float* ring_e = ring;
    float* ring_re = ring + ring_before(LG + 1);
    float* ring_im = ring_re + ring_before(LG);
    // the walk: x = i0 .. i1 + 2l - 2
    const int steps = (i1 - i0 + kLag - 1 + kSpan) / kSpan;
    for (int c = 0; c < steps; ++c) {
        const int xb = i0 + c * kSpan + wp.lane;
        float2 b[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) {
            const int x = xb + 32 * j;
            b[j] = x < n ? rr[x] : zero;
        }
        // a = r[x - l]
        float ax[kV], ay[kV];
        if constexpr (L < kSpan) {
            float bx[kV], by[kV];
#pragma unroll
            for (int j = 0; j < kV; ++j) {
                bx[j] = b[j].x;
                by[j] = b[j].y;
            }
            delay<L>(bx, ax, cax, nullptr, c, wp);
            delay<L>(by, ay, cay, nullptr, c, wp);
        } else {
#pragma unroll
            for (int j = 0; j < kV; ++j) {
                const int x = xb + 32 * j - L;
                const float2 a = x >= 0 && x < n ? rr[x] : zero;
                ax[j] = a.x;
                ay[j] = a.y;
            }
        }
        // the leaves: |r[x]|^2 and conj(r[x - l]) r[x] at x
        float e[kV], pr[kV], pi[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) {
            const float mag = hypotf(b[j].x, b[j].y);
            e[j] = __fmul_rn(mag, mag);
            pr[j] = __fadd_rn(__fmul_rn(ax[j], b[j].x),
                              __fmul_rn(ay[j], b[j].y));
            pi[j] = __fsub_rn(__fmul_rn(ax[j], b[j].y),
                              __fmul_rn(ay[j], b[j].x));
        }
        levels<0, LG + 1>(e, ce, ring_e, c, wp);
        levels<0, LG>(pr, cre, ring_re, c, wp);
        levels<0, LG>(pi, cim, ring_im, c, wp);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
            const int i = xb + 32 * j - kLag;
            if (i >= i0 && i < i1)
                write_out<kMetric>(p_out, q_out, out + i, pr[j], pi[j],
                                   e[j]);
        }
    }
}

}  // namespace sct
