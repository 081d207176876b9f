// One window of the K=7 rate-1/2 sliding-window Viterbi decode (K4w), as
// one thread runs it: the forward add-compare-select over the window's e
// steps with all 64 path metrics in registers, each step's 64 choices
// packed into two words, the entry state, and the traceback of the owned
// bits. viterbi.cu's ofdm_viterbi_windowed runs it on the card, one
// thread a window; the same source compiles on the host (g++, without
// CUDA) so that tests/test_torch_viterbi_windowed.py can hold it bit for
// bit against kernels/viterbi.py viterbi_windowed_plain.
//
// Numerics: the reference's ACS (ofdm_uhd_tpu/phy/bits.py viterbi_decode):
// branch metric bm = sa*la + sb*lb without the 0.5 factor (sa, sb = +-1,
// so the product is exact and the four metrics +-la +- lb are one add
// each), c0 = pm[2s'] + bm and c1 = pm[2s'+1] - bm for the predecessors
// 2s', 2s'+1 of states s' and s' + 32, strict c1 > c0 (a tie keeps
// predecessor 0; acs_step reads it as the sign of c0 - c1), every add written as add_rn / sub_rn (__fadd_rn /
// __fsub_rn on the card) so that nothing is contracted. Window conditions
// as the reference's: a window that starts at step 0 is pinned to state
// 0, the others start uniform; the window that ends at step n adds -1e30
// to every nonzero state; the traceback starts from the first state that
// reaches the maximum.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define VIT_HD __host__ __device__ __forceinline__
#else
// Host build (g++): the CUDA vector types it uses
#define VIT_HD inline
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
#endif

namespace vit {

// Unfused float adds: the round-to-nearest intrinsics on the card; plain
// float arithmetic on the host, compiled with -ffp-contract=off.
VIT_HD float add_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
    return __fadd_rn(a, b);
#else
    return a + b;
#endif
}

VIT_HD float sub_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
    return __fsub_rn(a, b);
#else
    return a - b;
#endif
}

// w shifted left by one with d's sign bit below: a step's choices are
// packed by one funnel shift each on the card.
VIT_HD unsigned push_sign(unsigned w, float d) {
#if defined(__CUDA_ARCH__)
    return __funnelshift_l(__float_as_uint(d), w, 1);
#else
    unsigned u;
    std::memcpy(&u, &d, sizeof u);
    return (w << 1) | (u >> 31);
#endif
}

// Chain g of kG holds the bits of states [g 32/kG, (g + 1) 32/kG) in its
// low 32/kG bits; the word puts them side by side.
template <int kG>
VIT_HD unsigned join_chains(const unsigned (&g)[kG]) {
    unsigned w = 0u;
#pragma unroll
    for (int k = 0; k < kG; ++k) w |= g[k] << (k * (32 / kG));
    return w;
}

constexpr int kPolyA = 0133;
constexpr int kPolyB = 0171;
constexpr float kNeg = -1e30f;

VIT_HD constexpr int parity7(int x) {
    return (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4) ^ (x >> 5)
            ^ (x >> 6)) & 1;
}

// Which of the four branch metrics (la + lb, la - lb, -la + lb, -la - lb)
// the p=0 predecessor of state s takes: its register word is s's input bit
// (s >> 5) at bit 6 over the predecessor bits (s & 31) << 1; the code
// bit's sign is -1 where the word's taps have odd parity.
VIT_HD constexpr int bm_index(int s) {
    return 2 * parity7((((s >> 5) << 6) | ((s & 31) << 1)) & kPolyA)
           + parity7((((s >> 5) << 6) | ((s & 31) << 1)) & kPolyB);
}

// One trellis step: pm -> nm; the 64 choices as two words (bit s: state
// s, resp. s + 32), the layout of the warp kernel's ballots. The choice
// c1 > c0 is the sign of c0 - c1 (two distinct finite floats never
// differ by zero, and a tie gives +0: predecessor 0), and the survivor
// max(c0, c1) (a tie's two values are equal: no metric is ever -0, since
// the metrics start at +0 or -1e30). On the card a state costs two adds
// and a subtract on the FMA pipes and a max and a funnel shift on the
// ALU pipe, where a compare, two selects and an OR would take four ALU
// issues. States run from 31 down, so within a chain the first shifted
// in ends highest. Finite LLRs assumed, as everywhere in the chain.
VIT_HD void acs_step(const float (&pm)[64], float (&nm)[64], float la,
                     float lb, uint2& dec) {
    float bm[4];
    bm[0] = add_rn(la, lb);
    bm[1] = add_rn(la, -lb);
    bm[2] = add_rn(-la, lb);
    bm[3] = add_rn(-la, -lb);
    // four independent packing chains of 8 states a word, so that the
    // shifts do not wait on one another 32 deep (3% faster than one chain
    // at c3_pallas in a chip call on the NVIDIA H100 80GB HBM3, 700 W)
    constexpr int kG = 4;
    unsigned w0[kG] = {}, w1[kG] = {};
#pragma unroll
    for (int s = 31; s >= 0; --s) {
        const float pe = pm[2 * s], po = pm[2 * s + 1];
        const float b0 = bm[bm_index(s)];
        const float c0 = add_rn(pe, b0), c1 = sub_rn(po, b0);
        nm[s] = fmaxf(c0, c1);
        w0[s / (32 / kG)] = push_sign(w0[s / (32 / kG)], sub_rn(c0, c1));
        const float b1 = bm[bm_index(s + 32)];
        const float d0 = add_rn(pe, b1), d1 = sub_rn(po, b1);
        nm[s + 32] = fmaxf(d0, d1);
        w1[s / (32 / kG)] = push_sign(w1[s / (32 / kG)], sub_rn(d0, d1));
    }
    dec.x = join_chains<kG>(w0);
    dec.y = join_chains<kG>(w1);
}

// The window's geometry: window wi of a row of n steps covers [start,
// start + e), start = clip(wi l - ov, 0, n - e), and owns [own_lo,
// own_hi) of it (window offsets).
struct Window {
    int start, own_lo, own_hi;
    bool first, tail;
    VIT_HD Window(int wi, int n, int l, int ov, int e) {
        const int s = wi * l - ov;
        start = s < 0 ? 0 : (s > n - e ? n - e : s);
        first = start == 0;
        tail = start + e == n;
        own_lo = wi * l - start;
        own_hi = own_lo + l < n - start ? own_lo + l : n - start;
    }
};

// Decode one window. pairs(t, la0, lb0, la1, lb1): the LLR pairs of steps
// t and t + 1 (t even, t + 1 < e); pair(t, la, lb): step t's; store(t,
// dec) / load(t): step t's decision words, kept only for t >= own_lo (the
// owned traceback never reads below it); emit(t, bit): owned bit t.
template <class Pairs, class Pair, class Store, class Load, class Emit>
VIT_HD void decode_window(const Window& w, int e, Pairs pairs, Pair pair,
                          Store store, Load load, Emit emit) {
    float pm[64], nm[64];
#pragma unroll
    for (int s = 0; s < 64; ++s) pm[s] = w.first && s != 0 ? kNeg : 0.0f;
    uint2 dec;
    int t = 0;
    // each pair's LLRs are loaded one iteration ahead, so that the load's
    // latency hides behind the two steps before it
    float la0 = 0.0f, lb0 = 0.0f, la1 = 0.0f, lb1 = 0.0f;
    if (e >= 2) pairs(0, la0, lb0, la1, lb1);
    for (; t + 1 < e; t += 2) {
        float na0 = 0.0f, nb0 = 0.0f, na1 = 0.0f, nb1 = 0.0f;
        if (t + 3 < e) pairs(t + 2, na0, nb0, na1, nb1);
        acs_step(pm, nm, la0, lb0, dec);
        if (t >= w.own_lo) store(t, dec);
        acs_step(nm, pm, la1, lb1, dec);
        if (t + 1 >= w.own_lo) store(t + 1, dec);
        la0 = na0;
        lb0 = nb0;
        la1 = na1;
        lb1 = nb1;
    }
    if (t < e) {                         // an odd e: the last step alone
        float la, lb;
        pair(t, la, lb);
        acs_step(pm, nm, la, lb, dec);
        if (t >= w.own_lo) store(t, dec);
#pragma unroll
        for (int s = 0; s < 64; ++s) pm[s] = nm[s];
    }
    if (w.tail) {                        // terminated in state 0
#pragma unroll
        for (int s = 1; s < 64; ++s) pm[s] = add_rn(pm[s], kNeg);
    }
    int state = 0;
    float best = pm[0];
#pragma unroll
    for (int s = 1; s < 64; ++s) {
        if (pm[s] > best) {
            best = pm[s];
            state = s;
        }
    }
#pragma unroll 16
    for (int u = e - 1; u >= w.own_lo; --u) {
        const uint2 d = load(u);
        if (u < w.own_hi) emit(u, static_cast<uint8_t>((state >> 5) & 1));
        const unsigned word = state >= 32 ? d.y : d.x;
        state = ((state & 31) << 1) | static_cast<int>((word >> (state & 31)) & 1u);
    }
}

}  // namespace vit
