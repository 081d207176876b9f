// The whole-sequence K=7 rate-1/2 Viterbi decode (K4) as one group of
// G = 64 / 2^M lanes runs it, each lane 2^M of the 64 states:
//   * G = 4, 8, 16 (decode_group, M = 4, 3, 2): a lane runs M trellis
//     steps with no exchange between lanes, then the group regroups its
//     states through shared memory; 32 / G sequences a warp;
//   * G = 32 (decode_butterfly, M = 1): one warp a sequence, a butterfly of
//     shuffles with one partner lane every step.
// viterbi.cu's ofdm_viterbi runs them on the card; the same source
// compiles on the host (g++, without CUDA) so that
// tests/test_torch_viterbi_group.py can hold it bit for bit against
// kernels/viterbi.py viterbi_plain, one std::thread a lane.
//
// Why M steps need no exchange. State s' has the predecessors
// 2 (s' & 31) and 2 (s' & 31) + 1. A lane that holds the 2^M states whose
// top 6 - M bits equal its number v (phase 0: state v 2^M + i in register
// i) holds both predecessors of every successor of them, and the
// successors again have 6 - M fixed bits, one place lower. After k steps
// (phase k) lane v's register i holds
//   state(k, v, i) = (i >> (M - k)) << (6 - k) | v << (M - k)
//                    | i & (2^(M - k) - 1),
// and every step is the same butterfly in register space: new register
// (u << (M - 1)) | x from old registers 2x and 2x + 1, u the input bit.
// After M steps the lane's fixed bits are the low ones, so the group
// regroups: each lane writes its (metric, path) pairs to shared memory by
// state and reads back the phase-0 layout, under one __syncwarp (two
// buffers, so that a buffer is rewritten only after the next barrier).
// The branch metric of each register is the reference's: its signs split
// into a part fixed by the register (a compile-time table) and a part fixed
// by the lane and the phase (two floats of +-1 a phase), and the input bit
// u negates both (both polynomials tap the oldest register bit).
//
// Survivors by register exchange, not stored decisions: next to its
// metric each state carries a 32-bit path word, the choice copies the
// predecessor's word, and a state whose input bit is 1 sets the step's bit
// (bit R - 1 - j at step j of an R-step record: R = 24, 20 at G = 32). At
// the end of every record the group stores the 64 words (256 bytes in
// state order, coalesced) and shifts each word left by R, so that bits
// R .. R + 5 hold the six inputs before the record: the state at its
// start. The traceback then reads one word a record, from state 0 at step
// n: the record's bits are the decoded bits, and the next state is
// (brev(word) >> (26 - R)) & 63. A C3 trellis writes 8208 x 288 records
// (605 MB) and reads back one 32-byte sector a record; the chain of
// dependent reads is 288 long at C3, 1844 at C4 (G = 32).
//
// Numerics: the ACS of phy/bits.py viterbi_decode exactly, as
// viterbi_window.cuh: bm = sa la + sb lb (sa, sb = +-1, products exact, one
// rounding), c0 = pm[2x] + bm, c1 = pm[2x + 1] - bm, the choice c1 > c0 (a
// tie keeps predecessor 0), written as add_rn / sub_rn / mul_rn
// (__fadd_rn, __fsub_rn, __fmul_rn on the card) so that nothing is
// contracted. Start pinned to state 0 (the others at -1e30), traceback
// from state 0 at step n.
#pragma once

#include <type_traits>

#include "viterbi_window.cuh"

#if !defined(__CUDACC__)
struct uint4 { unsigned x, y, z, w; };
#endif

namespace vit {

// steps a survivor record covers: 24 input bits, then the 6 of the state
// at the record's start, in a 32-bit word
constexpr int kRecordSteps = 24;

VIT_HD float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
    return __fmul_rn(a, b);
#else
    return a * b;
#endif
}

VIT_HD unsigned brev(unsigned x) {
#if defined(__CUDA_ARCH__)
    return __brev(x);
#else
    unsigned r = 0u;
    for (int b = 0; b < 32; ++b) r |= ((x >> b) & 1u) << (31 - b);
    return r;
#endif
}

VIT_HD unsigned float_bits(float f) {
#if defined(__CUDA_ARCH__)
    return __float_as_uint(f);
#else
    unsigned u;
    std::memcpy(&u, &f, sizeof u);
    return u;
#endif
}

VIT_HD float bits_float(unsigned u) {
#if defined(__CUDA_ARCH__)
    return __uint_as_float(u);
#else
    float f;
    std::memcpy(&f, &u, sizeof f);
    return f;
#endif
}

VIT_HD float2 load_pair(const float2* p) {
#if defined(__CUDA_ARCH__)
    return __ldg(p);
#else
    return *p;
#endif
}

// The layout of a group of 64 >> M lanes, 2^M states a lane.
template <int M>
struct GroupLayout {
    static_assert(M >= 2 && M <= 4, "4, 8 or 16 states a lane");
    static constexpr int kStates = 1 << M;       // states a lane
    static constexpr int kLanes = 64 >> M;       // G, lanes a group
    static constexpr int kGroups = 32 / kLanes;  // groups (sequences) a warp
    // shared memory of a warp, in (metric, path) pairs of 8 bytes: group q
    // at q kGroupPairs, its rows of kRowPairs, one a lane, the pair index
    // within a row XORed with swizzle(q, row). Chosen by enumeration so
    // that neither the writes (one 8-byte store a register, a half warp at
    // a time) nor the reads (16-byte loads, a quarter warp at a time) meet
    // a bank twice.
    static constexpr int kRowPairs = kStates;
    static constexpr int kGroupPairs = M >= 3 ? 72 : 64;

    VIT_HD static constexpr int swizzle(int q, int row) {
        return M == 2 ? ((row >> 2) & 1) << 1
             : M == 3 ? (row & 6)
             : ((((q >> 1) ^ row) & 1) << 2) | (((row >> 1) & 1) << 1);
    }
    VIT_HD static constexpr int slot(int q, int s) {
        return q * kGroupPairs + (s >> M) * kRowPairs
               + ((s & (kStates - 1)) ^ swizzle(q, s >> M));
    }
    // the state in register i of lane v after k steps of a cycle
    VIT_HD static constexpr int state(int k, int v, int i) {
        return ((i >> (M - k)) << (6 - k)) | (v << (M - k))
               | (i & ((1 << (M - k)) - 1));
    }
    // the code-bit signs (1: negative) of the p=0 branch into register x
    // at phase k that the register fixes; the lane's part is lane_sign,
    // and the input bit u flips both
    VIT_HD static constexpr int sign_a(int k, int x) {
        return parity7(((state(k, 0, x) & 31) << 1) & kPolyA);
    }
    VIT_HD static constexpr int sign_b(int k, int x) {
        return parity7(((state(k, 0, x) & 31) << 1) & kPolyB);
    }
    VIT_HD static constexpr int lane_sign(int k, int v, int poly) {
        return parity7(((v << (M - k)) << 1) & poly);
    }
};

// One group's decode of a sequence. A lane's registers: metrics pm and
// path words pp of its 2^M states.
template <int M>
struct GroupDecoder {
    using L = GroupLayout<M>;
    static constexpr int S = L::kStates;

    float pm[S];
    unsigned pp[S];
    float fa[M], fb[M];     // the lane's branch signs at phases 1..M
    int v;                  // the lane's number within its group

    VIT_HD explicit GroupDecoder(int lane) : v(lane) {
#pragma unroll
        for (int i = 0; i < S; ++i) {
            pm[i] = v == 0 && i == 0 ? 0.0f : kNeg;
            pp[i] = 0u;
        }
#pragma unroll
        for (int k = 1; k <= M; ++k) {
            fa[k - 1] = L::lane_sign(k, v, kPolyA) ? -1.0f : 1.0f;
            fb[k - 1] = L::lane_sign(k, v, kPolyB) ? -1.0f : 1.0f;
        }
    }

    // One trellis step into phase k; `mask` is the step's bit of a path
    // word.
    template <int K>
    VIT_HD void step(float2 ab, unsigned mask) {
        const float xa = mul_rn(ab.x, fa[K - 1]);
        const float xb = mul_rn(ab.y, fb[K - 1]);
        const float sum = add_rn(xa, xb), dif = sub_rn(xa, xb);
        float nm[S];
        unsigned np[S];
#pragma unroll
        for (int x = 0; x < S / 2; ++x) {
            const float pe = pm[2 * x], po = pm[2 * x + 1];
            const int sa = L::sign_a(K, x), sb = L::sign_b(K, x);
            // bm = +-(la +- lb): its magnitude term, then the sign
            const float base = sa == sb ? sum : dif;
#pragma unroll
            for (int u = 0; u < 2; ++u) {
                const bool neg = (u ^ sa) != 0;
                const float c0 = neg ? sub_rn(pe, base) : add_rn(pe, base);
                const float c1 = neg ? add_rn(po, base) : sub_rn(po, base);
                // the survivor's metric by max (equal to the choice's: no
                // metric is ever -0, as they start at +0 or -1e30), so that
                // the next step's adds wait on no predicate; the choice
                // picks the path word
                const bool ch = c1 > c0;
                const int j = (u << (M - 1)) | x;
                nm[j] = fmaxf(c0, c1);
                np[j] = (ch ? pp[2 * x + 1] : pp[2 * x]) | (u ? mask : 0u);
            }
        }
#pragma unroll
        for (int i = 0; i < S; ++i) {
            pm[i] = nm[i];
            pp[i] = np[i];
        }
    }

    // K steps into phases 1..K from ab[0..K)
    template <int K>
    VIT_HD void steps(const float2* ab, unsigned& mask) {
        if constexpr (K > 0) {
            steps<K - 1>(ab, mask);
            step<K>(ab[K - 1], mask);
            mask >>= 1;
        }
    }

    // From phase K back to phase 0 through the warp's buffer `buf`; q is
    // the lane's group within the warp.
    template <int K, class Sync>
    VIT_HD void regroup(uint2* buf, int q, Sync sync) {
#pragma unroll
        for (int i = 0; i < S; ++i)
            buf[L::slot(q, L::state(K, v, i))] =
                uint2{float_bits(pm[i]), pp[i]};
        sync();
#pragma unroll
        for (int c = 0; c < S / 2; ++c) {
            const uint4 w = *reinterpret_cast<const uint4*>(
                buf + L::slot(q, v * S + 2 * c));
            pm[2 * c] = bits_float(w.x);
            pp[2 * c] = w.y;
            pm[2 * c + 1] = bits_float(w.z);
            pp[2 * c + 1] = w.w;
        }
    }

    // The 64 path words of a record, in state order, lane v its row.
    VIT_HD void store_record(unsigned* rec) const {
        unsigned* dst = rec + v * S;
#pragma unroll
        for (int i = 0; i < S; i += 4)
            *reinterpret_cast<uint4*>(dst + i) =
                uint4{pp[i], pp[i + 1], pp[i + 2], pp[i + 3]};
    }
};

// Lookahead at G = 16, the group size of the middle batches (c2_pallas's
// 4160 rows: 16 sequences an SM, 8 warps), so that a step or a traceback
// record waits on registers, not on device memory: the LLRs of kLlrRounds
// two-cycle rounds and the path words of kTraceRecords records are in
// flight. With many groups an SM (G = 4, 8) the other warps hide the
// latency, and reading every record back (605 MB at C3) would cost more
// than the one sector a record the dependent load reads. (G = 32 stages
// both through shared memory: decode_butterfly.)
template <int M>
constexpr int kLlrRounds = M == 2 ? 4 : 1;
template <int M>
constexpr int kTraceRecords = M == 2 ? 8 : 0;

// The word of a lane's four words of a record at index j < 4, by selects
// with compile-time register indices.
VIT_HD unsigned pick4(const unsigned (&word)[4], int j) {
    const unsigned lo = j & 1 ? word[1] : word[0];
    const unsigned hi = j & 1 ? word[3] : word[2];
    return j & 2 ? hi : lo;
}

// The records a row of the scratch holds for records of R steps:
// ceil(n / R), made odd, so that the rows' records of one step (every
// group runs in step) lie an odd number of 256-byte records apart in
// device memory.
VIT_HD constexpr int record_stride(int n, int r) {
    return ((n + r - 1) / r) | 1;
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, in order: a loop
// whose index is a compile-time constant (register arrays indexed by it
// stay in registers).
template <int N, class F>
VIT_HD void unroll(F&& f) {
    if constexpr (N > 0) {
        unroll<N - 1>(f);
        f(std::integral_constant<int, N - 1>{});
    }
}

// Record r's word w on the traceback's path (records of R steps, lanes v of
// G): the state at the record's start (bits R .. R + 5), computed first,
// since the chain waits on it; then lane v's share of the record's decoded
// bits, bits R - 1 - j for j = v, v + G, ..., as predicated stores.
template <int R, int G>
VIT_HD int emit_record(unsigned w, int r, int n, int v, bool live,
                       uint8_t* bits) {
    const int s = static_cast<int>((brev(w) >> (26 - R)) & 63u);
    const int t0 = r * R;
    const int len = n - t0 < R ? n - t0 : R;
#pragma unroll
    for (int k = 0; k < (R + G - 1) / G; ++k) {
        const int j = v + k * G;
        if (live && j < len)
            bits[t0 + j] = static_cast<uint8_t>((w >> (R - 1 - j)) & 1u);
    }
    return s;
}

// The traceback of one sequence from state 0 at step n over its records
// of R steps (state order, 64 words each): one word a record, whose bits
// R - 1 - j are the record's decoded bits j and whose bits R .. R + 5 the
// state at its start. Lane v of the G emits bits v, v + G, ... of each
// record. D = 0: each word waits on the one before, straight from memory;
// D > 0 (G = 16): the lanes hold the D records below the one being read,
// lane v the words of states 4v .. 4v + 3, and lane s / 4 hands over word
// s % 4 by shuffle.
template <int R, int G, int D, class Shfl>
VIT_HD void trace_records(const unsigned* rec, uint8_t* bits, int n, int v,
                          bool live, Shfl shfl) {
    static_assert(R + 6 <= 32, "a record's bits and its start state");
    static_assert(D == 0 || G == 16, "the ring holds four words a lane");
    const int records = (n + R - 1) / R;
    int s = 0;
    auto emit = [&](unsigned w, int r) {
        s = emit_record<R, G>(w, r, n, v, live, bits);
    };
    if constexpr (D == 0) {
        for (int r = records - 1; r >= 0; --r) emit(rec[r * 64 + s], r);
    } else {
        unsigned ring[D][4];
        auto load_rec = [&](unsigned (&dst)[4], int r) {
            if (r < 0) return;
            const uint4 x = *reinterpret_cast<const uint4*>(rec + r * 64
                                                            + v * 4);
            dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
        };
#pragma unroll
        for (int k = 0; k < D; ++k) load_rec(ring[k], records - 1 - k);
        for (int r0 = records - 1; r0 >= 0; r0 -= D) {
#pragma unroll
            for (int k = 0; k < D; ++k) {
                const int r = r0 - k;
                if (r >= 0) {
                    const unsigned w = shfl(pick4(ring[k], s & 3), s / 4);
                    load_rec(ring[k], r - D);
                    emit(w, r);
                }
            }
        }
    }
}

// Decode one sequence of n steps: row, its LLR pairs [n]; rec, its
// records [record_stride(n, 24), 64] (scratch); bits [n]; v, the lane's
// number in the group and q the group's in the warp; buf, the warp's first buffer
// (the second at `other` pairs past it); live, whether the group has a
// sequence (a group past the batch runs on another row's LLRs and records,
// as the warp's barriers and shuffles need, and stores nothing);
// traceback, false to stop after the forward pass (timing only); sync, the
// warp's barrier; shfl(x, src), lane src's x within the group.
template <int M, class Sync, class Shfl>
VIT_HD void decode_group(const float2* row, unsigned* rec, uint8_t* bits,
                         int n, int v, int q, uint2* buf, int other,
                         bool live, bool traceback, Sync sync, Shfl shfl) {
    constexpr int S = GroupLayout<M>::kStates;
    constexpr int G = GroupLayout<M>::kLanes;
    constexpr int kRound = 2 * M;           // steps a two-buffer round
    constexpr int kAhead = kLlrRounds<M>;
    GroupDecoder<M> d(v);
    uint2* const buf1 = buf + other;
    // a round's LLRs [t, t + kRound) at one base address: a round past
    // the last whole one (read ahead, never used) reads the last kRound
    // steps instead
    auto load_round = [&](float2 (&dst)[kRound], int t) {
        const float2* p = row + (t < n - kRound ? t : n - kRound);
#pragma unroll
        for (int j = 0; j < kRound; ++j) dst[j] = load_pair(p + j);
    };
    // the steps [t, n) of the last part round, each index clamped
    auto load_rest = [&](float2 (&dst)[kRound], int t) {
#pragma unroll
        for (int j = 0; j < kRound; ++j)
            dst[j] = load_pair(row + (t + j < n ? t + j : n - 1));
    };
    unsigned mask = 1u << (kRecordSteps - 1);
    int left = kRecordSteps / kRound;       // rounds to the record's end
    auto round = [&](const float2 (&ab)[kRound], int t) {
        d.template steps<M>(ab, mask);
        d.template regroup<M>(buf, q, sync);
        d.template steps<M>(ab + M, mask);
        d.template regroup<M>(buf1, q, sync);
        if (--left == 0) {                  // a record ends at t + kRound
            if (live) d.store_record(rec + (t / kRecordSteps) * 64);
#pragma unroll
            for (int i = 0; i < S; ++i) d.pp[i] <<= kRecordSteps;
            mask = 1u << (kRecordSteps - 1);
            left = kRecordSteps / kRound;
        }
    };
    // ring[k] holds round rd + k, read in place and then reloaded with
    // the round kAhead later (at kAhead = 1 the next round's LLRs are
    // loaded before the round runs); no copy of a loaded register, which
    // would wait on its load
    float2 ring[kAhead][kRound];
    const int rounds = n / kRound;
#pragma unroll
    for (int k = 0; k < kAhead; ++k)
        if (k < rounds) load_round(ring[k], k * kRound);
    int rd = 0;
    for (; rd + kAhead <= rounds; rd += kAhead) {
#pragma unroll
        for (int k = 0; k < kAhead; ++k) {
            if constexpr (kAhead == 1) {
                float2 ab[kRound];
#pragma unroll
                for (int j = 0; j < kRound; ++j) ab[j] = ring[0][j];
                load_round(ring[0], (rd + 1) * kRound);
                round(ab, rd * kRound);
            } else {
                round(ring[k], (rd + k) * kRound);
                load_round(ring[k], (rd + k + kAhead) * kRound);
            }
        }
    }
#pragma unroll
    for (int k = 0; k + 1 < kAhead; ++k)
        if (rd + k < rounds) round(ring[k], (rd + k) * kRound);
    // the last steps (fewer than a round): a whole cycle, then a partial
    // one, each regrouped so that the record is stored in state order
    int t = rounds * kRound;
    int rest = n - t;
    float2 ab[kRound];
    load_rest(ab, t);
    uint2* next_buf = buf;
    if (rest >= M) {
        d.template steps<M>(ab, mask);
        d.template regroup<M>(buf, q, sync);
#pragma unroll
        for (int j = 0; j < M; ++j) ab[j] = ab[j + M];
        rest -= M;
        next_buf = buf1;
    }
    if (rest == 1) {
        d.template steps<1>(ab, mask);
        d.template regroup<1>(next_buf, q, sync);
    }
    if constexpr (M > 2) {
        if (rest == 2) {
            d.template steps<2>(ab, mask);
            d.template regroup<2>(next_buf, q, sync);
        }
    }
    if constexpr (M > 3) {
        if (rest == 3) {
            d.template steps<3>(ab, mask);
            d.template regroup<3>(next_buf, q, sync);
        }
    }
    const int records = (n + kRecordSteps - 1) / kRecordSteps;
    if (live && n % kRecordSteps != 0)
        d.store_record(rec + (records - 1) * 64);
    sync();                                 // the records, to the group
    if (!traceback) return;
    trace_records<kRecordSteps, G, kTraceRecords<M>>(rec, bits, n, v, live,
                                                     shfl);
}

// K4 at G = 32, one warp a sequence: a lane holds a predecessor pair of
// states (2w, 2w + 1) and computes their two successors w and w + 32; a
// butterfly with lane v ^ 2^p (two shuffles, one for the metrics, one for
// the path words) swaps the successors so that each lane again holds a
// pair, (w, w + 1) where w is even, (w + 32, w + 33) where it is odd. Lane
// v's w is v rotated right by p within five bits at phase p = t mod 5, so
// the butterfly's lane bit and the lane's branch signs cycle with period 5
// (precomputed). Against the regroup through shared memory every step
// (one store, a barrier and a load: ~80 cycles a step with a warp an SM),
// a step waits on one shuffle. Records of kButterflyRecord = 20 steps
// (four periods), stored where every lane holds its own pair (2v, 2v + 1).
// With a warp an SM nothing hides a load's latency, so the LLRs and, in
// the traceback, the records reach shared memory by cp.async kLlrStages
// and kRecStages records ahead of their use.
constexpr int kButterflyRecord = 20;
constexpr int kLlrStages = 8;
constexpr int kRecStages = 32;

struct ButterflySmem {
    float2 llr[kLlrStages][kButterflyRecord];
    unsigned rec[kRecStages][64];
};

// An 8-byte copy from device to shared memory that completes
// asynchronously (cp.async), the commit of the copies issued so far as one
// group, and the wait until at most N groups are pending; a plain copy on
// the host.
VIT_HD void copy_async8(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d),
                 "l"(src));
#else
    std::memcpy(dst, src, 8);
#endif
}

VIT_HD void copy_commit() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;");
#endif
}

template <int N>
VIT_HD void copy_wait() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_group %0;" ::"n"(N));
#endif
}

template <class Sync, class Shfl>
VIT_HD void decode_butterfly(const float2* row, unsigned* rec, uint8_t* bits,
                             int n, int v, bool live, bool traceback,
                             ButterflySmem& sm, Sync sync, Shfl shfl) {
    constexpr int R = kButterflyRecord;
    constexpr int P = 5;
    float fa[P], fb[P];
    bool hi[P];
    int w = v;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        fa[p] = parity7((w << 1) & kPolyA) ? -1.0f : 1.0f;
        fb[p] = parity7((w << 1) & kPolyB) ? -1.0f : 1.0f;
        hi[p] = ((v >> p) & 1) != 0;
        w = (w >> 1) | ((w & 1) << 4);
    }
    float pe = v == 0 ? 0.0f : kNeg, po = kNeg;     // metrics of 2w, 2w + 1
    unsigned qe = 0u, qo = 0u;                      // their path words
    auto step = [&](auto pc, float2 ab, unsigned mask) {
        constexpr int p = decltype(pc)::value;
        const float xa = mul_rn(ab.x, fa[p]);
        const float xb = mul_rn(ab.y, fb[p]);
        // successor w takes bm = xa + xb, successor w + 32 its negation
        const float bm = add_rn(xa, xb);
        const float a0 = add_rn(pe, bm), a1 = sub_rn(po, bm);
        const float b0 = sub_rn(pe, bm), b1 = add_rn(po, bm);
        const float m0 = fmaxf(a0, a1), m1 = fmaxf(b0, b1);
        const unsigned r0 = a1 > a0 ? qo : qe;
        const unsigned r1 = (b1 > b0 ? qo : qe) | mask;
        // the exchange: the lane whose bit p is 0 keeps its successor w
        // and takes its partner's (w | 1), the other keeps w + 32 and takes
        // its partner's (w ^ 1) + 32. Both metrics cross (two shuffles), so
        // that the chain of dependent steps waits on no select before a
        // shuffle; the path words, off that chain, cross as one.
        const bool h = hi[p];
        const int other = v ^ (1 << p);
        const float x0 = bits_float(shfl(float_bits(m0), other));
        const float x1 = bits_float(shfl(float_bits(m1), other));
        const unsigned gq = shfl(h ? r0 : r1, other);
        pe = h ? x1 : m0;
        po = h ? m1 : x0;
        qe = h ? gq : r0;
        qo = h ? r1 : gq;
    };
    // record r's LLRs into stage r % kLlrStages, a step a lane
    auto fetch = [&](int r) {
        const int t = r * R + v;
        if (v < R && t < n) copy_async8(&sm.llr[r % kLlrStages][v], row + t);
        copy_commit();
    };
    // record r's LLRs from its stage, once every lane may read them: its
    // group complete, then the warp's barrier; the stage of record r - 1
    // is refilled with record r + kLlrStages - 1 only after every lane has
    // read it (the barrier before)
    auto stage_in = [&](int r, float2 (&ab)[R]) {
        sync();
        fetch(r + kLlrStages - 1);
        copy_wait<kLlrStages - 1>();
        sync();
#pragma unroll
        for (int j = 0; j < R; ++j) ab[j] = sm.llr[r % kLlrStages][j];
    };
#pragma unroll
    for (int k = 0; k + 1 < kLlrStages; ++k) fetch(k);
    const int full = n / R;
    for (int r = 0; r < full; ++r) {
        float2 ab[R];
        stage_in(r, ab);
        unsigned mask = 1u << (R - 1);
        unroll<R>([&](auto jc) {
            constexpr int j = decltype(jc)::value;
            step(std::integral_constant<int, j % P>{}, ab[j], mask);
            mask >>= 1;
        });
        if (live)
            *reinterpret_cast<uint2*>(rec + r * 64 + 2 * v) = uint2{qe, qo};
        qe <<= R;
        qo <<= R;
    }
    const int rest = n - full * R;
    if (rest > 0) {
        float2 ab[R];
        stage_in(full, ab);
        unsigned mask = 1u << (R - 1);
        unroll<R - 1>([&](auto jc) {
            constexpr int j = decltype(jc)::value;
            if (j < rest) {
                step(std::integral_constant<int, j % P>{}, ab[j], mask);
                mask >>= 1;
            }
        });
        // the lane's pair is (2w, 2w + 1), w = v rotated right by rest % 5
        int wl = v;
        for (int k = 0; k < rest % P; ++k) wl = (wl >> 1) | ((wl & 1) << 4);
        if (live) {
            rec[full * 64 + 2 * wl] = qe;
            rec[full * 64 + 2 * wl + 1] = qo;
        }
    }
    copy_wait<0>();                         // no copy left in flight
    sync();                                 // the records, to the warp
    if (!traceback) return;
    // traceback from state 0 at step n: record r reaches stage r %
    // kRecStages, a lane its pair of words, kRecStages - 1 records before
    // it is read; the chain waits on one shared-memory load a record
    const int records = (n + R - 1) / R;
    auto fetch_rec = [&](int r) {
        if (r >= 0)
            copy_async8(&sm.rec[r % kRecStages][2 * v], rec + r * 64 + 2 * v);
        copy_commit();
    };
#pragma unroll 1
    for (int k = 0; k + 1 < kRecStages; ++k) fetch_rec(records - 1 - k);
    int s = 0;
    for (int r = records - 1; r >= 0; --r) {
        sync();
        fetch_rec(r - (kRecStages - 1));
        copy_wait<kRecStages - 1>();
        sync();
        s = emit_record<R, 32>(sm.rec[r % kRecStages][s], r, n, v, live,
                               bits);
    }
    copy_wait<0>();
}

}  // namespace vit
