// The shifted-FMA tier's body (shift.cu): the 'same' FIR, the phase-split
// M-fold decimation and the branch-row L-fold interpolation of complex64
// rows read in place, one float32 FMA a tap and component. shift.cu
// launches it on the card; the same source compiles on the host (g++,
// without CUDA), where the bulk copies and stores are plain copies, so
// that tests/test_torch_shift_host.py can hold it against the plain
// versions, one std::thread a CUDA thread.
//
// The functions (w: the correlation weights, the taps reversed; zeros
// outside each row):
//   phase kind, y[r, i] = sum_{p < m} sum_{d < nd} W_p[d] P_p[i + d],
//     W_p[d] = w[d m + p] (zero past nt), P_p[j] = xp[j m + p], xp = row r
//     behind pad_left zeros; m = 1 is the FIR, one phase of nt taps;
//   interpolation, y[r, i l + q] = sum_{e < nd} g[q][nd - 1 - e] xp[i + e],
//     g the branch matrix [l, nd], xp = row r behind d_max zeros.
// Each output sums its taps in one fixed order: per phase an FMA chain
// over d ascending from zero, then the phases' sums added in ascending
// phase. No choice of the plan (tile, warps, stages) changes it, so a row
// filtered alone gives the bits it gets in a batch.
//
// A block is `warps` consumer warps and one producer warp; a persistent
// grid walks the work items (a row's tile of outputs; the interpolation's:
// of inputs), item += grid.
//   Producer: each item's input span, (tile + nd - 1) m samples as they
//     lie in the row, into the ring's stages on mbarriers (2 or 3 stages;
//     the decimation's span in kPieces pieces, a stage each, so that the
//     ring holds half a span), a stage once the consumers have released
//     it: lane 0 issues one bulk copy (cp.async.bulk) of the part inside
//     the row from the 16-byte boundary at or before it (a row 8 bytes off
//     a boundary starts one sample into its stage), its bytes completing
//     the stage's "full" mbarrier; the lanes load the one sample at either
//     end and write zeros outside the row, by index: no sample of a
//     neighbouring row is read. So the next item's span is in flight while
//     this one is summed.
//   Consumers: the decimation splits each piece once into phase planes of
//     float2 (P_p[q] = raw[q m + p]; where m divides the consumers a
//     thread keeps its phase, else (q, p) walks by a carry: no division a
//     sample) and releases its stage; the FIR and the interpolation sum
//     straight from the stage and release it after. A thread keeps kR
//     consecutive outputs (the interpolation: kR consecutive inputs of one
//     branch) and a window of kR samples a plane in registers: a tap costs
//     one 8-byte shared load and 2 kR FMAs, the window turns by register
//     renaming (the tap loop unrolled by kR), the decimation sums
//     kPhasesAPass planes at once (independent chains, each added in
//     ascending phase), and the taps come from a table row read by the
//     whole warp at one address (the interpolation: one address a branch,
//     the rows an odd number of 16-byte words apart), kR taps a chunk
//     padded to whole 16-byte words. The outputs go to an output buffer in
//     shared memory in sample order (kOutBuffers, used in turn), and one
//     consumer writes the tile's contiguous outputs with one bulk store
//     (cp.async.bulk.global.shared::cta; the interpolation one a pass, as
//     each pass's outputs are summed), the one output at either end that
//     shares a 16-byte line with its neighbour by a plain store; a buffer
//     is written again only after cp.async.bulk.wait_group.read has seen
//     its last stores read it.
//
// Banks: kR is odd, so the 16 lanes of a half warp, kR float2 apart, meet
// 16 distinct bank pairs. A plane's stride is whole rows of 16 float2 plus
// a skew of ceil(16 / m), so the split's writes (a half warp's 16
// consecutive samples, ceil(16 / m) q by m phases) meet distinct bank
// pairs too.
//
// What the parts cost, in-kernel on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/shift_ablation.py; PERF.md §6): at C4's decimation the split
// takes ~21% (0.152 ms, 0.120 without it), the bulk copies and stores
// ~2% each (hidden); a ring holding a whole span (one piece) 0.194, since
// shared memory, not the copy, bounds the warps an SM holds; two planes a
// pass 0.164, one 0.173; kR 3 and 7 slower than 5. The FIR and the
// interpolation are bound by their sums and their per-item overhead (the
// FIR 0.0245 ms at 193 taps over 2^20, 49% of the FMA rate; kR 7 ties 9,
// 11 and 13 are slower); one consumer warp a block was the slowest layout
// at five of the six shapes (1.3-1.7x).
#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define SHIFT_D __host__ __device__ __forceinline__
#else
#define SHIFT_D inline
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
#endif

namespace shiftk {

constexpr int kFir = 0, kDecim = 1, kInterp = 2;   // kinds
constexpr int kMinStages = 2, kMaxStages = 3;   // raw stages of the ring
constexpr int kPieces = 2;        // ring stages a decimation item's span takes
constexpr int kPhasesAPass = 4;   // phase planes a decimation pass sums,
                                  // most (then 2, then 1)
constexpr int kInterpPasses = 2;  // interp: passes an item, a (group,
                                  // branch) pair a thread a pass
constexpr int kOutBuffers = 2;    // output buffers, used in turn

// Everything a launch needs, computed once on the host (plan_*).
struct Plan {
    int kind, rows, n_in, n_out;
    int m;        // FIR 1; decimation: the stride; interp: l
    int nt;       // phase: weights; interp: the branch length
    int nd;       // taps a table row: ceil(nt / m); interp: nt
    int phases;   // table rows: min(m, nt); interp: l
    int lead;     // zeros in front of a row: pad_left; d_max
    int r;        // outputs (interp: inputs) a thread: kR
    int cf;       // floats a chunk of kR taps takes (a multiple of 4)
    int tstride;  // floats a table row: an odd number of 16-byte words
    int warps;    // consumer warps a block
    int groups;   // interp: kR-input groups an item
    int tile;     // outputs an item (interp: inputs)
    int out;      // outputs an item: tile; interp: tile * l
    int span;     // samples an item stages
    int piece;    // samples a ring stage takes of a span (a multiple of m)
    int pieces;   // stages a span takes: kPieces (decimation), else 1
    int len, lp;  // m > 1: samples a phase plane, its stride (float2)
    int stages;   // raw stages of the ring
    int per_sm;   // blocks an SM holds at this layout
    int raw_pairs, out_pairs;   // 16-byte pairs a ring stage, an out buffer
    int items_row;
    long long items;
    // shared memory, bytes from its base: taps, ring, planes, outputs,
    // mbarriers (full[S], empty[S])
    int o_raw, o_planes, o_out, o_bars, smem;

    SHIFT_D int consumers() const { return 32 * warps; }
    SHIFT_D int threads() const { return 32 * (warps + 1); }
};

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
inline long long up(long long a, long long b) { return cdiv(a, b) * b; }

// The item's layout at `warps` consumer warps and `stages` raw stages;
// false past max_smem.
inline bool layout(Plan& g, int warps, int stages, size_t max_smem) {
    g.warps = warps;
    g.stages = stages;
    const long long c = 32LL * warps;
    long long planes = 0;
    g.pieces = 1;
    if (g.kind != kInterp) {
        g.groups = 0;
        g.tile = static_cast<int>(c * g.r);
        g.out = g.tile;
        g.len = g.tile + g.nd - 1;
        g.span = g.len * g.m;
        g.piece = g.span;
        if (g.kind == kDecim) {
            const int skew = (16 + g.m - 1) / g.m;
            g.lp = static_cast<int>(up(g.len, 16)) + (skew < 16 ? skew : 0);
            planes = 8LL * g.phases * g.lp;
            g.piece = static_cast<int>(up(cdiv(g.span, kPieces), g.m));
            g.pieces = static_cast<int>(cdiv(g.span, g.piece));
        } else {
            g.lp = 0;
        }
        g.items_row = static_cast<int>(cdiv(g.n_out, g.tile));
    } else {
        g.groups = static_cast<int>(c >= g.m ? c / g.m : 1) * kInterpPasses;
        g.tile = g.groups * g.r;
        g.out = g.tile * g.m;
        g.len = g.lp = 0;
        g.span = g.piece = g.tile + g.nd - 1;
        g.items_row = static_cast<int>(cdiv(g.n_in, g.tile));
    }
    g.items = static_cast<long long>(g.rows) * g.items_row;
    g.raw_pairs = g.piece / 2 + 1;     // a phase of one sample, then a piece
    g.out_pairs = g.out / 2 + 1;
    const long long taps = up(4LL * g.phases * g.tstride, 16);
    const long long o_planes = taps + 16LL * stages * g.raw_pairs;
    const long long o_out = o_planes + up(planes, 16);
    const long long o_bars = o_out + kOutBuffers * 16LL * g.out_pairs;
    const long long smem = o_bars + 8LL * 2 * stages;
    if (smem > static_cast<long long>(max_smem)) return false;
    g.o_raw = static_cast<int>(taps);
    g.o_planes = static_cast<int>(o_planes);
    g.o_out = static_cast<int>(o_out);
    g.o_bars = static_cast<int>(o_bars);
    g.smem = static_cast<int>(smem);
    return true;
}

// Warps and stages. Consumer warps in the order measured fastest on the
// card (scripts/shift_ablation.py, at the shift phase's shapes: 4 the
// fastest wherever its items gave every SM two, within 4% of the fastest
// at the 3-tap FIR; 8 slower at five of six shapes; one warp a block the
// slowest at five of six, 1.3-1.7x), the first at most max_warps whose
// items give every one of `sms` SMs two (else the one giving the most);
// at it the stages (3 or 2) that let an SM hold the most blocks
// (per_sm(threads, smem)), 3 on a tie.
template <class PerSm>
inline bool choose(Plan& g, int max_warps, int sms, size_t max_smem,
                   PerSm per_sm) {
    constexpr int kOrder[3] = {4, 2, 1};
    if (sms < 1) sms = 1;
    int best_w = 0, best_s = 0, best_per = 0;
    long long best_items = 0;
    for (int w : kOrder) {
        if (w > max_warps) continue;
        int s_w = 0, per_w = 0;
        for (int s = kMaxStages; s >= kMinStages; --s) {
            if (!layout(g, w, s, max_smem)) continue;
            const int per = per_sm(g.threads(), g.smem);
            if (per > per_w) {
                per_w = per;
                s_w = s;
            }
        }
        if (per_w < 1) continue;
        layout(g, w, s_w, max_smem);
        if (best_w == 0 || g.items > best_items) {
            best_w = w, best_s = s_w, best_per = per_w;
            best_items = g.items;
        }
        if (g.items >= 2LL * sms) break;
    }
    if (best_w == 0 || !layout(g, best_w, best_s, max_smem)) return false;
    g.per_sm = best_per;
    return true;
}

inline void table(Plan& g) {
    g.cf = static_cast<int>(up(g.r, 4));
    const long long chunks = cdiv(g.nd, g.r);
    long long ts = chunks * g.cf;
    if ((ts / 4) % 2 == 0) ts += 4;    // an odd number of 16-byte words
    g.tstride = static_cast<int>(ts);
}

// y[r, i] = sum_t w[t] xp[r, i m + t], i < n_out, xp = row r with pad_left
// zeros in front and zeros past n_in; w: nt correlation weights.
template <class PerSm>
inline bool plan_phase(Plan& g, int rows, int n_in, int n_out, int nt, int m,
                       int pad_left, int r, int max_warps, int sms,
                       size_t max_smem, PerSm per_sm) {
    if (rows < 1 || n_in < 1 || n_out < 1 || nt < 1 || m < 1 || r < 1 ||
        r % 2 == 0 || max_warps < 1)
        return false;
    g = Plan{};
    g.kind = m > 1 ? kDecim : kFir;
    g.rows = rows, g.n_in = n_in, g.n_out = n_out, g.nt = nt, g.m = m;
    g.lead = pad_left;
    g.r = r;
    g.nd = static_cast<int>(cdiv(nt, m));
    g.phases = m < nt ? m : nt;
    table(g);
    return choose(g, max_warps, sms, max_smem, per_sm);
}

// y[r, i l + q] = sum_e gm[q][nd - 1 - e] xp[r, i + e], i < n, xp = row r
// with d_max zeros in front; gm: the branch matrix [l, nd].
template <class PerSm>
inline bool plan_interp(Plan& g, int rows, int n, int l, int nd, int d_max,
                        int r, int max_warps, int sms, size_t max_smem,
                        PerSm per_sm) {
    if (rows < 1 || n < 1 || l < 1 || nd < 1 || r < 1 || r % 2 == 0 ||
        max_warps < 1)
        return false;
    g = Plan{};
    g.kind = kInterp;
    g.rows = rows, g.n_in = n, g.n_out = n * l, g.nt = nd, g.m = l;
    g.nd = nd;
    g.phases = l;
    g.lead = d_max;
    g.r = r;
    table(g);
    return choose(g, max_warps, sms, max_smem, per_sm);
}

// ---------------------------------------------------------------- ops

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device to shared memory, completing on the stage's "full" mbarrier
// (one arrival and the bytes); on the host a plain copy and an arrival.
template <class Pipe>
SHIFT_D void bulk_load(float2* dst, const float2* src, unsigned bytes,
                       Pipe& pipe, int stage) {
#if defined(__CUDA_ARCH__)
    // the consumers' reads of this stage (generic proxy) come before the
    // copy engine's writes (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    pipe.expect_full(stage, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
           "l"(src), "r"(bytes),
           "r"(static_cast<unsigned>(__cvta_generic_to_shared(
               pipe.full_bar(stage))))
        : "memory");
#else
    std::memcpy(dst, src, bytes);
    pipe.arrive_full(stage);
#endif
}

// A bulk store of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from shared to device memory, committed as one bulk group.
SHIFT_D void bulk_store(float2* dst, const float2* src, unsigned bytes) {
#if defined(__CUDA_ARCH__)
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        :: "l"(dst),
           "r"(static_cast<unsigned>(__cvta_generic_to_shared(src))),
           "r"(bytes)
        : "memory");
#else
    std::memcpy(dst, src, bytes);
#endif
}

SHIFT_D void bulk_commit() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
#endif
}

// The bulk stores of all but the newest N groups have read their sources.
template <int N>
SHIFT_D void bulk_wait_read() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
#endif
}

// Every bulk store is complete.
SHIFT_D void bulk_wait_all() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#endif
}

// This thread's writes to shared memory are seen by a later bulk store.
SHIFT_D void fence_async() {
#if defined(__CUDA_ARCH__)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

SHIFT_D float fma32(float a, float b, float c) {
#if defined(__CUDA_ARCH__)
    return __fmaf_rn(a, b, c);
#else
    return std::fma(a, b, c);
#endif
}

#if defined(__CUDACC__)
// The ring's mbarriers on the card: full[S] (one arrival a producer
// thread, and the bulk copy's bytes) and empty[S] (one arrival a consumer
// thread).
struct DevicePipe {
    unsigned long long* bars;
    int stages;

    __device__ static unsigned addr(const void* p) {
        return static_cast<unsigned>(__cvta_generic_to_shared(p));
    }
    __device__ void init(int producers, int consumers) {
        for (int s = 0; s < stages; ++s) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                             addr(bars + s)), "r"(producers) : "memory");
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                             addr(bars + stages + s)), "r"(consumers)
                         : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __device__ unsigned long long* full_bar(int s) { return bars + s; }
    // one arrival, and `bytes` more that the bulk copy must bring
    __device__ void expect_full(int s, unsigned bytes) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     ::"r"(addr(bars + s)), "r"(bytes) : "memory");
    }
    __device__ void arrive_full(int s) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     ::"r"(addr(bars + s)) : "memory");
    }
    __device__ void arrive_empty(int s) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     ::"r"(addr(bars + stages + s)) : "memory");
    }
    __device__ static void wait(const unsigned long long* bar,
                                unsigned parity) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "WAIT:\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
            "@!p bra WAIT;\n"
            "}\n" ::"r"(addr(bar)), "r"(parity) : "memory");
    }
    __device__ void wait_full(int s, unsigned parity) {
        wait(bars + s, parity);
    }
    __device__ void wait_empty(int s, unsigned parity) {
        wait(bars + stages + s, parity);
    }
};
#endif

// ---------------------------------------------------------------- body

struct Args {
    const float2* x;   // the rows' base, 16-byte aligned
    int xoff;          // samples from that base to the first row (0, 1)
    const float* coef; // phase: weights [nt]; interp: branches [l, nd]
    float2* y;         // the outputs' base, 16-byte aligned
    int yoff;          // samples from that base to the first output (0, 1)
};

// p as the body takes it: the 16-byte aligned base at or before p, and p's
// offset from it in samples; false if p is not 8-byte aligned.
inline bool aligned_at(const void* p, const float2*& base, int& off) {
    const uintptr_t u = reinterpret_cast<uintptr_t>(p);
    if (u % 8 != 0) return false;
    off = static_cast<int>(u % 16 / 8);
    base = reinterpret_cast<const float2*>(u - u % 16);
    return true;
}

inline bool args_at(const void* x, const float* coef, void* y, Args& a) {
    const float2* yb = nullptr;
    if (!aligned_at(x, a.x, a.xoff) || !aligned_at(y, yb, a.yoff))
        return false;
    a.coef = coef;
    a.y = const_cast<float2*>(yb);
    return true;
}

// An item's row, its first staged sample (row-local, may be negative),
// its first output's flat index in y and its outputs in the row.
struct Item {
    long long row, first, fo;
    int here;
};

SHIFT_D Item item_at(const Args& a, const Plan& g, long long item) {
    Item it;
    it.row = item / g.items_row;
    const long long k = item - it.row * g.items_row;
    const long long i0 = k * g.tile;   // first output (interp: input)
    if (g.kind != kInterp) {
        it.first = i0 * g.m - g.lead;
        const long long left = g.n_out - i0;
        it.here = static_cast<int>(left < g.tile ? left : g.tile);
        it.fo = it.row * g.n_out + i0 + a.yoff;
    } else {
        it.first = i0 - g.lead;
        const long long left = g.n_in - i0;
        it.here = static_cast<int>(left < g.tile ? left : g.tile) * g.m;
        it.fo = (it.row * g.n_in + i0) * g.m + a.yoff;
    }
    return it;
}

// The table, once a block: row p (phase p; interp: branch q), chunk c,
// slot u holds tap d = c kR + u of the row (zero past nd or nt): phase
// W_p[d] = w[d m + p], interp gm[q][nd - 1 - d].
SHIFT_D void load_taps(const Args& a, const Plan& g, float* taps, int tid,
                       int threads) {
    const int total = g.phases * g.tstride;
    for (int e = tid; e < total; e += threads) {
        const int row = e / g.tstride, cu = e - row * g.tstride;
        const int c = cu / g.cf, u = cu - c * g.cf;
        const long long d = static_cast<long long>(c) * g.r + u;
        float v = 0.0f;
        if (u < g.r && d < g.nd) {
            if (g.kind != kInterp) {
                const long long t = d * g.m + row;
                if (t < g.nt) v = a.coef[t];
            } else {
                v = a.coef[static_cast<long long>(row) * g.nd + g.nd - 1 - d];
            }
        }
        taps[e] = v;
    }
}

// Producer: a piece of an item's span from row-local `first` into a ring
// stage, from the even flat sample f0 at or before it (the stage's phase
// is f - f0):
// lane 0 copies the 16-byte aligned part inside the row in one bulk copy;
// the lanes load the samples beside it in the row (at most one at each
// end) and write zeros outside the row; each lane arrives once.
template <class Pipe>
SHIFT_D void stage_item(const Args& a, const Plan& g, float2* dst,
                        long long row, long long first, int lane, Pipe& pipe,
                        int stage) {
    const long long lo = row * g.n_in + a.xoff, hi = lo + g.n_in;
    const long long f = lo + first, f0 = f - (f & 1);
    const long long end = f0 + 2LL * g.raw_pairs;
    long long b0 = f0 > lo ? f0 : lo + (lo & 1);     // even, in the row
    long long b1 = end < hi ? end : hi - (hi & 1);
    if (b1 < b0) b1 = b0;
    for (int side = 0; side < 2; ++side)
        for (long long e = (side ? b1 : f0) + lane; e < (side ? end : b0);
             e += 32)
            dst[e - f0] = e >= lo && e < hi ? a.x[e] : float2{0.0f, 0.0f};
    if (lane == 0 && b1 > b0)
        bulk_load(dst + (b0 - f0), a.x + b0,
                  static_cast<unsigned>(8 * (b1 - b0)), pipe, stage);
    else
        pipe.arrive_full(stage);
}

// Consumers, decimation: a staged piece of the span, from its sample q0 m,
// split once into the phase planes, planes[p lp + q0 + q] = raw[q m + p]
// for p < phases; sample j = tid + k C walks (q, p) by a carry, or, where
// m divides C, keeps its phase.
SHIFT_D void split(const Plan& g, const float2* raw, int count, int q0,
                   float2* planes, int tid, int consumers) {
    const int dq = consumers / g.m, dp = consumers - dq * g.m;
    int q = tid / g.m, p = tid - q * g.m;
    if (dp == 0) {
        if (p >= g.phases) return;
        float2* dst = planes + p * g.lp + q0 + q;
#pragma unroll 4
        for (int j = tid; j < count; j += consumers, dst += dq) *dst = raw[j];
        return;
    }
    q += q0;
#pragma unroll 4
    for (int j = tid; j < count; j += consumers) {
        if (p < g.phases) planes[p * g.lp + q] = raw[j];
        q += dq;
        p += dp;
        if (p >= g.m) {
            p -= g.m;
            ++q;
        }
    }
}

// re[j][k], im[j][k] += sum_{d < nd} w[j][d] s[j][d + k] (k < R) for P
// planes j at once, an FMA chain over d ascending each: w[j] a table row
// (chunks of R taps in CF floats, 16-byte aligned), s[j] the thread's
// first sample; a window of R samples a plane in registers, sample d + k
// in slot (d + k) % R.
template <int R, int CF, int P>
SHIFT_D void fma_taps(const float2* const (&s)[P], const float* const (&w)[P],
                      int nd, float (&re)[P][R], float (&im)[P][R]) {
    float2 win[P][R];
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
        for (int k = 0; k < R - 1; ++k) win[j][k] = s[j][k];
    const auto chunk = [&](int d0, int c, int count) {
        float t[P][CF];
#pragma unroll
        for (int j = 0; j < P; ++j)
#pragma unroll
            for (int v = 0; v < CF; v += 4) {
                const float4 q =
                    *reinterpret_cast<const float4*>(w[j] + c * CF + v);
                t[j][v] = q.x, t[j][v + 1] = q.y, t[j][v + 2] = q.z,
                t[j][v + 3] = q.w;
            }
#pragma unroll
        for (int u = 0; u < R; ++u) {
            if (u < count) {
#pragma unroll
                for (int j = 0; j < P; ++j) {
                    win[j][(u + R - 1) % R] = s[j][d0 + u + R - 1];
#pragma unroll
                    for (int k = 0; k < R; ++k) {
                        re[j][k] = fma32(t[j][u], win[j][(u + k) % R].x,
                                         re[j][k]);
                        im[j][k] = fma32(t[j][u], win[j][(u + k) % R].y,
                                         im[j][k]);
                    }
                }
            }
        }
    };
    int d0 = 0, c = 0;
    for (; d0 + R <= nd; d0 += R, ++c) chunk(d0, c, R);
    if (d0 < nd) chunk(d0, c, nd - d0);      // the last, partial chunk
}

// y[k] += the sums of P planes from `first` (planes lp apart, taps tstride
// apart), added in ascending plane.
template <int R, int CF, int P>
SHIFT_D void sum_planes(const Plan& g, const float2* first,
                        const float* taps, float (&yre)[R],
                        float (&yim)[R]) {
    const float2* s[P];
    const float* w[P];
    float re[P][R], im[P][R];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        s[j] = first + j * g.lp;
        w[j] = taps + j * g.tstride;
#pragma unroll
        for (int k = 0; k < R; ++k) re[j][k] = im[j][k] = 0.0f;
    }
    fma_taps<R, CF, P>(s, w, g.nd, re, im);
#pragma unroll
    for (int j = 0; j < P; ++j)
#pragma unroll
        for (int k = 0; k < R; ++k) {
            yre[k] = yre[k] + re[j][k];
            yim[k] = yim[k] + im[j][k];
        }
}

// The item's `here` outputs from its buffer (output i at buf[ph + i], ph =
// fo & 1) to y at flat index fo: one bulk store of the whole 16-byte lines,
// the output at either end that shares a line with the next item by a
// plain store; then the bulk group is committed.
SHIFT_D void store_item(const Args& a, const float2* buf, long long fo,
                        int here) {
    const long long a0 = fo + (fo & 1), e = fo + here;
    const long long a1 = e - (e & 1);
    const float2* src = buf - (fo & 1);       // flat fo - (fo & 1), even
    if (a1 > a0) {
        bulk_store(a.y + a0, src + (a0 - fo + (fo & 1)),
                   static_cast<unsigned>(8 * (a1 - a0)));
    }
    bulk_commit();
    for (int side = 0; side < 2; ++side) {
        const long long f = side ? e - 1 : fo;
        if (side && e - 1 == fo) break;   // one output: stored once
        if (a1 <= a0 || f < a0 || f >= a1) a.y[f] = buf[f - fo];
    }
}

// One block's share of a launch of kind kKind at R outputs (interp:
// inputs) a thread: items block_id, block_id + grid, ... of g.items; tid <
// g.threads(); smem: g.smem bytes, 16-byte aligned; pipe on its words at
// g.o_bars. sync(): the whole block, once; csync(): the consumers (a named
// barrier on the card). The ring's stages are taken in turn by the items'
// pieces (the decimation: kPieces an item; else one, the whole span).
template <int kKind, int R, class Pipe, class Sync, class CSync>
SHIFT_D void shift_block(const Args& a, const Plan& g, unsigned char* smem,
                         long long block_id, long long grid, int tid,
                         Pipe& pipe, Sync sync, CSync csync) {
    constexpr int CF = (R + 3) / 4 * 4;
    float* taps = reinterpret_cast<float*>(smem);
    float2* ring = reinterpret_cast<float2*>(smem + g.o_raw);
    float2* planes = reinterpret_cast<float2*>(smem + g.o_planes);
    float2* outs = reinterpret_cast<float2*>(smem + g.o_out);
    const int consumers = g.consumers();
    if (tid == 0) pipe.init(32, consumers);
    load_taps(a, g, taps, tid, g.threads());
    sync();
    long long n = 0;             // ring stages taken so far
    if (tid >= consumers) {
        const int lane = tid - consumers;
        for (long long item = block_id; item < g.items; item += grid) {
            const Item it = item_at(a, g, item);
            for (int j = 0; j < g.pieces; ++j, ++n) {
                const int st = static_cast<int>(n % g.stages);
                if (n >= g.stages)
                    pipe.wait_empty(st, static_cast<unsigned>(
                                            (n / g.stages - 1) & 1));
                stage_item(a, g, ring + 2 * g.raw_pairs * st, it.row,
                           it.first + static_cast<long long>(j) * g.piece,
                           lane, pipe, st);
            }
        }
        return;
    }
    long long taken = 0;         // items taken so far
    for (long long item = block_id; item < g.items; item += grid, ++taken) {
        const Item it = item_at(a, g, item);
        float2* buf = outs + 2 * g.out_pairs * (taken % kOutBuffers) +
                      (it.fo & 1);
        // the bulk stores that last read this buffer (kOutBuffers items ago;
        // the interpolation commits one group a pass) are done with it
        if (tid == 0)
            bulk_wait_read<(kOutBuffers - 1) *
                           (kKind == kInterp ? kInterpPasses : 1)>();
        const float2* raw = nullptr;
        int st = 0;
        for (int j = 0; j < g.pieces; ++j) {
            st = static_cast<int>(n % g.stages);
            const long long f = it.row * g.n_in + a.xoff + it.first +
                                static_cast<long long>(j) * g.piece;
            raw = ring + 2 * g.raw_pairs * st + (f & 1);
            pipe.wait_full(st, static_cast<unsigned>((n / g.stages) & 1));
            if constexpr (kKind == kDecim) {
                const int count = g.span - j * g.piece;
                split(g, raw, count < g.piece ? count : g.piece,
                      j * (g.piece / g.m), planes, tid, consumers);
                pipe.arrive_empty(st);
                ++n;
            }
        }
        csync();                 // the planes are in place, the buffer free
        if constexpr (kKind != kInterp) {
            const int base = tid * R;
            if (base < it.here) {
                float yre[R], yim[R];
#pragma unroll
                for (int k = 0; k < R; ++k) yre[k] = yim[k] = 0.0f;
                if constexpr (kKind == kDecim) {
                    int p = 0;
                    for (; p + kPhasesAPass <= g.phases; p += kPhasesAPass)
                        sum_planes<R, CF, kPhasesAPass>(
                            g, planes + p * g.lp + base, taps + p * g.tstride,
                            yre, yim);
                    if constexpr (kPhasesAPass > 2)
                        for (; p + 2 <= g.phases; p += 2)
                            sum_planes<R, CF, 2>(g, planes + p * g.lp + base,
                                                 taps + p * g.tstride, yre,
                                                 yim);
                    for (; p < g.phases; ++p)
                        sum_planes<R, CF, 1>(g, planes + p * g.lp + base,
                                             taps + p * g.tstride, yre, yim);
                } else {
                    sum_planes<R, CF, 1>(g, raw + base, taps, yre, yim);
                }
#pragma unroll
                for (int k = 0; k < R; ++k) buf[base + k] = float2{yre[k], yim[k]};
            }
        } else {
            // pass j sums groups [j gp, (j + 1) gp) of the item, whose
            // outputs are contiguous: each pass's are stored as soon as it
            // is summed, under the next pass's sums
            const int l = g.m, gp = g.groups / kInterpPasses;
            for (int j = 0; j < kInterpPasses; ++j) {
                for (int pair = tid; pair < gp * l; pair += consumers) {
                    const int grp = j * gp + pair / l, q = pair % l;
                    const int base = grp * R;
                    if (base * l >= it.here) continue;
                    float re[R], im[R];
#pragma unroll
                    for (int k = 0; k < R; ++k) re[k] = im[k] = 0.0f;
                    sum_planes<R, CF, 1>(g, raw + base, taps + q * g.tstride,
                                         re, im);
#pragma unroll
                    for (int k = 0; k < R; ++k)
                        buf[(base + k) * l + q] = float2{re[k], im[k]};
                }
                if (j + 1 == kInterpPasses) {
                    pipe.arrive_empty(st);
                    ++n;
                }
                fence_async();
                csync();         // this pass's outputs are in place
                const int o0 = j * gp * R * l, o1 = o0 + gp * R * l;
                if (tid == 0 && o0 < it.here)
                    store_item(a, buf + o0, it.fo + o0,
                               (o1 < it.here ? o1 : it.here) - o0);
                else if (tid == 0)
                    bulk_commit();
            }
        }
        if constexpr (kKind != kInterp) {
            if constexpr (kKind == kFir) {
                pipe.arrive_empty(st);
                ++n;
            }
            fence_async();
            csync();             // the outputs are in place, the planes free
            if (tid == 0) store_item(a, buf, it.fo, it.here);
        }
    }
    if (tid == 0) bulk_wait_all();
}

}  // namespace shiftk
