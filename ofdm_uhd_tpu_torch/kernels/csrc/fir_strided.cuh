// The exact strided FIR of complex rows (K7's ofdm_fir_strided): the
// 'same' FIR (stride 1), M-fold decimation (stride M) and the stream's
// valid-mode decimation (pad_left = 0),
//   y[r, i] = sum_{t < nt} w[t] * xp[r, i*m + t],  i < n_out,
// xp = row r with pad_left zeros in front and zeros past its end; w are
// the correlation weights (the taps reversed). fir.cu launches it on the
// card; the same source compiles on the host (g++, without CUDA) so that
// tests/test_torch_fir_host.py can hold it against kernels/fir.py's
// decim_plain and decim_stream_plain, one std::thread a CUDA thread.
//
// Phases. With t = d*m + p, y[i] = sum_p sum_d W_p[d] * P_p[i + d], where
// P_p[j] = xp[j*m + p] is phase plane p and W_p[d] = w[d*m + p]: each
// plane is a stride-1 correlation with nd = ceil(nt / m) taps (the first
// `full` phases nd, the others nd - 1; at m > nt only the nt phases with
// a tap, one tap each). A consumer thread keeps kR consecutive outputs of
// a tile and, per plane, a window of kR samples in registers: each sample
// it loads from shared memory serves kR outputs (2 kR FMAs), and the
// window turns by register renaming (the tap loop is unrolled by kR). The
// taps sit in shared memory in chunks of kR padded to 12 floats, read by
// the whole warp at one address, three 16-byte loads a chunk.
//
// Pair planes. Where the stride is even and every pair of phases 2q,
// 2q + 1 lies 16-byte aligned in the rows (an even left pad, rows of an
// even length, x aligned), a stage holds pair planes instead: float4
// (P_2q[j], P_2q+1[j]) at index j of pair plane q. A producer copies a
// pair with one 16-byte cp.async, and a consumer loads both phases' samples
// with one 16-byte shared load (4 kR FMAs a load). C4's decimation (m = 8,
// pad 96, rows of 4,138,472) takes them.
//
// Banks. kR is odd, so the lanes of a warp, kR elements apart in a plane,
// meet each bank once (a half warp at a time for float2, a quarter warp
// for float4). The producers write the planes de-interleaved, consecutive
// lanes consecutive elements, and the plane stride (whole rows of banks
// plus a skew) spreads them over the banks. The copy walks (j, p) by
// adding the producers' (dj, dp) step with a carry, so no sample costs an
// integer division.
//
// Producers and consumers. A persistent grid walks the (row, tile) work
// items, item += gridDim. A block's first threads are consumers, in groups
// that split each tile's taps (the planes' chunks in order, evenly to
// within a chunk) and add their sums in order when the tile is stored; its
// last threads only copy: item n into stage n mod S by cp.async,
// zero-filled outside the row, each thread's copies arriving on the
// stage's "full" mbarrier as they land (cp.async.mbarrier.arrive.noinc);
// the consumers release a stage on its "empty" mbarrier. So the next
// tile's span is in flight while the current one is summed, and no
// consumer issues a copy: a warp that issues a run of cp.async stalls for
// long, which, measured, cost the sums more than the overlap gained. A
// stage holds the tile plus its halo, tile + nd - 1 samples a phase; the
// plan shrinks the tile, then falls back to one stage, where two would not
// fit. Outputs go through shared memory so that a warp stores 32
// consecutive float2.
//
// Rows never leak: a work item reads its own row only, zeros outside it.
// Offsets into the rows are size_t / long long.
#pragma once

#include <cmath>
#include <cstddef>
#include <cstring>

#if defined(__CUDACC__)
#define FIR_HD __host__ __device__ __forceinline__
#else
// Host build (g++): the CUDA vector types it uses
#define FIR_HD inline
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
#endif

namespace firk {

constexpr int kR = 9;          // consecutive outputs a thread (odd)
constexpr int kChunk = 12;     // floats a chunk of kR taps takes (3 x 16 B)
constexpr int kGroups = 2;     // consumer groups that share a tile's taps
constexpr int kGroupThreads = 128;   // threads of a consumer group
constexpr int kProducers = 128;      // producer threads a block
constexpr int kStages = 2;     // stages of the ring (1 where 2 do not fit)

// Everything a launch needs, computed once on the host by plan_strided.
struct Plan {
    int n_in, n_out, nt, m, pad_left;
    int phases;       // planes with a tap: min(m, nt)
    int nd;           // taps of a full phase
    int full;         // phases with nd taps; the rest have nd - 1
    int chunks;       // ceil(nd / kR)
    int pairs;        // 1: pair planes (phases 2q, 2q + 1 as float4)
    int np;           // planes staged: phases, or phases / 2 pair planes
    int groups;       // consumer groups, one a range of the taps
    int per;          // threads a consumer group
    int consumers;    // groups * per: threads 0 .. consumers - 1
    int producers;    // threads consumers .. consumers + producers - 1
    int threads;      // threads of a group that sum (<= per)
    int tile;         // outputs a work item: threads * kR
    int len;          // samples a plane holds: tile + nd - 1
    int lp;           // plane stride, in float2 (float4 for pair planes)
    int dj, dp;       // producers = dj * np + dp: the copy's step
    int ddst, cdst;   // its step in the stage (float2), and carry
    long long dsrc, csrc;   // its step in the row (samples), and carry
    int tiles;        // work items a row
    long long items;  // rows * tiles
    int stages;       // 1 or 2
    // shared memory, floats: the taps, a group's sums, a stage; then the
    // ring's barriers (two 8-byte words a stage)
    int taps_floats, out_floats, stage_floats;

    FIR_HD int block() const { return consumers + producers; }
    FIR_HD size_t ring_floats() const {
        return static_cast<size_t>(taps_floats) +
               static_cast<size_t>(groups) * out_floats +
               static_cast<size_t>(stages) * stage_floats;
    }
    size_t smem_bytes() const {
        return sizeof(float) * ring_floats() + 2 * sizeof(long long) * stages;
    }
};

inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The plan of a launch of `groups` consumer groups of `per` threads and
// `producers` producer threads a block: `stages` stages (1 or 2) of the
// largest tile whose shared memory fits in max_smem bytes, else one stage;
// false if not even one thread's tile fits in one stage.
// Pair planes where every pair of phases 2q, 2q + 1 lies 16-byte aligned
// in the rows: an even stride up to the tap count, an even pad_left, rows
// of an even length (or one row), and x 16-byte aligned (aligned16).
inline bool plan_strided(Plan& g, int rows, int n_in, int n_out, int nt,
                         int m, int pad_left, int groups, int per,
                         int producers, int stages, bool aligned16,
                         size_t max_smem) {
    if (rows < 1 || n_out < 1 || nt < 1 || m < 1 || groups < 1 ||
        per < 1 || producers < 1 || stages < 1 || stages > 2)
        return false;
    g.n_in = n_in;
    g.n_out = n_out;
    g.nt = nt;
    g.m = m;
    g.pad_left = pad_left;
    g.phases = m < nt ? m : nt;
    g.nd = m < nt ? (nt + m - 1) / m : 1;
    g.full = m < nt ? nt - (g.nd - 1) * m : nt;
    g.chunks = (g.nd + kR - 1) / kR;
    g.pairs = aligned16 && m % 2 == 0 && m <= nt && pad_left % 2 == 0 &&
              (n_in % 2 == 0 || rows == 1);
    g.np = g.pairs ? g.phases / 2 : g.phases;
    const int es = g.pairs ? 2 : 1;          // samples an element
    g.groups = groups;
    g.per = per;
    g.consumers = groups * per;
    g.producers = producers;
    g.dj = producers / g.np;
    g.dp = producers % g.np;
    g.dsrc = static_cast<long long>(g.dj) * m + es * g.dp;
    g.csrc = m - es * g.np;
    // one chunk more than the phases hold: the last prefetch reads zeros
    g.taps_floats = (g.phases * g.chunks + 1) * kChunk;
    // a skew that spreads a warp's copies over the banks: 16 float2 or 8
    // float4 a row of banks
    const int row = g.pairs ? 8 : 16;
    const int skew = g.np > 1 ? (row + g.np - 1) / g.np : 0;
    for (; stages >= 1; --stages)
        // whole warps of a group first, then any count below a warp
        for (int threads = per; threads >= 1;
             threads -= threads > 32 ? 32 : 1) {
            g.threads = threads;
            g.tile = threads * kR;
            g.len = g.tile + g.nd - 1;
            g.lp = round_up(g.len, row) + skew;
            g.ddst = es * (g.dp * g.lp + g.dj);
            g.cdst = es * (1 - g.np * g.lp);
            g.out_floats = round_up(2 * g.tile, 4);
            g.stage_floats = round_up(2 * es * g.np * g.lp, 4);
            g.stages = stages;
            if (g.smem_bytes() <= max_smem) {
                g.tiles = (n_out + g.tile - 1) / g.tile;
                g.items = static_cast<long long>(rows) * g.tiles;
                return true;
            }
        }
    return false;
}

// An 8-byte copy from device to shared memory that completes
// asynchronously (cp.async), zeros where `ok` is false; on the host a
// plain copy.
FIR_HD void copy8(float2* dst, const float2* src, bool ok) {
#if defined(__CUDA_ARCH__)
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
                 "l"(src), "r"(ok ? 8 : 0));
#else
    if (ok)
        std::memcpy(dst, src, sizeof(float2));
    else
        *dst = float2{0.0f, 0.0f};
#endif
}

// A 16-byte copy of the same kind, of `bytes` (0, 8 or 16) bytes from
// src, zeros in the rest; dst and src 16-byte aligned.
FIR_HD void copy16(float2* dst, const float2* src, int bytes) {
#if defined(__CUDA_ARCH__)
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(src), "r"(bytes));
#else
    float2 v[2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
    std::memcpy(v, src, static_cast<size_t>(bytes));
    dst[0] = v[0];
    dst[1] = v[1];
#endif
}

FIR_HD void copy_wait_all() {   // this thread's copies have landed
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

#if defined(__CUDACC__)
// The ring's barriers on the card: an mbarrier a stage for "full" (one
// arrival a producer thread, made by its copies' completion:
// cp.async.mbarrier.arrive.noinc) and one for "empty" (one arrival a
// consumer thread), in shared memory after the stages.
struct DevicePipe {
    unsigned long long* bars;           // full[0..S), empty[0..S)
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
    }
    // this producer thread's copies so far, on their completion
    __device__ void arrive_full(int s) {
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
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

FIR_HD float tap(const float4 (&tw)[3], int u) {
    const float4 t = tw[u / 4];
    return u % 4 == 0 ? t.x : u % 4 == 1 ? t.y : u % 4 == 2 ? t.z : t.w;
}

// Chunk c of a phase plane's taps, d = c kR .. c kR + kR - 1: the kR
// samples its steps bring into the window, smp[u] = P[base + c kR + kR -
// 1 + u] (those with d < nd), and its 12 tap slots.
FIR_HD void load_chunk(const float2* pl, const float4* tp, int c, int nd,
                       float2 (&smp)[kR], float4 (&tw)[3]) {
#pragma unroll
    for (int u = 0; u < kR; ++u)
        if (c * kR + u < nd) smp[u] = pl[c * kR + kR - 1 + u];
#pragma unroll
    for (int i = 0; i < 3; ++i) tw[i] = tp[3 * c + i];
}

// The steps of one loaded chunk (at kTail only those with d0 + u < nd):
// on entry win holds P[base + d0 + k] in slot k for k < kR - 1, on exit
// P[base + d0 + kR + k] in slot k likewise.
template <bool kTail>
FIR_HD void sum_chunk(const float2 (&smp)[kR], const float4 (&tw)[3],
                      int d0, int nd, float2 (&win)[kR], float (&re)[kR],
                      float (&im)[kR]) {
#pragma unroll
    for (int u = 0; u < kR; ++u) {
        if (!kTail || d0 + u < nd) {
            win[(u + kR - 1) % kR] = smp[u];
            const float c = tap(tw, u);
#pragma unroll
            for (int k = 0; k < kR; ++k) {
                re[k] = fmaf(c, win[(u + k) % kR].x, re[k]);
                im[k] = fmaf(c, win[(u + k) % kR].y, im[k]);
            }
        }
    }
}

// Chunks [c_lo, c_hi) of phase plane p of the kR outputs from base of a
// staged tile, added to re, im. The chunks alternate between two register
// sets, so that each chunk's shared loads go out a chunk (2 kR^2 FMAs)
// before their use: on an H100 the stride-1 FIR at C4's baseband takes
// ~10% less time than with each chunk loaded just before its steps.
FIR_HD void sum_phase(const float2* st, const float* taps, const Plan& g,
                      int p, int c_lo, int c_hi, int base, float (&re)[kR],
                      float (&im)[kR]) {
    const int nd = p < g.full ? g.nd : g.nd - 1;
    const int whole = nd / kR;                     // chunks of kR steps
    const int end = c_hi < whole ? c_hi : whole;   // whole ones in range
    const float2* pl = st + static_cast<size_t>(p) * g.lp + base;
    const float4* tp =
        reinterpret_cast<const float4*>(taps + p * g.chunks * kChunk);
    float2 win[kR], sa[kR], sb[kR];
    float4 ta[3], tb[3];
    int c = c_lo;
#pragma unroll
    for (int k = 0; k < kR - 1; ++k) win[k] = pl[c * kR + k];
    load_chunk(pl, tp, c, nd, sa, ta);
    for (; c + 2 <= end; c += 2) {
        load_chunk(pl, tp, c + 1, nd, sb, tb);
        sum_chunk<false>(sa, ta, c * kR, nd, win, re, im);
        load_chunk(pl, tp, c + 2, nd, sa, ta);
        sum_chunk<false>(sb, tb, (c + 1) * kR, nd, win, re, im);
    }
    if (c < end) {                  // one whole chunk in sa, maybe a tail
        load_chunk(pl, tp, c + 1, nd, sb, tb);
        sum_chunk<false>(sa, ta, c * kR, nd, win, re, im);
        if (c + 1 < c_hi)
            sum_chunk<true>(sb, tb, (c + 1) * kR, nd, win, re, im);
    } else if (c < c_hi) {          // the tail in sa
        sum_chunk<true>(sa, ta, c * kR, nd, win, re, im);
    }
}

// The chunks of a plane of nd steps, `before` steps after the first of
// all planes' steps in order, that a group whose share is the steps [lo,
// hi) takes: those whose first step lies in it. The groups split the
// steps evenly to within a chunk.
FIR_HD void chunk_range(int nd, int before, int lo, int hi, int& c_lo,
                        int& c_hi) {
    const int ch = (nd + kR - 1) / kR;
    const int a = lo - before, b = hi - before;
    c_lo = a <= 0 ? 0 : (a + kR - 1) / kR;
    c_hi = b <= 0 ? 0 : (b + kR - 1) / kR;
    c_lo = c_lo < ch ? c_lo : ch;
    c_hi = c_hi < ch ? c_hi : ch;
}

// The steps of one loaded chunk of a pair plane q (phases 2q, 2q + 1) at
// kTail only those with d0 + u < nd: as sum_chunk, one window a phase.
template <bool kTail>
FIR_HD void sum_pair_chunk(const float4 (&smp)[kR], const float4 (&ta)[3],
                           const float4 (&tb)[3], int d0, int nd,
                           float2 (&wa)[kR], float2 (&wb)[kR],
                           float (&re)[kR], float (&im)[kR]) {
#pragma unroll
    for (int u = 0; u < kR; ++u) {
        if (!kTail || d0 + u < nd) {
            wa[(u + kR - 1) % kR] = float2{smp[u].x, smp[u].y};
            wb[(u + kR - 1) % kR] = float2{smp[u].z, smp[u].w};
            const float ca = tap(ta, u), cb = tap(tb, u);
#pragma unroll
            for (int k = 0; k < kR; ++k) {
                re[k] = fmaf(ca, wa[(u + k) % kR].x, re[k]);
                im[k] = fmaf(ca, wa[(u + k) % kR].y, im[k]);
                re[k] = fmaf(cb, wb[(u + k) % kR].x, re[k]);
                im[k] = fmaf(cb, wb[(u + k) % kR].y, im[k]);
            }
        }
    }
}

// Chunks [c_lo, c_hi) of pair plane q of the kR outputs from base, added
// to re, im: one 16-byte shared load feeds both phases' windows (4 kR
// FMAs); the lanes of a quarter warp, kR float4 apart, meet each bank
// once. Phase 2q + 1 has nd or nd - 1 taps: its last tap slot is zero
// where it has fewer.
FIR_HD void sum_pair(const float2* st, const float* taps, const Plan& g,
                     int q, int c_lo, int c_hi, int base, float (&re)[kR],
                     float (&im)[kR]) {
    const int nd = 2 * q < g.full ? g.nd : g.nd - 1;
    const float4* pl =
        reinterpret_cast<const float4*>(st) + static_cast<size_t>(q) * g.lp +
        base;
    const float4* tpa = reinterpret_cast<const float4*>(
        taps + 2 * q * g.chunks * kChunk);
    const float4* tpb = tpa + 3 * g.chunks;
    float2 wa[kR], wb[kR];
#pragma unroll
    for (int k = 0; k < kR - 1; ++k) {
        const float4 v = pl[c_lo * kR + k];
        wa[k] = float2{v.x, v.y};
        wb[k] = float2{v.z, v.w};
    }
    for (int c = c_lo; c < c_hi; ++c) {
        float4 smp[kR], ta[3], tb[3];
#pragma unroll
        for (int u = 0; u < kR; ++u)
            if (c * kR + u < nd) smp[u] = pl[c * kR + kR - 1 + u];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            ta[i] = tpa[3 * c + i];
            tb[i] = tpb[3 * c + i];
        }
        if ((c + 1) * kR <= nd)
            sum_pair_chunk<false>(smp, ta, tb, c * kR, nd, wa, wb, re, im);
        else
            sum_pair_chunk<true>(smp, ta, tb, c * kR, nd, wa, wb, re, im);
    }
}

// A producer thread's walk over its elements of one work item's span:
// sample j <- xp[(o0 + j) m + p] into plane p (or the pair (j, q) of
// samples xp[(o0 + j) m + 2q], + 1 into pair plane q), (j, p) from (j0,
// p0) by the producers' step.
struct Copy {
    const float2* xr;   // the item's row
    float2* st;         // its stage
    long long s;        // row index of the next element's first sample
    int j, p, dst;      // its plane index, plane, stage offset (float2)

    FIR_HD void start(const float2* x, float2* ring, const Plan& g,
                      long long item, int stage, int j0, int p0) {
        if (item >= g.items) {
            j = g.len;                         // nothing to copy
            return;
        }
        const int es = g.pairs ? 2 : 1;
        const long long row = item / g.tiles;
        const long long o0 = (item - row * g.tiles) * g.tile;
        xr = x + static_cast<size_t>(row) * g.n_in;
        st = ring + static_cast<size_t>(stage) * (g.stage_floats / 2);
        s = o0 * g.m - g.pad_left + static_cast<long long>(j0) * g.m +
            es * p0;
        j = j0;
        p = p0;
        dst = es * (p0 * g.lp + j0);
    }

    FIR_HD void advance(const Plan& g) {
        j += g.dj;
        p += g.dp;
        s += g.dsrc;
        dst += g.ddst;
        if (p >= g.np) {
            p -= g.np;
            ++j;
            s += g.csrc;
            dst += g.cdst;
        }
    }

    FIR_HD void all(const Plan& g) {
        if (g.pairs) {
            // s is even: a pair is inside the row, outside it, or (at an
            // odd row end) its first sample only
            for (; j < g.len; advance(g)) {
                const long long left = s < 0 ? 0 : g.n_in - s;
                const int bytes = left >= 2 ? 16 : left == 1 ? 8 : 0;
                copy16(st + dst, bytes ? xr + s : xr, bytes);
            }
            return;
        }
        for (; j < g.len; advance(g)) {
            const bool ok = static_cast<unsigned long long>(s) <
                            static_cast<unsigned long long>(g.n_in);
            copy8(st + dst, ok ? xr + s : xr, ok);
        }
    }
};

// One block's share of the launch: work items block_id, block_id + grid,
// ... of g.items; tid < g.block(); smem: g.smem_bytes(), 16-byte aligned.
// Threads below g.consumers sum, the others copy. pipe: the ring's
// barriers (DevicePipe on the card), on smem's words after the ring;
// sync(): a barrier of the whole block, used once; csync(): a barrier of
// the consumers (a named barrier on the card).
template <int S, class Pipe, class Sync, class CSync>
FIR_HD void strided_block(const float2* __restrict__ x,
                          const float* __restrict__ w,
                          float2* __restrict__ y, const Plan& g,
                          float* smem, long long block_id, long long grid,
                          int tid, Pipe& pipe, Sync sync, CSync csync) {
    static_assert(S == 1 || S == 2, "one or two stages");
    float* taps = smem;                                // [phases][chunks][12]
    float2* outs = reinterpret_cast<float2*>(smem + g.taps_floats);
    float2* ring = reinterpret_cast<float2*>(
        smem + g.taps_floats + static_cast<size_t>(g.groups) * g.out_floats);
    if (tid == 0) pipe.init(g.producers, g.consumers);
    // taps[(p chunks + c) 12 + u] = W_p[c kR + u], zero past the chunk's
    // kR, past nt or in the chunk after the last phase: once a block
    for (int i = tid; i < g.taps_floats; i += g.block()) {
        const int u = i % kChunk, pc = i / kChunk;
        const int c = pc % g.chunks, p = pc / g.chunks;
        const long long t = static_cast<long long>(c * kR + u) * g.m + p;
        taps[i] = (u < kR && p < g.phases && t < g.nt) ? w[t] : 0.0f;
    }
    sync();                  // the barriers and the taps are in place
    if (tid >= g.consumers) {
        // producer: item n into stage n mod S once its (n / S)-th use is
        // free, i.e. once the consumers are done with item n - S
        const int pt = tid - g.consumers;
        const int j0 = pt / g.np, p0 = pt - j0 * g.np;
        Copy copy;
        long long n = 0;
        for (long long item = block_id; item < g.items; item += grid, ++n) {
            const int stage = static_cast<int>(n % S);
            const long long use = n / S;
            if (use > 0)
                pipe.wait_empty(stage, static_cast<unsigned>((use - 1) & 1));
            copy.start(x, ring, g, item, stage, j0, p0);
            copy.all(g);
            pipe.arrive_full(stage);
        }
        copy_wait_all();
        return;
    }
    // consumer: its group, its outputs base .. base + kR - 1 of a tile, and
    // the group's share of the taps
    const int q = tid / g.per, lane = tid - q * g.per, base = lane * kR;
    // steps over every plane in order: a phase's taps, a pair plane's
    // steps (phase 2q's taps); planes from `full` (pair planes from
    // fq) have one fewer
    const int fq = g.pairs ? (g.full + 1) / 2 : g.full;
    const int total = g.np * g.nd - (g.np > fq ? g.np - fq : 0);
    const int lo = (q * total + g.groups - 1) / g.groups;
    const int hi = ((q + 1) * total + g.groups - 1) / g.groups;
    float2* out = outs + static_cast<size_t>(q) * (g.out_floats / 2);
    long long n = 0;
    for (long long item = block_id; item < g.items; item += grid, ++n) {
        const int stage = static_cast<int>(n % S);
        pipe.wait_full(stage, static_cast<unsigned>((n / S) & 1));
        const long long row = item / g.tiles;
        const long long o0 = (item - row * g.tiles) * g.tile;
        const bool live = lane < g.threads && o0 + base < g.n_out;
        const float2* st =
            ring + static_cast<size_t>(stage) * (g.stage_floats / 2);
        float re[kR], im[kR];
#pragma unroll
        for (int k = 0; k < kR; ++k) re[k] = im[k] = 0.0f;
        if (live)
            for (int p = 0; p < g.np; ++p) {
                const int nd = p < fq ? g.nd : g.nd - 1;
                const int before = p * g.nd - (p > fq ? p - fq : 0);
                int c_lo, c_hi;
                chunk_range(nd, before, lo, hi, c_lo, c_hi);
                if (c_lo >= c_hi) continue;
                if (g.pairs)
                    sum_pair(st, taps, g, p, c_lo, c_hi, base, re, im);
                else
                    sum_phase(st, taps, g, p, c_lo, c_hi, base, re, im);
            }
        pipe.arrive_empty(stage);          // the stage may be refilled
        if (live) {
#pragma unroll
            for (int k = 0; k < kR; ++k) {
                out[base + k].x = re[k];
                out[base + k].y = im[k];
            }
        }
        csync();             // every group's sums are in place
        const long long left = g.n_out - o0;
        const int here = left < g.tile ? static_cast<int>(left) : g.tile;
        float2* yr = y + static_cast<size_t>(row) * g.n_out + o0;
        for (int i = tid; i < here; i += g.consumers) {
            float2 v = outs[i];                    // the groups in order
            for (int r = 1; r < g.groups; ++r) {
                const float2 u = outs[static_cast<size_t>(r) *
                                      (g.out_floats / 2) + i];
                v.x += u.x;
                v.y += u.y;
            }
            yr[i] = v;
        }
        csync();             // the sums are stored: the next may go in
    }
}

}  // namespace firk
