// The banded tier's bodies (banded.cu): the strided real-tap correlation
// ('same' FIR at stride 1, M-fold decimation at stride M), the L-fold
// polyphase interpolation, and the Schmidl-Cox window sums, on complex64
// rows read in place, at float32 accuracy on the tensor cores (3xTF32,
// mma.sync m16n8k8). banded.cu launches them on the card; the same source
// compiles on the host (g++, without CUDA), where the tensor-core product,
// the TF32 rounding and the asynchronous copies are a software model, so
// that tests/test_torch_banded_host.py can hold the bodies against the
// plain versions, one std::thread a CUDA thread.
//
// A block is `warps` consumer warps and one producer warp; a persistent
// grid walks the work items (a row's span of outputs), item += grid.
//   Producer: copies item n's input span, complex64 as it lies in the
//     rows, into raw stage n mod 2 (a ring of two on mbarriers) once the
//     consumers have released it: lane 0 issues one bulk copy
//     (cp.async.bulk) of the 16-byte aligned part inside the row, whose
//     bytes complete the stage's "full" mbarrier; the lanes load the one
//     sample at either end and write zeros outside the row.
//   Consumers, per item: wait for the stage; split each staged sample once
//     into TF32 hi and lo parts, de-interleaved into planes (the S&C forms
//     the lag product conj(r[j]) r[j + l] and the energy |r[j]|^2 on the
//     way); release the stage; then the products. The strided kind's warps
//     share each tile's k-steps (a stride of 8 stages 8 samples an output,
//     so a tile a warp would not fit): each writes its sums to its group's
//     partials, and after a barrier the groups are added in order and
//     stored as whole 16-byte lines. The interpolation's and the S&C's
//     warps take whole tiles and store from their fragments (16 or 8 bytes
//     a lane, whole lines a warp: no partials, no store phase).
//
// The MMA tiles (lane: g = lane / 4, t = lane % 4; A rows g and g + 8 at
// columns t and t + 4; B rows t and t + 4 of column g; D rows g, g + 8 at
// columns 2t, 2t + 1):
//   strided: out[i0 + I] = sum_t w[t] X[I s + t], X the item's span. A tile
//     of NB column blocks holds outputs I = 8 NB m + 8 nb + n: A[m][k] =
//     X[8 NB s m + 8 kk + k] (rows 8 NB s samples apart), B_nb[k][n] =
//     w[8 kk + k - (8 nb + n) s] = B_0 at k-step kk - nb s, so one table of
//     B_0's fragments (hi and lo, built once a block) serves every block
//     and plane, and the NB blocks share each A load.
//   interpolation: y[q L + p] = sum_k g[p][nd - 1 - k] X[q + k], X = the row
//     with d_max zeros in front: A[m][k] = X[q0 + m + 8 kk + k] (a Hankel
//     tile, rows 1 sample apart), B_nb the branches 8 nb .. 8 nb + 7,
//     each reversed; NB blocks of branches share each A load.
//   S&C: the stride-1 window sums of a band of ones (lo = 0: two products),
//     window l over the lag product's two planes and 2l over the energy's,
//     NB blocks an A load; R = 0.5 x the 2l sum.
// Each product is lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), the small terms
// first, accumulated by the tensor cores in float32 (the products of TF32
// parts are exact). The loops have no branch around a product: a block
// whose band is empty at a k-step multiplies by zeros, so that the
// compiler keeps every block's and plane's products in flight at once
// (behind a branch each chain of products ran alone).
//
// Banks: a plane is rows of rs = 8 NB s samples padded to rs + 4 words
// (8 bytes: hi, lo), so the four rows g of a half warp's A load land 4
// words apart and its 16 lanes meet 16 banks; the Hankel tile needs no
// padding (its lanes read 7 consecutive words).
//
// Rows never leak: an item reads its own row only, zeros outside it, and
// masks its outputs at the row's end. Offsets into the rows are long long.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__CUDACC__)
#define BAND_D __host__ __device__ __forceinline__
#else
#define BAND_D inline
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
#endif

namespace bandk {

constexpr int kStrided = 0, kInterp = 1, kSc = 2;
constexpr int kNbStrided = 1;   // column blocks an A tile feeds: the FIR
constexpr int kNbSc = 4;        // and the S&C; the interpolation 1, 2 or 4
constexpr int kMaxTiles = 16;   // MMA tiles an item
constexpr double kHaloGoal = 1.25;   // staged inputs / an item's own
constexpr uint32_t kOne = 0x3f800000u;

// Everything a launch needs, computed once on the host (plan_*).
struct Plan {
    int kind, rows, n_in, n_out;
    int nt;       // strided: taps; interp: branch length; S&C: the lag l
    int s;        // strided: stride; interp: l (branches); S&C: 1
    int lead;     // zeros in front of a row: pad_left; d_max; 0
    int nb;       // column blocks an A tile feeds
    int ksteps;   // k-steps of the B table (strided: B_0; interp: a block)
    int cblocks;  // interp: blocks of 8 branches, ceil(l / 8)
    int cgroups;  // interp: groups of nb blocks an item's q-tile takes
    int planes;   // split planes: 2, or 3 (S&C: lag product re, im; energy)
    int kspan[3]; // k-steps a tile spans in each plane
    int win[3];   // S&C: each plane's window
    int warps, tiles, groups;   // an item: tiles x groups tasks
    int tile_out; // outputs of a tile (interp: input positions q)
    int item_in;  // input samples between items
    int item_out; // outputs an item (interp: item_in * l)
    int items_row;
    long long items;
    int rs, rp;   // A rows' spacing (samples), a padded row (words); rs 0: none
    int span[3];  // samples a split plane holds
    int words[3]; // words (8 bytes) a plane takes
    int raw;      // samples an item stages
    int raw_pairs;   // 16-byte pairs a raw stage holds
    int btab;     // B-table entries (16 bytes each)
    int stage;    // floats of one group's partials
    // shared memory, bytes from its base
    int o_raw, o_split, o_stage, o_bars, smem;

    BAND_D int threads() const { return 32 * (warps + 1); }
};

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Split planes, partials and offsets for tiles x groups; false past
// max_smem.
inline bool layout(Plan& g, int tiles, int groups, size_t max_smem) {
    g.tiles = tiles;
    g.groups = groups;
    if (g.kind == kInterp) {
        g.item_in = 16 * (tiles / g.cgroups);
        g.item_out = g.item_in * g.s;
        g.span[0] = g.span[1] = g.item_in + 8 * g.kspan[0];
        g.raw = g.span[0];
        g.stage = 0;
    } else if (g.kind == kStrided) {
        g.item_out = tiles * g.tile_out;
        g.item_in = g.item_out * g.s;
        g.span[0] = g.span[1] =
            (g.item_out - 8 * g.nb) * g.s + 8 * g.kspan[0];
        g.raw = g.span[0];
        g.stage = 2 * g.item_out;
    } else {
        g.item_out = g.item_in = tiles * g.tile_out;
        for (int p = 0; p < 3; ++p)
            g.span[p] = g.item_out - 8 * g.nb + 8 * g.kspan[p];
        // the lag product reads r[j + l]
        const int need = g.span[0] + g.nt;
        g.raw = need > g.span[2] ? need : g.span[2];
        g.stage = 0;
    }
    size_t bytes = 0;
    for (int p = 0; p < g.planes; ++p) {
        g.words[p] = g.rs ? static_cast<int>(cdiv(g.span[p], g.rs)) * g.rp
                          : g.span[p];
        g.words[p] += g.words[p] & 1;
        bytes += 8 * static_cast<size_t>(g.words[p]);
    }
    g.raw_pairs = g.raw / 2 + 1;       // a phase of one sample, then raw
    g.o_raw = 16 * g.btab;
    g.o_split = g.o_raw + 2 * 16 * g.raw_pairs;
    g.o_stage = g.o_split + static_cast<int>(bytes);
    g.o_bars = g.o_stage + 4 * groups * g.stage;
    g.smem = g.o_bars + 32;
    return static_cast<size_t>(g.smem) <= max_smem;
}

// Groups for tiles (the strided kind: warps / tiles, so that every warp
// has a task, fewer where that does not fit; the others one group, a warp
// a tile): false if none fits `limit`.
inline bool fits(Plan& g, int tiles, size_t limit) {
    const int most = g.kind == kStrided && g.warps / tiles > 1
                         ? g.warps / tiles : 1;
    for (int grp = most; grp >= 1; grp /= 2)
        if (layout(g, tiles, grp, limit)) return true;
    return false;
}

// Staged samples over an item's own at tiles
inline double halo(Plan& g, int tiles) {
    layout(g, tiles, 1, ~size_t(0));
    return static_cast<double>(g.raw) / g.item_in;
}

// The item size: tiles, step * 2^k (so that tiles x groups tasks share
// evenly among warps that are a power of two), at most kMaxTiles steps,
// no more than a row holds or than leave each of `sms` blocks an item. The
// most that fit smem_goal (two blocks an SM); where their staged halo
// exceeds kHaloGoal, the fewest more within max_smem whose halo does not
// (else the most that fit max_smem).
inline bool choose(Plan& g, long long tiles_row, int sms, size_t max_smem,
                   size_t smem_goal) {
    const int step = g.kind == kInterp ? g.cgroups : 1;
    long long cap = kMaxTiles * step;
    const long long spread = g.rows * tiles_row / (sms > 0 ? sms : 1);
    cap = cap < tiles_row ? cap : tiles_row;
    cap = cap < spread ? cap : spread;
    int top = step;
    while (2LL * top <= cap) top *= 2;
    int pick = 0;
    size_t limit = smem_goal;
    for (int t = top; t >= step && !pick; t /= 2)
        if (fits(g, t, smem_goal)) pick = t;
    if (!pick || halo(g, pick) > kHaloGoal)
        for (int t = pick ? 2 * pick : step; t <= top; t *= 2)
            if (fits(g, t, max_smem)) {
                pick = t;
                limit = max_smem;
                if (halo(g, t) <= kHaloGoal) break;
            }
    if (!pick || !fits(g, pick, limit)) return false;
    if (g.warps > g.tiles * g.groups) g.warps = g.tiles * g.groups;
    g.items_row = static_cast<int>(
        g.kind == kInterp ? cdiv(g.n_in, g.item_in)
                          : cdiv(g.n_out, g.item_out));
    g.items = static_cast<long long>(g.rows) * g.items_row;
    return true;
}

// y[r, i] = sum_t w[t] xp[r, i s + t], i < n_out, xp = row r with pad_left
// zeros in front and zeros past n_in; w: nt correlation weights.
inline bool plan_strided(Plan& g, int rows, int n_in, int n_out, int nt,
                         int s, int pad_left, int warps, int sms,
                         size_t max_smem, size_t smem_goal) {
    if (rows < 1 || n_out < 1 || nt < 1 || s < 1 || warps < 1) return false;
    g = Plan{};
    g.kind = kStrided;
    g.rows = rows, g.n_in = n_in, g.n_out = n_out, g.nt = nt, g.s = s;
    g.lead = pad_left;
    g.nb = kNbStrided;
    g.planes = 2;
    g.warps = warps;
    g.ksteps = (7 * s + nt + 7) / 8;
    g.kspan[0] = g.kspan[1] = g.ksteps + (g.nb - 1) * s;
    g.tile_out = 128 * g.nb;
    g.rs = 8 * g.nb * s;
    g.rp = g.rs + 4;
    g.btab = 32 * g.ksteps;
    return choose(g, cdiv(n_out, g.tile_out), sms, max_smem, smem_goal);
}

// y[r, q l + p] = sum_k gm[p][nd - 1 - k] xp[r, q + k], q < n, xp = row r
// with d_max zeros in front; gm: the branch matrix [l, nd].
inline bool plan_interp(Plan& g, int rows, int n, int l, int nd, int d_max,
                        int warps, int sms, size_t max_smem,
                        size_t smem_goal) {
    if (rows < 1 || n < 1 || l < 1 || nd < 1 || warps < 1) return false;
    g = Plan{};
    g.kind = kInterp;
    g.rows = rows, g.n_in = n, g.n_out = n * l, g.nt = nd, g.s = l;
    g.lead = d_max;
    g.cblocks = (l + 7) / 8;
    g.nb = g.cblocks >= 4 ? 4 : g.cblocks == 3 ? 4 : g.cblocks;
    g.cgroups = (g.cblocks + g.nb - 1) / g.nb;
    g.planes = 2;
    g.warps = warps;
    g.ksteps = (nd + 7) / 8;
    g.kspan[0] = g.kspan[1] = g.ksteps;
    g.tile_out = 16;
    g.btab = 32 * g.cblocks * g.ksteps;
    return choose(g, cdiv(n, 16) * g.cgroups, sms, max_smem, smem_goal);
}

// P[r, i] = sum_{k < l} conj(x[r, i + k]) x[r, i + k + l], R[r, i] = 0.5
// sum_{k < 2l} |x[r, i + k]|^2, i < n - 2l + 1.
inline bool plan_sc(Plan& g, int rows, int n, int l, int warps, int sms,
                    size_t max_smem, size_t smem_goal) {
    const int nd = n - 2 * l + 1;
    if (rows < 1 || l < 1 || nd < 1 || warps < 1) return false;
    g = Plan{};
    g.kind = kSc;
    g.rows = rows, g.n_in = n, g.n_out = nd, g.nt = l, g.s = 1;
    g.nb = kNbSc;
    g.planes = 3;
    g.warps = warps;
    g.win[0] = g.win[1] = l;
    g.win[2] = 2 * l;
    for (int p = 0; p < 3; ++p)
        g.kspan[p] = (8 * g.nb - 1 + g.win[p] + 7) / 8;
    g.tile_out = 128 * g.nb;
    g.rs = 8 * g.nb;
    g.rp = g.rs + 4;
    return choose(g, cdiv(nd, g.tile_out), sms, max_smem, smem_goal);
}

// ---------------------------------------------------------------- ops

#if !defined(__CUDACC__)
// The host build's tensor-core product, given by its harness: d += a b
// over the calling lane's warp (the m16n8k8 .tf32 fragments above).
void host_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
              uint32_t b1);
#endif

// v rounded to TF32: nearest, ties away from zero, low 13 bits cleared
BAND_D uint32_t tf32(float v) {
    uint32_t r;
#if defined(__CUDA_ARCH__)
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
#else
    std::memcpy(&r, &v, 4);
    r += 0x1000u;
#endif
    return r & 0xffffe000u;
}

BAND_D float as_float(uint32_t u) {
#if defined(__CUDA_ARCH__)
    return __uint_as_float(u);
#else
    float f;
    std::memcpy(&f, &u, 4);
    return f;
#endif
}

// v = hi + lo + O(2^-22 |v|), both TF32
BAND_D uint2 split(float v) {
    const uint32_t hi = tf32(v);
    return uint2{hi, tf32(v - as_float(hi))};
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), f32 accumulators
BAND_D void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                uint32_t b1) {
#if defined(__CUDA_ARCH__)
    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#elif !defined(__CUDACC__)
    host_mma(d, a, b0, b1);
#endif
}

// acc += A B at float32 accuracy, the small products first: b = (hi(b0),
// hi(b1), lo(b0), lo(b1)); kOnes: a band of ones (lo = 0).
template <bool kOnes>
BAND_D void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                 const uint32_t (&al)[4], uint4 b) {
    mma(acc, al, b.x, b.y);
    if (!kOnes) mma(acc, ah, b.z, b.w);
    mma(acc, ah, b.x, b.y);
}

// Global stores of 16 and 8 bytes (p aligned to them)
BAND_D void st4(float* p, float a, float b, float c, float d) {
#if defined(__CUDA_ARCH__)
    asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
#else
    p[0] = a, p[1] = b, p[2] = c, p[3] = d;
#endif
}

BAND_D void st2(float* p, float a, float b) {
#if defined(__CUDA_ARCH__)
    asm volatile("st.global.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(a),
                 "f"(b) : "memory");
#else
    p[0] = a, p[1] = b;
#endif
}

// A bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device to shared memory, completing on the mbarrier `bar` whose
// phase it adds the bytes to (and one arrival); on the host a plain copy
// and an arrival.
template <class Pipe>
BAND_D void bulk_copy(float2* dst, const float2* src, unsigned bytes,
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

#if defined(__CUDACC__)
// The ring's mbarriers on the card, after the partials: full[2] (one
// arrival a producer thread, and the bulk copy's bytes) and empty[2] (one
// arrival a consumer thread).
struct DevicePipe {
    unsigned long long* bars;

    __device__ static unsigned addr(const void* p) {
        return static_cast<unsigned>(__cvta_generic_to_shared(p));
    }
    __device__ void init(int producers, int consumers) {
        for (int s = 0; s < 2; ++s) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                             addr(bars + s)), "r"(producers) : "memory");
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                             addr(bars + 2 + s)), "r"(consumers)
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
                     ::"r"(addr(bars + 2 + s)) : "memory");
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
        wait(bars + 2 + s, parity);
    }
};
#endif

// ---------------------------------------------------------------- body

struct Args {
    const float2* x;   // the rows' base, 16-byte aligned
    int xoff;          // samples from that base to the first row (0, 1)
    const float* coef; // strided: weights [nt]; interp: branches [l, nd]
    float2* y;         // strided [rows, n_out]; interp [rows, n l]; S&C P
    float* r;          // S&C: R [rows, nd]
};

// x as the body takes it: the 16-byte aligned base at or before x, and
// x's offset from it in samples; false if x is not 8-byte aligned.
inline bool rows_at(const void* x, Args& a) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(x);
    if (p % 8 != 0) return false;
    a.xoff = static_cast<int>(p % 16 / 8);
    a.x = reinterpret_cast<const float2*>(p - p % 16);
    return true;
}

// Row and first staged sample (row-local, may be negative) of an item.
BAND_D void item_at(const Plan& g, long long item, long long& row,
                    long long& first, long long& o0) {
    row = item / g.items_row;
    const long long it = item - row * g.items_row;
    first = it * g.item_in - g.lead;
    o0 = it * (g.kind == kInterp ? g.item_in : g.item_out);
}

// The B table: entry (block, kk, lane) = (hi(b0), hi(b1), lo(b0), lo(b1)).
BAND_D void build_btab(const Args& a, const Plan& g, uint4* btab, int tid,
                       int threads) {
    for (int e = tid; e < g.btab; e += threads) {
        const int lane = e & 31, gg = lane >> 2, t = lane & 3;
        const int kk = (e >> 5) % g.ksteps, blk = (e >> 5) / g.ksteps;
        float v[2];
        for (int h = 0; h < 2; ++h) {
            const int k = 8 * kk + t + 4 * h;
            if (g.kind == kStrided) {
                const int u = k - gg * g.s;
                v[h] = (u >= 0 && u < g.nt) ? a.coef[u] : 0.0f;
            } else {
                const int p = 8 * blk + gg;
                v[h] = (p < g.s && k < g.nt)
                           ? a.coef[static_cast<size_t>(p) * g.nt +
                                    (g.nt - 1 - k)]
                           : 0.0f;
            }
        }
        const uint2 s0 = split(v[0]), s1 = split(v[1]);
        btab[e] = uint4{s0.x, s1.x, s0.y, s1.y};
    }
}

// Producer: the item's span from row-local `first` into a raw stage, from
// the even flat sample f0 at or before it (the stage's phase is first -
// f0): lane 0 copies the 16-byte aligned part inside the row in one bulk
// copy; the lanes load the samples beside it in the row (at most one at
// each end) and write zeros outside the row; each lane arrives once.
template <class Pipe>
BAND_D void stage_item(const Args& a, const Plan& g, float2* dst,
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
        bulk_copy(dst + (b0 - f0), a.x + b0,
                  static_cast<unsigned>(8 * (b1 - b0)), pipe, stage);
    else
        pipe.arrive_full(stage);
}

// Consumers: the staged samples split once into planes. Word of sample j:
// (j / rs) rp + j % rs, walked by a carry (no division a sample).
struct Walk {
    int q, r, dq, dr;
    BAND_D void start(const Plan& g, int j0, int step) {
        if (g.rs) {
            q = j0 / g.rs, r = j0 % g.rs, dq = step / g.rs, dr = step % g.rs;
        } else {
            q = 0, r = j0, dq = 0, dr = step;
        }
    }
    BAND_D int word(const Plan& g) const { return q * g.rp + r; }
    BAND_D void next(const Plan& g) {
        q += dq;
        r += dr;
        if (g.rs && r >= g.rs) {
            r -= g.rs;
            ++q;
        }
    }
};

BAND_D void split_item(const Plan& g, const float2* raw, uint2* planes,
                       int tid, int consumers) {
    uint2* p0 = planes;
    uint2* p1 = p0 + g.words[0];
    uint2* p2 = p1 + g.words[1];
    Walk w;
    w.start(g, tid, consumers);
    if (g.kind != kSc) {
        for (int j = tid; j < g.span[0]; j += consumers, w.next(g)) {
            const float2 v = raw[j];
            const int o = w.word(g);
            p0[o] = split(v.x);
            p1[o] = split(v.y);
        }
        return;
    }
    const int l = g.nt;
    for (int j = tid; j < g.span[2]; j += consumers, w.next(g)) {
        const float2 v = raw[j];
        const int o = w.word(g);
        p2[o] = split(v.x * v.x + v.y * v.y);
        if (j < g.span[0]) {
            const float2 u = raw[j + l];         // conj(v) u
            p0[o] = split(v.x * u.x + v.y * u.y);
            p1[o] = split(v.x * u.y - v.y * u.x);
        }
    }
}

// A fragment of plane pl at word w0 of row g, column t: rows g, g + 8 at
// `down` words apart, columns t, t + 4 four words apart.
BAND_D void load_a(const uint2* pl, int w0, int down, uint32_t (&ah)[4],
                   uint32_t (&al)[4]) {
    const uint2 v0 = pl[w0], v1 = pl[w0 + down], v2 = pl[w0 + 4],
                v3 = pl[w0 + down + 4];
    ah[0] = v0.x, al[0] = v0.y;
    ah[1] = v1.x, al[1] = v1.y;
    ah[2] = v2.x, al[2] = v2.y;
    ah[3] = v3.x, al[3] = v3.y;
}

// One group's k-steps [lo, hi) of strided tile `tile`; acc[plane][block].
template <int NB>
BAND_D void mma_strided(const Plan& g, const uint2* planes, const uint4* btab,
                        int tile, int lo, int hi, int lane,
                        float (&acc)[2][NB][4]) {
    const int gg = lane >> 2, t = lane & 3;
    const uint2* p1 = planes + g.words[0];
    int q = 8 * lo / g.rs, r = 8 * lo % g.rs;
    const int base = (16 * tile + gg) * g.rp + t, down = 8 * g.rp;
    for (int kk = lo; kk < hi; ++kk) {
        uint32_t ah[2][4], al[2][4];
        const int w0 = base + q * g.rp + r;
        load_a(planes, w0, down, ah[0], al[0]);
        load_a(p1, w0, down, ah[1], al[1]);
        // B_nb = B_0 at kk - nb s, zero outside B_0's k-steps
        uint4 b[NB];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            const int kb = kk - nb * g.s;
            b[nb] = kb >= 0 && kb < g.ksteps ? btab[kb * 32 + lane]
                                             : uint4{0u, 0u, 0u, 0u};
        }
        // the small products of every block and plane, then the large
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int p = 0; p < 2; ++p) mma(acc[p][nb], al[p], b[nb].x, b[nb].y);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int p = 0; p < 2; ++p) mma(acc[p][nb], ah[p], b[nb].z, b[nb].w);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int p = 0; p < 2; ++p) mma(acc[p][nb], ah[p], b[nb].x, b[nb].y);
        r += 8;
        if (r == g.rs) {
            r = 0;
            ++q;
        }
    }
}

// Interpolation tile `tile` (q-tile tile / cgroups, branch blocks of
// group tile % cgroups), every k-step.
template <int NB>
BAND_D void mma_interp(const Plan& g, const uint2* planes, const uint4* btab,
                       int tile, int lane, float (&acc)[2][NB][4]) {
    const int gg = lane >> 2, t = lane & 3;
    const int qt = tile / g.cgroups, cg = tile % g.cgroups;
    const uint2* p1 = planes + g.words[0];
    for (int kk = 0; kk < g.ksteps; ++kk) {
        uint32_t ah[2][4], al[2][4];
        const int w0 = 16 * qt + gg + 8 * kk + t;
        load_a(planes, w0, 8, ah[0], al[0]);
        load_a(p1, w0, 8, ah[1], al[1]);
        uint4 b[NB];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            const int blk = cg * NB + nb;
            b[nb] = blk < g.cblocks ? btab[(blk * g.ksteps + kk) * 32 + lane]
                                    : uint4{0u, 0u, 0u, 0u};
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int p = 0; p < 2; ++p) mma(acc[p][nb], al[p], b[nb].x, b[nb].y);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int p = 0; p < 2; ++p) mma(acc[p][nb], ah[p], b[nb].z, b[nb].w);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int p = 0; p < 2; ++p) mma(acc[p][nb], ah[p], b[nb].x, b[nb].y);
    }
}

// The band of ones' B fragment at k-step kk of block nb for window w:
// B[k][n] = 1 where 0 <= k - 8 nb - n < w; tg = t - g of the lane.
BAND_D uint4 ones(int kk, int nb, int tg, unsigned w) {
    const unsigned u = 8 * (kk - nb) + tg;
    return uint4{u < w ? kOne : 0u, u + 4 < w ? kOne : 0u, 0u, 0u};
}

// S&C tile `tile`, every k-step: the three planes together for the lag
// product's k-steps, then the energy's last k-steps, two at a time (the
// odd ones in an accumulator of their own, added at the end).
template <int NB>
BAND_D void mma_sc(const Plan& g, const uint2* planes, int tile, int lane,
                   float (&acc)[3][NB][4]) {
    const int gg = lane >> 2, t = lane & 3, tg = t - gg;
    const int base = (16 * tile + gg) * g.rp + t, down = 8 * g.rp;
    const uint2* p1 = planes + g.words[0];
    const uint2* p2 = p1 + g.words[1];
    const unsigned wl = g.win[0], we = g.win[2];
    int kk = 0, q = 0, r = 0;
    const auto next = [&] {
        r += 8;
        if (r == g.rs) {
            r = 0;
            ++q;
        }
    };
    for (; kk < g.kspan[0]; ++kk, next()) {
        uint32_t ah[3][4], al[3][4];
        const int w0 = base + q * g.rp + r;
        load_a(planes, w0, down, ah[0], al[0]);
        load_a(p1, w0, down, ah[1], al[1]);
        load_a(p2, w0, down, ah[2], al[2]);
        uint4 bl[NB], be[NB];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            bl[nb] = ones(kk, nb, tg, wl);
            be[nb] = ones(kk, nb, tg, we);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            mma(acc[0][nb], al[0], bl[nb].x, bl[nb].y);
            mma(acc[1][nb], al[1], bl[nb].x, bl[nb].y);
            mma(acc[2][nb], al[2], be[nb].x, be[nb].y);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            mma(acc[0][nb], ah[0], bl[nb].x, bl[nb].y);
            mma(acc[1][nb], ah[1], bl[nb].x, bl[nb].y);
            mma(acc[2][nb], ah[2], be[nb].x, be[nb].y);
        }
    }
    float odd[NB][4] = {};
    for (; kk + 1 < g.kspan[2]; kk += 2) {
        uint32_t ah[2][4], al[2][4];
        load_a(p2, base + q * g.rp + r, down, ah[0], al[0]);
        next();
        load_a(p2, base + q * g.rp + r, down, ah[1], al[1]);
        next();
        uint4 b[2][NB];
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            b[0][nb] = ones(kk, nb, tg, we);
            b[1][nb] = ones(kk + 1, nb, tg, we);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            mma(acc[2][nb], al[0], b[0][nb].x, b[0][nb].y);
            mma(odd[nb], al[1], b[1][nb].x, b[1][nb].y);
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            mma(acc[2][nb], ah[0], b[0][nb].x, b[0][nb].y);
            mma(odd[nb], ah[1], b[1][nb].x, b[1][nb].y);
        }
    }
    if (kk < g.kspan[2]) {
        uint32_t ah[4], al[4];
        load_a(p2, base + q * g.rp + r, down, ah, al);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
            mma3<true>(acc[2][nb], ah, al, ones(kk, nb, tg, we));
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[2][nb][i] += odd[nb][i];
}

// k-step share [lo, hi) of group grp of n steps, in order
BAND_D void share(int n, int grp, int groups, int& lo, int& hi) {
    lo = static_cast<int>(static_cast<long long>(n) * grp / groups);
    hi = static_cast<int>(static_cast<long long>(n) * (grp + 1) / groups);
}

// A strided task's sums into its group's partials: (re, im) of output I
// at floats 2I, 2I + 1.
template <int NB>
BAND_D void put_strided(const Plan& g, float* part, int tile, int lane,
                        const float (&acc)[2][NB][4]) {
    const int gg = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int i = tile * g.tile_out + 8 * NB * (gg + 8 * h) +
                          8 * nb + 2 * t;
            *reinterpret_cast<float4*>(part + 2 * i) =
                float4{acc[0][nb][2 * h], acc[1][nb][2 * h],
                       acc[0][nb][2 * h + 1], acc[1][nb][2 * h + 1]};
        }
}

// Interpolation tile `tile`'s sums straight to y: lane (g, t) holds
// branches p, p + 1 (p = 2t in each block) of input positions q = g, g + 8
// of the q-tile, outputs q l + p, q l + p + 1; q0: the row's flat input
// position of the item, here: its positions in the row.
template <int NB>
BAND_D void put_interp(const Args& a, const Plan& g, long long q0, int here,
                       int tile, int lane, const float (&acc)[2][NB][4]) {
    const int gg = lane >> 2, t = lane & 3;
    const int qt = tile / g.cgroups, cg = tile % g.cgroups;
    float* y = reinterpret_cast<float*>(a.y);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int q = 16 * qt + gg + 8 * h;
            const int p = 8 * (cg * NB + nb) + 2 * t;
            if (q >= here || p >= g.s) continue;
            const long long f = (q0 + q) * g.s + p;
            const float* v0 = &acc[0][nb][2 * h];
            const float* v1 = &acc[1][nb][2 * h];
            if (p + 1 < g.s && (f & 1) == 0) {
                st4(y + 2 * f, v0[0], v1[0], v0[1], v1[1]);
            } else {
                st2(y + 2 * f, v0[0], v1[0]);
                if (p + 1 < g.s) st2(y + 2 * f + 2, v0[1], v1[1]);
            }
        }
}

// S&C tile `tile`'s sums straight to P and R: lane (g, t) holds outputs i,
// i + 1 of each block and row half; f0: the flat output of the item's
// first, here: its outputs in the row.
template <int NB>
BAND_D void put_sc(const Args& a, const Plan& g, long long f0, int here,
                   int tile, int lane, const float (&acc)[3][NB][4]) {
    const int gg = lane >> 2, t = lane & 3;
    float* pp = reinterpret_cast<float*>(a.y);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int i = tile * g.tile_out + 8 * NB * (gg + 8 * h) +
                          8 * nb + 2 * t;
            if (i >= here) continue;
            const long long f = f0 + i;
            const float* re = &acc[0][nb][2 * h];
            const float* im = &acc[1][nb][2 * h];
            const float* e = &acc[2][nb][2 * h];
            if (i + 1 < here && (f & 1) == 0) {
                st4(pp + 2 * f, re[0], im[0], re[1], im[1]);
                st2(a.r + f, 0.5f * e[0], 0.5f * e[1]);
            } else {
                st2(pp + 2 * f, re[0], im[0]);
                a.r[f] = 0.5f * e[0];
                if (i + 1 < here) {
                    st2(pp + 2 * f + 2, re[1], im[1]);
                    a.r[f + 1] = 0.5f * e[1];
                }
            }
        }
}

// Output i of the item, the groups' partials added in order.
BAND_D float2 summed(const float* part, int stride, int groups, int i) {
    float2 v{0.0f, 0.0f};
    for (int grp = 0; grp < groups; ++grp) {
        const float2 u = *reinterpret_cast<const float2*>(
            part + static_cast<size_t>(grp) * stride + 2 * i);
        v.x += u.x;
        v.y += u.y;
    }
    return v;
}

// The item's `here` complex outputs to y, flat output f of a 16-byte
// aligned base: whole 16-byte lines (two outputs), then the one output at
// either end that shares a line with the item next to it.
BAND_D void store(const float* part, int stride, int groups, int here,
                  float* y, long long f, int tid, int consumers) {
    const int ph = static_cast<int>(f & 1);
    float* dst = y + 2 * (f - ph);
    const int first = ph, end = (here + ph) / 2;
    for (int u = first + tid; u < end; u += consumers) {
        const float2 a = summed(part, stride, groups, 2 * u - ph);
        const float2 b = summed(part, stride, groups, 2 * u - ph + 1);
        st4(dst + 4 * u, a.x, a.y, b.x, b.y);
    }
    if (tid == 0 && ph) {                       // output 0 ends line 0
        const float2 a = summed(part, stride, groups, 0);
        st2(dst + 2, a.x, a.y);
    }
    if (tid == 1 && (here + ph) % 2 && end >= first) {   // the last output
        const float2 a = summed(part, stride, groups, here - 1);
        st2(dst + 4 * end, a.x, a.y);
    }
}

// One block's share of a launch of kind kKind: items block_id, block_id +
// grid, ... of g.items; tid < g.threads(); smem: g.smem bytes, 16-byte
// aligned; pipe on its words at g.o_bars. sync(): the whole block, once;
// csync(): the consumers (a named barrier on the card).
template <int kKind, int NB, class Pipe, class Sync, class CSync>
BAND_D void band_block(const Args& a, const Plan& g, unsigned char* smem,
                       long long block_id, long long grid, int tid,
                       Pipe& pipe, Sync sync, CSync csync) {
    uint4* btab = reinterpret_cast<uint4*>(smem);
    float2* ring = reinterpret_cast<float2*>(smem + g.o_raw);
    uint2* planes = reinterpret_cast<uint2*>(smem + g.o_split);
    float* part = reinterpret_cast<float*>(smem + g.o_stage);
    const int consumers = 32 * g.warps;
    if (tid == 0) pipe.init(32, consumers);
    build_btab(a, g, btab, tid, g.threads());
    sync();
    long long n = 0;
    if (tid >= consumers) {
        const int lane = tid - consumers;
        for (long long item = block_id; item < g.items; item += grid, ++n) {
            const int st = static_cast<int>(n & 1);
            if (n >= 2)
                pipe.wait_empty(st,
                                static_cast<unsigned>(((n >> 1) - 1) & 1));
            long long row, first, o0;
            item_at(g, item, row, first, o0);
            stage_item(a, g, ring + 2 * g.raw_pairs * st, row, first, lane,
                       pipe, st);
        }
        return;
    }
    const int warp = tid >> 5, lane = tid & 31;
    for (long long item = block_id; item < g.items; item += grid, ++n) {
        const int st = static_cast<int>(n & 1);
        pipe.wait_full(st, static_cast<unsigned>((n >> 1) & 1));
        long long row, first, o0;
        item_at(g, item, row, first, o0);
        const long long f = row * g.n_in + a.xoff + first;
        split_item(g, ring + 2 * g.raw_pairs * st + (f & 1), planes, tid,
                   consumers);
        pipe.arrive_empty(st);
        csync();                 // the planes are in place
        if constexpr (kKind == kStrided) {
            // k-step shares of each tile, added in order through shared
            // memory
            for (int task = warp; task < g.tiles * g.groups;
                 task += g.warps) {
                const int tile = task / g.groups, grp = task % g.groups;
                int lo, hi;
                share(g.kspan[0], grp, g.groups, lo, hi);
                float acc[2][NB][4] = {};
                mma_strided<NB>(g, planes, btab, tile, lo, hi, lane, acc);
                put_strided<NB>(g, part + grp * g.stage, tile, lane, acc);
            }
            csync();             // every task's sums are in place
            const long long left = g.n_out - o0;
            const int here = static_cast<int>(
                left < g.item_out ? left : g.item_out);
            store(part, g.stage, g.groups, here,
                  reinterpret_cast<float*>(a.y), row * g.n_out + o0, tid,
                  consumers);
        } else {
            // a warp a tile, stored from its fragments
            const long long left = (kKind == kInterp ? g.n_in : g.n_out) - o0;
            const int width = kKind == kInterp ? g.item_in : g.item_out;
            const int here = static_cast<int>(left < width ? left : width);
            for (int tile = warp; tile < g.tiles; tile += g.warps) {
                if constexpr (kKind == kSc) {
                    float acc[3][NB][4] = {};
                    mma_sc<NB>(g, planes, tile, lane, acc);
                    put_sc<NB>(a, g, row * g.n_out + o0, here, tile, lane,
                               acc);
                } else {
                    float acc[2][NB][4] = {};
                    mma_interp<NB>(g, planes, btab, tile, lane, acc);
                    put_interp<NB>(a, g, row * g.n_in + o0, here, tile, lane,
                                   acc);
                }
            }
            csync();             // the planes may take the next item
        }
    }
}

}  // namespace bandk
