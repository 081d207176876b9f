// Soft-input Viterbi decoders, rate 1/2, K=7 (polys 0o133 / 0o171):
//   ofdm_viterbi           (K4)  whole sequence, pinned to state 0 at both
//                          ends; one group of G lanes a sequence
//                          (viterbi_group.cuh);
//   ofdm_viterbi_windowed  (K4w) sliding windows with overlap, one thread a
//                          window (viterbi_window.cuh);
//   ofdm_viterbi_windowed_warp  K4w's previous body, one warp a window,
//                          kept only as the A/B baseline chip_smoke.py
//                          times in turns with K4w; no path launches it.
//
// Replaces: ofdm_uhd_tpu/kernels/pallas_viterbi.py:viterbi_pallas (K4:
// _run_windows with one window, first = tail = 1) and
// :viterbi_pallas_windowed (K4w, and the same construction as
// phy/bits.py:viterbi_decode_windowed at other window sizes). K4 is
// bit-exact with the scan of phy/bits.py:viterbi_decode, K4w with both
// windowed decoders.
//
// Bound on this card: the 64-state add-compare-select is a chain of
// dependent steps, so a decode is latency- or issue-bound, not
// bandwidth-bound.
//
// K4: ONE GROUP OF G = 64 / 2^M LANES PER SEQUENCE (G = 4, 8, 16 or 32,
// chosen at launch by kernels/viterbi.py k4_group from the batch and the
// card's SMs), a one-warp block (viterbi_group.cuh has the layouts).
//   * G = 4, 8, 16: 32 / G sequences a warp. A lane holds 2^M states, runs
//     M trellis steps with no exchange (the states whose top 6 - M bits
//     are fixed hold both predecessors of all their successors), and the
//     group regroups its (metric, path) pairs through shared memory under
//     one __syncwarp every M steps. Many sequences an SM (C3's 8208 rows:
//     G = 4, 16 states a lane, ~6.8 instructions a state-step) are bound
//     by issue, the other warps hiding each one's latency.
//   * G = 32: one warp a sequence, a pair of states a lane, a butterfly of
//     two shuffles with lane v ^ 2^(t mod 5) every step; LLRs and, in the
//     traceback, records come through shared memory by cp.async many steps
//     ahead. Few sequences (C4's 272, big_nsc's 24: one or two warps an
//     SM) are bound by the latency of a step, one shuffle.
// Survivors travel as 32-bit path words (register exchange), stored as a
// 256-byte record of the 64 states every 24 steps (20 at G = 32), and the
// traceback reads one word a record. Against the warp body it replaced
// (one warp a sequence, states l and l + 32 a lane, 4 predecessor
// shuffles, 2 LLR shuffles and 2 ballots a step, the decisions 8 bytes a
// step and a traceback of one shuffled decision a step): no ballot, one
// exchange every M steps or one butterfly a step, and a traceback chain 20
// to 24 times shorter.
//
// The warp baseline: ONE WARP PER WINDOW. Lane l holds the path metrics of
// states l and l+32 in registers; both states share the predecessors 2l
// and 2l+1, which four warp shuffles bring in (`Acs`). No shared memory
// and no block barrier sit in the step loop.
//   * LLRs: each lane loads one (a, b) pair per 32-step chunk, coalesced;
//     step j takes them by shuffle from lane j (`forward`).
//   * Decisions: __ballot_sync packs the 64 choices of a step into two
//     words (states 0-31, 32-63); lane j keeps step j's pair and the warp
//     stores the chunk's 32 pairs to the window's e x 8 bytes of shared
//     memory.
//   * Traceback reads a chunk of 32 pairs per load the same way and walks
//     it by shuffles; every lane tracks the same state (`traceback`), from
//     the first state that reaches the maximum (`first_max_state`).
// A step costs each warp 6 shuffles, 2 ballots and ~20 other
// instructions; Hopper issues one warp-wide shuffle an SM a clock against
// four FP32 instructions, so at c3_pallas (221,616 windows of 384 steps)
// the shuffles alone take ~2.6 ms of the warp baseline's 5.05 (NVIDIA
// H100 80GB HBM3, 700 W): it is bound by shuffles and issue.
//
// K4w: ONE THREAD PER WINDOW, no exchange between lanes. A thread holds
// its window's 64 path metrics as two unrolled register arrays (old and
// new, swapped by unrolling two steps) and runs the 32 butterflies of a
// step on them: 4 adds for the branch metrics, then per state an add and
// a subtract (the candidates), a max (the survivor), a subtract whose
// sign is the choice and a funnel shift that packs it into the step's
// decision word, ~330 instructions a step and no shuffle, ballot or
// barrier (viterbi_window.cuh). Decisions go to a device scratch laid out
// [e, windows]: the 32 windows of a warp store one step's words as one
// coalesced 256-byte write, and the traceback reads them back the same
// way; steps before the owned range are neither stored nor read (the
// traceback stops at the owned range's start). LLRs: neighbouring windows
// lie l x 8 bytes apart, so a thread reads two steps as one 16-byte load
// where its window is 16-byte aligned (else two 8-byte loads), one
// iteration ahead of their use. Windows are independent, so a block is
// one warp (32 windows), which spreads a small decode (the stream's 612
// windows) over as many SMs as it has warps.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W) at c3_pallas
// (221,616 windows of 384 steps): ~1.6 ms in-kernel against the warp
// body's 4.67, ~3.4e12 state-steps/s, about 55% of the issue rate the
// instruction count allows; the issue model predicted 0.9-1.3 ms. What
// holds it is not measured (no profiler counters on that machine). On
// the stream's 612 windows (20 warps on 132 SMs) one warp a window wins:
// ~0.12 ms against 0.032.
// Numerics: the ACS of phy/bits.py exactly (no 0.5 factor; bm0 = sa0*la +
// sb0*lb; c0 = pm_even + bm0; c1 = pm_odd - bm0; strict c1 > c0, so a tie
// keeps predecessor 0), with __fadd_rn / __fsub_rn / __fmul_rn so no
// multiply-add is contracted. K4 starts in state 0 and traces back from
// state 0 at step n. K4w's window boundary conditions are the
// reference's: the window that starts at step 0 is pinned to state 0, the
// others start uniform (all metrics 0); the window that ends at step n
// adds -1e30 to every nonzero state's final metric; each traces back from
// the first state that reaches the maximum (argmax's tie-break).
#include "ofdm_kernels.h"
#include "viterbi_group.cuh"
#include "viterbi_window.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPolyA = 0133;
constexpr int kPolyB = 0171;
constexpr int kWarpsPerBlock = 4;
constexpr float kNeg = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;     // without the opt-in
constexpr size_t kMaxSmem = 232448;            // 227 KB, the opt-in limit

__device__ __forceinline__ float branch_sign(int window, int poly) {
    // +1 for code bit 0, -1 for code bit 1
    return (__popc(window & poly) & 1) ? -1.0f : 1.0f;
}

// One lane's share of the 64-state trellis: states lane and lane+32.
struct Acs {
    float sa_lo, sb_lo, sa_hi, sb_hi;
    int src_even, src_odd;
    bool from_hi;

    __device__ explicit Acs(int lane) {
        // branch signs for the p=0 predecessor of state lane (input bit 0)
        // and state lane+32 (input bit 1); the p=1 branch is their negation
        const int w_lo = lane << 1, w_hi = 64 | (lane << 1);
        sa_lo = branch_sign(w_lo, kPolyA);
        sb_lo = branch_sign(w_lo, kPolyB);
        sa_hi = branch_sign(w_hi, kPolyA);
        sb_hi = branch_sign(w_hi, kPolyB);
        // predecessors of both owned states: 2*lane (even) and 2*lane+1
        // (odd), held by lane (2*lane)&31 in its lo (lane < 16) or hi
        // register
        src_even = (lane << 1) & 31;
        src_odd = src_even | 1;
        from_hi = lane >= 16;
    }

    // one add-compare-select step of the whole warp; returns the 64
    // choices as two ballot words (bit l: state l, resp. l + 32)
    __device__ __forceinline__ uint2 step(float la, float lb, float& pm_lo,
                                          float& pm_hi) const {
        const float e_lo = __shfl_sync(kFull, pm_lo, src_even);
        const float e_hi = __shfl_sync(kFull, pm_hi, src_even);
        const float o_lo = __shfl_sync(kFull, pm_lo, src_odd);
        const float o_hi = __shfl_sync(kFull, pm_hi, src_odd);
        const float pe = from_hi ? e_hi : e_lo;
        const float po = from_hi ? o_hi : o_lo;

        const float bm_lo = __fadd_rn(__fmul_rn(sa_lo, la),
                                      __fmul_rn(sb_lo, lb));
        const float c0_lo = __fadd_rn(pe, bm_lo);
        const float c1_lo = __fsub_rn(po, bm_lo);
        const bool ch_lo = c1_lo > c0_lo;
        pm_lo = ch_lo ? c1_lo : c0_lo;

        const float bm_hi = __fadd_rn(__fmul_rn(sa_hi, la),
                                      __fmul_rn(sb_hi, lb));
        const float c0_hi = __fadd_rn(pe, bm_hi);
        const float c1_hi = __fsub_rn(po, bm_hi);
        const bool ch_hi = c1_hi > c0_hi;
        pm_hi = ch_hi ? c1_hi : c0_hi;

        return make_uint2(__ballot_sync(kFull, ch_lo),
                          __ballot_sync(kFull, ch_hi));
    }
};

// The warp baseline's forward ACS over n steps of ab (a/b pairs) from the
// lane's metrics; step t's decision words go to dec[t], stored by lane
// t % 32.
__device__ __forceinline__ void forward(const float2* __restrict__ ab,
                                        uint2* dec, int n, int lane,
                                        float& pm_lo, float& pm_hi) {
    const Acs acs(lane);
    for (int t0 = 0; t0 < n; t0 += 32) {
        const int t = t0 + lane;
        const float2 mine = t < n ? ab[t] : make_float2(0.0f, 0.0f);
        const int steps = min(32, n - t0);
        uint2 keep = make_uint2(0u, 0u);
        for (int j = 0; j < steps; ++j) {
            const float la = __shfl_sync(kFull, mine.x, j);
            const float lb = __shfl_sync(kFull, mine.y, j);
            const uint2 w = acs.step(la, lb, pm_lo, pm_hi);
            if (lane == j) keep = w;
        }
        if (t < n) dec[t] = keep;
    }
}

// Traceback over dec[0, n) from `state`, the state after step n-1; lane
// t % 32 receives step t's bit through emit(t, bit). Each lane rereads
// only the decisions it stored itself in `forward`, so program order
// makes them visible.
template <class Emit>
__device__ __forceinline__ void traceback(const uint2* dec, int n, int state,
                                          int lane, Emit emit) {
    for (int t0 = ((n - 1) >> 5) << 5; t0 >= 0; t0 -= 32) {
        const int t = t0 + lane;
        const uint2 mine = t < n ? dec[t] : make_uint2(0u, 0u);
        const int steps = min(32, n - t0);
        uint8_t bit_out = 0;
        for (int j = steps - 1; j >= 0; --j) {
            const unsigned w0 = __shfl_sync(kFull, mine.x, j);
            const unsigned w1 = __shfl_sync(kFull, mine.y, j);
            if (lane == j) bit_out = static_cast<uint8_t>((state >> 5) & 1);
            const unsigned word = state >= 32 ? w1 : w0;
            state = ((state & 31) << 1) | ((word >> (state & 31)) & 1u);
        }
        if (t < n) emit(t, bit_out);
    }
}

// The first of the 64 states whose metric reaches the maximum, on every
// lane (max, then the lowest index among the states equal to it).
__device__ __forceinline__ int first_max_state(float pm_lo, float pm_hi,
                                               int lane) {
    float v = pm_lo;
    int s = lane;
    if (pm_hi > v) {
        v = pm_hi;
        s = lane + 32;
    }
    for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_xor_sync(kFull, v, off);
        const int s2 = __shfl_xor_sync(kFull, s, off);
        if (v2 > v || (v2 == v && s2 < s)) {
            v = v2;
            s = s2;
        }
    }
    return s;
}

// K4: one group of G = 64 >> M lanes a sequence (viterbi_group.cuh), a
// block one warp, so that a small batch spreads over as many SMs as it
// has warps; sequence blockIdx.x * (32 / G) + lane / G.
template <int M>
__global__ void __launch_bounds__(32)
viterbi_k7_group_kernel(const float* __restrict__ llr,
                        unsigned* __restrict__ rec,
                        uint8_t* __restrict__ bits, int batch, int n,
                        bool traceback) {
    using L = vit::GroupLayout<M>;
    __shared__ __align__(16) uint2 buf[2 * L::kGroups * L::kGroupPairs];
    const int lane = threadIdx.x;
    const int q = lane / L::kLanes;
    const long long seq =
        static_cast<long long>(blockIdx.x) * L::kGroups + q;
    const bool live = seq < batch;
    const size_t row = static_cast<size_t>(live ? seq : batch - 1);
    const size_t records =
        static_cast<size_t>(vit::record_stride(n, vit::kRecordSteps));
    vit::decode_group<M>(
        reinterpret_cast<const float2*>(llr) + row * n,
        rec + row * records * 64, bits + row * n, n, lane % L::kLanes, q, buf,
        L::kGroups * L::kGroupPairs, live, traceback, [] { __syncwarp(); },
        [](unsigned x, int src) {
            return __shfl_sync(0xffffffffu, x, src, L::kLanes);
        });
}

// K4 at G = 32: one warp a sequence (vit::decode_butterfly).
__global__ void __launch_bounds__(32)
viterbi_k7_butterfly_kernel(const float* __restrict__ llr,
                            unsigned* __restrict__ rec,
                            uint8_t* __restrict__ bits, int n,
                            bool traceback) {
    __shared__ __align__(16) vit::ButterflySmem sm;
    const size_t row = blockIdx.x;
    const size_t records =
        static_cast<size_t>(vit::record_stride(n, vit::kButterflyRecord));
    vit::decode_butterfly(
        reinterpret_cast<const float2*>(llr) + row * n,
        rec + row * records * 64, bits + row * n, n, threadIdx.x, true,
        traceback, sm, [] { __syncwarp(); },
        [](unsigned x, int src) { return __shfl_sync(0xffffffffu, x, src); });
}

template <int M>
int launch_group(const float* llr, unsigned* rec, uint8_t* bits, int batch,
                 int n, bool traceback, cudaStream_t stream) {
    constexpr int kGroups = vit::GroupLayout<M>::kGroups;
    const int blocks = (batch + kGroups - 1) / kGroups;
    viterbi_k7_group_kernel<M><<<blocks, 32, 0, stream>>>(
        llr, rec, bits, batch, n, traceback);
    return static_cast<int>(cudaGetLastError());
}

int launch_butterfly(const float* llr, unsigned* rec, uint8_t* bits,
                     int batch, int n, bool traceback, cudaStream_t stream) {
    viterbi_k7_butterfly_kernel<<<batch, 32, 0, stream>>>(llr, rec, bits, n,
                                                          traceback);
    return static_cast<int>(cudaGetLastError());
}

// The warp baseline: one warp per window; window wi of row b covers steps
// [start, start + e), start = clip(wi*l - ov, 0, n - e), and owns [wi*l,
// wi*l + l) ∩ [0, n).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
viterbi_k7_windowed_warp_kernel(const float* __restrict__ llr,
                           uint8_t* __restrict__ bits, int batch, int n,
                           int windows, int l, int ov, int e) {
    extern __shared__ uint2 dec_smem[];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long gw =
        static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
    if (gw >= static_cast<long long>(batch) * windows) return;
    const int b = static_cast<int>(gw / windows);
    const int wi = static_cast<int>(gw % windows);
    const int start = min(max(wi * l - ov, 0), n - e);
    const bool first = start == 0;
    const bool tail = start + e == n;
    const float2* ab = reinterpret_cast<const float2*>(llr) +
                       static_cast<size_t>(b) * n + start;
    uint2* dec = dec_smem + static_cast<size_t>(warp) * e;

    // first window pinned to state 0; interior windows uniform
    float pm_lo = first && lane != 0 ? kNeg : 0.0f;
    float pm_hi = first ? kNeg : 0.0f;
    forward(ab, dec, e, lane, pm_lo, pm_hi);
    if (tail) {                     // terminated in state 0
        if (lane != 0) pm_lo = __fadd_rn(pm_lo, kNeg);
        pm_hi = __fadd_rn(pm_hi, kNeg);
    }
    const int entry = first_max_state(pm_lo, pm_hi, lane);

    const int own_lo = wi * l - start;               // window offsets
    const int own_hi = min(own_lo + l, n - start);
    uint8_t* brow = bits + static_cast<size_t>(b) * n + start;
    traceback(dec, e, entry, lane, [&](int t, uint8_t bit) {
        if (t >= own_lo && t < own_hi) brow[t] = bit;
    });
}


// K4w: one thread per window (viterbi_window.cuh decode_window); window
// gw = b * windows + wi keeps step t's decision words at dec[t * total +
// gw], total = batch * windows.
constexpr int kWindowThreads = 32;
// 16 one-warp blocks an SM caps a thread at 128 registers (ptxas: 64 bytes
// of spills; 231 registers uncapped). In chip calls on the NVIDIA H100
// 80GB HBM3 (700 W), at c3_pallas's shape: 1.585 ms in-kernel capped,
// 1.802 uncapped, 1.62-1.69 at 12 blocks or 64- and 128-thread blocks
// with 168 registers; the stream's 612 windows lose ~10% capped (0.130
// against 0.118 ms).
constexpr int kWindowMinBlocks = 16;

__global__ void __launch_bounds__(kWindowThreads, kWindowMinBlocks)
viterbi_k7_window_kernel(const float* __restrict__ llr, uint2* __restrict__ dec,
                         uint8_t* __restrict__ bits, int batch, int n,
                         int windows, int l, int ov, int e) {
    const long long total = static_cast<long long>(batch) * windows;
    const long long gw =
        static_cast<long long>(blockIdx.x) * kWindowThreads + threadIdx.x;
    if (gw >= total) return;
    const int b = static_cast<int>(gw / windows);
    const int wi = static_cast<int>(gw % windows);
    const vit::Window w(wi, n, l, ov, e);
    const float2* ab = reinterpret_cast<const float2*>(llr) +
                       static_cast<size_t>(b) * n + w.start;
    const bool wide = (reinterpret_cast<uintptr_t>(ab) & 15u) == 0;
    uint2* d = dec + gw;
    const size_t stride = static_cast<size_t>(total);
    uint8_t* brow = bits + static_cast<size_t>(b) * n + w.start;
    vit::decode_window(
        w, e,
        [&](int t, float& la0, float& lb0, float& la1, float& lb1) {
            if (wide) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(ab + t));
                la0 = v.x; lb0 = v.y; la1 = v.z; lb1 = v.w;
            } else {
                const float2 v0 = __ldg(ab + t), v1 = __ldg(ab + t + 1);
                la0 = v0.x; lb0 = v0.y; la1 = v1.x; lb1 = v1.y;
            }
        },
        [&](int t, float& la, float& lb) {
            const float2 v = __ldg(ab + t);
            la = v.x; lb = v.y;
        },
        [&](int t, const uint2& v) { d[t * stride] = v; },
        [&](int t) { return d[t * stride]; },
        [&](int t, uint8_t bit) { brow[t] = bit; });
}

}  // namespace

OFDM_API int ofdm_viterbi(const float* llr, uint32_t* rec, uint8_t* bits,
                          int batch, int n, int group, int traceback,
                          void* stream) {
    if (batch <= 0 || n <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    const bool tb = traceback != 0;
    switch (group) {
        case 4: return launch_group<4>(llr, rec, bits, batch, n, tb, s);
        case 8: return launch_group<3>(llr, rec, bits, batch, n, tb, s);
        case 16: return launch_group<2>(llr, rec, bits, batch, n, tb, s);
        case 32: return launch_butterfly(llr, rec, bits, batch, n, tb, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

OFDM_API int ofdm_viterbi_windowed(const float* llr, uint32_t* dec,
                                   uint8_t* bits, int batch, int n,
                                   int windows, int l, int ov, int e,
                                   void* stream) {
    if (batch <= 0 || n <= 0) return 0;
    if (windows <= 0 || l <= 0 || ov < 0 || e <= 0 || e > n ||
        static_cast<long long>(windows - 1) * l >= n)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long total = static_cast<long long>(batch) * windows;
    const long long blocks = (total + kWindowThreads - 1) / kWindowThreads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    viterbi_k7_window_kernel<<<static_cast<unsigned>(blocks), kWindowThreads,
                               0, static_cast<cudaStream_t>(stream)>>>(
        llr, reinterpret_cast<uint2*>(dec), bits, batch, n, windows, l, ov,
        e);
    return static_cast<int>(cudaGetLastError());
}

OFDM_API int ofdm_viterbi_windowed_warp(const float* llr, uint8_t* bits,
                                   int batch, int n, int windows, int l,
                                   int ov, int e, void* stream) {
    if (batch <= 0 || n <= 0) return 0;
    if (windows <= 0 || l <= 0 || ov < 0 || e <= 0 || e > n ||
        static_cast<long long>(windows - 1) * l >= n)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(kWarpsPerBlock) * e *
                        sizeof(uint2);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > kDefaultSmem) {
        const cudaError_t err = cudaFuncSetAttribute(
            viterbi_k7_windowed_warp_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long rows = static_cast<long long>(batch) * windows;
    const int blocks =
        static_cast<int>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
    viterbi_k7_windowed_warp_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        llr, bits, batch, n, windows, l, ov, e);
    return static_cast<int>(cudaGetLastError());
}
