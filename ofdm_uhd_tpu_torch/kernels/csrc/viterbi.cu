// Soft-input Viterbi decoder, rate 1/2, K=7 (polys 0o133 / 0o171), whole
// sequence: the trellis starts and ends in state 0.
//
// Replaces: ofdm_uhd_tpu/kernels/pallas_viterbi.py:viterbi_pallas
// (_vit_kernel_shuffle / _vit_kernel via _run_windows) in whole-sequence
// mode, and is bit-exact with the scan of phy/bits.py:viterbi_decode.
//
// Bound on this card: the 64-state add-compare-select is a chain of n
// dependent steps per sequence, so the decoder is latency-bound, not
// bandwidth-bound (decisions are 8 bytes per step: 454 MB written and read
// once at 8208 x 6912). Design: ONE WARP PER SEQUENCE. Lane l holds the
// path metrics of states l and l+32 in registers; both states share the
// predecessors 2l and 2l+1, which four warp shuffles bring in. No shared
// memory and no block barrier sit in the step loop, and a block's four
// warps decode four independent sequences, so the SM's schedulers hide
// one warp's step latency behind the others (every sequence of the C3
// batch is resident at once: 64 warps per SM x 132 SMs > 8208).
//   * LLRs: each lane loads one (a, b) pair per 32-step chunk, coalesced;
//     step j takes them by shuffle from lane j.
//   * Decisions: __ballot_sync packs the 64 choices of a step into two
//     words (states 0-31, 32-63); lane j keeps step j's pair and the warp
//     stores the chunk's 32 pairs in one coalesced 256-byte write.
//   * Traceback reads a chunk of 32 pairs per load the same way and walks
//     it by shuffles; every lane tracks the same state.
// Numerics: the ACS of phy/bits.py exactly (no 0.5 factor; bm0 = sa0*la +
// sb0*lb; c0 = pm_even + bm0; c1 = pm_odd - bm0; strict c1 > c0, so a tie
// keeps predecessor 0), with __fadd_rn / __fsub_rn / __fmul_rn so no
// multiply-add is contracted.
#include "ofdm_kernels.h"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kPolyA = 0133;
constexpr int kPolyB = 0171;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float branch_sign(int window, int poly) {
    // +1 for code bit 0, -1 for code bit 1
    return (__popc(window & poly) & 1) ? -1.0f : 1.0f;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
viterbi_k7_kernel(const float* __restrict__ llr, uint2* __restrict__ dec,
                  uint8_t* __restrict__ bits, int batch, int n) {
    const int seq = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (seq >= batch) return;       // the whole warp leaves together
    const float2* ab = reinterpret_cast<const float2*>(llr) +
                       static_cast<size_t>(seq) * n;
    uint2* dseq = dec + static_cast<size_t>(seq) * n;
    uint8_t* bseq = bits + static_cast<size_t>(seq) * n;

    // branch signs for the p=0 predecessor of state lane (input bit 0)
    // and state lane+32 (input bit 1); the p=1 branch is their negation
    const int w_lo = lane << 1, w_hi = 64 | (lane << 1);
    const float sa_lo = branch_sign(w_lo, kPolyA);
    const float sb_lo = branch_sign(w_lo, kPolyB);
    const float sa_hi = branch_sign(w_hi, kPolyA);
    const float sb_hi = branch_sign(w_hi, kPolyB);

    // predecessors of both owned states: 2*lane (even) and 2*lane+1 (odd),
    // held by lane (2*lane)&31 in its lo (lane < 16) or hi register
    const int src_even = (lane << 1) & 31;
    const int src_odd = src_even | 1;
    const bool from_hi = lane >= 16;

    float pm_lo = lane == 0 ? 0.0f : -1e30f;
    float pm_hi = -1e30f;

    for (int t0 = 0; t0 < n; t0 += 32) {
        const int t = t0 + lane;
        const float2 mine = t < n ? ab[t] : make_float2(0.0f, 0.0f);
        const int steps = min(32, n - t0);
        uint2 keep = make_uint2(0u, 0u);
        for (int j = 0; j < steps; ++j) {
            const float la = __shfl_sync(kFull, mine.x, j);
            const float lb = __shfl_sync(kFull, mine.y, j);
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

            const unsigned w0 = __ballot_sync(kFull, ch_lo);
            const unsigned w1 = __ballot_sync(kFull, ch_hi);
            if (lane == j) keep = make_uint2(w0, w1);
        }
        if (t < n) dseq[t] = keep;
    }

    // traceback from state 0 (tail-terminated); each lane rereads only
    // what it wrote itself, so program order makes the decisions visible
    int state = 0;
    for (int t0 = ((n - 1) >> 5) << 5; t0 >= 0; t0 -= 32) {
        const int t = t0 + lane;
        const uint2 mine = t < n ? dseq[t] : make_uint2(0u, 0u);
        const int steps = min(32, n - t0);
        uint8_t bit_out = 0;
        for (int j = steps - 1; j >= 0; --j) {
            const unsigned w0 = __shfl_sync(kFull, mine.x, j);
            const unsigned w1 = __shfl_sync(kFull, mine.y, j);
            if (lane == j) bit_out = static_cast<uint8_t>((state >> 5) & 1);
            const unsigned word = state >= 32 ? w1 : w0;
            state = ((state & 31) << 1) | ((word >> (state & 31)) & 1u);
        }
        if (t < n) bseq[t] = bit_out;
    }
}

}  // namespace

OFDM_API int ofdm_viterbi(const float* llr, uint32_t* dec, uint8_t* bits,
                          int batch, int n, void* stream) {
    if (batch <= 0 || n <= 0) return 0;
    const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    viterbi_k7_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        llr, reinterpret_cast<uint2*>(dec), bits, batch, n);
    return static_cast<int>(cudaGetLastError());
}
