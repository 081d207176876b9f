// The shifted-FMA filter tier: the 'same' FIR, phase-split M-fold
// decimation and branch-row L-fold interpolation of complex64 rows read
// in place, one float32 FMA a tap and component.
//
// Replaces ofdm_uhd_tpu/research/pallas_shift.py (K11):
//   ofdm_shift_fir:    fir_shift_pallas (_fir_kernel, chunk rows) and
//                      _fir_shift_phased (_fir_phase_kernel, 8 phases);
//   ofdm_shift_decim:  polyphase_decim_shift_pallas (_decim_kernel);
//   ofdm_shift_interp: polyphase_interp_shift_pallas (_interp_kernel).
// (The tier's S&C correlator, sc_correlate_shift_pallas, computes K9's
// function in K9's order, and runs on ofdm_sc_correlate in scfront.cu.)
//
// The TPU kernels keep the signal as re and im planes, stage a tile plus
// its halo in VMEM, and add one weighted FMA per tap over the tile. The
// TPU split long filters into 8 phases only because Mosaic's compile
// budget allowed about 33 distinct lane shifts per kernel (pallas_shift.py
// :32-37, _MAX_OFFSETS); CUDA has no such limit, so the FIR is the phase
// kind at M = 1, one phase of nt taps. The decimation keeps the phase
// split, which is its layout (pallas_shift.py:359): output i sums P_p[i +
// d] over d < nd = ceil(nt / M) per phase, then the M phase sums in
// ascending phase (pallas_shift.py:324-328).
//
// The design for this card (shift_body.cuh): a persistent grid of blocks
// of consumer warps and a producer warp; the producer bulk-copies each
// item's contiguous span (cp.async.bulk, complex64 as it lies) into a ring
// of 2-3 stages on mbarriers (the decimation's span in two pieces), so the
// next span arrives while the consumers sum; the decimation's consumers
// split each piece once into float2 phase planes (no division a sample;
// skewed plane strides), the FIR's and the interpolation's sum straight
// from the stage; kR outputs a thread from a window in registers, the taps
// a table row read at one address a warp; the outputs staged in shared
// memory in sample order and written by bulk stores
// (cp.async.bulk.global.shared::cta). The plan (shiftk::plan_*) takes 4
// consumer warps a block where that gives every SM two items (else 2, 1),
// the stages by the occupancy API.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): C4's decimation of
// 8 x 4,138,472 samples by 8 with 193 taps moves 298 MB (0.089 ms) for 1.6
// G FMAs (0.049 ms), bound by bytes; C4's TX interpolation [32, 16128] by
// 8 moves 37 MB (0.011 ms), 33 MB of it outputs; the 193-tap FIR over 2^20
// samples is bound by its 0.4 G FMAs (0.012 ms). Shared memory bounds the
// decimation's tile: a staged output takes 64 bytes in the planes and 32
// a stage. In-kernel on an NVIDIA H100 80GB HBM3 at 700.00 W, in turns with
// the previous body (scripts/tiers_ab.py --phase shift; PERF.md §6): C4's
// decimation 0.152 ms (0.231; K7's strided body 0.173 in the same turns),
// its TX interpolation 0.021 (0.024), the 193-tap FIR at 2^20 0.0245
// (0.0326). Rows never leak: each row is filtered on its own, zeros read
// by index before its start and past its end.
#include <algorithm>

#include "ofdm_kernels.h"
#include "shift_body.cuh"

namespace {

constexpr int kMaxWarps = 4;                 // consumer warps a block, most
constexpr size_t kMaxSmem = 232448;          // a block's dynamic shared memory
// consecutive outputs a thread (odd): the FIR, the decimation (m > 1),
// the interpolation (inputs of one branch)
constexpr int kRFir = 9, kRDecim = 5, kRInterp = 9;

template <int kKind, int R>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1))
shift_kernel(const shiftk::Args a, const shiftk::Plan g) {
    extern __shared__ float4 shift_smem[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(shift_smem);
    shiftk::DevicePipe pipe{
        reinterpret_cast<unsigned long long*>(smem + g.o_bars), g.stages};
    const int consumers = g.consumers();
    shiftk::shift_block<kKind, R>(
        a, g, smem, blockIdx.x, gridDim.x, threadIdx.x, pipe,
        [] { __syncthreads(); },
        [consumers] {
            asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
        });
}

// The blocks of an instance an SM holds at `threads` threads and `smem`
// bytes of shared memory (the occupancy API, after the shared-memory
// opt-in, set once an instance and device to the most a block may use);
// 0 where the card refuses.
template <int kKind, int R>
int per_sm(int dev, int threads, int smem) {
    static constexpr int kDevices = 64;
    static bool opted[kDevices] = {};
    if (dev < 0 || dev >= kDevices) return 0;
    if (!opted[dev]) {
        if (cudaFuncSetAttribute(shift_kernel<kKind, R>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMaxSmem)) != cudaSuccess)
            return 0;
        opted[dev] = true;
    }
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, shift_kernel<kKind, R>, threads, smem) != cudaSuccess)
        return 0;
    return n;
}

// The current device and its SM count.
cudaError_t card(int& dev, int& sms) {
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

// The plan of a launch of kind `kind` on device dev of `sms` SMs: the FIR
// and the decimation (nt weights, stride m, lead = pad_left) or the
// interpolation (n_in = n, nt = nd, m = l, lead = d_max).
bool make_plan(int kind, int rows, int n_in, int n_out, int nt, int m,
               int lead, int dev, int sms, shiftk::Plan& g) {
    using namespace shiftk;
    switch (kind) {
        case kFir:
            return plan_phase(g, rows, n_in, n_out, nt, 1, lead, kRFir,
                              kMaxWarps, sms, kMaxSmem, [dev](int t, int b) {
                                  return per_sm<kFir, kRFir>(dev, t, b);
                              });
        case kDecim:
            return plan_phase(g, rows, n_in, n_out, nt, m, lead, kRDecim,
                              kMaxWarps, sms, kMaxSmem, [dev](int t, int b) {
                                  return per_sm<kDecim, kRDecim>(dev, t, b);
                              });
        default:
            return plan_interp(g, rows, n_in, m, nt, lead, kRInterp,
                               kMaxWarps, sms, kMaxSmem, [dev](int t, int b) {
                                   return per_sm<kInterp, kRInterp>(dev, t,
                                                                    b);
                               });
    }
}

// One launch of kind kKind: its plan made again only for other arguments
// than the last launch of the kind on this host thread (a session's
// launches repeat theirs), a grid of as many blocks as the card holds at
// once, at most one an item.
template <int kKind, int R>
int launch(const void* x, const float* coef, void* y, int rows, int n_in,
           int n_out, int nt, int m, int lead, void* stream) {
    if (rows <= 0 || n_in <= 0 || n_out <= 0) return 0;
    static thread_local int key[8] = {};
    static thread_local bool ok = false;
    static thread_local shiftk::Plan g;
    int dev = 0, sms = 0;
    cudaError_t err = card(dev, sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int args[8] = {rows, n_in, n_out, nt, m, lead, dev, sms};
    if (!std::equal(args, args + 8, key)) {
        ok = make_plan(kKind, rows, n_in, n_out, nt, m, lead, dev, sms, g);
        std::copy(args, args + 8, key);
    }
    shiftk::Args a{};
    if (!ok || !shiftk::args_at(x, coef, y, a))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long fit = static_cast<long long>(sms) * g.per_sm;
    const int blocks = static_cast<int>(g.items < fit ? g.items : fit);
    shift_kernel<kKind, R><<<blocks, g.threads(), g.smem,
                             static_cast<cudaStream_t>(stream)>>>(a, g);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

OFDM_API int ofdm_shift_fir(const void* x, const float* w, void* y, int rows,
                            int n, int nt, int pad_left, void* stream) {
    return launch<shiftk::kFir, kRFir>(x, w, y, rows, n, n, nt, 1, pad_left,
                                       stream);
}

OFDM_API int ofdm_shift_decim(const void* x, const float* w, void* y,
                              int rows, int n_in, int n_out, int m, int nt,
                              int pad_left, void* stream) {
    if (m == 1)
        return launch<shiftk::kFir, kRFir>(x, w, y, rows, n_in, n_out, nt, 1,
                                           pad_left, stream);
    return launch<shiftk::kDecim, kRDecim>(x, w, y, rows, n_in, n_out, nt, m,
                                           pad_left, stream);
}

OFDM_API int ofdm_shift_interp(const void* x, const float* gm, void* y,
                               int rows, int n, int l, int nd, int d_max,
                               void* stream) {
    return launch<shiftk::kInterp, kRInterp>(x, gm, y, rows, n, n * l, nd, l,
                                             d_max, stream);
}

OFDM_API int ofdm_shift_plan(int kind, int rows, int n_in, int n_out, int nt,
                             int m, int lead, int* out) {
    int dev = 0, sms = 0;
    cudaError_t err = card(dev, sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (kind != shiftk::kInterp) kind = m > 1 ? shiftk::kDecim : shiftk::kFir;
    shiftk::Plan g;
    if (!make_plan(kind, rows, n_in, n_out, nt, m, lead, dev, sms, g))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long fit = static_cast<long long>(sms) * g.per_sm;
    const int v[8] = {g.tile, g.warps, g.stages, g.per_sm,
                      static_cast<int>(g.items < fit ? g.items : fit),
                      static_cast<int>(g.items), g.smem, g.pieces};
    std::copy(v, v + 8, out);
    return 0;
}
