// The banded filter tier at float32 accuracy on the tensor cores (3xTF32):
// the strided real-tap correlation ('same' FIR at stride 1, M-fold
// decimation at stride M), L-fold polyphase interpolation, and the
// Schmidl-Cox window sums, over complex64 rows read in place.
//
// Replaces two TPU kernels that express a filter as a banded matrix
// product on the MXU:
//   K8, ofdm_uhd_tpu/kernels/pallas_fir.py (_banded_kernel, pallas_call at
//     :102): fir_pallas (:133), polyphase_interp_pallas (:150),
//     polyphase_decim_pallas (:174), and pallas_sync.py:40
//     sc_correlate_pallas on its _moving_sum_pallas (:25). Batch rows of
//     (re, im) planes on the MXU's rows, y_j = x_j @ A + head_j @ B with
//     dense banded A, B; jnp.dot at its default precision, which the
//     reference's tests hold to float32 (atol 1e-4 against the XLA
//     backend). The planes were the TPU's layout; here the kernel reads
//     the complex64 rows and de-interleaves them in shared memory.
//   K13, ofdm_uhd_tpu/research/pallas_fir_ilv.py (fir_ilv_pallas :63,
//     polyphase_decim_ilv_pallas :108, polyphase_interp_ilv_pallas :155)
//     on K7b's general-tap _banded_rows_call (pallas_fir_mxu.py:239,
//     pallas_call at :259) at Precision.HIGHEST: the same filters on the
//     interleaved (re, im) layout, with the taps dilated by 2 (w2[0::2] =
//     w) so that one real correlation serves both components. The same
//     entry points: complex64 read as float2 is the free bitcast the TPU
//     lacked (pallas_fir_ilv.py:8-21), and the de-interleaving does what
//     the zero taps did.
// Entry points: ofdm_banded_strided, ofdm_banded_interp, ofdm_banded_sc
// (P at window l, R at 2l, from r itself: the lag product and the energy
// are formed on chip).
//
// Bound on an H100 SXM (3.35 TB/s, 495 TFLOP/s dense TF32): the bytes,
// the rows in and the outputs out once, against the useful multiply-adds
// as three TF32 products each, the larger. C4's decimation of 8 x
// 4,138,472 complex64 samples moves 298 MB (0.089 ms) against ~0.02 ms
// of products; C4's TX interpolation [32, 16128] by 8 moves 37 MB (0.011
// ms); the S&C over C3's [8, 4,436,068] at l = 128 moves 710 MB (0.212
// ms) against 0.006 ms of products: all bound by bytes.
//
// The design (banded_body.cuh): a persistent grid of blocks of 8 consumer
// warps and a producer warp. The producer keeps a ring of two raw stages
// on mbarriers, one bulk copy (cp.async.bulk) an item's span, so the next
// item's bytes arrive while the consumers compute; the consumers split
// each staged sample once into TF32 hi and lo planes whose padded rows
// make the mma.sync A loads conflict-free 8-byte loads, then run 3xTF32
// mma.sync m16n8k8 accumulated in the tensor cores, every block's and
// plane's products in flight together (no branch around a product). The
// decimation's warps share a tile's k-steps (a stride of 8 stages 8
// samples an output: a tile a warp would not fit two blocks an SM), their
// sums added in order in shared memory and stored as whole 16-byte lines;
// the interpolation's and the S&C's warps take whole tiles and store from
// their fragments. An item stages at most ~1.25x its own inputs at C4 and
// at C3's S&C. In-kernel on an NVIDIA H100 80GB HBM3 at 700.00 W
// (scripts/tiers_ab.py beside the previous body; PERF.md §6): the S&C at
// C3 0.84 ms (the previous body 3.25), C4's decimation 0.29 (0.57 on
// planes, 0.29 in place), its TX interpolation 0.025 (0.058, 0.027). What
// holds them at 3-4x their bound: the stores (the S&C takes 0.57 ms and
// the interpolation 0.007 without them) and the split (the decimation
// 0.22 without it) beside the products' issue (scripts/banded_ablation.py).
// mma.sync m16n8k8 .tf32 runs at ~315 TFLOP/s on that card
// (scripts/mma_rate.py); wgmma is not used.
//
// Rows never leak: each row is filtered on its own, with zeros read before
// its start and past its end; ragged tiles are masked at the store.
#include "banded_body.cuh"
#include "ofdm_kernels.h"

namespace {

constexpr int kWarps = 8;                    // consumer warps a block
constexpr int kThreads = 32 * (kWarps + 1);
constexpr size_t kMaxSmem = 232448;          // a block's dynamic shared memory
constexpr size_t kSmemGoal = 113 * 1024;     // two blocks an SM

template <int kKind, int NB>
__global__ void __launch_bounds__(kThreads)
banded_kernel(const bandk::Args a, const bandk::Plan g) {
    extern __shared__ float4 banded_smem[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(banded_smem);
    bandk::DevicePipe pipe{
        reinterpret_cast<unsigned long long*>(smem + g.o_bars)};
    const int consumers = 32 * g.warps;
    bandk::band_block<kKind, NB>(
        a, g, smem, blockIdx.x, gridDim.x, threadIdx.x, pipe,
        [] { __syncthreads(); },
        [consumers] {
            asm volatile("bar.sync 1, %0;" ::"r"(consumers) : "memory");
        });
}

// The shared-memory opt-in (set once an instance and device, to the most a
// block may use) and the blocks an SM holds (asked again only when the
// shared memory changes): a grid of as many blocks as fit on the card at
// once, at most one an item.
template <int kKind, int NB>
struct Instance {
    static constexpr int kDevices = 64;
    bool opted[kDevices] = {};
    int smem[kDevices] = {};
    int per_sm[kDevices] = {};

    cudaError_t grid(const bandk::Plan& g, int dev, int sms, int& blocks) {
        if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
        cudaError_t err;
        if (!opted[dev]) {
            if ((err = cudaFuncSetAttribute(
                     banded_kernel<kKind, NB>,
                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                     static_cast<int>(kMaxSmem))) != cudaSuccess)
                return err;
            opted[dev] = true;
        }
        if (smem[dev] != g.smem) {
            if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &per_sm[dev], banded_kernel<kKind, NB>, g.threads(),
                     g.smem)) != cudaSuccess)
                return err;
            smem[dev] = g.smem;
        }
        const long long fit = static_cast<long long>(sms) *
                              (per_sm[dev] > 0 ? per_sm[dev] : 1);
        blocks = static_cast<int>(g.items < fit ? g.items : fit);
        return cudaSuccess;
    }
};

// The current device and its SM count.
cudaError_t card(int& dev, int& sms) {
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    return cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
}

// The last plan of an entry point on this host thread, made again only
// for other arguments (a session's launches repeat theirs).
template <int kN>
struct LastPlan {
    int key[kN] = {};
    bool ok = false;
    bandk::Plan plan;

    template <typename Make>
    bool get(const int (&k)[kN], Make make, bandk::Plan& out) {
        bool same = ok;
        for (int i = 0; i < kN && same; ++i) same = key[i] == k[i];
        if (!same) {
            ok = make(plan);
            for (int i = 0; i < kN; ++i) key[i] = k[i];
        }
        out = plan;
        return ok;
    }
};

template <int kKind, int NB>
int launch(const bandk::Args& a, const bandk::Plan& g, int dev, int sms,
           void* stream) {
    static Instance<kKind, NB> inst;
    int blocks = 0;
    cudaError_t err = inst.grid(g, dev, sms, blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    banded_kernel<kKind, NB><<<blocks, g.threads(), g.smem,
                               static_cast<cudaStream_t>(stream)>>>(a, g);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

OFDM_API int ofdm_banded_strided(const void* x, const float* w, void* y,
                                 int rows, int n_in, int n_out, int nt,
                                 int stride, int pad_left, void* stream) {
    if (rows <= 0 || n_out <= 0) return 0;
    static thread_local LastPlan<7> last;
    int dev = 0, sms = 0;
    cudaError_t err = card(dev, sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    bandk::Args a{};
    bandk::Plan g;
    if (!bandk::rows_at(x, a) ||
        !last.get({rows, n_in, n_out, nt, stride, pad_left, sms},
                  [&](bandk::Plan& p) {
                      return bandk::plan_strided(p, rows, n_in, n_out, nt,
                                                 stride, pad_left, kWarps,
                                                 sms, kMaxSmem, kSmemGoal);
                  }, g))
        return static_cast<int>(cudaErrorInvalidValue);
    a.coef = w;
    a.y = static_cast<float2*>(y);
    return launch<bandk::kStrided, bandk::kNbStrided>(a, g, dev, sms, stream);
}

OFDM_API int ofdm_banded_interp(const void* x, const float* gm, void* y,
                                int rows, int n, int l, int nd, int d_max,
                                void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    static thread_local LastPlan<6> last;
    int dev = 0, sms = 0;
    cudaError_t err = card(dev, sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    bandk::Args a{};
    bandk::Plan g;
    if (!bandk::rows_at(x, a) ||
        !last.get({rows, n, l, nd, d_max, sms},
                  [&](bandk::Plan& p) {
                      return bandk::plan_interp(p, rows, n, l, nd, d_max,
                                                kWarps, sms, kMaxSmem,
                                                kSmemGoal);
                  }, g))
        return static_cast<int>(cudaErrorInvalidValue);
    a.coef = gm;
    a.y = static_cast<float2*>(y);
    switch (g.nb) {
        case 1: return launch<bandk::kInterp, 1>(a, g, dev, sms, stream);
        case 2: return launch<bandk::kInterp, 2>(a, g, dev, sms, stream);
        default: return launch<bandk::kInterp, 4>(a, g, dev, sms, stream);
    }
}

OFDM_API int ofdm_banded_sc(const void* r, void* p, float* rr, int rows,
                            int n, int l, void* stream) {
    if (rows <= 0 || n - 2 * l + 1 <= 0) return 0;
    static thread_local LastPlan<4> last;
    int dev = 0, sms = 0;
    cudaError_t err = card(dev, sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    bandk::Args a{};
    bandk::Plan g;
    if (l < 1 || !bandk::rows_at(r, a) ||
        !last.get({rows, n, l, sms},
                  [&](bandk::Plan& p) {
                      return bandk::plan_sc(p, rows, n, l, kWarps, sms,
                                            kMaxSmem, kSmemGoal);
                  }, g))
        return static_cast<int>(cudaErrorInvalidValue);
    a.y = static_cast<float2*>(p);
    a.r = rr;
    return launch<bandk::kSc, bandk::kNbSc>(a, g, dev, sms, stream);
}
