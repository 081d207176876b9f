// Schmidl-Cox plateau localization: the launch of the warp body
// localize_warp.cuh, which sets out the design.
//
// Replaces: ofdm_uhd_tpu/kernels/pallas_localize.py:localize_pallas
// (_localize_kernel). d is emitted as int32 (the TPU kernel packs d into
// float32, exact only below 2^24).
//
// Bound on this card: bytes, of the found candidates alone. Each found
// candidate reads span metric samples and one P sample, and every slot
// writes d and eps: at C3 ~8200 found windows of 288 floats, ~10 MB,
// 0.003 ms at 3.35 TB/s (chip_smoke.py's hold_localize counts the same).
// The pad slots (c = nd) read nothing but their index.
#include "ofdm_kernels.h"
#include "localize_warp.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = lzk::kWarpsPerBlock * 32;

struct DeviceWarp {
    __device__ unsigned shfl(unsigned v, int src) const {
        return __shfl_sync(kFull, v, src);
    }
    __device__ int reduce_min(int v) const {
        return __reduce_min_sync(kFull, v);
    }
    __device__ int reduce_max(int v) const {
        return __reduce_max_sync(kFull, v);
    }
};

// kRowSlots slots a warp, a quarter of the row apart; W window loads a
// lane
template <int W>
__global__ void __launch_bounds__(kThreads)
localize_kernel(const lzk::Args a) {
    const long long warp =
        static_cast<long long>(blockIdx.x) * lzk::kWarpsPerBlock +
        (threadIdx.x >> 5);
    const int stride = lzk::row_stride(a.mf);
    const long long r = warp / stride;
    if (r >= a.caps) return;
    lzk::localize_row_slots<W>(a, DeviceWarp{}, threadIdx.x & 31, r,
                               static_cast<int>(warp - r * stride));
}

// one slot a block, any span
__global__ void __launch_bounds__(lzk::kBlockWarps * 32)
localize_block_kernel(const lzk::Args a) {
    __shared__ lzk::BlockSmem sm;
    lzk::localize_block(a, DeviceWarp{}, [] { __syncthreads(); }, sm,
                        threadIdx.x, lzk::kBlockWarps, blockIdx.x);
}

template <int W>
void launch(const lzk::Args& a, cudaStream_t stream) {
    const long long warps =
        static_cast<long long>(a.caps) * lzk::row_stride(a.mf);
    const long long blocks =
        (warps + lzk::kWarpsPerBlock - 1) / lzk::kWarpsPerBlock;
    localize_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(a);
}

}  // namespace

OFDM_API int ofdm_localize(const float* m, const float2* p, const int* cand,
                           int* d, float* eps, int caps, int nd, int mf,
                           int span, int cp_half, float rel, void* stream) {
    const long long total = static_cast<long long>(caps) * mf;
    if (total <= 0) return 0;
    const lzk::Args a{m, p, cand, d, eps, caps, nd, mf, span, cp_half, rel};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (lzk::window_loads(span)) {
        case 3: launch<3>(a, s); break;
        case 9: launch<9>(a, s); break;
        case 36: launch<36>(a, s); break;
        default:
            localize_block_kernel<<<static_cast<unsigned>(total),
                                    lzk::kBlockWarps * 32, 0, s>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}
