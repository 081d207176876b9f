// Halo exchange of the time-sharded stream: shard i's halo is the head of
// shard i + 1's block.
//
// Replaces: ofdm_uhd_tpu/kernels/pallas_halo.py:halo_from_right_pallas
// (_halo_kernel), where every shard sends its head [H] complex64 to shard
// i - 1 by remote DMA under send/recv semaphores. Here one launch per
// destination device copies, for each of that device's shards i < T - 1,
// the H-sample head of shard i + 1 into shard i's halo. A source is a
// local pointer, or a peer pointer when shard i + 1 lives on another card
// (the wrapper has enabled peer access and ordered the two streams with
// events, the counterpart of the semaphores); the last shard's halo is
// the caller's (the fresh tail), as in the reference.
//
// Bound on this card: launch latency. A C5 step moves 3 x 4288 samples
// (34 KB each way per shard), some 2e-5 ms at 3.35 TB/s, against a launch
// of a few microseconds. Design: the (source, destination) pairs ride in
// the kernel's parameters (no pointer table to upload), grid.y walks the
// pairs, and each thread moves 16 bytes (two complex samples) a step;
// where H is odd or a pointer is not 16-byte aligned the same kernel runs
// on 8-byte samples.
#include <cstdint>

#include "ofdm_kernels.h"

namespace {

constexpr int kMaxPairs = 64;
constexpr int kThreads = 256;
constexpr int kMaxBlocksPerPair = 16;

template <typename V>
struct HaloPairs {
    const V* src[kMaxPairs];
    V* dst[kMaxPairs];
};

template <typename V>
__global__ void __launch_bounds__(kThreads)
halo_kernel(const HaloPairs<V> pairs, int n) {
    const V* __restrict__ src = pairs.src[blockIdx.y];
    V* __restrict__ dst = pairs.dst[blockIdx.y];
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
         i += gridDim.x * kThreads) {
        dst[i] = src[i];
    }
}

template <typename V>
int launch(const void* const* src, void* const* dst, int pairs, int n,
           cudaStream_t stream) {
    HaloPairs<V> args;
    for (int p = 0; p < pairs; ++p) {
        args.src[p] = static_cast<const V*>(src[p]);
        args.dst[p] = static_cast<V*>(dst[p]);
    }
    int blocks = (n + kThreads - 1) / kThreads;
    blocks = blocks < kMaxBlocksPerPair ? blocks : kMaxBlocksPerPair;
    halo_kernel<V><<<dim3(blocks, pairs), kThreads, 0, stream>>>(args, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

OFDM_API int ofdm_halo_from_right(const void* const* src, void* const* dst,
                                  int pairs, int h, void* stream) {
    if (pairs <= 0 || h <= 0) return 0;
    if (pairs > kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
    bool wide = h % 2 == 0;
    for (int p = 0; p < pairs; ++p) {
        wide = wide && reinterpret_cast<uintptr_t>(src[p]) % 16 == 0
                    && reinterpret_cast<uintptr_t>(dst[p]) % 16 == 0;
    }
    auto s = static_cast<cudaStream_t>(stream);
    return wide ? launch<float4>(src, dst, pairs, h / 2, s)
                : launch<float2>(src, dst, pairs, h, s);
}

OFDM_API int ofdm_enable_peer_access(int device, int peer) {
    int can = 0;
    cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
    // the current device is restored after, so the caller's record of it
    // (kernels/build.py stream_ptr) stays true
    int previous = 0;
    err = cudaGetDevice(&previous);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();                  // clear the sticky-free error
        err = cudaSuccess;
    }
    cudaError_t restored = cudaSetDevice(previous);
    return static_cast<int>(err != cudaSuccess ? err : restored);
}
