// Frame extraction as bulk copies: frames[f] = capture[c, d : d +
// frame_len] with d = min(ds[f], n), zeros past the capture's end, and an
// all-zero frame where ds[f] < 0; a bit-exact copy.
//
// Replaces: ofdm_uhd_tpu/research/pallas_deframe.py:extract_frames_dma
// (_deframe_kernel, pallas_call at :69): one DMA per frame at a
// scalar-prefetched offset into a capture padded with zeros. Mosaic wanted
// the DMA's offset on a 128-lane boundary, which detection's offsets never
// are, and that made the TPU kernel a dead end. The card's copy engine for
// this is the bulk copy (cp.async.bulk, global -> shared, completing on an
// mbarrier), which needs only 16-byte alignment: at most one sample of
// shift.
//
// Design: one block per frame. Thread 0 copies the frame's 16-byte-aligned
// interior [d + head, d + head + nb) (head = 1 where the start sits 8
// bytes past a 16-byte boundary, nb even) into shared memory, in chunks of
// at most kChunk samples (32 KB), two buffers, so that the next chunk's
// copy runs while the block stores the last; each chunk completes on its
// buffer's mbarrier. The threads store the chunk to the frame shifted by
// `head`, with 8-byte stores (the frame's start has no alignment to
// exploit); the head and tail samples outside the interior (at most one
// each) are plain loads, and samples past n are zeros. The capture is read
// in place: no padded copy, no planes, and nothing outside [d, min(d +
// frame_len, n)) is read.
//
// Bound on this card: memory. At C3 (8208 frames x 4032 complex64) the
// copy moves 265 MB in and 265 MB out, 0.158 ms at 3.35 TB/s.
#include "ofdm_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;              // samples (32 KB) a chunk

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// Expect `bytes` on the barrier, then copy them from global to shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n"
        :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__global__ void __launch_bounds__(kThreads)
deframe_kernel(const float2* __restrict__ capture, const int* __restrict__ ds,
               float2* __restrict__ out, int n, int mf, int frame_len,
               int chunk) {
    extern __shared__ __align__(128) float2 buf[];         // [2][chunk]
    __shared__ __align__(8) uint64_t bars[2];
    const int frame = blockIdx.x;                          // over caps * mf
    const float2* src = capture + static_cast<size_t>(frame / mf) * n;
    float2* dst = out + static_cast<size_t>(frame) * frame_len;
    const int raw = ds[frame];
    const float2 zero = make_float2(0.0f, 0.0f);
    if (raw < 0) {                            // K12's zero frame
        for (int i = threadIdx.x; i < frame_len; i += kThreads) dst[i] = zero;
        return;
    }
    const int d = min(raw, n);
    const int avail = min(frame_len, n - d);  // samples read from the row
    const int head = min(static_cast<int>(
        (reinterpret_cast<uintptr_t>(src + d) >> 3) & 1), avail);
    const int nb = (avail - head) & ~1;       // 16-byte interior, samples
    const int chunks = (nb + chunk - 1) / chunk;
    const float2* from = src + d + head;
    if (threadIdx.x == 0 && chunks > 0) {
        bar_init(&bars[0]);
        bar_init(&bars[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int k = 0; k < min(chunks, 2); ++k)
            bulk_load(buf + k * chunk, from + static_cast<size_t>(k) * chunk,
                      8u * min(chunk, nb - k * chunk), &bars[k]);
    }
    // the head, the tail past the interior and the zeros past n
    for (int i = threadIdx.x; i < frame_len; i += kThreads) {
        if (i >= head && i < head + nb) continue;
        dst[i] = i < avail ? src[d + i] : zero;
    }
    __syncthreads();                          // the barriers are initialised
    for (int k = 0; k < chunks; ++k) {
        const int b = k & 1;
        bar_wait(&bars[b], (k >> 1) & 1);
        const int len = min(chunk, nb - k * chunk);
        const float2* s = buf + b * chunk;
        float2* o = dst + head + static_cast<size_t>(k) * chunk;
        for (int i = threadIdx.x; i < len; i += kThreads) o[i] = s[i];
        __syncthreads();                      // buffer b is free again
        if (threadIdx.x == 0 && k + 2 < chunks) {
            // order the block's reads of b before the copy engine's writes
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            bulk_load(buf + b * chunk,
                      from + static_cast<size_t>(k + 2) * chunk,
                      8u * min(chunk, nb - (k + 2) * chunk), &bars[b]);
        }
    }
}

}  // namespace

OFDM_API int ofdm_deframe(const float2* capture, const int* ds, float2* out,
                          int caps, int n, int mf, int frame_len,
                          void* stream) {
    const int frames = caps * mf;
    if (frames <= 0 || frame_len <= 0) return 0;
    // one buffer where a frame fits one chunk, else two
    const int chunk = min(kChunk, (frame_len + 1) & ~1);
    const size_t smem = sizeof(float2) * chunk * (frame_len > kChunk ? 2 : 1);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            deframe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    deframe_kernel<<<frames, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        capture, ds, out, n, mf, frame_len, chunk);
    return static_cast<int>(cudaGetLastError());
}
