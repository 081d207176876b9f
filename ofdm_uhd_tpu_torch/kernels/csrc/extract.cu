// Frame extraction: frames[i] = capture[clip(ds[i], 0, n) : + frame_len],
// zeros past the capture's end; a bit-exact copy.
//
// Replaces: ofdm_uhd_tpu/kernels/pallas_extract.py:extract_frames_pallas
// (_extract_kernel). The TPU kernel needed 128-aligned DMA windows and an
// on-chip lane shift by a one-hot matmul; here any offset is a plain
// gather, since the card loads at 8-byte granularity.
//
// Bound on this card: memory. A C3 dispatch copies 8208 frames x 4032
// complex64 = 265 MB in and 265 MB out. Design: one block per frame,
// 256 threads striding over the frame, so consecutive threads read
// consecutive samples of the capture and write consecutive samples of the
// frame (both coalesced at 8 bytes per thread; the frame's start has no
// 16-byte alignment to exploit). The CFO ramps are not fused in.
#include "ofdm_kernels.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
extract_kernel(const float2* __restrict__ capture, const int* __restrict__ ds,
               float2* __restrict__ out, int n, int mf, int frame_len) {
    const int frame = blockIdx.x;             // over caps * mf
    const int cap = frame / mf;
    const int start = min(max(ds[frame], 0), n);
    const float2* src = capture + static_cast<size_t>(cap) * n;
    float2* dst = out + static_cast<size_t>(frame) * frame_len;
    const int avail = n - start;              // samples before the end
    for (int i = threadIdx.x; i < frame_len; i += kThreads)
        dst[i] = i < avail ? src[start + i] : make_float2(0.0f, 0.0f);
}

}  // namespace

OFDM_API int ofdm_extract(const float2* capture, const int* ds, float2* out,
                          int caps, int n, int mf, int frame_len,
                          void* stream) {
    const int frames = caps * mf;
    if (frames <= 0 || frame_len <= 0) return 0;
    extract_kernel<<<frames, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        capture, ds, out, n, mf, frame_len);
    return static_cast<int>(cudaGetLastError());
}
