// Batched orthonormal FFT / IFFT along the last axis, complex64, for
// power-of-two lengths up to 2048 (the chain uses N = 256 on RX and TX;
// the other waveforms use 64 and 1024).
//
// Replaces: ofdm_uhd_tpu/kernels/pallas_fft.py:fft_pallas (_build_fft,
// _direct_kernel). The TPU kernel is a dense DFT matmul on the MXU; that
// O(N^2) form would waste the card's f32 units, so this is a radix-2 FFT.
//
// Bound on this card: memory. At N = 256 a row is 2 KB in and 2 KB out
// against 8 * 256 * 5 = 10 flops per byte, under the card's f32 ridge, so
// the kernel should run near the bandwidth of one read and one write.
// Design: a block holds 2048 / N rows (16 KB) in shared memory. Threads
// load the rows coalesced and store each sample at its bit-reversed
// position, run the log2(N) decimation-in-time radix-2 stages in shared
// memory (one barrier per stage; each thread owns N * rows / 2 / 256
// butterflies per stage), and store coalesced with the 1/sqrt(N) scale.
// Twiddles w_k = exp(-2 pi i k / N) for k < N/2 come from float64 cast to
// float32 (computed by the wrapper) and are conjugated for the inverse.
#include <cmath>

#include "ofdm_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockSamples = 2048;   // samples (all rows) per block

__global__ void __launch_bounds__(kThreads)
fft_radix2_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                  const float2* __restrict__ twiddles, int rows, int log2n,
                  int inverse, float scale) {
    __shared__ float2 buf[kBlockSamples];
    __shared__ float2 tw[kBlockSamples / 2];
    const int n = 1 << log2n;
    const int half_n = n >> 1;
    const int rows_per_block = kBlockSamples >> log2n;
    const int r0 = blockIdx.x * rows_per_block;
    const int nrows = min(rows_per_block, rows - r0);
    const int total = nrows << log2n;
    const size_t base = static_cast<size_t>(r0) << log2n;

    for (int k = threadIdx.x; k < half_n; k += kThreads) {
        float2 w = twiddles[k];
        if (inverse) w.y = -w.y;
        tw[k] = w;
    }
    for (int i = threadIdx.x; i < total; i += kThreads) {
        const int row = i >> log2n;
        const int k = i & (n - 1);
        const int rev = static_cast<int>(__brev(static_cast<unsigned>(k)) >>
                                         (32 - log2n));
        buf[(row << log2n) + rev] = x[base + i];
    }
    __syncthreads();

    const int butterflies = total >> 1;
    for (int s = 1; s <= log2n; ++s) {
        const int half = 1 << (s - 1);
        const int tw_step = n >> s;               // N / len
        for (int b = threadIdx.x; b < butterflies; b += kThreads) {
            const int row = b >> (log2n - 1);
            const int j = b & (half_n - 1);
            const int k = j & (half - 1);
            const int i0 = (row << log2n) + ((j >> (s - 1)) << s) + k;
            const int i1 = i0 + half;
            const float2 w = tw[k * tw_step];
            const float2 a = buf[i0];
            const float2 v = buf[i1];
            const float2 t = make_float2(w.x * v.x - w.y * v.y,
                                         w.x * v.y + w.y * v.x);
            buf[i0] = make_float2(a.x + t.x, a.y + t.y);
            buf[i1] = make_float2(a.x - t.x, a.y - t.y);
        }
        __syncthreads();
    }

    for (int i = threadIdx.x; i < total; i += kThreads) {
        const float2 v = buf[i];
        y[base + i] = make_float2(v.x * scale, v.y * scale);
    }
}

}  // namespace

OFDM_API int ofdm_fft(const float2* x, float2* y, const float2* twiddles,
                      int rows, int log2n, int inverse, void* stream) {
    if (rows <= 0) return 0;
    if (log2n < 1 || (1 << log2n) > kBlockSamples)
        return static_cast<int>(cudaErrorInvalidValue);
    const int rows_per_block = kBlockSamples >> log2n;
    const int blocks = (rows + rows_per_block - 1) / rows_per_block;
    const float scale =
        static_cast<float>(1.0 / std::sqrt(static_cast<double>(1 << log2n)));
    fft_radix2_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        x, y, twiddles, rows, log2n, inverse, scale);
    return static_cast<int>(cudaGetLastError());
}
