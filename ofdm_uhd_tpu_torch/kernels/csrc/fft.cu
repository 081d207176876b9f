// Batched orthonormal FFT / IFFT along rows, complex64, for power-of-two
// lengths up to 2048 (the chain uses N = 256 on RX and TX; the other
// waveforms use 64 and 1024), and its two CP-fused forms.
//
// Replaces:
//   ofdm_fft (K3): ofdm_uhd_tpu/kernels/pallas_fft.py:fft_pallas
//     (_build_fft, _direct_kernel);
//   ofdm_fft_cp (K5): pallas_fft.py:cp_strip_fft_pallas and ifft_cp_pallas
//     (_build_fused). The TPU kernel folds the CP strip into zero rows of a
//     dense [sym_len, n] DFT matrix, and the CP insertion into n + cp
//     columns, so that its MXU reads the raw symbol rows and writes the
//     prefixed rows in one pass.
// The TPU's dense DFT is O(N^2) work that this card's f32 units should not
// do, so both are a radix-2 FFT; K5 keeps what the TPU form saved, the
// extra passes over device memory: the strip is an offset and a row stride
// on the load (no contiguous copy of the windows), and the CP is a second
// store of the row's last cp samples (no concatenation pass).
//
// Bound on this card: memory. At N = 256 a row is 2 KB in and 2 KB out
// against 8 * 256 * 5 = 10 flops per byte, under the card's f32 ridge, so
// the kernels should run near the bandwidth of one read and one write.
// Design: a block holds 2048 / N rows (16 KB) in shared memory. Threads
// load the rows coalesced and store each sample at its bit-reversed
// position, run the log2(N) decimation-in-time radix-2 stages in shared
// memory (one barrier per stage; each thread owns N * rows / 2 / 256
// butterflies per stage), and store coalesced with the 1/sqrt(N) scale.
// Twiddles w_k = exp(-2 pi i k / N) for k < N/2 come from float64 cast to
// float32 (computed by the wrapper) and are conjugated for the inverse.
// K3 and K5 are one kernel: K3 is its case of contiguous rows and no CP.
#include <cmath>

#include "ofdm_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockSamples = 2048;   // samples (all rows) per block

// Twiddles for one transform direction into shared memory.
__device__ __forceinline__ void load_twiddles(float2* tw,
                                              const float2* twiddles,
                                              int half_n, int inverse) {
    for (int k = threadIdx.x; k < half_n; k += kThreads) {
        float2 w = twiddles[k];
        if (inverse) w.y = -w.y;
        tw[k] = w;
    }
}

// Rows [r0, r0 + nrows) of n = 2^log2n samples, row r starting at
// x[r * in_stride + in_off], into buf in bit-reversed order.
__device__ __forceinline__ void load_bitrev(float2* buf,
                                            const float2* __restrict__ x,
                                            int r0, int nrows, int log2n,
                                            int in_stride, int in_off) {
    const int n = 1 << log2n;
    const int total = nrows << log2n;
    for (int i = threadIdx.x; i < total; i += kThreads) {
        const int row = i >> log2n;
        const int k = i & (n - 1);
        const int rev = static_cast<int>(__brev(static_cast<unsigned>(k)) >>
                                         (32 - log2n));
        buf[(row << log2n) + rev] =
            x[static_cast<size_t>(r0 + row) * in_stride + in_off + k];
    }
}

// The log2(n) radix-2 stages over `total` samples (whole rows) of buf,
// bit-reversed order in, natural order out. Starts and ends with a barrier.
__device__ __forceinline__ void radix2_stages(float2* buf, const float2* tw,
                                              int total, int log2n) {
    const int n = 1 << log2n;
    const int half_n = n >> 1;
    const int butterflies = total >> 1;
    __syncthreads();
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
}

// Row r's input is x[r * in_stride + in_off, + n); its output row is
// y[r * (n + cp), + n + cp): the transform's last cp samples, then all n.
// K3 is the case in_stride = n, in_off = 0, cp = 0.
__global__ void __launch_bounds__(kThreads)
fft_cp_kernel(const float2* __restrict__ x, float2* __restrict__ y,
              const float2* __restrict__ twiddles, int rows, int log2n,
              int inverse, float scale, int in_stride, int in_off, int cp) {
    __shared__ float2 buf[kBlockSamples];
    __shared__ float2 tw[kBlockSamples / 2];
    const int n = 1 << log2n;
    const int rows_per_block = kBlockSamples >> log2n;
    const int r0 = blockIdx.x * rows_per_block;
    const int nrows = min(rows_per_block, rows - r0);

    load_twiddles(tw, twiddles, n >> 1, inverse);
    load_bitrev(buf, x, r0, nrows, log2n, in_stride, in_off);
    radix2_stages(buf, tw, nrows << log2n, log2n);
    const int out_len = n + cp;
    const size_t base = static_cast<size_t>(r0) * out_len;
    if (cp == 0) {                    // K3, K5 RX: no row arithmetic
        for (int i = threadIdx.x; i < nrows << log2n; i += kThreads) {
            const float2 v = buf[i];
            y[base + i] = make_float2(v.x * scale, v.y * scale);
        }
        return;
    }
    for (int i = threadIdx.x; i < nrows * out_len; i += kThreads) {
        const int row = i / out_len;
        const int j = i - row * out_len;
        const int src = j < cp ? j + n - cp : j - cp;
        const float2 v = buf[(row << log2n) + src];
        y[base + i] = make_float2(v.x * scale, v.y * scale);
    }
}

float ortho_scale(int log2n) {
    return static_cast<float>(
        1.0 / std::sqrt(static_cast<double>(1 << log2n)));
}

int blocks_for(int rows, int log2n) {
    const int rows_per_block = kBlockSamples >> log2n;
    return (rows + rows_per_block - 1) / rows_per_block;
}

}  // namespace

OFDM_API int ofdm_fft(const float2* x, float2* y, const float2* twiddles,
                      int rows, int log2n, int inverse, void* stream) {
    if (rows <= 0) return 0;
    if (log2n < 1 || (1 << log2n) > kBlockSamples)
        return static_cast<int>(cudaErrorInvalidValue);
    fft_cp_kernel<<<blocks_for(rows, log2n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        x, y, twiddles, rows, log2n, inverse, ortho_scale(log2n), 1 << log2n,
        0, 0);
    return static_cast<int>(cudaGetLastError());
}

OFDM_API int ofdm_fft_cp(const float2* x, float2* y, const float2* twiddles,
                         int rows, int log2n, int inverse, int in_stride,
                         int in_off, int cp, void* stream) {
    if (rows <= 0) return 0;
    if (log2n < 1 || (1 << log2n) > kBlockSamples || cp < 0
            || cp > (1 << log2n) || in_off < 0
            || in_stride < in_off + (1 << log2n))
        return static_cast<int>(cudaErrorInvalidValue);
    fft_cp_kernel<<<blocks_for(rows, log2n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        x, y, twiddles, rows, log2n, inverse, ortho_scale(log2n), in_stride,
        in_off, cp);
    return static_cast<int>(cudaGetLastError());
}
