// The shifted-FMA filter tier: the 'same' FIR, phase-split M-fold
// decimation and branch-row L-fold interpolation of complex rows, in
// float32 planes, one weighted FMA per tap.
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
// its halo in VMEM, and add one weighted FMA per tap over the tile. These
// keep that layout: a block stages one row's tile of outputs plus the
// nd - 1 samples of halo after it, as two float planes in shared memory,
// and every tap is one fmaf per output and plane. The TPU split long
// filters into 8 phases only because Mosaic's compile budget allowed about
// 33 distinct lane shifts per kernel (pallas_shift.py:32-37, _MAX_OFFSETS);
// CUDA has no such limit, so the FIR is the decimation's kernel at M = 1,
// one phase of nt taps, at any tap count. The decimation keeps the phase
// split, which is its layout: the tile is staged de-interleaved into M
// phase planes P_p[j] = xp[j*M + p] (pallas_shift.py:359), and output i
// sums P_p[i + d] over d < nd = ceil(nt / M) per phase, then the M phase
// sums in ascending phase (pallas_shift.py:324-328). The FIR's taps are
// summed in ascending order, as the TPU kernels sum them.
//
// Each thread keeps kR consecutive outputs in registers and a window of
// kR input samples per plane: a tap costs one shared load per plane and
// kR FMAs, and the window rotates by register renaming (the tap loop is
// unrolled by kR). kR is odd, so the 32 lanes of a warp, kR words apart,
// read 32 distinct banks; the taps are read by every lane at one address
// (a broadcast). fir.cu's strided kernel, by contrast, reads interleaved
// float2 at stride * 8 bytes between lanes (64 B at stride 8).
//
// Bound on this card: memory for the decimation (C4's capture, 8 x
// 4,138,472 samples in, 517,309 out a row: 265 MB for 1.6 G FMAs, 0.089
// ms at 3.35 TB/s against 0.048 ms of float32 FMAs); shared-memory loads
// and FMAs come next, at 2 (nd + kR - 1) / kR loads and 2 nd FMAs per
// output and phase. Rows never leak: each row is filtered on its own,
// with zeros before its start and past its end. Offsets are size_t.
#include "ofdm_kernels.h"

namespace {

constexpr int kThreads = 256;     // threads per block
constexpr int kR = 5;             // consecutive outputs a thread (odd)
constexpr int kTile = kThreads * kR;      // outputs a block (phase kernel)
constexpr int kGroups = 64;       // interp: kR-input groups a block
constexpr int kTileIn = kGroups * kR;     // interp: inputs a block
constexpr size_t kMaxSmem = 227 * 1024;   // shared memory a block may use

// Plane stride of the phase planes: whole 32-word rows plus a skew, so the
// staging writes of one warp (lane j -> phase j % m, index j / m) fall in
// distinct banks.
int plane_stride(int len, int m) {
    const int whole = (len + 31) / 32 * 32;
    return whole + (m > 1 ? (32 + m - 1) / m : 0);
}

// out[r, i] = sum_{p<m} sum_{d<nd} kern[p, d] * P_p[i + d], with
// P_p[j] = xp[j*m + p] and xp = row r with pad_left zeros in front and
// zeros past its end; i < n_out. kern is [m, nd] row-major.
__global__ void __launch_bounds__(kThreads)
shift_phase_kernel(const float2* __restrict__ x,
                   const float* __restrict__ kern, float2* __restrict__ y,
                   int n_in, int n_out, int m, int nd, int pad_left, int lp,
                   int tiles) {
    extern __shared__ float sm[];
    float* ks = sm;                                // [m * nd]
    float* pre = sm + ((m * nd + 1) & ~1);         // [m][lp], re plane
    float* pim = pre + static_cast<size_t>(m) * lp;   // im plane
    const int row = blockIdx.x / tiles;
    const int o0 = (blockIdx.x - row * tiles) * kTile;
    const int len = kTile + nd - 1;                // tile + halo, per phase
    const long long first = static_cast<long long>(o0) * m - pad_left;
    const float2* xr = x + static_cast<size_t>(row) * n_in;
    for (int j = threadIdx.x; j < m * nd; j += kThreads) ks[j] = kern[j];
    // coalesced reads of the span, de-interleaved into the phase planes
    const int span = len * m;
    for (int j = threadIdx.x; j < span; j += kThreads) {
        const long long s = first + j;
        const float2 v = (s >= 0 && s < n_in) ? xr[s]
                                                : make_float2(0.0f, 0.0f);
        const int i = j / m, p = j - i * m;
        pre[p * lp + i] = v.x;
        pim[p * lp + i] = v.y;
    }
    __syncthreads();
    const int base = threadIdx.x * kR;             // first output, in tile
    if (o0 + base >= n_out) return;
    float yre[kR], yim[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) yre[k] = yim[k] = 0.0f;
    for (int p = 0; p < m; ++p) {
        const float* sre = pre + p * lp + base;
        const float* sim = pim + p * lp + base;
        const float* kp = ks + p * nd;
        float are[kR], aim[kR];                    // this phase's sums
        float wre[kR], wim[kR];    // window: P_p[base + d + k] in slot (d + k) % kR
#pragma unroll
        for (int k = 0; k < kR; ++k) {
            are[k] = aim[k] = 0.0f;
            if (k < kR - 1) {
                wre[k] = sre[k];
                wim[k] = sim[k];
            }
        }
        for (int d0 = 0; d0 < nd; d0 += kR) {
#pragma unroll
            for (int u = 0; u < kR; ++u) {
                const int d = d0 + u;
                if (d < nd) {
                    const int in = (u + kR - 1) % kR;
                    wre[in] = sre[d + kR - 1];
                    wim[in] = sim[d + kR - 1];
                    const float c = kp[d];
#pragma unroll
                    for (int k = 0; k < kR; ++k) {
                        are[k] = fmaf(c, wre[(u + k) % kR], are[k]);
                        aim[k] = fmaf(c, wim[(u + k) % kR], aim[k]);
                    }
                }
            }
        }
#pragma unroll
        for (int k = 0; k < kR; ++k) {
            yre[k] = __fadd_rn(yre[k], are[k]);
            yim[k] = __fadd_rn(yim[k], aim[k]);
        }
    }
    float2* yr = y + static_cast<size_t>(row) * n_out + o0 + base;
#pragma unroll
    for (int k = 0; k < kR; ++k)
        if (o0 + base + k < n_out) yr[k] = make_float2(yre[k], yim[k]);
}

// out[r, i*l + q] = sum_{e<nd} kern[q, e] * xp[i + e], xp = row r with
// d_max zeros in front and zeros past its end; kern [l, nd] is the branch
// matrix with each branch reversed. A (group, branch) pair takes kR
// consecutive inputs of one branch; the pairs of a warp are the l branches
// of consecutive groups, so a store writes runs of l consecutive outputs.
__global__ void __launch_bounds__(kThreads)
shift_interp_kernel(const float2* __restrict__ x,
                    const float* __restrict__ kern, float2* __restrict__ y,
                    int n, int l, int nd, int d_max, int kstride,
                    int tiles) {
    extern __shared__ float sm[];
    float* ks = sm;                                // [l][kstride], odd
    const int len = kTileIn + nd - 1;
    float* xre = sm + ((l * kstride + 1) & ~1);    // [len]
    float* xim = xre + len;
    const int row = blockIdx.x / tiles;
    const int i0 = (blockIdx.x - row * tiles) * kTileIn;
    const float2* xr = x + static_cast<size_t>(row) * n;
    for (int j = threadIdx.x; j < l * nd; j += kThreads) {
        const int q = j / nd;
        ks[q * kstride + (j - q * nd)] = kern[j];
    }
    for (int j = threadIdx.x; j < len; j += kThreads) {
        const int s = i0 - d_max + j;
        const float2 v = (s >= 0 && s < n) ? xr[s] : make_float2(0.0f, 0.0f);
        xre[j] = v.x;
        xim[j] = v.y;
    }
    __syncthreads();
    const size_t n_out = static_cast<size_t>(n) * l;
    float2* yr = y + static_cast<size_t>(row) * n_out;
    for (int pair = threadIdx.x; pair < kGroups * l; pair += kThreads) {
        const int g = pair / l, q = pair - g * l;
        const int base = g * kR;
        if (i0 + base >= n) break;        // pairs ascend with their group
        const float* sre = xre + base;
        const float* sim = xim + base;
        const float* kq = ks + q * kstride;
        float are[kR], aim[kR], wre[kR], wim[kR];
#pragma unroll
        for (int k = 0; k < kR; ++k) {
            are[k] = aim[k] = 0.0f;
            if (k < kR - 1) {
                wre[k] = sre[k];
                wim[k] = sim[k];
            }
        }
        for (int e0 = 0; e0 < nd; e0 += kR) {
#pragma unroll
            for (int u = 0; u < kR; ++u) {
                const int e = e0 + u;
                if (e < nd) {
                    const int in = (u + kR - 1) % kR;
                    wre[in] = sre[e + kR - 1];
                    wim[in] = sim[e + kR - 1];
                    const float c = kq[e];
#pragma unroll
                    for (int k = 0; k < kR; ++k) {
                        are[k] = fmaf(c, wre[(u + k) % kR], are[k]);
                        aim[k] = fmaf(c, wim[(u + k) % kR], aim[k]);
                    }
                }
            }
        }
#pragma unroll
        for (int k = 0; k < kR; ++k) {
            const size_t i = static_cast<size_t>(i0) + base + k;
            if (i < static_cast<size_t>(n))
                yr[i * l + q] = make_float2(are[k], aim[k]);
        }
    }
}

// Dynamic shared memory above the default 48 KB needs the opt-in; above
// what a block may use, the launch is refused.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes > kMaxSmem) return cudaErrorInvalidValue;
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

int launch_phase(const float2* x, const float* kern, float2* y, int rows,
                 int n_in, int n_out, int m, int nd, int pad_left,
                 void* stream) {
    if (rows <= 0 || n_out <= 0) return 0;
    if (m < 1 || nd < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (n_out + kTile - 1) / kTile;
    const int lp = plane_stride(kTile + nd - 1, m);
    const size_t smem = sizeof(float) * (((m * nd + 1) & ~1)
                                         + 2 * static_cast<size_t>(m) * lp);
    cudaError_t err = allow_smem(shift_phase_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    shift_phase_kernel<<<rows * tiles, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        x, kern, y, n_in, n_out, m, nd, pad_left, lp, tiles);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

OFDM_API int ofdm_shift_fir(const float2* x, const float* w, float2* y,
                            int rows, int n, int nt, int pad_left,
                            void* stream) {
    return launch_phase(x, w, y, rows, n, n, 1, nt, pad_left, stream);
}

OFDM_API int ofdm_shift_decim(const float2* x, const float* kern, float2* y,
                              int rows, int n_in, int n_out, int m, int nd,
                              int pad_left, void* stream) {
    return launch_phase(x, kern, y, rows, n_in, n_out, m, nd, pad_left,
                        stream);
}

OFDM_API int ofdm_shift_interp(const float2* x, const float* kern, float2* y,
                               int rows, int n, int l, int nd, int d_max,
                               void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    if (l < 1 || nd < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (n + kTileIn - 1) / kTileIn;
    const int kstride = nd | 1;
    const size_t smem = sizeof(float) * (((l * kstride + 1) & ~1)
                                         + 2 * static_cast<size_t>(
                                             kTileIn + nd - 1));
    cudaError_t err = allow_smem(shift_interp_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    shift_interp_kernel<<<rows * tiles, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        x, kern, y, n, l, nd, d_max, kstride, tiles);
    return static_cast<int>(cudaGetLastError());
}
