// C interface of the hand-written Hopper kernels (bound with ctypes by
// kernels/build.py). Every entry point launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError()
// right after the launch (0 = launched). Pointers are device pointers
// whose shapes, types and contiguity the Python wrappers have checked.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define OFDM_API extern "C" __attribute__((visibility("default")))

// Rate-1/2 K=7 Viterbi, whole-sequence, one group of `group` lanes (4,
// 8, 16 or 32) a sequence: llr [batch, 2n] f32 (a/b interleaved) -> bits
// [batch, n] u8; rec [batch, ceil(n / R) | 1, 64] u32 scratch (the
// survivor records of R = 24 steps, 20 at 32 lanes). traceback = 0 stops
// after the forward pass (bits unset), for timing the traceback's share.
OFDM_API int ofdm_viterbi(const float* llr, uint32_t* rec, uint8_t* bits,
                          int batch, int n, int group, int traceback,
                          void* stream);

// Rate-1/2 K=7 Viterbi in sliding windows, one thread a window: llr
// [batch, 2n] f32 -> bits [batch, n] u8. Window wi of a row decodes steps
// [start, start + e), start = clip(wi*l - ov, 0, n - e), wi < windows =
// ceil(n / l), and writes its owned bits [wi*l, wi*l + l) ∩ [0, n);
// windows = 1, l = e = n is the whole sequence. dec: scratch of e x batch
// x windows x 2 u32 (step t's words of window g at [t, g]).
OFDM_API int ofdm_viterbi_windowed(const float* llr, uint32_t* dec,
                                   uint8_t* bits, int batch, int n,
                                   int windows, int l, int ov, int e,
                                   void* stream);

// The same decode by the previous body, one warp a window (decisions in
// shared memory, 4 * e * 8 bytes a block, at most 227 KB): the A/B
// baseline, which no path launches.
OFDM_API int ofdm_viterbi_windowed_warp(const float* llr, uint8_t* bits,
                                        int batch, int n, int windows, int l,
                                        int ov, int e, void* stream);

// Orthonormal FFT/IFFT along rows (a Stockham FFT in registers, log2n in
// 1..13): x, y [rows, 2^log2n] complex64 (float2), twiddles: the plan's
// table (kernels/fft.py twiddle_table; empty for log2n <= 4).
OFDM_API int ofdm_fft(const float2* x, float2* y, const float2* twiddles,
                      int rows, int log2n, int inverse, void* stream);

// The column pass of the two-pass route (N = N1 N2, log2n1 and log2n2 in
// 1..12): x, y [rows, N1, N2] complex64; column n2 of each row transformed
// over n1 (ortho scale 1/sqrt N1; the inverse where `inverse`), output k1
// times route_twiddles[k1 N2 + n2] = W_N^(n2 k1) (conjugated for the
// inverse), stored at [k1, n2]. twiddles: the N1-point plan's table.
OFDM_API int ofdm_fft_columns(const float2* x, float2* y,
                              const float2* twiddles,
                              const float2* route_twiddles, int rows,
                              int log2n1, int log2n2, int inverse,
                              void* stream);

// The row pass: x [rows, N1, N2] -> y [rows, N], row k1 of x transformed
// (scale 1/sqrt N2), output k2 stored at y[k1 + N1 k2]. twiddles: the
// N2-point plan's table. N1 must be a multiple of the rows a block holds
// (4096 / N2 for N2 >= 16, else 256).
OFDM_API int ofdm_fft_rows_t(const float2* x, float2* y,
                             const float2* twiddles, int rows, int log2n1,
                             int log2n2, int inverse, void* stream);

// The same transform with the CP fused in: row r reads x[r * in_stride +
// in_off, + n) and writes y[r * (n + cp), + n + cp), the transform's last
// cp samples followed by all n (RX CP strip: in_off = cp - shift, cp = 0;
// TX CP insertion: in_stride = n, in_off = 0, inverse).
OFDM_API int ofdm_fft_cp(const float2* x, float2* y, const float2* twiddles,
                         int rows, int log2n, int inverse, int in_stride,
                         int in_off, int cp, void* stream);

// Schmidl-Cox plateau localization: m [caps, nd] f32, p [caps, nd]
// complex64, cand [caps, mf] i32 -> d [caps, mf] i32, eps [caps, mf] f32.
OFDM_API int ofdm_localize(const float* m, const float2* p, const int* cand,
                           int* d, float* eps, int caps, int nd, int mf,
                           int span, int cp_half, float rel, void* stream);

// Frame extraction: capture [caps, n] complex64, ds [caps, mf] i32 ->
// out [caps, mf, frame_len] complex64, zeros past the capture's end.
OFDM_API int ofdm_extract(const float2* capture, const int* ds, float2* out,
                          int caps, int n, int mf, int frame_len,
                          void* stream);

// Strided real-tap FIR over complex rows ('same' FIR at stride 1, M-fold
// decimation at stride M): x [rows, n_in] complex64, w [nt] f32 (the
// correlation weights, i.e. the taps reversed) -> y [rows, n_out],
// y[r, i] = sum_t w[t] * x[r, i*stride + t - pad_left], zeros outside.
OFDM_API int ofdm_fir_strided(const float2* x, const float* w, float2* y,
                              int rows, int n_in, int n_out, int nt,
                              int stride, int pad_left, void* stream);

// L-fold polyphase interpolation: x [rows, n] complex64, g [l, nd] f32
// branch matrix over d = d_max - nd + 1 .. d_max -> y [rows, n * l],
// y[r, k] = sum_d g[k % l, d - d_min] * x[r, k / l - d], zeros outside.
OFDM_API int ofdm_fir_interp(const float2* x, const float* g, float2* y,
                             int rows, int n, int l, int nd, int d_max,
                             void* stream);

// The bf16 tier of the two above (tensor cores, mma.sync bf16 -> f32):
// the same arguments and outputs ('same' padding only), with x and the
// coefficients rounded to bf16 (nearest even) before each product.
OFDM_API int ofdm_fir_bf16_strided(const float2* x, const float* w, float2* y,
                                   int rows, int n_in, int n_out, int nt,
                                   int stride, int pad_left, void* stream);
OFDM_API int ofdm_fir_bf16_interp(const float2* x, const float* g, float2* y,
                                  int rows, int n, int l, int nd, int d_max,
                                  void* stream);

// The shifted-FMA tier (shift.cu, body shift_body.cuh), one float32 FMA
// a tap, complex64 rows read in place (any 8-byte aligned x and y): 'same'
// FIR, x [rows, n] -> y [rows, n], y[r, i] = sum_t w[t] * x[r, i + t -
// pad_left] (w: the nt taps reversed), taps summed in ascending order;
// M-fold decimation, x [rows, n_in] -> y [rows, n_out], y[r, i] = sum_p
// sum_d w[d*m + p] * x[r, (i + d)*m + p - pad_left] (zero past nt), each
// phase summed over d ascending, then the phases in ascending order;
// L-fold interpolation, x [rows, n] -> y [rows, n * l], y[r, i*l + q] =
// sum_e g[q, nd - 1 - e] * x[r, i + e - d_max] (g [l, nd]: the branch
// matrix). Zeros outside each row.
OFDM_API int ofdm_shift_fir(const void* x, const float* w, void* y,
                            int rows, int n, int nt, int pad_left,
                            void* stream);
OFDM_API int ofdm_shift_decim(const void* x, const float* w, void* y,
                              int rows, int n_in, int n_out, int m, int nt,
                              int pad_left, void* stream);
OFDM_API int ofdm_shift_interp(const void* x, const float* g, void* y,
                               int rows, int n, int l, int nd, int d_max,
                               void* stream);
// The plan the launch of those arguments takes on the current device,
// for measurement (kind 2: the interpolation, n_in = n, nt = nd, m = l,
// lead = d_max; else the FIR or the decimation by m, lead = pad_left):
// out[8] = tile, consumer warps, ring stages, blocks an SM, blocks, items,
// shared memory bytes, pieces.
OFDM_API int ofdm_shift_plan(int kind, int rows, int n_in, int n_out, int nt,
                             int m, int lead, int* out);

// The banded tier (banded.cu), float32 accuracy on the tensor cores
// (3xTF32), complex64 rows read in place (any 8-byte aligned x). Strided:
// x [rows, n_in] -> y [rows, n_out], y[r, i] = sum_t w[t] * x[r, i*stride
// + t - pad_left] (w: the taps reversed), zeros outside each row;
// interpolation: x [rows, n] -> y [rows, n * l], y[r, k] = sum_d g[k % l,
// d - d_min] * x[r, k / l - d] over the branch matrix g [l, nd] of d =
// d_max - nd + 1 .. d_max.
OFDM_API int ofdm_banded_strided(const void* x, const float* w, void* y,
                                 int rows, int n_in, int n_out, int nt,
                                 int stride, int pad_left, void* stream);
OFDM_API int ofdm_banded_interp(const void* x, const float* g, void* y,
                                int rows, int n, int l, int nd, int d_max,
                                void* stream);
// The S&C window sums, direct, in one launch from r [rows, n] complex64:
// p [rows, nd] complex64 (window l of conj(r[i]) r[i + l]), rr [rows, nd]
// (0.5 x window 2l of |r|^2), nd = n - 2l + 1.
OFDM_API int ofdm_banded_sc(const void* r, void* p, float* rr, int rows,
                            int n, int l, void* stream);

// Frame extraction by bulk copies (deframe.cu): capture [caps, n]
// complex64, ds [caps, mf] i32 -> out [caps, mf, frame_len]: the samples
// from min(ds, n), zeros past n; an all-zero frame where ds < 0.
OFDM_API int ofdm_deframe(const float2* capture, const int* ds, float2* out,
                          int caps, int n, int mf, int frame_len,
                          void* stream);

// Schmidl-Cox front end: r [rows, n] complex64 -> p [rows, nd] complex64,
// m [rows, nd] f32, nd = n - 2l + 1, l a power of two up to 4096.
OFDM_API int ofdm_scfront(const float2* r, float2* p, float* m, int rows,
                          int n, int l, void* stream);

// Schmidl-Cox correlation alone: r [rows, n] complex64 -> p [rows, nd]
// complex64, rr [rows, nd] f32 (R, no metric), as ofdm_scfront sums them.
OFDM_API int ofdm_sc_correlate(const float2* r, float2* p, float* rr,
                               int rows, int n, int l, void* stream);

// The S&C split route (l above the tile's 4096), at a width w (powers of
// two, w <= l, w <= 16384): set [3, rows, n] f32. Span: set[2][i] = S_w of
// |r|^2 at i < n - w + 1, set[0], set[1] = S_w of the re, im of conj(r[j])
// r[j + l] at i < n - l - w + 1 (the rest not written), S_w[i] the
// pairwise doubling of w values from i. Stride: from those, p [rows, nd]
// complex64 and q [rows, nd] = M (metric) or R, as ofdm_scfront and
// ofdm_sc_correlate give them.
OFDM_API int ofdm_sc_span(const float2* r, float* set, int rows, int n,
                          int l, int w, void* stream);
OFDM_API int ofdm_sc_stride(const float* set, float2* p, float* q, int rows,
                            int n, int l, int w, int metric, void* stream);

// Halo exchange: for each of `pairs` (source, destination) pointer pairs
// (host arrays of device pointers; a source may lie on a peer card whose
// access the caller has enabled), copy h complex64 samples, dst[p][k] =
// src[p][k]; pairs <= 64, launched on the destination device's stream.
OFDM_API int ofdm_halo_from_right(const void* const* src, void* const* dst,
                                  int pairs, int h, void* stream);

// Enable `device`'s access to `peer`'s memory (once per pair; enabled
// already counts as success; the current device is left as it was);
// cudaErrorPeerAccessUnsupported where the two cards cannot reach each
// other.
OFDM_API int ofdm_enable_peer_access(int device, int peer);

// Make `device` current for the kernels' runtime: a launch must go to a
// stream of the current device.
OFDM_API int ofdm_set_device(int device);

OFDM_API const char* ofdm_error_string(int err);
