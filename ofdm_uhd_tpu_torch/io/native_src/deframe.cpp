// Native IQ deframer: the host-side C++ tier of the IO layer.
//
// A copy of ofdm_uhd_tpu/io/native_src/deframe.cpp. A UHD-class radio's
// native code is its C++ streamer plus SIMD sample-format conversion
// (sc16 <-> fc32) on the host; with files and streams in place of the
// radio, the surviving native role is this conversion, on the host feed
// into the device. Built with g++ -O3 (auto-vectorized) at first use into
// the port's build directory (ofdm_uhd_tpu_torch/io/native.py).
//
// Exposed C ABI (loaded via ctypes from ofdm_uhd_tpu_torch.io.native):
//   sc16_to_fc32(in int16[2n], out float[2n], n)     interleaved IQ -> c64
//   fc32_to_sc16(in float[2n], out int16[2n], n)     with clip+round
//   block_power(in float[2n], n) -> double           mean |x|^2 (AGC feed)

#include <cstdint>
#include <cmath>

extern "C" {

void sc16_to_fc32(const int16_t* in, float* out, long n) {
    const float scale = 1.0f / 32767.0f;
    for (long i = 0; i < 2 * n; ++i) {
        out[i] = static_cast<float>(in[i]) * scale;
    }
}

void fc32_to_sc16(const float* in, int16_t* out, long n) {
    for (long i = 0; i < 2 * n; ++i) {
        float v = in[i] * 32767.0f;
        if (v > 32767.0f) v = 32767.0f;
        if (v < -32768.0f) v = -32768.0f;
        out[i] = static_cast<int16_t>(std::lrintf(v));
    }
}

double block_power(const float* in, long n) {
    double acc = 0.0;
    for (long i = 0; i < 2 * n; ++i) {
        acc += static_cast<double>(in[i]) * in[i];
    }
    return n > 0 ? acc / n : 0.0;
}

}  // extern "C"
