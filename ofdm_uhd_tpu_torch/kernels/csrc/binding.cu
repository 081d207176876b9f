// Shared part of the C interface bound by kernels/build.py.
#include "ofdm_kernels.h"

OFDM_API int ofdm_set_device(int device) {
    return static_cast<int>(cudaSetDevice(device));
}

OFDM_API const char* ofdm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
