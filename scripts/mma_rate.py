"""The tensor cores' rate through mma.sync on the card: a kernel whose
warps issue only independent mma.sync products (8 accumulators a warp, no
memory traffic) at m16n8k8 .tf32 (the banded tier's product), m16n8k4
.tf32 and m16n8k16 .bf16 (the bf16 filter tier's), at 4 to 32 warps an
SM, timed by CUDA events; prints TFLOP/s and cycles an SM per product at
the card's clock. A yardstick for the banded tier's bound, which counts
its products at the dense TF32 peak (495 TFLOP/s) that only wgmma reaches.

    python3 scripts/mma_rate.py [--out FILE]

Needs an NVIDIA GPU and nvcc; no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

template <int kShape>
__device__ __forceinline__ void product(float (&d)[4], uint32_t a0,
                                        uint32_t a1, uint32_t b0) {
    if (kShape == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%4,%5}, {%6,%6}, {%0,%1,%2,%3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a0), "r"(a1), "r"(b0));
    else if (kShape == 1)
        asm volatile(
            "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a0), "r"(a1), "r"(b0));
    else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%4,%5}, {%6,%6}, {%0,%1,%2,%3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a0), "r"(a1), "r"(b0));
}

template <int kShape>
__global__ void rate_kernel(float* out, int iters, uint32_t seed) {
    float d[8][4] = {};
    const uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3u, b0 = a0 + 7u;
    for (int i = 0; i < iters; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) product<kShape>(d[k], a0, a1, b0);
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
    if (s == 12345.0f) out[threadIdx.x] = s;
}

extern "C" int mma_rate(int shape, int blocks, int warps, int iters,
                        float* out, float* ms) {
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    auto run = [&] {
        if (shape == 0) rate_kernel<0><<<blocks, 32 * warps>>>(out, iters, 1u);
        else if (shape == 1) rate_kernel<1><<<blocks, 32 * warps>>>(out, iters, 1u);
        else rate_kernel<2><<<blocks, 32 * warps>>>(out, iters, 1u);
    };
    run();
    cudaEventRecord(e0);
    run();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(ms, e0, e1);
    cudaEventDestroy(e0);
    cudaEventDestroy(e1);
    return static_cast<int>(cudaGetLastError());
}
"""

SHAPES = {"m16n8k8.tf32": (0, 16 * 8 * 8), "m16n8k4.tf32": (1, 16 * 8 * 4),
          "m16n8k16.bf16": (2, 16 * 8 * 16)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args()
    import torch
    from ofdm_uhd_tpu_torch.kernels import build
    if not torch.cuda.is_available():
        print("mma_rate: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    out_dir = REPO / "build" / "mma_rate"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "rate.cu").write_text(SOURCE)
    subprocess.run([build._nvcc(), *build.FLAGS, "-shared", "-o",
                    str(out_dir / "lib.so"), str(out_dir / "rate.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    lib.mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.split()
    clock = float(smi[0]) * 1e6              # the SM clock's maximum, Hz
    buf = torch.zeros(1024, device="cuda")
    res = {}
    for name, (shape, macs) in SHAPES.items():
        for warps in (4, 8, 16, 32):
            ms = ctypes.c_float()
            iters = 4096
            err = lib.mma_rate(shape, sms, warps, iters, buf.data_ptr(),
                               ctypes.byref(ms))
            if err:
                raise RuntimeError(f"mma_rate: launch error {err}")
            count = sms * warps * iters * 8
            tflops = 2.0 * macs * count / (ms.value * 1e-3) / 1e12
            per_sm = ms.value * 1e-3 * clock / (count / sms)
            res[f"{name} {warps} warps"] = {"ms": ms.value, "tflops": tflops,
                                            "sm_cycles_a_product": per_sm}
            print(f"{name}, {warps} warps an SM: {tflops:.1f} TFLOP/s, "
                  f"{per_sm:.3f} SM cycles a product (clock {clock / 1e9:.3f}"
                  " GHz)", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
