"""Ablation of the banded tier's body (K8 and K13: ofdm_uhd_tpu_torch/
kernels/csrc/banded.cu, body banded_body.cuh) on the card: builds
banded.cu as it is and in variants made by text substitution of its
sources (the tensor-core products left out, the split left out, the bulk
copy left out, the stores left out; one block an SM; 4 or 16 consumer
warps; 2 column blocks an A tile; items of at most 4 tiles; the consumer
loop's phases timed by clock64), each into its own library beside build/,
and times every variant
in-kernel (chip_smoke.device_ms: behind a spin kernel), in turns (in
order, then in reverse), at the tiers phase's shapes: C4's decimation [8,
4,138,472] by 8 (n // 8 outputs) and TX interpolation [32, 16128] by 8,
the session rows [16, 8192] (FIR, decimation, interpolation), the S&C at
l = 128 over C3's captures [8, 4,436,068] and over 2^20 samples; seeded
normal rows, 193 taps. Variants that compute the function are held
within chip_smoke's REL_TOL (R: R_TOL) of the plain versions. Then the
host's cost of one call of each public wrapper at the session size, and
of its parts, in microseconds (no synchronisation: the enqueue alone).

    python3 scripts/banded_ablation.py [--only NAME,..] [--out FILE]

Prints the card's name and power limit, a line a shape and variant, and a
JSON object last; needs an NVIDIA GPU and nvcc (the build's), no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BODY, SOURCE = "banded_body.cuh", "banded.cu"
# no products (the loads they read stay live)
NO_MMA = (BODY, """    asm(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));""",
          """    d[0] += as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1);""")
NO_SPLIT = (BODY, '''                       int tid, int consumers) {
    uint2* p0 = planes;''', '''                       int tid, int consumers) {
    return;
    uint2* p0 = planes;''')
NO_COPY = (BODY, "    if (lane == 0 && b1 > b0)\n",
           "    if (lane == 0 && b1 > b0 && false)\n")
# no global stores of whole lines (16 and 8 bytes)
NO_STORE = (
    (BODY, """    asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "f"(a), "f"(b), "f"(c), "f"(d) : "memory");""", ""),
    (BODY, """    asm volatile("st.global.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(a),
                 "f"(b) : "memory");""", ""))
GOAL_MAX = (SOURCE, "constexpr size_t kSmemGoal = 113 * 1024;",
            "constexpr size_t kSmemGoal = 232448;")
# thread 0's clock at the consumer loop's phase boundaries, summed over the
# blocks into a device array that ofdm_banded_phases reads and clears
PHASE_DEFS = (SOURCE, '#include "banded_body.cuh"\n', r'''__device__ unsigned long long bandk_phase[8];
__host__ __device__ __forceinline__ long long bandk_now() {
#if defined(__CUDA_ARCH__)
    return clock64();
#else
    return 0;
#endif
}
__host__ __device__ __forceinline__ void bandk_mark(long long& mark, int k) {
#if defined(__CUDA_ARCH__)
    if (threadIdx.x == 0) {
        const long long c = clock64();
        atomicAdd(&bandk_phase[k], static_cast<unsigned long long>(c - mark));
        mark = c;
    }
#endif
}
#define BANDK_START long long bandk_mark_v = bandk_now()
#define BANDK_MARK(k) bandk_mark(bandk_mark_v, k)
#include "banded_body.cuh"
''')
PHASE_READ = (SOURCE, "OFDM_API int ofdm_banded_strided(", '''OFDM_API int ofdm_banded_phases(unsigned long long* out, int reset) {
    cudaError_t e = cudaMemcpyFromSymbol(out, bandk_phase, 64);
    unsigned long long z[8] = {};
    if (e == cudaSuccess && reset) e = cudaMemcpyToSymbol(bandk_phase, z, 64);
    return static_cast<int>(e);
}

OFDM_API int ofdm_banded_strided(''')
PHASE_MARKS = (
    (BODY, """    for (long long item = block_id; item < g.items; item += grid, ++n) {
        const int st = static_cast<int>(n & 1);
        pipe.wait_full(st, static_cast<unsigned>((n >> 1) & 1));
""", """    BANDK_START;
    for (long long item = block_id; item < g.items; item += grid, ++n) {
        const int st = static_cast<int>(n & 1);
        pipe.wait_full(st, static_cast<unsigned>((n >> 1) & 1));
        BANDK_MARK(0);
"""),
    (BODY, """        pipe.arrive_empty(st);
        csync();                 // the planes are in place
""", """        BANDK_MARK(1);
        pipe.arrive_empty(st);
        csync();                 // the planes are in place
        BANDK_MARK(2);
"""),
    (BODY, """            csync();             // every task's sums are in place
""", """            BANDK_MARK(3);
            csync();             // every task's sums are in place
            BANDK_MARK(4);
"""),
    (BODY, """            csync();             // the planes may take the next item
""", """            BANDK_MARK(3);
            csync();             // the planes may take the next item
            BANDK_MARK(4);
"""),
    (BODY, "        }\n    }\n}\n\n}  // namespace bandk",
     "        }\n        BANDK_MARK(5);\n    }\n}\n\n}  // namespace bandk"))
PHASES = ("wait_full", "split", "csync_planes", "mma_put", "csync_sums",
          "store")


# the same plan on one block an SM (a grid of the SM count)
ONE_PER_SM = (SOURCE, "(per_sm[dev] > 0 ? per_sm[dev] : 1);", "1;")


def const(name, value, new, where=BODY):
    return (where, f"constexpr int {name} = {value};",
            f"constexpr int {name} = {new};")


def warps(n):
    return (SOURCE, "constexpr int kWarps = 8;", f"constexpr int kWarps = {n};")


# name: (substitutions, whether the variant still computes the function)
VARIANTS = {
    "as_built": ((), True),
    "no_mma": ((NO_MMA,), False),
    "no_split": ((NO_SPLIT,), False),
    "no_copy": ((NO_COPY,), False),
    "no_store": (NO_STORE, False),
    "one_block_an_sm": ((GOAL_MAX,), True),
    "warps_4": ((warps(4),), True),
    "warps_16": ((warps(16),), True),
    "strided_nb2": ((const("kNbStrided", 1, 2),), True),
    "sc_nb2": ((const("kNbSc", 4, 2),), True),
    "max_tiles_4": ((const("kMaxTiles", 16, 4),), True),
    "phases": ((PHASE_DEFS, PHASE_READ) + PHASE_MARKS, True),
    "phases_one_per_sm": ((PHASE_DEFS, PHASE_READ, ONE_PER_SM) + PHASE_MARKS,
                          True),

}


def variant_sources(subs) -> dict:
    """{file: text} of banded.cu and its body with each (file, old, new)
    substitution made once; raises where a source no longer holds old."""
    from ofdm_uhd_tpu_torch.kernels import build
    out = {f: (build.CSRC / f).read_text() for f in (BODY, SOURCE)}
    for f, old, new in subs:
        if out[f].count(old) != 1:
            raise ValueError(f"{f} no longer holds {old!r}")
        out[f] = out[f].replace(old, new)
    return out


def build_variants(out: Path, names) -> dict:
    """One library a variant (banded.cu beside its variant of the body; a
    quoted include looks beside the includer first), nvcc all at once."""
    from ofdm_uhd_tpu_torch.kernels import build
    procs = {}
    for name in names:
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in variant_sources(VARIANTS[name][0]).items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-Xptxas", "-v", "-shared", "-I",
             str(build.CSRC), "-o", str(d / "lib.so"), str(d / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:                # reported and left out
            print(f"{name}: nvcc failed\n{log[-3000:]}", flush=True)
            continue
        regs = sorted({ln.split("Used ")[1].split(" registers")[0]
                       for ln in log.splitlines() if "registers" in ln})
        print(f"{name}: registers {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.ofdm_banded_strided.argtypes = [p_] * 3 + [i_] * 6 + [p_]
        lib.ofdm_banded_interp.argtypes = [p_] * 3 + [i_] * 5 + [p_]
        lib.ofdm_banded_sc.argtypes = [p_] * 3 + [i_] * 3 + [p_]
        if name.startswith("phases"):
            lib.ofdm_banded_phases.argtypes = [p_, i_]
        libs[name] = lib
    return libs


def cases(torch, cs):
    """{shape: (launch(lib), output, plain output, close)} at the tiers
    phase's shapes."""
    from ofdm_uhd_tpu_torch.kernels import banded, fir
    from ofdm_uhd_tpu_torch.phy.tables import resample_filter
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    taps = resample_filter(8, 1)
    _, w, pad = fir._corr_weights(taps)
    wt = torch.from_numpy(w.copy()).to(dev)
    g, _, d_max = fir.branch_matrix(taps, 8)
    gt = torch.from_numpy(g).to(dev)
    stream = torch.cuda.current_stream().cuda_stream

    def rows(shape):
        return torch.randn(shape, dtype=torch.complex64, generator=gen,
                           device=dev)

    def strided(x, m):
        r, n = x.shape
        y = torch.empty((r, n // m), dtype=torch.complex64, device=dev)
        return (lambda lib: lib.ofdm_banded_strided(
            x.data_ptr(), wt.data_ptr(), y.data_ptr(), r, n, n // m, len(w),
            m, pad, stream), y, fir.decim_plain(x, m, taps), cs.rel_close)

    def interp(x):
        r, n = x.shape
        y = torch.empty((r, n * 8), dtype=torch.complex64, device=dev)
        return (lambda lib: lib.ofdm_banded_interp(
            x.data_ptr(), gt.data_ptr(), y.data_ptr(), r, n, 8, g.shape[1],
            d_max, stream), y, fir.interp_plain(x, 8, taps), cs.rel_close)

    def sc(x, l=128):
        r, n = x.shape
        nd = n - 2 * l + 1
        p = torch.empty((r, nd), dtype=torch.complex64, device=dev)
        rr = torch.empty((r, nd), dtype=torch.float32, device=dev)
        return (lambda lib: lib.ofdm_banded_sc(
            x.data_ptr(), p.data_ptr(), rr.data_ptr(), r, n, l, stream),
            (p, rr), banded.sc_correlate_banded_plain(x, l), cs.sc_close)

    session = rows((16, 8192))
    return {"decim_c4": strided(rows((8, 4_138_472)), 8),
            "interp_c4": interp(rows((32, 16128))),
            "fir_session": strided(session, 1),
            "decim_session": strided(session, 8),
            "interp_session": interp(session),
            "sc_c3": sc(rows((8, 4_436_068))),
            "sc_2e20": sc(rows((1, 1 << 20)))}


def phase_cycles(torch, lib, launch) -> dict:
    """The phases variant's counters over one launch: thread 0's cycles in
    each phase of the consumer loop, summed over the blocks."""
    import numpy as np
    buf = np.zeros(8, np.uint64)
    lib.ofdm_banded_phases(buf.ctypes.data, 1)
    launch(lib)
    torch.cuda.synchronize()
    lib.ofdm_banded_phases(buf.ctypes.data, 1)
    return {k: int(v) for k, v in zip(PHASES, buf)}


def host_costs(torch) -> dict:
    """Microseconds of host time a call, over 2000 calls without a
    synchronisation, of each public wrapper at the session size and of its
    parts."""
    import numpy as np
    from ofdm_uhd_tpu_torch.kernels import banded, build, fir
    from ofdm_uhd_tpu_torch.phy.tables import resample_filter
    from ofdm_uhd_tpu_torch.research import fir_ilv
    dev = torch.device("cuda", 0)
    x = torch.randn((16, 8192), dtype=torch.complex64, device=dev)
    taps = resample_filter(8, 1)
    lib = build.library()
    runs = {
        "fir_banded": lambda: banded.fir_banded(x, taps),
        "polyphase_decim_banded": lambda: banded.polyphase_decim_banded(
            x, 8, taps),
        "fir_ilv": lambda: fir_ilv.fir_ilv(x, taps),
        "polyphase_interp_banded": lambda: banded.polyphase_interp_banded(
            x, 8, taps),
        "torch.empty": lambda: torch.empty((16, 8192),
                                           dtype=torch.complex64,
                                           device=dev),
        "build.stream_ptr": lambda: build.stream_ptr(dev),
        "taps bytes + _weights": lambda: banded._weights(
            np.asarray(taps, np.float32).tobytes(), dev),
        "fir._rows": lambda: fir._rows(x, "banded_fir"),
        "ctypes, no launch": lambda: lib.ofdm_banded_strided(
            0, 0, 0, 0, 0, 0, 0, 1, 0, 0),
    }
    out = {}
    for name, fn in runs.items():
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        out[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        print(f"host: {name}: {out[name]:.2f} us a call", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", help="comma-separated variants (and as_built)")
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    names = list(VARIANTS)
    if args.only:
        names = ["as_built"] + [n for n in args.only.split(",")
                                if n != "as_built"]
    try:
        dev_info = cs.phase_device(torch)
        torch.cuda.set_device(0)
        libs = build_variants(REPO / "build" / "banded_ablation", names)
        res = {}
        for shape, (launch, y, ref, close) in cases(torch, cs).items():
            res[shape] = {}
            for name, lib in libs.items():
                err = launch(lib)
                cs.check(err == 0, f"{name} {shape}: launch error {err}")
                torch.cuda.synchronize()
                entry = res[shape][name] = {"ms": []}
                if VARIANTS[name][1]:
                    ok, e = close(y, ref)
                    cs.check(ok, f"{name} {shape}: off by {e}")
                    entry["err"] = e
            built = [n for n in names if n in libs]
            for name in built + built[::-1]:
                res[shape][name]["ms"].append(cs.device_ms(
                    torch, lambda lib=libs[name]: launch(lib)))
            for name in built:
                if name.startswith("phases"):
                    res[shape][name]["cycles"] = phase_cycles(
                        torch, libs[name], launch)
            for name, entry in res[shape].items():
                print(f"{shape} {name}: in-kernel " + " / ".join(
                    "none" if t is None else f"{t:.4f}"
                    for t in entry["ms"]) + " ms" + ("  thread 0's cycles: "
                    + ", ".join(f"{k} {v}" for k, v in entry["cycles"].items())
                    if "cycles" in entry else ""), flush=True)
        host = host_costs(torch)
    except cs.SmokeFailure as e:
        print(f"banded_ablation: FAILED: {e}", file=sys.stderr)
        return 1
    out = {"device": dev_info, "results": res, "host_us": host}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
