"""Ablation of the shifted-FMA tier's body (K11: ofdm_uhd_tpu_torch/
kernels/csrc/shift.cu, body shift_body.cuh) on the card: builds shift.cu
as it is and in variants made by text substitution of its sources
(other outputs a thread, kR, for the FIR, the decimation and the
interpolation; one or two phase planes a decimation pass; two or three
raw stages only, or one (no ring: the next item's copy in flight during
the sums only); 8 consumer warps a block tried first, or another order
of the warps the plan tries; one or four (group, branch) pairs a thread an
interpolation item; three or four output buffers; one or three ring
stages a decimation span; the taps read one float at a time; the split,
the bulk copy or the bulk store left out),
each into its own library beside build/, and
times every variant in-kernel (chip_smoke.device_ms: behind a spin
kernel), in turns (in order, then in reverse), at the shift phase's
shapes: the 193- and 3-tap FIR and the decimation by 8 over 2^20 samples,
the interpolation by 8 over 2^17, C4's decimation [8, 4,138,472] by 8 and
TX interpolation [32, 16128] by 8; seeded normal rows, the 193-tap
prototype. Variants that compute the function are held within
chip_smoke's REL_TOL of the plain versions.

    python3 scripts/shift_ablation.py [--only NAME,..] [--out FILE]

Prints the card's name and power limit, each variant's registers, a line
a shape and variant, and a JSON object last; needs an NVIDIA GPU and nvcc
(the build's), no JAX.
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

BODY, SOURCE = "shift_body.cuh", "shift.cu"
R_LINE = "constexpr int kRFir = 9, kRDecim = 5, kRInterp = 9;"


def outputs_a_thread(fir=9, decim=5, interp=9):
    return (SOURCE, R_LINE, f"constexpr int kRFir = {fir}, kRDecim = "
            f"{decim}, kRInterp = {interp};")


STAGES = "constexpr int kMinStages = 2, kMaxStages = 3;"
ORDER = "constexpr int kOrder[3] = {4, 2, 1};"
WARPS = "constexpr int kMaxWarps = 4; "
WARPS_8 = ((BODY, ORDER, "constexpr int kOrder[4] = {8, 4, 2, 1};"),
           (SOURCE, WARPS, WARPS.replace("4", "8")))
WARP_ORDER_2 = (BODY, ORDER, ORDER.replace("{4, 2, 1}", "{2, 4, 1}"))
WARP_ORDER_1 = (BODY, ORDER, ORDER.replace("{4, 2, 1}", "{1, 2, 4}"))
SCALAR_TAPS = ("""                const float4 q =
                    *reinterpret_cast<const float4*>(w[j] + c * CF + v);
                t[j][v] = q.x, t[j][v + 1] = q.y, t[j][v + 2] = q.z,
                t[j][v + 3] = q.w;""", """                const float* q = w[j] + c * CF + v;
                t[j][v] = q[0], t[j][v + 1] = q[1], t[j][v + 2] = q[2],
                t[j][v + 3] = q[3];""")
PASS = "constexpr int kPhasesAPass = 4;"
PIECES = "constexpr int kPieces = 2;"
PASSES = "constexpr int kInterpPasses = 2;"
BUFFERS = "constexpr int kOutBuffers = 2;"
NO_SPLIT = (BODY, """                   float2* planes, int tid, int consumers) {
    const int dq""", """                   float2* planes, int tid, int consumers) {
    return;
    const int dq""")
NO_COPY = (BODY, "    if (lane == 0 && b1 > b0)\n",
           "    if (lane == 0 && b1 > b0 && false)\n")
NO_STORE = (BODY, "    if (a1 > a0) {\n        bulk_store(",
            "    if (a1 > a0 && false) {\n        bulk_store(")

# name: (substitutions, whether the variant still computes the function)
VARIANTS = {
    "as_built": ((), True),
    "r_fir_7": ((outputs_a_thread(fir=7),), True),
    "r_fir_11": ((outputs_a_thread(fir=11),), True),
    "r_fir_13": ((outputs_a_thread(fir=13),), True),
    "r_decim_3": ((outputs_a_thread(decim=3),), True),
    "r_decim_7": ((outputs_a_thread(decim=7),), True),
    "r_interp_7": ((outputs_a_thread(interp=7),), True),
    "r_interp_11": ((outputs_a_thread(interp=11),), True),
    "r_interp_13": ((outputs_a_thread(interp=13),), True),
    "phases_a_pass_1": (((BODY, PASS, PASS.replace("4", "1")),), True),
    "phases_a_pass_2": (((BODY, PASS, PASS.replace("4", "2")),), True),
    "stages_1": (((BODY, STAGES, STAGES.replace("= 2,", "= 1,")),), True),
    "stages_2": (((BODY, STAGES, STAGES.replace("= 3;", "= 2;")),), True),
    "stages_3": (((BODY, STAGES, STAGES.replace("= 2,", "= 3,")),), True),
    "warps_8": (WARPS_8, True),
    "warps_first_2": ((WARP_ORDER_2,), True),
    "warps_first_1": ((WARP_ORDER_1,), True),
    "interp_passes_1": (((BODY, PASSES, PASSES.replace("2", "1")),), True),
    "interp_passes_4": (((BODY, PASSES, PASSES.replace("2", "4")),), True),
    "out_buffers_3": (((BODY, BUFFERS, BUFFERS.replace("2", "3")),), True),
    "out_buffers_4": (((BODY, BUFFERS, BUFFERS.replace("2", "4")),), True),
    "pieces_1": (((BODY, PIECES, PIECES.replace("2", "1")),), True),
    "pieces_3": (((BODY, PIECES, PIECES.replace("2", "3")),), True),
    "scalar_taps": (((BODY,) + SCALAR_TAPS,), True),
    "no_split": ((NO_SPLIT,), False),
    "no_copy": ((NO_COPY,), False),
    "no_store": ((NO_STORE,), False),
}


def variant_sources(subs) -> dict:
    """{file: text} of shift.cu and its body with each (file, old, new)
    substitution made (every occurrence, at least one)."""
    from ofdm_uhd_tpu_torch.kernels import build
    out = {f: (build.CSRC / f).read_text() for f in (BODY, SOURCE)}
    for f, old, new in subs:
        if old not in out[f]:
            raise ValueError(f"{f} no longer holds {old!r}")
        out[f] = out[f].replace(old, new)
    return out


def build_variants(out: Path, names) -> dict:
    """One library a variant (shift.cu beside its variant of the body; a
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
        regs = [ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                if "Used " in ln]
        print(f"{name}: registers {', '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.ofdm_shift_fir.argtypes = [p_] * 3 + [i_] * 4 + [p_]
        lib.ofdm_shift_decim.argtypes = [p_] * 3 + [i_] * 6 + [p_]
        lib.ofdm_shift_interp.argtypes = [p_] * 3 + [i_] * 5 + [p_]
        lib.ofdm_shift_plan.argtypes = [i_] * 7 + [p_]
        libs[name] = lib
    return libs


def cases(torch, cs):
    """{shape: (launch(lib), output, plain output, plan(lib))} at the shift
    phase's shapes; plan(lib): the plan the launch takes (ofdm_shift_plan:
    tile, warps, stages, blocks an SM, blocks, items, shared memory,
    pieces)."""
    from ofdm_uhd_tpu_torch.kernels import fir
    from ofdm_uhd_tpu_torch.phy.tables import resample_filter
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    taps = resample_filter(8, 1)
    taps3 = [0.25, 0.5, 0.25]
    stream = torch.cuda.current_stream().cuda_stream

    def rows(shape):
        return torch.randn(shape, dtype=torch.complex64, generator=gen,
                           device=dev)

    def plan(lib, *args):
        out = (ctypes.c_int * 8)()
        cs.check(lib.ofdm_shift_plan(*args, out) == 0, f"no plan for {args}")
        return list(out)

    def phase(x, m, t):
        r, n = x.shape
        _, w, pad = fir._corr_weights(t)
        wt = torch.from_numpy(w.copy()).to(dev)
        y = torch.empty((r, n // m), dtype=torch.complex64, device=dev)
        return (lambda lib: lib.ofdm_shift_decim(
            x.data_ptr(), wt.data_ptr(), y.data_ptr(), r, n, n // m, m,
            len(w), pad, stream), y, fir.decim_plain(x, m, t),
            lambda lib: plan(lib, 0, r, n, n // m, len(w), m, pad))

    def interp(x):
        r, n = x.shape
        g, _, d_max = fir.branch_matrix(taps, 8)
        gt = torch.from_numpy(g).to(dev)
        y = torch.empty((r, n * 8), dtype=torch.complex64, device=dev)
        return (lambda lib: lib.ofdm_shift_interp(
            x.data_ptr(), gt.data_ptr(), y.data_ptr(), r, n, 8, g.shape[1],
            d_max, stream), y, fir.interp_plain(x, 8, taps),
            lambda lib: plan(lib, 2, r, n, n * 8, g.shape[1], 8, d_max))

    x = rows((1, 1 << 20))
    return {"fir_193": phase(x, 1, taps), "fir_3": phase(x, 1, taps3),
            "decim_2e20": phase(x, 8, taps),
            "interp_2e17": interp(rows((1, 1 << 17))),
            "decim_c4": phase(rows((8, 4_138_472)), 8, taps),
            "interp_c4": interp(rows((32, 16128)))}


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
        libs = build_variants(REPO / "build" / "shift_ablation", names)
        res = {}
        for shape, (launch, y, ref, plan) in cases(torch, cs).items():
            res[shape] = {}
            for name, lib in libs.items():
                err = launch(lib)
                cs.check(err == 0, f"{name} {shape}: launch error {err}")
                torch.cuda.synchronize()
                entry = res[shape][name] = {"ms": [], "plan": plan(lib)}
                if VARIANTS[name][1]:
                    ok, e = cs.rel_close(y, ref)
                    cs.check(ok, f"{name} {shape}: off by {e}")
                    entry["err"] = e
            built = [n for n in names if n in libs]
            for name in built + built[::-1]:
                res[shape][name]["ms"].append(cs.device_ms(
                    torch, lambda lib=libs[name]: launch(lib)))
            for name, entry in res[shape].items():
                print(f"{shape} {name}: in-kernel " + " / ".join(
                    "none" if t is None else f"{t:.4f}"
                    for t in entry["ms"]) + " ms  plan " + str(entry["plan"]),
                    flush=True)
    except cs.SmokeFailure as e:
        print(f"shift_ablation: FAILED: {e}", file=sys.stderr)
        return 1
    out = {"device": dev_info, "results": res}
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
