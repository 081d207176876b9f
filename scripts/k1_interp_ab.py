"""K1, the plateau localizer (ofdm_uhd_tpu_torch/kernels/csrc/localize.cu,
body csrc/localize_warp.cuh), and K7's exact interpolation (csrc/fir.cu
ofdm_fir_interp, body csrc/fir_interp.cuh) on the card, as built and in
variants made by text substitution of their bodies, each into its own
library beside build/; --against DIR adds another checkout's
ofdm_localize and ofdm_fir_interp (DIR's localize.cu and fir.cu as they
are), e.g. a parent commit's.

K1 variants: the slots a warp takes (kRowSlots: 1, 2 or 8 in place of
4), blocks of 4 or 16 warps, P loaded at the warp's peak after the
argmax (p_after), and the block body (spans above 1152) at 8 or 32 warps
a block and 36 loads a thread; and, computing something else, no P load
(no_p) and every slot read as a sentinel's (index_only). Interpolation
variants: 8, 10 or 14 inputs a thread (kQ), blocks of 64 or 256
threads, registers for 2 or 3 blocks an SM (min_blocks); and,
computing something else, no sums (memory_only), no stores to device
memory (no_stores) and half the sums (half_fma).

K1 inputs, seeded, at the shapes and found counts of the paths'
candidates (C3 [8, 4120] with 1024 found a row, span 288; C4 [8, 152],
32 found, span 1152; c2_pallas [32, 536], 128 found, span 80; C5 [1,
4120], 954 found; big_nsc 4096 and 32768 [4, 40], 4 found, spans 4608
and 36,864): found offsets ascending and evenly spaced, the rest the
sentinel nd, over a metric of uniform samples to the fourth power with a
plateau at each found offset. Interpolation inputs: C4's TX frames [32,
16128] by 8 (193 taps), the shift phase's 2^17 samples by 8, the tiers
phase's [16, 8192] by 8, and [8, 20011] by 2 (49 taps) and by 8 with 321
taps (nd = 41, the taps in chunks). Every variant that computes the
function and DIR's kernels must give the bits of the kernel as built (d
and eps; y), which must agree with the plain version (d exact, eps
within 1e-6; y within 1e-5 of max|y|); all are timed in-kernel
(chip_smoke.device_ms: behind a spin kernel) in turns, in order and then
in reverse.

    python3 scripts/k1_interp_ab.py [--against DIR] [--only LABEL,..]
                                    [--out FILE]

Prints each variant's registers, a line a shape and variant, and a JSON
object last; exits 1 if a kernel gives other bits. Needs an NVIDIA GPU
and nvcc (the build's), no JAX.
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

K1_BODY = "localize_warp.cuh"
K1_SOURCE = "localize.cu"
K7_BODY = "fir_interp.cuh"
K7_SOURCE = "fir.cu"
# the sources each kernel's library compiles, beside its source
FILES = {"localize": (K1_SOURCE, K1_BODY),
         "interp": (K7_SOURCE, K7_BODY, "fir_strided.cuh")}


def row_slots(f):
    return ("constexpr int kRowSlots = 4;",
            f"constexpr int kRowSlots = {f};")


def warps(f):
    return ("constexpr int kWarpsPerBlock = 8;",
            f"constexpr int kWarpsPerBlock = {f};")


P_LOAD = "    const float2 pv = corr(a, a.p + cap * a.nd, c, bi);\n"
ARGMAX = "    argmax_warp(warp, lane, best, bi);\n"
# P loaded by every lane at the warp's peak, after the argmax (one address)
P_AFTER = ((P_LOAD + ARGMAX, ARGMAX + P_LOAD),)
# no P load: eps of P = 0
NO_P = ((P_LOAD, P_LOAD.replace("c, bi)", "a.nd, 0)")),)
# every slot read as a sentinel's: the index loads and the stores alone
INDEX_ONLY = (("        mine = imin(imax(a.cand[slot], 0), a.nd);",
               "        mine = a.cand[slot] == -2147483647 - 1 ? 0 : a.nd;"),)
# the interpolation without its sums (staging, barriers, stores of zeros)
FMA_RE = "                            re[q] = fmaf(h[t], sx, re[q]);\n"
FMA_IM = "                            im[q] = fmaf(h[t], sy, im[q]);\n"
MEMORY_ONLY = ((FMA_RE + FMA_IM, ""),)
# ... and without its stores to device memory (a test that never holds
# keeps the sums)
NO_STORES = (("    if (base % 2 == 0) {", "    if (os[0].x == 1234.5f) {"),
             ("        for (int k = tid; k < count; k += g.threads) yt[k] = os[k];",
              "        for (int k = tid; k < count; k += g.threads)\n"
              "            if (os[k].x == 1234.5f) yt[k] = os[k];"))
# half the sums: the imaginary parts' FMAs left out
HALF_FMA = ((FMA_IM, ""),)


def min_blocks(b):
    """__launch_bounds__(threads, b): registers for b blocks an SM"""
    return {K7_SOURCE: ((
        "__global__ void __launch_bounds__(fii::kThreads)\n",
        f"__global__ void __launch_bounds__(fii::kThreads, {b})\n"),)}


def interp_const(name, old, new):
    return {K7_BODY: ((f"constexpr int {name} = {old};",
                       f"constexpr int {name} = {new};"),)}


# name: (kernel, {file: substitutions}, computes the function)
VARIANTS = {
    "as_built": ("localize", {}, True),
    "row_slots_1": ("localize", {K1_BODY: (row_slots(1),)}, True),
    "row_slots_2": ("localize", {K1_BODY: (row_slots(2),)}, True),
    "row_slots_8": ("localize", {K1_BODY: (row_slots(8),)}, True),
    "warps_4": ("localize", {K1_BODY: (warps(4),)}, True),
    "warps_16": ("localize", {K1_BODY: (warps(16),)}, True),
    "p_after": ("localize", {K1_BODY: P_AFTER}, True),
    "no_p": ("localize", {K1_BODY: NO_P}, False),
    "index_only": ("localize", {K1_BODY: INDEX_ONLY}, False),
    "block_8": ("localize", {K1_BODY: ((
        "constexpr int kBlockWarps = 16;",
        "constexpr int kBlockWarps = 8;"),)}, True),
    "block_32": ("localize", {K1_BODY: ((
        "constexpr int kBlockWarps = 16;",
        "constexpr int kBlockWarps = 32;"),)}, True),
    "block_loads_36": ("localize", {K1_BODY: ((
        "constexpr int kBlockLoads = 18;",
        "constexpr int kBlockLoads = 36;"),)}, True),
    "interp_as_built": ("interp", {}, True),
    "q8": ("interp", interp_const("kQ", 12, 8), True),
    "q10": ("interp", interp_const("kQ", 12, 10), True),
    "q14": ("interp", interp_const("kQ", 12, 14), True),
    "threads_64": ("interp", interp_const("kThreads", 128, 64), True),
    "threads_256": ("interp", interp_const("kThreads", 128, 256), True),
    "min_blocks_2": ("interp", min_blocks(2), True),
    "min_blocks_3": ("interp", min_blocks(3), True),
    "memory_only": ("interp", {K7_BODY: MEMORY_ONLY}, False),
    "half_fma": ("interp", {K7_BODY: HALF_FMA}, False),
    "no_stores": ("interp", {K7_BODY: NO_STORES}, False),
}
# the block body's variants run only above a span of 1152; the others only
# at or below it
BLOCK_VARIANTS = ("block_8", "block_32", "block_loads_36")

# label: (caps, nd, mf, found a row, span, cp)
K1_SHAPES = {"c3": (8, 4_435_813, 4120, 1024, 288, 32),
             "c4": (8, 516_286, 152, 32, 1152, 128),
             "c2_pallas": (32, 181_797, 536, 128, 80, 16),
             "c5": (1, 4_132_801, 4120, 954, 288, 32),
             "big_nsc_4096": (4, 70_933, 40, 4, 4608, 512),
             "big_nsc_32768": (4, 558_357, 40, 4, 36_864, 4096)}
# label: (rows, n, l, taps: None = resample_filter(l, 1), or a seeded count)
K7_SHAPES = {"c4_tx": (32, 16128, 8, None),
             "shift_2e17": (1, 1 << 17, 8, None),
             "tiers_16x8192": (16, 8192, 8, None),
             "l2": (8, 20011, 2, None),
             "nd41": (8, 20011, 8, 321)}


def substituted(text: str, subs, name: str) -> str:
    """text with each (old, new) substitution made once; raises where the
    source no longer holds `old`."""
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name} no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def kernel_of(name: str) -> str:
    """'localize' or 'interp': the kernel a library of build_variants
    holds."""
    if name in VARIANTS:
        return VARIANTS[name][0]
    return "interp" if name == "interp_against" else "localize"


def bind(lib, kernel) -> None:
    pt, i = ctypes.c_void_p, ctypes.c_int
    if kernel == "localize":
        lib.ofdm_localize.argtypes = [pt, pt, pt, pt, pt, i, i, i, i, i,
                                      ctypes.c_float, pt]
    else:
        lib.ofdm_fir_interp.argtypes = [pt, pt, pt, i, i, i, i, i, pt]


def build_variants(out: Path, against: Path | None) -> tuple[dict, dict]:
    """One library a variant (its copies of the kernel's source and
    headers, the shared C header beside them) and `against`'s localize.cu
    and fir.cu as they are, all nvcc processes started together: ({name:
    CDLL}, {name: ptxas registers of its kernels})."""
    import chip_smoke as cs
    from ofdm_uhd_tpu_torch.kernels import build
    procs = {}

    def nvcc(name, src, include):
        (out / name).mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-Xptxas", "-v", "-shared", "-I",
             str(include), "-o", str(out / name / "lib.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, (kernel, subs, _) in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f in FILES[kernel]:
            text = (build.CSRC / f).read_text()
            (d / f).write_text(substituted(text, subs.get(f, ()), f))
        nvcc(name, d / FILES[kernel][0], build.CSRC)
    if against is not None:
        csrc = against / "ofdm_uhd_tpu_torch" / "kernels" / "csrc"
        nvcc("against", csrc / K1_SOURCE, csrc)
        nvcc("interp_against", csrc / K7_SOURCE, csrc)
    libs, regs = {}, {}
    for name, p in procs.items():
        log, _ = p.communicate()
        (out / name / "nvcc.log").write_text(log)
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        regs[name] = {k: v for k, v in cs.kernel_registers(log).items()
                      if k.startswith(("localize", "fir_interp"))}
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        bind(lib, kernel_of(name))
        libs[name] = lib
    return libs, regs


def check_err(err, what):
    if err:
        raise RuntimeError(f"{what}: launch error {err}")


def k1_inputs(torch, gen, dev, caps, nd, mf, found, span):
    """(m, p, cand) of a path's shape: `found` ascending, evenly spaced
    offsets a row, each at a plateau of 0.9, then the sentinel nd."""
    m = torch.rand((caps, nd), generator=gen, device=dev) ** 4
    p = torch.randn((caps, nd), dtype=torch.complex64, generator=gen,
                    device=dev)
    step = nd // (found + 1)
    pos = torch.arange(found, device=dev) * step + step // 2
    for r in range(caps):
        for k in pos.tolist():
            m[r, k + span // 4:k + span // 4 + span // 2] = 0.9
    cand = torch.full((caps, mf), nd, dtype=torch.int32, device=dev)
    cand[:, :found] = pos.to(torch.int32)
    return m, p, cand


def k1_runs(torch, libs, args, stream, span) -> dict:
    """{name: a function launching its ofdm_localize} on args = (m, p,
    cand, cp), into its own (d, eps)."""
    m, p, cand, cp = args
    caps, nd = m.shape
    mf = cand.shape[1]
    runs = {}
    for name, lib in libs.items():
        if kernel_of(name) != "localize" or (
                name in VARIANTS and name != "as_built"
                and (name in BLOCK_VARIANTS) != (span > 1152)):
            continue
        d = torch.empty((caps, mf), dtype=torch.int32, device=m.device)
        eps = torch.empty((caps, mf), dtype=torch.float32, device=m.device)

        def run(lib=lib, d=d, eps=eps):
            check_err(lib.ofdm_localize(
                m.data_ptr(), p.data_ptr(), cand.data_ptr(), d.data_ptr(),
                eps.data_ptr(), caps, nd, mf, span, cp // 2, 0.9, stream),
                "localize")
            return d, eps
        runs[name] = run
    return runs


def k7_runs(torch, libs, x, l, taps, stream) -> dict:
    """{name: a function launching its ofdm_fir_interp} on x by l."""
    import numpy as np
    from ofdm_uhd_tpu_torch.kernels import fir
    g, _, d_max = fir.branch_matrix(taps, l)
    gt = torch.from_numpy(np.ascontiguousarray(g)).to(x.device)
    rows, n = x.shape
    runs = {}
    for name, lib in libs.items():
        if kernel_of(name) != "interp":
            continue
        y = torch.empty((rows, n * l), dtype=torch.complex64, device=x.device)

        def run(lib=lib, y=y):
            check_err(lib.ofdm_fir_interp(
                x.data_ptr(), gt.data_ptr(), y.data_ptr(), rows, n, l,
                g.shape[1], d_max, stream), "interp")
            return (y,)
        runs[name] = run
    return runs


def in_turns(torch, cs, runs, want, entry) -> list:
    """Each run's bits against `want` and its in-kernel ms in turns (in
    order, then in reverse); returns the names whose bits differ."""
    wrong = []
    for name, fn in runs.items():
        got = fn()
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
        entry[name] = {"ms": [], "equal": equal}
        if not equal and (name not in VARIANTS or VARIANTS[name][2]):
            wrong.append(name)
    for name in list(runs) + list(runs)[::-1]:
        entry[name]["ms"].append(cs.device_ms(torch, runs[name]))
    return wrong


def log_entry(label, entry, names) -> None:
    for name in names:
        e = entry[name]
        print(f"{label} {name}: in-kernel "
              + " / ".join("none" if t is None else f"{t:.4f}"
                           for t in e["ms"])
              + " ms" + (", bits equal" if e["equal"] else ", bits DIFFER"),
              flush=True)


def run(torch, cs, out_file, against, only) -> int:
    import numpy as np
    from ofdm_uhd_tpu_torch.kernels import fir, localize
    from ofdm_uhd_tpu_torch.phy.tables import resample_filter
    dev_info = cs.phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs, regs = build_variants(REPO / "build" / "k1_interp_ab", against)
    for name, r in regs.items():
        print(f"registers {name}: " + ", ".join(
            f"{k} {v[0]} ({v[1]} B spilled)" for k, v in sorted(r.items())),
            flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    res, wrong = {}, []
    for label, (caps, nd, mf, found, span, cp) in K1_SHAPES.items():
        if only and label not in only:
            continue
        m, p, cand = k1_inputs(torch, gen, dev, caps, nd, mf, found, span)
        runs = k1_runs(torch, libs, (m, p, cand, cp), stream, span)
        want = [t.clone() for t in runs["as_built"]()]
        d_p, eps_p = localize.localize_plain(m, p, cand, span, cp)
        ok = (bool(torch.equal(want[0], d_p))
              and float((want[1] - eps_p).abs().max()) <= 1e-6)
        nbytes, ops = (12.0 * cand.numel() + caps * found * (4.0 * span + 8),
                       3.0 * caps * found * span)
        entry = {"shape": [caps, mf], "found": caps * found, "span": span,
                 "plain_close": ok, "bound_ms": cs.bound(nbytes, ops)[0]}
        if not ok:
            wrong.append(f"{label} as_built against the plain version")
        wrong += [f"{label} {n}" for n in in_turns(torch, cs, runs, want,
                                                    entry)]
        log_entry(label, entry, runs)
        print(f"{label}: found {caps * found}, bound "
              f"{entry['bound_ms']:.4f} ms, plain "
              + ("close" if ok else "FAR"), flush=True)
        res[label] = entry
        del runs, want, m, p, cand
        torch.cuda.empty_cache()
    for label, (rows, n, l, nt) in K7_SHAPES.items():
        if only and label not in only:
            continue
        taps = (resample_filter(l, 1) if nt is None else
                np.random.default_rng(nt).normal(size=nt).astype(np.float32))
        x = torch.randn((rows, n), dtype=torch.complex64, generator=gen,
                        device=dev)
        runs = k7_runs(torch, libs, x, l, taps, stream)
        want = [t.clone() for t in runs["interp_as_built"]()]
        ok, err = cs.rel_close(want[0], fir.interp_plain(x, l, taps))
        nd = fir.branch_matrix(taps, l)[0].shape[1]
        entry = {"shape": [rows, n], "l": l, "nd": nd, "plain_close": ok,
                 "max_abs_err": err,
                 "bound_ms": cs.bound(*cs.work_filter(rows, n, n * l,
                                                      nd)[:2])[0]}
        if not ok:
            wrong.append(f"{label} interp_as_built against the plain version")
        wrong += [f"{label} {n}" for n in in_turns(torch, cs, runs, want,
                                                    entry)]
        log_entry(label, entry, runs)
        print(f"{label}: bound {entry['bound_ms']:.4f} ms, max_abs_err "
              f"{err:.3g}", flush=True)
        res[label] = entry
        del runs, want, x
        torch.cuda.empty_cache()
    out = {"device": dev_info, "registers": regs, "results": res,
           "differ": wrong}
    if out_file:
        Path(out_file).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    if wrong:
        print("k1_interp_ab: FAILED: " + ", ".join(wrong), file=sys.stderr)
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--against", type=Path,
                    help="also time K1 and the interpolation of this "
                         "checkout")
    ap.add_argument("--only", help="comma-separated shape labels to run")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    only = set(args.only.split(",")) if args.only else None
    try:
        return run(torch, cs, args.out, args.against, only)
    except cs.SmokeFailure as e:
        print(f"k1_interp_ab: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
