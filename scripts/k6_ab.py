"""K6's and K9's S&C tile body (ofdm_uhd_tpu_torch/kernels/csrc/
scfront_tile.cuh, launched by csrc/scfront.cu) on the card, as built and
in variants made by text substitution of its sources (4 positions a lane
for 8, segments for 2 or 1/2 work items a resident warp for 1, blocks of
2 or 8 warps for 4; and, computing something else, the doubling levels,
the stores, or all but the loads and stores left out), each into its own
library beside build/;
--against DIR adds the tile kernel of another checkout (DIR's
csrc/scfront.cu, the same C entries), e.g. a parent commit's. At the main
paths' shapes (C3's and C5's captures [8, 4,436,068] at l = 128, C4's
baseband [8, 517,309] at l = 512, c5_sharded's shard rows [4, 1,036,480]
at l = 128, c2_pallas's captures [32, 181,860] at l = 32 through
ofdm_sc_correlate, big_nsc's [4, 75,028] at n_sc 4096, l = 2048, and the
shift phase's 2^20 samples at l = 128 through ofdm_sc_correlate), on
seeded random rows with an idle stretch each, every variant that computes
the function must give the bits of the levels route (ofdm_sc_leaves,
ofdm_sc_level, ofdm_sc_out: the same adds through device memory) and of
DIR's kernel; all are timed in-kernel (chip_smoke.device_ms: behind a spin
kernel) in turns, in order and then in reverse, beside `Tensor.clone` of
the input.

    python3 scripts/k6_ab.py [--against DIR] [--out FILE]

Prints the card's name and power limit, each variant's registers, a line
a shape and variant, and a JSON object last; exits 1 if a variant that
computes the function gives other bits. Needs an NVIDIA GPU and nvcc (the
build's), no JAX.
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

HEADER = "scfront_tile.cuh"
SOURCE = "scfront.cu"
NO_LEVELS = ("""        levels<0, LG + 1>(e, ce, ring_e, c, wp);
        levels<0, LG>(pr, cre, ring_re, c, wp);
        levels<0, LG>(pi, cim, ring_im, c, wp);
""", "")
V4 = ("constexpr int kV = 8;", "constexpr int kV = 4;")
# stores only where e < 0, which never holds: the sums without the stores
NO_STORES = ("            if (i >= i0 && i < i1)\n",
             "            if (i >= i0 && i < i1 && e[j] < 0.0f)\n")


def slots(f):
    """kSlotsPerWarp = f: segments for f work items a resident warp."""
    return ("constexpr double kSlotsPerWarp = 1.0;",
            f"constexpr double kSlotsPerWarp = {f};")


# the walk's loads and stores with next to no arithmetic: no levels, no
# hypotf, a product for the metric's division
MEMORY_ONLY = (NO_LEVELS,
               ("            const float mag = hypotf(b[j].x, b[j].y);",
                "            const float mag = b[j].x;"),
               ("        const float mag = hypotf(pr, pi);",
                "        const float mag = pr;"),
               ("        const float m = __fdiv_rn(__fmul_rn(mag, mag), "
                "__fmul_rn(den, den));",
                "        const float m = __fmul_rn(__fmul_rn(mag, mag), "
                "__fmul_rn(den, den));"))
# name: (header substitutions, source substitutions, computes the function)
VARIANTS = {
    "as_built": ((), (), True),
    "v4": ((V4,), (), True),
    "slots2": ((), (slots(2.0),), True),
    "slots_half": ((), (slots(0.5),), True),
    "warps2": ((("constexpr int kWarps = 4;", "constexpr int kWarps = 2;"),),
               (), True),
    "warps8": ((("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),),
               (), True),
    "no_levels": ((NO_LEVELS,), (), False),
    "no_stores": ((NO_STORES,), (), False),
    "memory_only": (MEMORY_ONLY, (), False),
}
# label: (rows, n, l, metric)
SHAPES = {"c3": (8, 4_436_068, 128, True),
          "c4": (8, 517_309, 512, True),
          "c5_sharded": (4, 1_036_480, 128, True),
          "c2_pallas": (32, 181_860, 32, False),
          "big_nsc_4096": (4, 75_028, 2048, True),
          "shift_2e20": (1, 1 << 20, 128, False)}


def substituted(text: str, subs, name: str) -> str:
    """text with each (old, new) substitution made once; raises where the
    source no longer holds `old`."""
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name} no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(out: Path, against: Path | None) -> tuple[dict, dict]:
    """One library a variant (its copies of scfront.cu and the header,
    with the shared C header beside them) and `against`'s scfront.cu as it
    is, all nvcc processes started together: ({name: CDLL}, {name: ptxas
    registers of its kernels})."""
    import chip_smoke as cs
    from ofdm_uhd_tpu_torch.kernels import build
    header = (build.CSRC / HEADER).read_text()
    source = (build.CSRC / SOURCE).read_text()
    procs = {}

    def nvcc(name, src, include):
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-Xptxas", "-v", "-shared", "-I",
             str(include), "-o", str(out / name / "lib.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, (hsubs, ssubs, _) in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / HEADER).write_text(substituted(header, hsubs, HEADER))
        (d / SOURCE).write_text(substituted(source, ssubs, SOURCE))
        nvcc(name, d / SOURCE, build.CSRC)
    if against is not None:
        csrc = against / "ofdm_uhd_tpu_torch" / "kernels" / "csrc"
        (out / "against").mkdir(parents=True, exist_ok=True)
        nvcc("against", csrc / SOURCE, csrc)
    libs, regs = {}, {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        regs[name] = {k: v for k, v in cs.kernel_registers(log).items()
                      if k.startswith("scfront_kernel")}
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        pt, i = ctypes.c_void_p, ctypes.c_int
        for fn in ("ofdm_scfront", "ofdm_sc_correlate"):
            getattr(lib, fn).argtypes = [pt, pt, pt, i, i, i, pt]
        lib.ofdm_sc_leaves.argtypes = [pt, pt, i, i, i, pt]
        lib.ofdm_sc_level.argtypes = [pt, pt, i, i, i, i, i, pt]
        lib.ofdm_sc_out.argtypes = [pt, pt, pt, i, i, i, i, pt]
        libs[name] = lib
    return libs, regs


def levels_route(torch, lib, x, l, metric, stream):
    """The levels route through lib's kernels: (P, M or R)."""
    rows, n = x.shape
    nd = n - 2 * l + 1
    a = torch.empty((3, rows, n), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    err = lib.ofdm_sc_leaves(x.data_ptr(), a.data_ptr(), rows, n, l, stream)
    len_p, len_e, w = n - l, n, 1
    while w < l and not err:
        len_p, len_e = len_p - w, len_e - w
        err = lib.ofdm_sc_level(a.data_ptr(), b.data_ptr(), rows, n, w,
                                len_p, len_e, stream)
        a, b = b, a
        w *= 2
    p = torch.empty((rows, nd), dtype=torch.complex64, device=x.device)
    q = torch.empty((rows, nd), dtype=torch.float32, device=x.device)
    if not err:
        err = lib.ofdm_sc_out(a.data_ptr(), p.data_ptr(), q.data_ptr(), rows,
                              n, l, int(metric), stream)
    if err:
        raise RuntimeError(f"levels route: launch error {err}")
    return p, q


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--against", type=Path,
                    help="also time the tile kernel of this checkout")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    try:
        return run(torch, cs, args.out, args.against)
    except cs.SmokeFailure as e:
        print(f"k6_ab: FAILED: {e}", file=sys.stderr)
        return 1


def run(torch, cs, out_file, against) -> int:
    dev_info = cs.phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs, regs = build_variants(REPO / "build" / "k6_ab", against)
    for name, r in regs.items():
        print(f"registers {name}: " + ", ".join(
            f"{k} {v[0]} ({v[1]} B spilled)" for k, v in sorted(r.items())),
            flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    res, wrong = {}, []
    for label, (rows, n, l, metric) in SHAPES.items():
        x = torch.randn((rows, n), dtype=torch.complex64, generator=gen,
                        device=dev)
        x[:, n // 3:n // 3 + 2 * l + 5000] = 0      # idle: M = 0
        nd = n - 2 * l + 1
        entry = "ofdm_scfront" if metric else "ofdm_sc_correlate"
        want = levels_route(torch, libs["as_built"], x, l, metric, stream)
        outs, launches = {}, {}
        for name, lib in libs.items():
            p = torch.empty((rows, nd), dtype=torch.complex64, device=dev)
            q = torch.empty((rows, nd), dtype=torch.float32, device=dev)

            def launch(lib=lib, name=name, p=p, q=q):
                err = getattr(lib, entry)(x.data_ptr(), p.data_ptr(),
                                          q.data_ptr(), rows, n, l, stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
            launch()
            torch.cuda.synchronize()
            outs[name], launches[name] = (p, q), launch
        res[label] = {"shape": [rows, n], "l": l, "metric": metric,
                      "clone_ms": [cs.device_ms(torch, x.clone)
                                   for _ in range(2)],
                      "bound_ms": cs.bound(*cs.work_sc(rows, n, l,
                                                       metric))[0]}
        for name in libs:
            exact = name == "against" or VARIANTS[name][2]
            same = [bool(torch.equal(a, b))
                    for a, b in zip(outs[name], want)]
            if "against" in outs:
                same += [bool(torch.equal(a, b))
                         for a, b in zip(outs[name], outs["against"])]
            res[label][name] = {"ms": [], "equal": all(same)}
            if exact and not all(same):
                wrong.append(f"{label} {name}")
        del outs
        for name in list(libs) + list(libs)[::-1]:          # in turns
            res[label][name]["ms"].append(cs.device_ms(torch,
                                                       launches[name]))
        for name in libs:
            e = res[label][name]
            print(f"{label} {name}: in-kernel "
                  + " / ".join(f"{t:.4f}" for t in e["ms"])
                  + f" ms, bits {'equal' if e['equal'] else 'DIFFER'}",
                  flush=True)
        print(f"{label} clone: in-kernel "
              + " / ".join(f"{t:.4f}" for t in res[label]["clone_ms"])
              + f" ms; bound {res[label]['bound_ms']:.4f} ms", flush=True)
    out = {"device": dev_info, "registers": regs, "results": res,
           "differ": wrong}
    if out_file:
        Path(out_file).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    if wrong:
        print("k6_ab: FAILED: other bits from " + ", ".join(wrong),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
