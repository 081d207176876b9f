"""Ablation of K7's exact strided FIR body (ofdm_uhd_tpu_torch/kernels/csrc/
fir_strided.cuh) on the card: builds the body as it is and in variants
made by text substitution of its source (the sums left out, the copies
left out, phase planes instead of pair planes, one stage, fewer
producers), each into its own library beside build/, and times every
variant in-kernel (chip_smoke.device_ms: behind a spin kernel) at C4's
decimation [8, 4,138,472] -> [8, 517,309] and at the stride-1 FIR of
[8, 517,309], 193 taps, seeded random rows, with `Tensor.clone` of each
input as a copy yardstick; --against DIR adds the strided kernel of
another checkout (DIR's csrc/fir.cu, the same C entry), e.g. a parent
commit's. The variants are timed in turns (in order, then in reverse).
Those that compute the function are held within 1e-5 of max|y| of
kernels/fir.py decim_plain.

    python3 scripts/k7_ablation.py [--against DIR] [--out FILE]

Prints the card's name and power limit, a line a variant and shape, and a
JSON object last; needs an NVIDIA GPU and nvcc (the build's), no JAX.
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

HEADER = "fir_strided.cuh"
NO_SUM = ("                if (g.pairs)\n"
          "                    sum_pair(st, taps, g, p, c_lo, c_hi, base, re,"
          " im);\n"
          "                else\n"
          "                    sum_phase(st, taps, g, p, c_lo, c_hi, base, re,"
          " im);\n", "")
NO_COPY = ("    FIR_HD void all(const Plan& g) {\n",
           "    FIR_HD void all(const Plan& g) {\n        return;\n")
NO_PAIRS = ("    g.pairs = aligned16 && m % 2 == 0",
            "    g.pairs = false && m % 2 == 0")
ONE_STAGE = ("constexpr int kStages = 2;", "constexpr int kStages = 1;")
PRODUCERS_64 = ("constexpr int kProducers = 128;",
                "constexpr int kProducers = 64;")
# name: (substitutions, whether the variant still computes the function)
VARIANTS = {
    "as_built": ((), True),
    "no_sums": ((NO_SUM,), False),
    "no_copies": ((NO_COPY,), False),
    "phase_planes": ((NO_PAIRS,), True),
    "one_stage": ((ONE_STAGE,), True),
    "producers_64": ((PRODUCERS_64,), True),
}
SHAPES = {"decim_c4": (8, 4_138_472, 8), "fir_c4_baseband": (8, 517_309, 1)}


def variant_source(header: str, subs) -> str:
    """The header with each (old, new) substitution made once; raises
    where the source no longer holds `old`."""
    for old, new in subs:
        if header.count(old) != 1:
            raise ValueError(f"{HEADER} no longer holds {old!r}")
        header = header.replace(old, new)
    return header


def build_variants(out: Path, against: Path | None = None) -> dict:
    """One library a variant: a copy of fir.cu beside its variant of the
    header (a quoted include looks beside the includer first), and
    `against`'s fir.cu as it is, all nvcc processes started together."""
    from ofdm_uhd_tpu_torch.kernels import build
    header = (build.CSRC / HEADER).read_text()
    procs = {}

    def nvcc(name, src, include):
        (out / name).mkdir(parents=True, exist_ok=True)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-shared", "-I", str(include),
             "-o", str(out / name / "lib.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, (subs, _) in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / HEADER).write_text(variant_source(header, subs))
        (d / "fir.cu").write_text((build.CSRC / "fir.cu").read_text())
        nvcc(name, d / "fir.cu", build.CSRC)
    if against is not None:
        csrc = against / "ofdm_uhd_tpu_torch" / "kernels" / "csrc"
        nvcc("against", csrc / "fir.cu", csrc)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        pt, i = ctypes.c_void_p, ctypes.c_int
        lib.ofdm_fir_strided.argtypes = [pt, pt, pt, i, i, i, i, i, i, pt]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--against", type=Path,
                    help="also time the strided kernel of this checkout")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    try:
        return run(torch, cs, args.out, args.against)
    except cs.SmokeFailure as e:
        print(f"k7_ablation: FAILED: {e}", file=sys.stderr)
        return 1


def run(torch, cs, out_file, against) -> int:
    from ofdm_uhd_tpu_torch.kernels import fir
    from ofdm_uhd_tpu_torch.phy.tables import resample_filter
    dev_info = cs.phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    libs = build_variants(REPO / "build" / "k7_ablation", against)
    taps = resample_filter(8, 1)
    _, w, pad = fir._corr_weights(taps)
    wt = torch.from_numpy(w.copy()).to(dev)
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for label, (rows, n_in, m) in SHAPES.items():
        x = torch.randn((rows, n_in), dtype=torch.complex64, generator=gen,
                        device=dev)
        n_out = n_in // m
        y = torch.empty((rows, n_out), dtype=torch.complex64, device=dev)
        ref = fir.decim_plain(x, m, taps)
        stream = torch.cuda.current_stream().cuda_stream
        res[label] = {"clone_ms": [cs.device_ms(torch, x.clone)
                                   for _ in range(2)]}
        launches = {}
        for name, lib in libs.items():
            def launch(lib=lib, name=name):
                err = lib.ofdm_fir_strided(
                    x.data_ptr(), wt.data_ptr(), y.data_ptr(), rows, n_in,
                    n_out, len(w), m, pad, stream)
                if err:
                    raise RuntimeError(f"{name}: launch error {err}")
            launch()
            torch.cuda.synchronize()
            res[label][name] = {"ms": []}
            if name == "against" or VARIANTS[name][1]:
                rel = float((y - ref).abs().max()) / float(ref.abs().max())
                cs.check(rel <= cs.REL_TOL, f"{name} {label}: {rel}")
                res[label][name]["rel_err"] = rel
            launches[name] = launch
        for name in list(libs) + list(libs)[::-1]:         # in turns
            res[label][name]["ms"].append(cs.device_ms(torch, launches[name]))
        for name, entry in res[label].items():
            if name == "clone_ms":
                continue
            print(f"{label} {name}: in-kernel "
                  + " / ".join(f"{t:.4f}" for t in entry["ms"]) + " ms"
                  + (f", rel err {entry['rel_err']:.2e}"
                     if "rel_err" in entry else ""), flush=True)
        print(f"{label} clone: in-kernel "
              + " / ".join(f"{t:.4f}" for t in res[label]["clone_ms"])
              + " ms", flush=True)
    out = {"device": dev_info, "results": res}
    if out_file:
        Path(out_file).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
