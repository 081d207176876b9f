"""K6's and K9's S&C kernels (ofdm_uhd_tpu_torch/kernels/csrc/scfront.cu:
the tile body csrc/scfront_tile.cuh up to l = 4096, the split route's two
passes csrc/scfront_split.cuh above) on the card, as built and in variants
made by text substitution of their sources, each into its own library
beside build/;
--against DIR adds another checkout's route (DIR's csrc/scfront.cu, the
same tile entries; above l = 4096 its split route's ofdm_sc_span and
ofdm_sc_stride or, where it still holds them, the levels route's
ofdm_sc_leaves, log2 l ofdm_sc_level and ofdm_sc_out), e.g. a parent
commit's.

Tile variants (at the tile kernel's lags, up to 4096): 4 positions a lane
for 8, segments for 2 or 1/2 work items a resident warp for 1, blocks of
2 or 8 warps for 4; and, computing something else, the doubling levels,
the stores, or all but the loads and stores left out. Split variants (at
the split route's lags, above 1024): the stride pass's segments for 2 or
1/2 work items a resident thread, 4 or 16 chain steps a thread for 8,
and the span pass with the tile variants' positions a lane, segments and
blocks; and the split route as built at the widths W = 128 .. 4096 (the
route takes sync.split_width(l)), and each pass alone.

Shapes: the main paths' (C3's and C5's captures [8, 4,436,068] at l =
128, C4's baseband [8, 517,309] at l = 512, c5_sharded's shard rows [4,
1,036,480] at l = 128, c2_pallas's captures [32, 181,860] at l = 32
through ofdm_sc_correlate, the shift phase's 2^20 samples at l = 128
through ofdm_sc_correlate) and big_nsc's ([4, 75,028] at n_sc 4096, l =
2048; [4, 38,164] at n_sc 2048, l = 1024, and [4, 148,756] at 8192, l =
4096, where both routes run; [4, 296,212] at 16384, l = 8192; [4,
591,124] at 32768, l = 16384), and for the routes' crossover [4, 19,732]
(n_sc 1024) at l = 512 and C4's row length at l = 1024, 2048 and 4096,
on seeded random rows with an idle
stretch each. Every variant that computes the function must give the
bits of the split route as built and of DIR's route; all are timed
in-kernel (chip_smoke.device_ms: behind a spin kernel) in turns, in order
and then in reverse, beside `Tensor.clone` of the input.

    python3 scripts/k6_ab.py [--against DIR] [--only LABEL,..] [--out FILE]

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

TILE = "scfront_tile.cuh"
SPLIT = "scfront_split.cuh"
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


def stride_slots(f):
    """kStrideSlots = f: the stride pass's segments for f work items a
    resident thread."""
    return ("constexpr double kStrideSlots = 1.0;",
            f"constexpr double kStrideSlots = {f};")


def chain_steps(lg):
    """kK = 2^lg chain steps a thread of the stride pass holds."""
    return ("constexpr int kRegLg = 3;", f"constexpr int kRegLg = {lg};")


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
# name: ({file: substitutions}, computes the function, route it is timed
# through: "tile" at the tile's lags, "split" at big_nsc's)
VARIANTS = {
    "as_built": ({}, True, "both"),
    "v4": ({TILE: (V4,)}, True, "tile"),
    "slots2": ({SOURCE: (slots(2.0),)}, True, "tile"),
    "slots_half": ({SOURCE: (slots(0.5),)}, True, "tile"),
    "warps2": ({TILE: (("constexpr int kWarps = 4;",
                        "constexpr int kWarps = 2;"),)}, True, "tile"),
    "warps8": ({TILE: (("constexpr int kWarps = 4;",
                        "constexpr int kWarps = 8;"),)}, True, "tile"),
    "no_levels": ({TILE: (NO_LEVELS,)}, False, "tile"),
    "no_stores": ({TILE: (NO_STORES,)}, False, "tile"),
    "memory_only": ({TILE: MEMORY_ONLY}, False, "tile"),
    "stride_slots2": ({SOURCE: (stride_slots(2.0),)}, True, "split"),
    "stride_slots_half": ({SOURCE: (stride_slots(0.5),)}, True, "split"),
    "k4": ({SPLIT: (chain_steps(2),)}, True, "split"),
    "k16": ({SPLIT: (chain_steps(4),)}, True, "split"),
    "span_v4": ({TILE: (V4,)}, True, "split"),
    "span_slots2": ({SOURCE: (slots(2.0),)}, True, "split"),
    "span_slots_half": ({SOURCE: (slots(0.5),)}, True, "split"),
    "span_warps2": ({TILE: (("constexpr int kWarps = 4;",
                             "constexpr int kWarps = 2;"),)}, True, "split"),
}
# label: (rows, n, l, metric)
SHAPES = {"c3": (8, 4_436_068, 128, True),
          "c4": (8, 517_309, 512, True),
          "c5_sharded": (4, 1_036_480, 128, True),
          "c2_pallas": (32, 181_860, 32, False),
          "nsc_2048": (4, 38_164, 1024, True),
          "big_nsc_4096": (4, 75_028, 2048, True),
          "big_nsc_8192": (4, 148_756, 4096, True),
          "big_nsc_16384": (4, 296_212, 8192, True),
          "big_nsc_32768": (4, 591_124, 16384, True),
          "shift_2e20": (1, 1 << 20, 128, False),
          # the tile / split crossover on short rows (n_sc 1024's) and on
          # rows of C4's length at the lags around it
          "nsc_1024": (4, 19_732, 512, True),
          "long_1024": (8, 517_309, 1024, True),
          "long_2048": (8, 517_309, 2048, True),
          "long_4096": (8, 517_309, 4096, True)}
# the split route's widths timed at big_nsc's lags
WIDTHS = (128, 256, 512, 1024, 2048, 4096)


def substituted(text: str, subs, name: str) -> str:
    """text with each (old, new) substitution made once; raises where the
    source no longer holds `old`."""
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"{name} no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def bind(lib) -> None:
    pt, i = ctypes.c_void_p, ctypes.c_int
    for fn in ("ofdm_scfront", "ofdm_sc_correlate"):
        getattr(lib, fn).argtypes = [pt, pt, pt, i, i, i, pt]
    if hasattr(lib, "ofdm_sc_span"):
        lib.ofdm_sc_span.argtypes = [pt, pt, i, i, i, i, pt]
        lib.ofdm_sc_stride.argtypes = [pt, pt, pt, i, i, i, i, i, pt]
    if hasattr(lib, "ofdm_sc_leaves"):
        lib.ofdm_sc_leaves.argtypes = [pt, pt, i, i, i, pt]
        lib.ofdm_sc_level.argtypes = [pt, pt, i, i, i, i, i, pt]
        lib.ofdm_sc_out.argtypes = [pt, pt, pt, i, i, i, i, pt]


def build_variants(out: Path, against: Path | None) -> tuple[dict, dict]:
    """One library a variant (its copies of scfront.cu and both headers,
    with the shared C header beside them) and `against`'s scfront.cu as it
    is, all nvcc processes started together: ({name: CDLL}, {name: ptxas
    registers of its kernels})."""
    import chip_smoke as cs
    from ofdm_uhd_tpu_torch.kernels import build
    texts = {f: (build.CSRC / f).read_text() for f in (TILE, SPLIT, SOURCE)}
    procs = {}

    def nvcc(name, src, include):
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-Xptxas", "-v", "-shared", "-I",
             str(include), "-o", str(out / name / "lib.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, (subs, _, _) in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in texts.items():
            (d / f).write_text(substituted(text, subs.get(f, ()), f))
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
                      if k.startswith(("scfront_kernel", "sc_"))}
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        bind(lib)
        libs[name] = lib
    return libs, regs


def check_err(err, what):
    if err:
        raise RuntimeError(f"{what}: launch error {err}")


class Route:
    """Launches of one library's S&C kernels on x [rows, n] at lag l into
    buffers allocated once: tile(), split(w), span(w), stride(w), levels()
    (the levels route, where the library holds it); each returns (P, M or
    R)."""

    def __init__(self, torch, lib, x, l, metric, stream):
        rows, n = x.shape
        nd = n - 2 * l + 1
        self.lib, self.x, self.l, self.metric = lib, x, l, metric
        self.stream, self.rows, self.n = stream, rows, n
        self.p = torch.empty((rows, nd), dtype=torch.complex64,
                             device=x.device)
        self.q = torch.empty((rows, nd), dtype=torch.float32, device=x.device)
        self.a = torch.empty((3, rows, n), dtype=torch.float32,
                             device=x.device)
        self.b = (torch.empty_like(self.a) if hasattr(lib, "ofdm_sc_leaves")
                  else None)

    def out(self):
        return self.p, self.q

    def tile(self):
        entry = "ofdm_scfront" if self.metric else "ofdm_sc_correlate"
        check_err(getattr(self.lib, entry)(
            self.x.data_ptr(), self.p.data_ptr(), self.q.data_ptr(),
            self.rows, self.n, self.l, self.stream), "tile")
        return self.out()

    def span(self, w):
        check_err(self.lib.ofdm_sc_span(self.x.data_ptr(), self.a.data_ptr(),
                                        self.rows, self.n, self.l, w,
                                        self.stream), "span")
        return self.a

    def stride(self, w):
        check_err(self.lib.ofdm_sc_stride(
            self.a.data_ptr(), self.p.data_ptr(), self.q.data_ptr(),
            self.rows, self.n, self.l, w, int(self.metric), self.stream),
            "stride")
        return self.out()

    def split(self, w):
        self.span(w)
        return self.stride(w)

    def levels(self):
        lib, a, b = self.lib, self.a, self.b
        err = lib.ofdm_sc_leaves(self.x.data_ptr(), a.data_ptr(), self.rows,
                                 self.n, self.l, self.stream)
        len_p, len_e, w = self.n - self.l, self.n, 1
        while w < self.l and not err:
            len_p, len_e = len_p - w, len_e - w
            err = lib.ofdm_sc_level(a.data_ptr(), b.data_ptr(), self.rows,
                                    self.n, w, len_p, len_e, self.stream)
            a, b = b, a
            w *= 2
        if not err:
            err = lib.ofdm_sc_out(a.data_ptr(), self.p.data_ptr(),
                                  self.q.data_ptr(), self.rows, self.n,
                                  self.l, int(self.metric), self.stream)
        check_err(err, "levels route")
        return self.out()

    def route(self, tile_max_l, w):
        """The library's kernels at this lag: its tile up to tile_max_l,
        else its split route at width w or its levels route."""
        if self.l <= tile_max_l:
            return self.tile()
        if hasattr(self.lib, "ofdm_sc_span"):
            return self.split(w)
        return self.levels()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--against", type=Path,
                    help="also time the S&C route of this checkout")
    ap.add_argument("--only", help="comma-separated shape labels to run")
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    shapes = (SHAPES if not args.only else
              {k: SHAPES[k] for k in args.only.split(",")})
    try:
        return run(torch, cs, args.out, args.against, shapes)
    except cs.SmokeFailure as e:
        print(f"k6_ab: FAILED: {e}", file=sys.stderr)
        return 1


def runs_for(torch, libs, x, l, metric, stream) -> dict:
    """{name: a function launching it} at this shape: the tile kernel
    ("as_built") and its variants at the tile kernel's lags, the split
    route as built ("split") at its width and at WIDTHS, each pass alone
    and the split variants above the tile route's lags, and `against`'s
    kernels (its tile at the tile kernel's lags, else its split or levels
    route)."""
    from ofdm_uhd_tpu_torch.kernels import sync
    w = sync.split_width(l)
    built = Route(torch, libs["as_built"], x, l, metric, stream)
    runs = {}
    tile_lag = l <= sync.TILE_KERNEL_MAX_L
    split_lag = l > sync.TILE_MAX_L
    if tile_lag:
        runs["as_built"] = built.tile
    runs["split"] = lambda: built.split(w)
    if l >= 512:
        for width in WIDTHS:
            if width <= l and width != w:
                runs[f"split_w{width}"] = (lambda width=width:
                                           built.split(width))
    if split_lag:
        built.span(w)
        runs["span"] = lambda: built.span(w)
        runs["stride"] = lambda: built.stride(w)
    for name, (_, _, route) in VARIANTS.items():
        if name == "as_built" or not (tile_lag if route == "tile"
                                      else split_lag):
            continue
        r = Route(torch, libs[name], x, l, metric, stream)
        runs[name] = r.tile if route == "tile" else (lambda r=r: r.split(w))
    if "against" in libs:
        r = Route(torch, libs["against"], x, l, metric, stream)
        runs["against"] = lambda: r.route(sync.TILE_KERNEL_MAX_L, w)
    return runs


def run(torch, cs, out_file, against, shapes) -> int:
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
    for label, (rows, n, l, metric) in shapes.items():
        x = torch.randn((rows, n), dtype=torch.complex64, generator=gen,
                        device=dev)
        x[:, n // 3:n // 3 + 2 * l + 5000] = 0      # idle: M = 0
        runs = runs_for(torch, libs, x, l, metric, stream)
        want = [t.clone() for t in runs["split"]()]
        res[label] = {"shape": [rows, n], "l": l, "metric": metric,
                      "clone_ms": [cs.device_ms(torch, x.clone)
                                   for _ in range(2)],
                      "bound_ms": cs.bound(*cs.work_sc(rows, n, l,
                                                       metric))[0]}
        for name, fn in runs.items():
            got = fn()
            torch.cuda.synchronize()
            exact = name not in VARIANTS or VARIANTS[name][1]
            equal = (None if name == "span" else
                     all(bool(torch.equal(a, b)) for a, b in zip(got, want)))
            res[label][name] = {"ms": [], "equal": equal}
            if exact and equal is False:
                wrong.append(f"{label} {name}")
        for name in list(runs) + list(runs)[::-1]:          # in turns
            res[label][name]["ms"].append(cs.device_ms(torch, runs[name]))
        for name in runs:
            e = res[label][name]
            bits = {None: "", True: ", bits equal", False: ", bits DIFFER"}
            print(f"{label} {name}: in-kernel "
                  + " / ".join("none" if t is None else f"{t:.4f}"
                               for t in e["ms"])
                  + f" ms{bits[e['equal']]}", flush=True)
        print(f"{label} clone: in-kernel "
              + " / ".join(f"{t:.4f}" for t in res[label]["clone_ms"])
              + f" ms; bound {res[label]['bound_ms']:.4f} ms", flush=True)
        del runs, want, x
        torch.cuda.empty_cache()
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
