"""chip_smoke.py's tiers phase (run_tiers: K8, K13, K13 at DEFAULT and
K12 held against their plain versions and timed) or, with --phase shift,
its shift phase (run_shift: K11 held and timed, with the exact K7 beside
it at C4), of this checkout and, with --against DIR, of another
checkout's (e.g. a parent commit unpacked with `git archive` into a
directory .gitignore lists), in turns: DIR, this, this, DIR (--rounds 1:
DIR, this). Each run is a process of its own that imports its checkout's
chip_smoke.py and package, builds its kernels, and runs the phase on the
same seeded inputs at the phase's shapes: C4's decimation input [8,
4,138,472] and TX frames [32, 16128], C3's captures [8, 4,436,068] with 8
x 1026 offsets (normal samples and uniform offsets from a seed-0 CUDA
generator, not the C3 and C4 paths' own data); the session rows and the
2^20 signal are the phase's own.

    python3 scripts/tiers_ab.py [--phase tiers|shift] [--against DIR]
                                [--rounds 1|2] [--out FILE]

Prints each run's log and, last, per case: events ms, in-kernel ms, the
library call's in-kernel ms and the wrapper's host us a call of every
run, and the C4 (and the tiers phase's S&C) turns (JSON in --out). Exits 1
if a run fails (a kernel outside its tolerance fails its run). Needs an
NVIDIA GPU and nvcc, no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
N_RADIO, N_BASE, N_CAP = (8, 4_138_472), (32, 16128), (8, 4_436_068)
SLOTS = 1026


def inputs(torch, frame_len: int):
    """The phase's C4 and C3 inputs, seeded, on the card."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    radio, base, cap = (torch.randn(s, dtype=torch.complex64, device=dev,
                                    generator=gen)
                        for s in (N_RADIO, N_BASE, N_CAP))
    ds = torch.randint(0, N_CAP[1] - frame_len, (N_CAP[0], SLOTS),
                       device=dev, generator=gen, dtype=torch.int32)
    return (radio, base), (cap, ds.sort(dim=1).values)


def worker(root: Path, out: Path, phase: str) -> int:
    """One run of root's tiers or shift phase; its results as JSON into
    out."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.kernels import build
    torch.cuda.set_device(0)
    build.library()
    c4, c3 = inputs(torch, config("c3").frame_len)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    try:
        if phase == "shift":
            res = chip_smoke.run_shift(torch, dev, c4)
            # the C4 rows' turns: K7, K11, K11, K7
            res["ab"] = {k: {"K7": v["k7_device_ms"],
                             "K11": v["device_ms_turns"]}
                         for k, v in res["kernels"].items()
                         if "k7_device_ms" in v}
        else:
            res = chip_smoke.run_tiers(torch, dev, c4, c3)
    except chip_smoke.SmokeFailure as e:
        print(f"tiers_ab: {root}: FAILED: {e}", flush=True)
        return 1
    out.write_text(json.dumps({
        "root": str(root), "seconds": time.perf_counter() - t0,
        "kernels": res["kernels"], "ab": res["ab"],
        "launches": res["launches"]}, default=float))
    return 0


def prebuild(roots: list[Path]) -> None:
    """Every checkout's kernel library, built side by side."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", "from ofdm_uhd_tpu_torch.kernels import "
         "build; build.library()"], cwd=root) for root in roots]
    for root, p in zip(roots, procs):
        if p.wait() != 0:
            raise SystemExit(f"tiers_ab: the build in {root} failed")


def summary(runs: list[tuple[str, dict]]) -> dict:
    """Per case and run: events ms, in-kernel ms, library in-kernel ms,
    host us a call."""
    table = {}
    for label, r in runs:
        for key, v in r["kernels"].items():
            table.setdefault(key, []).append(
                {"run": label, "ms": v["ms"],
                 "device_ms": v.get("device_ms"),
                 "library_ms": v.get("library_ms"),
                 "library_device_ms": v.get("library_device_ms"),
                 "host_us": v.get("host_us"),
                 "bound_ms": v["bound_ms"], "max_abs_err": v["max_abs_err"]})
    return table


def fmt(x) -> str:
    return "none" if x is None else f"{x:.4f}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", choices=("tiers", "shift"), default="tiers",
                    help="chip_smoke's phase to run (default: tiers)")
    ap.add_argument("--against", type=Path,
                    help="another checkout whose phase runs in turns")
    ap.add_argument("--rounds", type=int, default=2, choices=(1, 2))
    ap.add_argument("--out", type=Path, help="the results as JSON")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--result", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker.resolve(), args.result, args.phase)
    import torch
    if not torch.cuda.is_available():
        print("tiers_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    roots = [("this", REPO)]
    if args.against:
        roots.insert(0, ("against", args.against.resolve()))
    prebuild([r for _, r in roots])
    order = roots + roots[::-1] if args.rounds == 2 else roots
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs, tmp = [], REPO / "build" / "tiers_ab" / args.phase
    tmp.mkdir(parents=True, exist_ok=True)
    for i, (label, root) in enumerate(order):
        res = tmp / f"run{i}.json"
        print(f"tiers_ab: run {i}: {label} ({root})", flush=True)
        rc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(root), "--result", str(res), "--phase", args.phase],
            cwd=root).returncode
        if rc != 0:
            print(f"tiers_ab: run {i} ({label}) exited {rc}",
                  file=sys.stderr)
            return 1
        runs.append((label, json.loads(res.read_text())))
    table = summary(runs)
    for key, rows in table.items():
        print(f"tiers_ab: {key:20s} " + "  ".join(
            f"{r['run']} ev {fmt(r['ms'])} in {fmt(r['device_ms'])} "
            f"lib {fmt(r['library_device_ms'])} host {fmt(r['host_us'])}"
            for r in rows)
            + f"  bound {rows[0]['bound_ms']:.4f}", flush=True)
    for label, r in runs:
        for key, turns in r["ab"].items():
            print(f"tiers_ab: {label} turns {key}: " + ", ".join(
                f"{k} " + " / ".join(fmt(t) for t in v)
                for k, v in turns.items()), flush=True)
    if args.out:
        args.out.write_text(json.dumps(
            {"card": card, "order": [lab for lab, _ in order],
             "table": table, "runs": [r for _, r in runs]}, indent=1,
            default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
