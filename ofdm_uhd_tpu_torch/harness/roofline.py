"""Analytic roofline anchors for the RX chain: the port of
bench/roofline.py, against the peaks of the card the port runs on.

Per-stage FLOPs and HBM bytes per processed sample from the spec, so that
measured Msamples/s can be judged against the speed of light:

    python -m ofdm_uhd_tpu_torch.harness.roofline --config c3 \\
        [--msps 123] [--stages-jsonl stages.jsonl] [--device cuda]

The peaks are those PERF.md §6's bound column uses, NVIDIA's published
figures for one H100 (SXM, at its full 700 W limit): 3.35 TB/s of HBM and
67 TFLOP/s in float32 outside the tensor cores. With --device cuda (the
default) the card's name and power limit are printed beside them (a
missing card raises); --device cpu prints the published peaks alone.
--stages-jsonl reads the last record of harness.stages --jsonl and sets
the model's time per stage group beside the measured one, each on the
samples its row ran on: one capture for corr and det+ext, mf frames for
frontend and decode, N captures for corr-xN and det+ext-xN.
"""

from __future__ import annotations

import argparse
import math
import subprocess

from . import add_device_arg, open_device, read_jsonl

PEAK_F32_TFLOPS = 67.0      # float32, CUDA cores
PEAK_HBM_GBS = 3350.0


def chain_costs(spec) -> list[tuple[str, float, float]]:
    """[(stage, flops_per_sample, bytes_per_sample)] at baseband rate."""
    n = spec.n_sc
    sym = spec.sym_len
    occ = spec.n_occupied
    stages = []
    # S&C correlator: prod (8 flops cmul) + 2 boxcar updates (~4) per sample
    stages.append(("sync_correlate", 16.0, 8 * 3))  # read r twice + write P
    # CFO mixer: complex exp + cmul ~ 12 flops
    stages.append(("cfo_mix", 12.0, 16))
    # FFT: 5 N log2 N per symbol of sym samples
    fft_flops = 5 * n * math.log2(n) / sym
    stages.append(("fft", fft_flops, 16))
    # chanest+EQ+CPE per occupied bin, amortized over sym samples
    eq_flops = (occ * 20) / sym
    stages.append(("eq_phase", eq_flops, 8 * occ / sym))
    # LLR demap: 2 axes * 2^(b/2) levels * 4 flops per data bin
    nb = max(spec.bits_per_qam // 2, 1)
    demap = (spec.n_data_sc * 2 * (2 ** nb) * 4) / sym
    stages.append(("llr_demap", demap, 4 * spec.coded_bits_per_sym / sym))
    # Viterbi: 64 states * 2 preds * ~4 flops per input bit
    vit = (spec.uncoded_bits_per_frame * 64 * 2 * 4) / spec.frame_len
    stages.append(("viterbi", vit, 1))
    if spec.resample_l > 1:
        nt = 12 * spec.resample_l
        stages.append(("resample", 4.0 * nt / spec.resample_l, 16))
    return stages


# which chain_costs stages make up each harness.stages timing row, and
# what it runs on: "capture" one capture of n_samples, "frames" mf
# extracted frames (mf * frame_len samples); with --batch N the rows
# corr-xN and det+ext-xN run on N captures (harness.stages times the
# plain rows at one capture whatever the batch)
_STAGE_GROUPS = {
    "corr": (["sync_correlate"], "capture"),
    "det+ext": (["sync_correlate", "cfo_mix"], "capture"),
    "frontend": (["fft", "eq_phase", "llr_demap"], "frames"),
    "decode": (["viterbi"], "frames"),
}
_BATCHED = ("corr", "det+ext")


def crosscheck(spec, rec) -> dict:
    """Model against measured per stage group: is the cost model (and the
    chain's speed of light derived from it) anchored to the card? rec: a
    harness.stages --jsonl record. Returns {row: (model ms, measured
    ms)} and prints them. A measured time below the model's is the
    model's error: no run beats the card's peaks."""
    stages = dict((nm, (f, b)) for nm, f, b in chain_costs(spec))
    batch = rec.get("batch", 1)
    samples = {"capture": rec["n_samples"],
               "frames": rec["mf"] * rec["frame_len"]}
    rows_in = [(row, parts, samples[basis])
               for row, (parts, basis) in _STAGE_GROUPS.items()]
    if batch > 1:
        rows_in += [(f"{row}-x{batch}", _STAGE_GROUPS[row][0],
                     rec["n_samples"] * batch) for row in _BATCHED]
    print(f"\ncross-check vs measured profile ({rec.get('device')}, "
          f"batch={batch}):")
    print(f"{'stage':<12}{'model ms':>10}{'meas ms':>10}{'meas/model':>12}")
    rows = {}
    for row, parts, nsamp in rows_in:
        ms = rec["stages_ms"].get(row)
        if ms is None:
            continue
        f = sum(stages[p][0] for p in parts)
        b = sum(stages[p][1] for p in parts)
        t_model = max(f * nsamp / (PEAK_F32_TFLOPS * 1e12),
                      b * nsamp / (PEAK_HBM_GBS * 1e9)) * 1e3
        rows[row] = (t_model, ms)
        print(f"{row:<12}{t_model:>10.3f}{ms:>10.3f}{ms / t_model:>11.1f}x"
              + ("  (below the model: the model's error)"
                 if ms < t_model else ""))
    print("(meas/model includes each call's launch and host floor; large "
          "ratios on tiny-model stages are that floor, not model error)")
    return rows


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="c3")
    p.add_argument("--msps", type=float, default=None,
                   help="measured Msamples/s to compare against the roofline")
    p.add_argument("--stages-jsonl", default=None,
                   help="harness.stages --jsonl output; cross-checks the "
                        "cost model against the measured per-stage profile")
    add_device_arg(p)
    args = p.parse_args(argv)

    from ..cli import config as C
    device = open_device(args.device)
    spec = C.load_spec(args.config)
    stages = chain_costs(spec)
    tf = sum(f for _, f, _ in stages)
    tb = sum(b for _, _, b in stages)
    card = (card_line() if device.type == "cuda"
            else "no card queried (--device cpu)")
    print(f"peaks: NVIDIA H100 (published, 700 W): {PEAK_HBM_GBS:.0f} GB/s "
          f"HBM, {PEAK_F32_TFLOPS:.0f} TFLOP/s float32; card: {card}")
    print(f"config {args.config}: N={spec.n_sc} cp={spec.cp} "
          f"{spec.modulation} x{spec.n_data_syms} syms")
    print(f"{'stage':<16}{'flops/samp':>12}{'bytes/samp':>12}")
    for name, f, b in stages:
        print(f"{name:<16}{f:>12.1f}{b:>12.1f}")
    print(f"{'TOTAL':<16}{tf:>12.1f}{tb:>12.1f}")
    msps_flops = PEAK_F32_TFLOPS * 1e12 / tf / 1e6
    msps_bw = PEAK_HBM_GBS * 1e9 / tb / 1e6
    bound = "HBM-bandwidth" if msps_bw < msps_flops else "compute"
    sol = min(msps_flops, msps_bw)
    print(f"\nspeed-of-light: {sol:,.0f} Msamples/s ({bound}-bound; "
          f"flops-limit {msps_flops:,.0f}, bw-limit {msps_bw:,.0f})")
    if args.msps:
        print(f"measured {args.msps:,.1f} Msamples/s = "
              f"{100 * args.msps / sol:.1f}% of speed-of-light")
    if args.stages_jsonl:
        recs = read_jsonl(args.stages_jsonl)
        recs = [r for r in recs if r.get("config") == args.config] or recs
        crosscheck(spec, recs[-1])


if __name__ == "__main__":
    main()
