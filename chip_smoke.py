"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path, the C3 capture-mode RX chain, through its
user entry point `RxPipeline(spec).rx_capture_sc16(iq, max_frames)` at the
size the repository's bench.py judges (8 captures x 1024 frames, gap 300,
sc16), in phases; each prints its findings on a line of its own:

  1. device:  a CUDA card must be present; prints the card's name and
              power limit as nvidia-smi reports them;
  2. build:   builds the four hand kernels from ofdm_uhd_tpu_torch/kernels/
              csrc (nvcc, sm_90a) into build/ofdm_uhd_tpu_torch/;
  3. stages:  runs the chain's steps one at a time on the whole batch and
              times each (CUDA events, median of 5);
     kernels: holds each kernel against its plain PyTorch version on the
              card, on the inputs those steps gave it, and times both
              (CUDA events, median of 5);
  4. slice:   decodes all 8192 frames, which must match the sent payloads
              bit for bit, with every kernel's launch count > 0 over that
              run; times the chain with the kernels and with the plain
              versions forced, and reads the card's busy share over one
              dispatch from a torch.profiler trace.

Then it prints one JSON line with the per-kernel results and, last, the
line {"ok": true, "device": {...}}. Any failure exits non-zero before
that line. Usage: python3 chip_smoke.py [--out FILE.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

N_CAPS, N_FRAMES, GAP = 8, 1024, 300
MAX_FRAMES = N_FRAMES + 2
REPS = 5

KERNEL_INFO = {
    "localize": ("ofdm_uhd_tpu_torch/kernels/csrc/localize.cu",
                 "ofdm_uhd_tpu/kernels/pallas_localize.py:117"),
    "extract": ("ofdm_uhd_tpu_torch/kernels/csrc/extract.cu",
                "ofdm_uhd_tpu/kernels/pallas_extract.py:108"),
    "fft": ("ofdm_uhd_tpu_torch/kernels/csrc/fft.cu",
            "ofdm_uhd_tpu/kernels/pallas_fft.py:185"),
    "viterbi": ("ofdm_uhd_tpu_torch/kernels/csrc/viterbi.cu",
                "ofdm_uhd_tpu/kernels/pallas_viterbi.py:324"),
}


class SmokeFailure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median device milliseconds of fn over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device(torch) -> dict:
    check(torch.cuda.is_available(), "no CUDA device: the port's kernels "
          "run only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"phase device: ok  torch {torch.__version__} cuda "
        f"{torch.version.cuda}  python {sys.version.split()[0]}  "
        f"devices {torch.cuda.device_count()}")
    return {"card": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> dict:
    from ofdm_uhd_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library(verbose=True)
    secs = time.perf_counter() - t0
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(line, file=sys.stderr)
    log(f"phase build: ok  {secs:.1f} s into {build.build_dir()}")
    return {"build_s": secs}


def make_input(torch, spec, device):
    """The bench's captures: seeds 0..7, as sc16 planes [2, C, n] on device,
    plus the sent payloads [C, F, bits]."""
    import numpy as np
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    t0 = time.perf_counter()
    built = [build_capture(spec, N_FRAMES, GAP, seed=s, device=device)
             for s in range(N_CAPS)]
    caps = np.stack([c for c, _ in built])
    pays = np.stack([p for _, p in built])
    iq = torch.from_numpy(to_sc16(caps)).to(device)
    log(f"input: {N_CAPS} captures x {caps.shape[1]} samples, "
        f"{N_FRAMES} frames each, built in {time.perf_counter() - t0:.1f} s")
    return iq, torch.from_numpy(pays).to(device)


def phase_stages(torch, spec, iq) -> tuple[dict, dict]:
    """The steps of pipeline/rx.py:_rx_capture one at a time, on the whole
    batch: each step's device time (CUDA events, median of 5, so steps do
    not overlap) and each kernel's inputs as the main path produces them."""
    from ofdm_uhd_tpu_torch.kernels import sync as KS
    from ofdm_uhd_tpu_torch.kernels.localize import localize
    from ofdm_uhd_tpu_torch.phy import agc, bits, frame, sync
    from ofdm_uhd_tpu_torch.pipeline import rx
    ms = {}

    def step(name, fn):
        out = fn()
        ms[name] = cuda_ms(torch, fn)
        return out

    shift = min(4, spec.cp // 4)
    nd = iq.shape[-1] - spec.n_sc + 1
    cap = step("sc16+agc", lambda: agc.agc_normalize(
        rx._sc16_to_complex(iq))[0])

    def front():
        p, rr = KS.sc_correlate(cap, spec.n_sc // 2)
        return p, KS.sc_metric(p, rr)
    p, m = step("sc_correlate+metric", front)

    def candidates():
        return sync._first_k_indices(sync._rising_edges(m, 0.5),
                                     min(4 * MAX_FRAMES + 16, nd), nd)[0]
    cand = step("candidates", candidates)
    ds_c, eps_c = step("localize", lambda: localize(m, p, cand, spec.sym_len,
                                                    spec.cp))

    def select():
        found = cand < nd
        valid = found & (ds_c + spec.frame_len <= iq.shape[-1])
        keeps = sync._select(spec, cand, ds_c, valid, found, spec.sym_len)
        return sync._compact(ds_c, eps_c, keeps, MAX_FRAMES)
    ds, eps_f, _ = step("select+compact", select)
    frames = step("extract", lambda: sync.extract_frames(spec, cap, ds))

    def cfo():
        f = sync.cfo_correct(frames, eps_f, spec.n_sc)
        return sync.cfo_correct(f, sync.integer_cfo(spec, f), spec.n_sc)
    flat = step("cfo", cfo).reshape(N_CAPS * MAX_FRAMES, -1)
    grid = step("fft", lambda: frame.ofdm_demodulate(spec, flat, shift))

    def eq_cpe():
        h = frame.estimate_channel(spec, grid)
        return h, frame.track_phase(spec, frame.equalize(spec, grid, h))[0]
    h, data = step("chanest+eq+cpe", eq_cpe)

    llr = step("llr+evm", lambda: rx._demap(spec, data, h))[0]
    llr_d = step("deinterleave", lambda: bits.deinterleave_soft(
        llr, spec.coded_bits_per_sym).contiguous())
    dec = step("viterbi", lambda: bits.viterbi_decode(llr_d))

    def crc():
        body = bits.descramble(dec[:, : dec.shape[-1] - 6])
        return bits.crc32_check(body[:, :-32], body[:, -32:])
    step("descramble+crc", crc)
    total = sum(ms.values())
    log("phase stages: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f" ms; sum {total:.1f} ms")
    windows = frame.fft_windows(spec, flat, shift)
    ins = {"m": m, "p": p, "cand": cand, "cap": cap, "ds": ds,
           "windows": windows, "grid": grid, "llr": llr_d}
    return ins, ms


def device_busy_share(torch, run) -> dict:
    """Share of one dispatch's wall time in which the card ran a kernel or
    copy, from a torch.profiler trace (CUPTI); None where the trace shows
    no device activity."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        return {"busy_share": None, "traced_wall_ms": wall_us / 1e3}
    return {"busy_share": busy / wall_us, "traced_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3, "device_events": len(spans)}


def phase_kernels(torch, spec, ins) -> dict:
    from ofdm_uhd_tpu_torch.kernels import extract, fft, localize, viterbi
    res = {}

    # localize: d exact, eps within 1e-6
    args = (ins["m"], ins["p"], ins["cand"], spec.sym_len, spec.cp)
    d_k, e_k = localize._localize_cuda(*args, 0.9)
    d_p, e_p = localize.localize_plain(*args)
    torch.cuda.synchronize()
    bad_d = int((d_k != d_p).sum())
    err = float((e_k - e_p).abs().max())
    check(bad_d == 0, f"localize: {bad_d} frame starts differ")
    check(err <= 1e-6, f"localize: eps differs by {err}")
    res["localize"] = {"max_abs_err": err, "shape": list(ins["cand"].shape),
                       "ms": cuda_ms(torch, lambda: localize._localize_cuda(
                           *args, 0.9)),
                       "plain_ms": cuda_ms(torch, lambda: localize
                                           .localize_plain(*args))}

    # extract: bit-exact copy
    fl = spec.frame_len
    f_k = extract._extract_cuda(ins["cap"], ins["ds"], fl)
    f_p = extract.extract_plain(ins["cap"], ins["ds"], fl)
    torch.cuda.synchronize()
    check(torch.equal(torch.view_as_real(f_k), torch.view_as_real(f_p)),
          "extract: frames differ")
    res["extract"] = {"max_abs_err": float((f_k - f_p).abs().max()),
                      "shape": list(f_k.shape),
                      "ms": cuda_ms(torch, lambda: extract._extract_cuda(
                          ins["cap"], ins["ds"], fl)),
                      "plain_ms": cuda_ms(torch, lambda: extract
                                          .extract_plain(ins["cap"],
                                                         ins["ds"], fl))}

    # FFT-256, forward on the RX windows and inverse on their grid:
    # within 1e-5 of max|X| against torch.fft (norm="ortho")
    errs = []
    for x, inv in ((ins["windows"], False), (ins["grid"], True)):
        y_k = fft._fft_cuda(x, inverse=inv)
        y_p = fft.fft_plain(x, inverse=inv)
        torch.cuda.synchronize()
        e = float((y_k - y_p).abs().max())
        ref = float(y_p.abs().max())
        check(e <= 1e-5 * ref, f"fft (inverse={inv}): error {e} vs "
              f"max|X| {ref}")
        errs.append(e)
    w = ins["windows"]
    res["fft"] = {"max_abs_err": max(errs), "shape": list(w.shape),
                  "ms": cuda_ms(torch, lambda: fft._fft_cuda(w, False)),
                  "plain_ms": cuda_ms(torch, lambda: fft.fft_plain(w))}

    # Viterbi: bit-exact with the plain scan
    llr = ins["llr"]
    b_k = viterbi._viterbi_cuda(llr)
    b_p = viterbi.viterbi_plain(llr)
    torch.cuda.synchronize()
    bad = int((b_k != b_p).sum())
    check(bad == 0, f"viterbi: {bad} bits differ from the plain decoder")
    res["viterbi"] = {"max_abs_err": float(bad), "shape": list(llr.shape),
                      "ms": cuda_ms(torch, lambda: viterbi._viterbi_cuda(llr)),
                      "plain_ms": cuda_ms(torch, lambda: viterbi
                                          .viterbi_plain(llr))}
    for k, v in res.items():
        log(f"phase kernels: {k:8s} ok  {v['shape']}  kernel "
            f"{v['ms']:.3f} ms  plain {v['plain_ms']:.3f} ms  max_abs_err "
            f"{v['max_abs_err']:.3g}")
    return res


def phase_slice(torch, spec, iq, pays) -> dict:
    from ofdm_uhd_tpu_torch.kernels import policy
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline

    rx = RxPipeline(spec, diag=True)
    torch.cuda.synchronize()
    policy.reset_launches()
    out = rx.rx_capture_sc16(iq, max_frames=MAX_FRAMES)
    torch.cuda.synchronize()
    launches = policy.launches()
    for k, n in launches.items():
        check(n > 0, f"the main path never launched the {k} kernel")
    crc = out["crc_ok"][:, :N_FRAMES]
    n_ok = int(crc.sum())
    exact = bool(torch.equal(out["payload"][:, :N_FRAMES], pays))
    n_valid = int(out["valid"].sum())
    check(n_ok == N_CAPS * N_FRAMES and exact and n_valid == n_ok,
          f"slice: {n_ok}/{N_CAPS * N_FRAMES} crc_ok, payload exact "
          f"{exact}, {n_valid} valid slots")
    for k in ("evm_db", "eps"):
        check(bool(torch.isfinite(out[k]).all()), f"slice: {k} not finite")
    check(not bool(out["det_sat"].any()), "slice: candidate overflow")
    evm = float(out["evm_db"][:, :N_FRAMES].mean())
    log(f"phase slice: ok  {n_ok}/{N_CAPS * N_FRAMES} frames crc_ok and "
        f"bit-exact, mean EVM {evm:.2f} dB, launches {launches}")

    # timing: two distinct buffers (the second XOR 1 in the LSB), every
    # output kept alive, CUDA events around REPS dispatches
    fast = RxPipeline(spec, diag=False)
    xs = [iq, iq ^ 1]
    samples = iq.shape[1] * iq.shape[2]

    def timed(reps):
        for x in xs:
            fast.rx_capture_sc16(x, max_frames=MAX_FRAMES)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        outs = [fast.rx_capture_sc16(xs[i % 2], max_frames=MAX_FRAMES)
                for i in range(reps)]
        end.record()
        end.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / reps
        dev = start.elapsed_time(end) / reps
        check(all(bool(o["crc_ok"][:, :N_FRAMES].all()) for o in outs),
              "slice: a timed dispatch failed its CRC gate")
        return dev, host

    ms, host_ms = timed(REPS)
    busy = device_busy_share(torch, lambda: fast.rx_capture_sc16(
        iq, max_frames=MAX_FRAMES))
    with policy.plain_versions():
        plain_ms, plain_host_ms = timed(1)
    res = {"ms_per_dispatch": ms, "host_ms_per_dispatch": host_ms,
           "msps": samples / (ms * 1e3),
           "plain_ms_per_dispatch": plain_ms,
           "plain_msps": samples / (plain_ms * 1e3),
           "evm_db_mean": evm, "launches": launches,
           "frames_ok": n_ok, "profile": busy}
    log(f"phase slice: kernels {ms:.1f} ms/dispatch "
        f"({res['msps']:.1f} Msamples/s, host {host_ms:.1f} ms), plain "
        f"versions {plain_ms:.1f} ms/dispatch ({res['plain_msps']:.1f} "
        f"Msamples/s), {samples} samples per dispatch")
    share = busy["busy_share"]
    log("phase slice: device busy share under torch.profiler: " + (
        "not measured (no device events in the trace)" if share is None else
        f"{share:.3f} of {busy['traced_wall_ms']:.1f} ms "
        f"({busy['device_events']} device events)"))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    args = ap.parse_args()
    try:
        import torch
        from ofdm_uhd_tpu_torch.core.spec import config
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository's root", file=sys.stderr)
        return 2
    try:
        dev_info = phase_device(torch)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        build_info = phase_build()
        spec = config("c3")
        iq, pays = make_input(torch, spec, device)
        ins, stages = phase_stages(torch, spec, iq)
        kernels = phase_kernels(torch, spec, ins)
        sl = phase_slice(torch, spec, iq, pays)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    line = {"kernels": [
        {"name": k, "route": "cuda", "source": KERNEL_INFO[k][0],
         "replaces": KERNEL_INFO[k][1], "launches": sl["launches"][k],
         "max_abs_err": v["max_abs_err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"]} for k, v in kernels.items()]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": dev_info, "build": build_info,
                       "stages_ms": stages, "kernels": kernels, "slice": sl},
                      f, indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
