"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two paths through their user entry points, in phases;
each prints its findings on a line of its own:

  C3, the capture-mode RX chain `RxPipeline(config("c3")).rx_capture_sc16(
      iq, max_frames)` at the size the repository's bench.py judges (8
      captures x 1024 frames, gap 300, sc16);
  C4, the resampled chain: `TxPipeline(config("c4"))` builds 8 captures x
      32 frames on the card (the reference's C4 row: gap 300, timing offset
      100, SNR 28 dB, CFO 0.8 / 8 at the radio rate, no phase noise, fc32)
      and `RxPipeline(config("c4")).rx_capture(capture, max_frames)`
      decimates by 8 and decodes them.

  1. device:  a CUDA card must be present; prints the card's name and
              power limit as nvidia-smi reports them;
  2. build:   builds the seven hand kernels from ofdm_uhd_tpu_torch/kernels/
              csrc (one nvcc per source, sm_90a, started together) into
              build/ofdm_uhd_tpu_torch/;
  then for C3 and for C4 in turn:
  3. input:   C4 only: the captures, built by the port's TxPipeline (its
              interpolation is the interp kernel);
  4. stages:  runs the chain's steps one at a time on the whole batch and
              times each (CUDA events, median of 5);
  5. kernels: holds each kernel against its plain PyTorch version on the
              card, on the inputs those steps gave it, and times both
              (CUDA events, median of 5);
  6. slice:   decodes every frame, which must match the sent payloads bit
              for bit, with the launch count of every kernel of the path
              > 0 over that run; times the chain with the kernels and with
              the plain versions forced, requires the plain run's frame
              starts `d` and `valid` to equal the kernel run's, and reads
              the card's busy share over one dispatch (torch.profiler).

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

N_CAPS, GAP = 8, 300
C3_FRAMES = 1024
C4_FRAMES = 32
REPS = 5
REL_TOL = 1e-5          # FIR / FFT / S&C P: max error within 1e-5 * max|y|
M_TOL = 1e-5            # S&C metric M: absolute (M lies in [0, ~1])

KERNEL_INFO = {
    "localize": ("ofdm_uhd_tpu_torch/kernels/csrc/localize.cu",
                 "ofdm_uhd_tpu/kernels/pallas_localize.py:117"),
    "extract": ("ofdm_uhd_tpu_torch/kernels/csrc/extract.cu",
                "ofdm_uhd_tpu/kernels/pallas_extract.py:108"),
    "fft": ("ofdm_uhd_tpu_torch/kernels/csrc/fft.cu",
            "ofdm_uhd_tpu/kernels/pallas_fft.py:185"),
    "viterbi": ("ofdm_uhd_tpu_torch/kernels/csrc/viterbi.cu",
                "ofdm_uhd_tpu/kernels/pallas_viterbi.py:324"),
    "fir": ("ofdm_uhd_tpu_torch/kernels/csrc/fir.cu",
            "ofdm_uhd_tpu/kernels/pallas_fir_mxu.py:154"),
    "interp": ("ofdm_uhd_tpu_torch/kernels/csrc/fir.cu",
               "ofdm_uhd_tpu/kernels/pallas_fir_mxu.py:176"),
    "scfront": ("ofdm_uhd_tpu_torch/kernels/csrc/scfront.cu",
                "ofdm_uhd_tpu/kernels/pallas_scfront.py:103"),
}
# the kernels each path's RX launches (C4's interp runs in its TX)
C3_PATH = ("scfront", "localize", "extract", "fft", "viterbi")
C4_PATH = ("fir",) + C3_PATH


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


def make_input_c3(torch, spec, device):
    """The bench's captures: seeds 0..7, as sc16 planes [2, C, n] on device,
    plus the sent payloads [C, F, bits]."""
    import numpy as np
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    t0 = time.perf_counter()
    built = [build_capture(spec, C3_FRAMES, GAP, seed=s, device=device)
             for s in range(N_CAPS)]
    caps = np.stack([c for c, _ in built])
    pays = np.stack([p for _, p in built])
    iq = torch.from_numpy(to_sc16(caps)).to(device)
    log(f"c3 input: {N_CAPS} captures x {caps.shape[1]} samples, "
        f"{C3_FRAMES} frames each, built in {time.perf_counter() - t0:.1f} s")
    return iq, torch.from_numpy(pays).to(device)


def make_input_c4(torch, spec, device):
    """The reference's C4 row: seeds 0..7, fc32 captures [C, n] on device,
    the sent payloads [C, F, bits], the TX's launch counts, and the
    baseband frames its interpolation took (the interp kernel's input)."""
    import numpy as np
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.kernels import policy
    from ofdm_uhd_tpu_torch.pipeline import TxPipeline
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    policy.reset_launches()
    built = [build_capture(spec, C4_FRAMES, GAP, seed=s, snr_db=28.0,
                           cfo=0.8 / spec.resample_l, phase_noise_std=0.0,
                           timing_offset=100, device=device)
             for s in range(N_CAPS)]
    torch.cuda.synchronize()
    launches = policy.launches()
    check(launches["interp"] > 0, "c4 input: the TX never launched the "
          "interp kernel")
    caps = torch.from_numpy(np.stack([c for c, _ in built])).to(device)
    pays = torch.from_numpy(np.stack([p for _, p in built])).to(device)
    base = TxPipeline(spec).baseband(pays[0])
    log(f"c4 input: {N_CAPS} captures x {caps.shape[1]} radio samples, "
        f"{C4_FRAMES} frames each, fc32, built in "
        f"{time.perf_counter() - t0:.1f} s; TX launches {launches}")
    return caps, pays, base, launches


def phase_stages(torch, spec, label, x, max_frames) -> tuple[dict, dict]:
    """The steps of pipeline/rx.py:_rx_capture one at a time, on the whole
    batch: each step's device time (CUDA events, median of 5, so steps do
    not overlap) and each kernel's inputs as the main path produces them.
    x: sc16 planes [2, C, n] (C3) or fc32 radio-rate captures [C, n] (C4)."""
    from ofdm_uhd_tpu_torch.kernels import scfront
    from ofdm_uhd_tpu_torch.kernels.localize import localize
    from ofdm_uhd_tpu_torch.phy import agc, bits, frame, sync
    from ofdm_uhd_tpu_torch.pipeline import rx
    ms = {}
    ins = {}

    def step(name, fn):
        out = fn()
        ms[name] = cuda_ms(torch, fn)
        return out

    shift = min(4, spec.cp // 4)
    if x.dtype == torch.int16:
        cap = step("sc16+agc", lambda: agc.agc_normalize(
            rx._sc16_to_complex(x))[0])
    else:
        dec = step("decim", lambda: rx._capture_to_baseband(spec, x))
        cap = step("agc", lambda: agc.agc_normalize(dec)[0])
        pad = (-x.shape[-1]) % spec.resample_l    # as _capture_to_baseband
        ins["radio"] = torch.cat([x, x.new_zeros(x.shape[0], pad)], -1)
        ins["dec"] = dec
    caps, n = cap.shape
    nd = n - spec.n_sc + 1
    p, m = step("scfront", lambda: scfront.sc_frontend(cap, spec.n_sc // 2))

    def candidates():
        return sync._first_k_indices(sync._rising_edges(m, 0.5),
                                     min(4 * max_frames + 16, nd), nd)[0]
    cand = step("candidates", candidates)
    ds_c, eps_c = step("localize", lambda: localize(m, p, cand, spec.sym_len,
                                                    spec.cp))

    def select():
        found = cand < nd
        valid = found & (ds_c + spec.frame_len <= n)
        keeps = sync._select(spec, cand, ds_c, valid, found, spec.sym_len)
        return sync._compact(ds_c, eps_c, keeps, max_frames)
    ds, eps_f, _ = step("select+compact", select)
    frames = step("extract", lambda: sync.extract_frames(spec, cap, ds))

    def cfo():
        f = sync.cfo_correct(frames, eps_f, spec.n_sc)
        return sync.cfo_correct(f, sync.integer_cfo(spec, f), spec.n_sc)
    flat = step("cfo", cfo).reshape(caps * max_frames, -1)
    grid = step("fft", lambda: frame.ofdm_demodulate(spec, flat, shift))

    def eq_cpe():
        h = frame.estimate_channel(spec, grid)
        return h, frame.track_phase(spec, frame.equalize(spec, grid, h))[0]
    h, data = step("chanest+eq+cpe", eq_cpe)

    llr = step("llr+evm", lambda: rx._demap(spec, data, h))[0]
    llr_d = step("deinterleave", lambda: bits.deinterleave_soft(
        llr, spec.coded_bits_per_sym).contiguous())
    dec_bits = step("viterbi", lambda: bits.viterbi_decode(llr_d))

    def crc():
        body = bits.descramble(dec_bits[:, : dec_bits.shape[-1] - 6])
        return bits.crc32_check(body[:, :-32], body[:, -32:])
    step("descramble+crc", crc)
    total = sum(ms.values())
    log(f"{label} stages: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f" ms; sum {total:.1f} ms")
    ins.update({"m": m, "p": p, "cand": cand, "cap": cap, "ds": ds,
                "windows": frame.fft_windows(spec, flat, shift),
                "grid": grid, "llr": llr_d})
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


def held(torch, name, run_k, run_p, tol, shape) -> dict:
    """Run a kernel wrapper and its plain version on the same inputs,
    require tol(kernel, plain) -> (ok, err), and time both."""
    y_k, y_p = run_k(), run_p()
    torch.cuda.synchronize()
    ok, err = tol(y_k, y_p)
    check(ok, f"{name}: kernel differs from the plain version by {err}")
    return {"max_abs_err": err, "shape": list(shape),
            "ms": cuda_ms(torch, run_k), "plain_ms": cuda_ms(torch, run_p)}


def rel_close(y_k, y_p) -> tuple[bool, float]:
    err = float((y_k - y_p).abs().max())
    return err <= REL_TOL * float(y_p.abs().max()), err


def scfront_close(k, p) -> tuple[bool, float]:
    """(P, M) pairs: M within M_TOL absolute, P within REL_TOL of max|P|."""
    ok_p, _ = rel_close(k[0], p[0])
    err = float((k[1] - p[1]).abs().max())
    return ok_p and err <= M_TOL, err


def log_kernels(label, res) -> None:
    for k, v in res.items():
        log(f"{label} kernels: {k:9s} ok  {v['shape']}  kernel "
            f"{v['ms']:.3f} ms  plain {v['plain_ms']:.3f} ms  max_abs_err "
            f"{v['max_abs_err']:.3g}")


def phase_kernels(torch, spec, label, ins) -> dict:
    """The kernels both paths' RX runs (S&C front end, localize, extract,
    FFT, Viterbi), each against its plain version on the inputs this
    path's steps gave it."""
    from ofdm_uhd_tpu_torch.kernels import (extract, fft, localize, scfront,
                                            viterbi)
    res = {}

    # S&C front end at l = n_sc / 2 (128 on C3, 512 on C4)
    l = spec.n_sc // 2
    res["scfront"] = held(torch, "scfront",
                          lambda: scfront._scfront_cuda(ins["cap"], l),
                          lambda: scfront.sc_frontend_plain(ins["cap"], l),
                          scfront_close, ins["cap"].shape)

    # localize: d exact, eps within 1e-6
    args = (ins["m"], ins["p"], ins["cand"], spec.sym_len, spec.cp)

    def loc_close(k, p):
        err = float((k[1] - p[1]).abs().max())
        return bool(torch.equal(k[0], p[0])) and err <= 1e-6, err
    res["localize"] = held(torch, "localize",
                           lambda: localize._localize_cuda(*args, 0.9),
                           lambda: localize.localize_plain(*args), loc_close,
                           ins["cand"].shape)

    # extract: bit-exact copy
    fl = spec.frame_len

    def ext_close(k, p):
        return (bool(torch.equal(torch.view_as_real(k),
                                 torch.view_as_real(p))),
                float((k - p).abs().max()))
    res["extract"] = held(torch, "extract",
                          lambda: extract._extract_cuda(ins["cap"], ins["ds"],
                                                        fl),
                          lambda: extract.extract_plain(ins["cap"], ins["ds"],
                                                        fl),
                          ext_close, (ins["ds"].numel(), fl))

    # FFT, forward on the RX windows and inverse on their grid: within
    # 1e-5 of max|X| against torch.fft (norm="ortho")
    inv = held(torch, "ifft", lambda: fft._fft_cuda(ins["grid"], True),
               lambda: fft.fft_plain(ins["grid"], inverse=True), rel_close,
               ins["grid"].shape)
    w = ins["windows"]
    res["fft"] = held(torch, "fft", lambda: fft._fft_cuda(w, False),
                      lambda: fft.fft_plain(w), rel_close, w.shape)
    res["fft"]["max_abs_err"] = max(res["fft"]["max_abs_err"],
                                    inv["max_abs_err"])

    # Viterbi: bit-exact with the plain scan
    llr = ins["llr"]

    def vit_close(k, p):
        bad = int((k != p).sum())
        return bad == 0, float(bad)
    res["viterbi"] = held(torch, "viterbi", lambda: viterbi._viterbi_cuda(llr),
                          lambda: viterbi.viterbi_plain(llr), vit_close,
                          llr.shape)
    log_kernels(label, res)
    return res


def phase_kernels_fir(torch, spec, ins, base) -> dict:
    """C4's FIR kernels: decimation of the padded radio-rate captures,
    the stride-1 FIR of the decimated ones, and the TX's interpolation of
    its baseband frames."""
    from ofdm_uhd_tpu_torch.kernels import fir
    from ofdm_uhd_tpu_torch.phy import tables
    res = {}
    lr = spec.resample_l
    taps = tables.resample_filter(lr, spec.resample_m)
    xin = ins["radio"]
    res["fir"] = held(torch, "decim", lambda: fir._strided_cuda(xin, taps, lr),
                      lambda: fir.decim_plain(xin, lr, taps), rel_close,
                      xin.shape)
    dec = ins["dec"]
    res["fir_stride1"] = held(torch, "fir", lambda: fir._strided_cuda(
        dec, taps, 1), lambda: fir.decim_plain(dec, 1, taps), rel_close,
        dec.shape)
    res["interp"] = held(torch, "interp",
                         lambda: fir._interp_cuda(base, lr, taps),
                         lambda: fir.interp_plain(base, lr, taps), rel_close,
                         base.shape)
    log_kernels("c4", res)
    return res


def phase_slice(torch, spec, label, x, x2, pays, max_frames, path,
                sc16) -> dict:
    """Decode every frame of x through the entry point (rx_capture_sc16 for
    sc16 planes, rx_capture for fc32), check it, and time it against the
    plain-forced chain; x2 is a second, distinct buffer of the same shape
    for the timed loop."""
    from ofdm_uhd_tpu_torch.kernels import policy
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline

    def entry(rx):
        return rx.rx_capture_sc16 if sc16 else rx.rx_capture

    n_caps, n_frames = pays.shape[0], pays.shape[1]
    run = entry(RxPipeline(spec, diag=True))
    torch.cuda.synchronize()
    policy.reset_launches()
    out = run(x, max_frames=max_frames)
    torch.cuda.synchronize()
    launches = policy.launches()
    for k in path:
        check(launches[k] > 0, f"{label}: the main path never launched the "
              f"{k} kernel")
    crc = out["crc_ok"][:, :n_frames]
    n_ok = int(crc.sum())
    exact = bool(torch.equal(out["payload"][:, :n_frames], pays))
    n_valid = int(out["valid"].sum())
    check(n_ok == n_caps * n_frames and exact and n_valid == n_ok,
          f"{label} slice: {n_ok}/{n_caps * n_frames} crc_ok, payload exact "
          f"{exact}, {n_valid} valid slots")
    for k in ("evm_db", "eps"):
        check(bool(torch.isfinite(out[k]).all()), f"{label}: {k} not finite")
    check(not bool(out["det_sat"].any()), f"{label}: candidate overflow")
    evm = float(out["evm_db"][:, :n_frames].mean())
    # the reference's bench averages over every slot, empty ones included
    evm_slots = float(out["evm_db"].mean())
    log(f"{label} slice: ok  {n_ok}/{n_caps * n_frames} frames crc_ok and "
        f"bit-exact, mean EVM {evm:.2f} dB over the frames, {evm_slots:.2f} "
        f"dB over all {max_frames} slots, launches {launches}")

    # timing: two distinct buffers, every output kept alive, CUDA events
    # around the dispatches
    fast = entry(RxPipeline(spec, diag=False))
    xs = [x, x2]
    samples = n_caps * x.shape[-1]            # at the radio rate

    def timed(reps):
        for xi in xs:
            fast(xi, max_frames=max_frames)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        outs = [fast(xs[i % 2], max_frames=max_frames) for i in range(reps)]
        end.record()
        end.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / reps
        dev = start.elapsed_time(end) / reps
        check(all(bool(o["crc_ok"][:, :n_frames].all()) for o in outs),
              f"{label}: a timed dispatch failed its CRC gate")
        return dev, host, outs[0]

    ms, host_ms, _ = timed(REPS)
    busy = device_busy_share(torch, lambda: fast(x, max_frames=max_frames))
    with policy.plain_versions():
        plain_ms, plain_host_ms, plain_out = timed(1)
    for k in ("d", "valid"):
        same = bool(torch.equal(plain_out[k], out[k]))
        check(same, f"{label}: {k} of the plain-forced run differs from the "
              "kernel run's")
    res = {"ms_per_dispatch": ms, "host_ms_per_dispatch": host_ms,
           "msps": samples / (ms * 1e3),
           "plain_ms_per_dispatch": plain_ms,
           "plain_msps": samples / (plain_ms * 1e3),
           "evm_db_mean": evm, "evm_db_mean_slots": evm_slots,
           "launches": launches,
           "frames_ok": n_ok, "profile": busy}
    log(f"{label} slice: d and valid equal to the plain-forced run; kernels "
        f"{ms:.1f} ms/dispatch ({res['msps']:.1f} Msamples/s, host "
        f"{host_ms:.1f} ms), plain versions {plain_ms:.1f} ms/dispatch "
        f"({res['plain_msps']:.1f} Msamples/s), {samples} samples per "
        "dispatch")
    share = busy["busy_share"]
    log(f"{label} slice: device busy share under torch.profiler: " + (
        "not measured (no device events in the trace)" if share is None else
        f"{share:.3f} of {busy['traced_wall_ms']:.1f} ms "
        f"({busy['device_events']} device events)"))
    return res


def run_c3(torch, config, device) -> dict:
    spec = config("c3")
    iq, pays = make_input_c3(torch, spec, device)
    max_frames = C3_FRAMES + 2
    ins, stages = phase_stages(torch, spec, "c3", iq, max_frames)
    kernels = phase_kernels(torch, spec, "c3", ins)
    del ins
    sl = phase_slice(torch, spec, "c3", iq, iq ^ 1, pays, max_frames,
                     C3_PATH, sc16=True)
    return {"stages_ms": stages, "kernels": kernels, "slice": sl}


def run_c4(torch, config, device) -> dict:
    spec = config("c4")
    caps, pays, base, tx_launches = make_input_c4(torch, spec, device)
    max_frames = C4_FRAMES + 2
    ins, stages = phase_stages(torch, spec, "c4", caps, max_frames)
    kernels = {**phase_kernels(torch, spec, "c4", ins),
               **phase_kernels_fir(torch, spec, ins, base)}
    del ins
    x2 = caps * torch.tensor(1 + 1e-6, dtype=torch.float32, device=device)
    sl = phase_slice(torch, spec, "c4", caps, x2, pays, max_frames,
                     C4_PATH, sc16=False)
    return {"stages_ms": stages, "kernels": kernels, "slice": sl,
            "tx_launches": tx_launches}


def kernel_entry(name, c3, c4) -> dict:
    """One kernel's entry of the kernels line. Each kernel was held against
    its plain version on every path that runs it (fir also at stride 1):
    max_abs_err is the worst over those checks, `paths` gives each
    check's numbers, and ms / plain_ms are those of the larger main-path
    shape (C3's, for the kernels both paths run). launches sums the
    counted runs (the C3 and C4 slices, and C4's TX input build), and
    launches_by_path splits them."""
    src, rep = KERNEL_INFO[name]
    held_on = {p + k[len(name):]: v for p, r in (("c3", c3), ("c4", c4))
               for k, v in r["kernels"].items()
               if k == name or k.startswith(name + "_")}
    first = next(iter(held_on.values()))
    by_path = {"c3": c3["slice"]["launches"][name],
               "c4": c4["slice"]["launches"][name],
               "c4_tx": c4["tx_launches"][name]}
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(by_path.values()),
            "max_abs_err": max(v["max_abs_err"] for v in held_on.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "launches_by_path": by_path,
            "paths": {p: {k: v[k] for k in ("shape", "max_abs_err", "ms",
                                             "plain_ms")}
                      for p, v in held_on.items()}}


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
        c3 = run_c3(torch, config, device)
        c4 = run_c4(torch, config, device)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    line = {"kernels": [kernel_entry(k, c3, c4) for k in KERNEL_INFO]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": dev_info, "build": build_info, "c3": c3,
                       "c4": c4}, f, indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
