"""Bench tool: per-config throughput and EVM of the port on one device,
with an optional torch.profiler trace; the counterpart of
ofdm_uhd_tpu/cli/bench.py:

    python -m ofdm_uhd_tpu_torch.cli.bench --config c3 --caps 8 \\
        --frames 1024 --input sc16

Modes: aligned (RxPipeline.rx_aligned on back-to-back frames), capture
(rx_capture / rx_capture_sc16, --caps captures a dispatch) and stream
(StreamRx: host-fed process + flush, or with --resident the K-step chunk
stacks staged on the device first and run through process_device).

The timed window opens after the warm-up: the inputs are built first
(TxPipeline on --device, the NumPy channel), every staged input is run
once, and the device is synchronized. A tool's start-up (imports, the
kernel library, the device's context: seconds) lies outside it, as does
the warm-up. On a card the window is a CUDA event pair on the device's
stream, closed after the small outputs every dispatch is counted by
(crc_ok, evm_db; the stream's frame lists) are on the host; on the CPU
it is the host clock. --trace-dir runs the timed loop under
torch.profiler and writes its Chrome trace there. Prints one JSON record
with the reference's keys.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np

from . import config as C


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    C.add_common_args(p)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--caps", type=int, default=1,
                   help="captures per dispatch (capture mode)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--mode", choices=["aligned", "capture", "stream"],
                   default="capture")
    p.add_argument("--input", choices=["fc32", "sc16"], default="fc32",
                   help="capture- and stream-mode input format (sc16 = "
                        "radio-native int16 IQ, converted on the device)")
    p.add_argument("--chunk", type=int, default=None,
                   help="stream-mode chunk length in baseband samples")
    p.add_argument("--ksteps", type=int, default=8,
                   help="stream-mode chunks per dispatch")
    p.add_argument("--no-track", action="store_true",
                   help="stream-mode: disable the TRACK-mode retry pass "
                        "(for quantifying its cost)")
    p.add_argument("--resident", action="store_true",
                   help="stream-mode: stage the K-step chunk stacks on the "
                        "device first and time the dispatches, the carried "
                        "state and the outputs' fetch alone, without the "
                        "host feed")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace of the timed "
                        "loop here")
    p.add_argument("--jsonl", default=None, help="append results to JSONL")
    args = p.parse_args(argv)

    import torch
    from ..bench_lib import to_sc16
    from ..channel import make_capture
    from ..core.spec import ChannelSpec
    from ..pipeline import RxPipeline, TxPipeline

    spec = C.spec_from_args(args)
    device = torch.device(args.device)
    rng = np.random.default_rng(args.seed)
    payloads = rng.integers(
        0, 2, (args.frames, spec.payload_bits_per_frame)).astype(np.uint8)
    # CFO is expressed in subcarrier spacings at BASEBAND; captures carry it
    # at the radio rate, where the same per-sample ramp reads 1/L as large.
    ch = ChannelSpec(snr_db=28.0, cfo=0.8 / spec.resample_l,
                     timing_offset=100)
    if args.mode == "stream":
        return _bench_stream(args, spec, payloads, ch, device)

    fr = TxPipeline(spec)(torch.from_numpy(payloads).to(device)).cpu().numpy()
    if args.mode == "aligned":
        rx_in = aligned_input(spec, fr)
        rx = RxPipeline(spec, shift=min(4, spec.cp // 4))
        xs = [_stage(torch, rx_in * np.float32(1 + 1e-6 * i), device)
              for i in range(2)]
        run = rx.rx_aligned
        n_samples = rx_in.size
    else:
        caps = np.stack([
            make_capture(fr, ch, spec.n_sc, gap=300, seed=s)
            for s in range(args.caps)]).astype(np.complex64)
        cap_in = caps[0] if args.caps == 1 else caps
        rx = RxPipeline(spec)
        if args.input == "sc16":
            iq = to_sc16(caps).reshape((2,) + cap_in.shape)
            xs = [_stage(torch, iq, device) for _ in range(2)]
            run = lambda x: rx.rx_capture_sc16(x, max_frames=args.frames + 2)
        else:
            xs = [_stage(torch, cap_in * np.float32(1 + 1e-6 * i), device)
                  for i in range(2)]
            run = lambda x: rx.rx_capture(x, max_frames=args.frames + 2)
        n_samples = cap_in.size

    def small(x):
        # the leaves the record reads; the rest of the outputs die here
        out = run(x)
        return out["crc_ok"], out["evm_db"]

    dt, outs = _timed(torch, device, small, xs, args.iters, args.trace_dir,
                      fetch=lambda o: [t.cpu().numpy() for t in o])
    dt /= args.iters
    crc, evm = outs[-1]
    n_ok = int(crc.sum())
    rec = {
        "config": args.config, "mode": args.mode,
        "backend": spec.kernel_backend, "input": args.input,
        "device": _device_name(torch, device),
        "caps_per_dispatch": args.caps,
        "msamples_per_s": round(n_samples / dt / 1e6, 3),
        "frames_per_s": round(n_ok / dt, 1),
        "frames_ok": n_ok,
        "frames": args.frames * (args.caps if args.mode == "capture" else 1),
        # the mean over every slot, the empty ones included, as the
        # reference reports it
        "evm_db": round(float(np.mean(evm)), 2),
    }
    _emit(args, rec)


def aligned_input(spec, fr: np.ndarray) -> np.ndarray:
    """The aligned mode's input: each TX frame fr[i] through the channel
    at SNR 28 dB with no CFO and no timing offset, seeded by its index."""
    from ..channel import apply_channel
    from ..core.spec import ChannelSpec
    ch = ChannelSpec(snr_db=28.0, cfo=0.0, timing_offset=0)
    return np.stack([apply_channel(f, ch, spec.n_sc, seed=i)
                     for i, f in enumerate(fr)])


def _stage(torch, x: np.ndarray, device):
    """One input on the device; complex inputs as complex64."""
    if np.iscomplexobj(x):
        x = x.astype(np.complex64)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _device_name(torch, device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


@contextlib.contextmanager
def _trace(torch, device, trace_dir):
    """torch.profiler around the block (the CPU's activity, and the card's
    where the device is one), its Chrome trace written into trace_dir."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"bench-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
                   ".pt.trace.json"))


def _timed(torch, device, run, inputs, iters, trace_dir, fetch=None):
    """run(x) once on every staged input (the warm-up), then `iters` timed
    passes over them in turn: (seconds for all the passes, each pass's
    result after `fetch`). The window closes once every result is on the
    host: a CUDA event pair on the device's stream on a card, the host
    clock on the CPU."""
    fetch = fetch or (lambda r: r)
    for x in inputs:
        fetch(run(x))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        stream = torch.cuda.current_stream(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with _trace(torch, device, trace_dir):
        if cuda:
            start.record(stream)
        else:
            t0 = time.perf_counter()
        got = [run(inputs[i % len(inputs)]) for i in range(iters)]
        got = [fetch(r) for r in got]
        if cuda:
            end.record(stream)
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - t0
    return dt, got


def _emit(args, rec: dict) -> None:
    from ..metrics import JsonlLogger
    if args.jsonl:
        JsonlLogger(args.jsonl).log(rec)
    print(json.dumps(rec))


def _bench_stream(args, spec, payloads, ch, device):
    """Continuous-stream throughput: StreamRx over a radio-rate capture,
    steady-state, counting input samples at the RADIO rate."""
    import torch
    from ..bench_lib import to_sc16
    from ..channel import make_capture
    from ..pipeline import StreamRx, TxPipeline

    fr = TxPipeline(spec)(torch.from_numpy(payloads).to(device)).cpu().numpy()
    cap = make_capture(fr, ch, spec.n_sc, gap=300,
                       seed=args.seed).astype(np.complex64)
    rx = StreamRx(spec, chunk_len=args.chunk,
                  steps_per_dispatch=args.ksteps,
                  track_mode=not args.no_track,
                  input_format=args.input, device=device)
    if args.input == "sc16":
        feed = to_sc16(cap[None])[:, 0]
        n_cap = feed.shape[1]
    else:
        feed, n_cap = cap, len(cap)
    # pad the tail so every iteration feeds whole K-groups of chunks
    # (steady state: every dispatch in the timed loop is the K-step one)
    pad = (-n_cap) % (rx.radio_chunk * args.ksteps)
    if args.input == "sc16":
        feed = np.concatenate([feed, np.zeros((2, pad), np.int16)], axis=1)
    else:
        feed = np.concatenate([feed, np.zeros(pad, np.complex64)])
    n_cap += pad

    if args.resident:
        return _bench_stream_resident(args, spec, rx, feed, n_cap, device)

    def run_pass(f):
        return sum(g.crc_ok for g in rx.process(f))

    # one warm-up pass; the stream's state carries through every pass
    dt, counts = _timed(torch, device, run_pass, [feed], args.iters,
                        args.trace_dir)
    n_ok = sum(counts) + sum(g.crc_ok for g in rx.flush())
    rec = {
        "config": args.config, "mode": "stream",
        "backend": spec.kernel_backend, "input": args.input,
        "device": _device_name(torch, device),
        "n_devices": rx.mesh.devices.size,
        "chunk_len": rx.chunk_len,
        "ksteps": args.ksteps,
        "track_mode": not args.no_track,
        "msamples_per_s": round(n_cap * args.iters / dt / 1e6, 3),
        "frames_per_s": round(n_ok / dt, 1),
        "frames_ok": n_ok, "frames": args.frames * args.iters,
    }
    _emit(args, rec)


def _bench_stream_resident(args, spec, rx, feed, n_cap, device):
    """Device-resident streaming: the K-step chunk stacks staged once (two
    perturbed copies, used in turn), then dispatch + carried StreamState +
    the outputs' fetch timed alone: the chain's streaming capacity
    separated from the host feed."""
    import torch

    k, rc = args.ksteps, rx.radio_chunk
    n_disp = n_cap // (k * rc)
    sc16 = args.input == "sc16"
    devs = []
    for v in range(2):
        if sc16:
            g = feed ^ np.int16(v)             # 1-LSB content perturbation
            stack = np.ascontiguousarray(
                g[:, :n_disp * k * rc].reshape(2, n_disp * k, rc)
                .swapaxes(0, 1).reshape(n_disp, k, 2, rc))
        else:
            g = feed * np.complex64(1 + 1e-6 * v)
            stack = g[:n_disp * k * rc].reshape(n_disp, k, rc)
        devs.append([_stage(torch, stack[d], device) for d in range(n_disp)])

    def run_pass(stacks):
        # the owned slots' CRC passes of every dispatch, no flush, as the
        # reference counts them (valid x crc_ok of each step's slots):
        # process_device returns exactly the owned slots
        return sum(g.crc_ok for g in rx.process_device(stacks))

    dt, counts = _timed(torch, device, run_pass, devs, args.iters,
                        args.trace_dir)
    n_ok = sum(counts)
    rec = {
        "config": args.config, "mode": "stream-resident",
        "backend": spec.kernel_backend, "input": args.input,
        "device": _device_name(torch, device),
        "n_devices": rx.mesh.devices.size, "chunk_len": rx.chunk_len,
        "ksteps": k, "track_mode": not args.no_track,
        "msamples_per_s": round(n_disp * k * rc * args.iters / dt / 1e6, 3),
        "frames_per_s": round(n_ok / dt, 1),
        "frames_ok": n_ok,
    }
    _emit(args, rec)


if __name__ == "__main__":
    main()
