"""Detection rate and false alarms against SNR on the port: the port of
bench/detect_sweep.py.

Stresses the S&C detector below the C2 sweep's 10 dB point, comparing
the fixed threshold against the CFAR (noise-floor-adaptive) mode, and
counts the stream's TRACK-mode rescues on low-SNR captures:

    python -m ofdm_uhd_tpu_torch.harness.detect_sweep [--config c3] \\
        [--snrs -2,0,2,5,8,10] [--trials 8] [--frames 6] \\
        [--device cuda] [--jsonl out]

Columns per SNR point and mode:
  det_rate    detected preambles / transmitted frames
  fer         post-FEC frame error rate among detections
  fa_noise    false 'valid' slots per 100k pure-noise samples (the same
              detector on signal-free captures)
  rescued     frames the TRACK-mode retry recovered on the streaming path
              (StreamRx.rescued; cfar mode at SNR <= 5 dB, else None).
              The reference's harness reads a `rescued` attribute of
              each returned frame, which its StreamFrame does not have, so
              its records say 0 whatever its receiver counted; the port's
              say the receiver's count.
"""

from __future__ import annotations

import argparse

import numpy as np

from . import add_device_arg, open_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="c3")
    ap.add_argument("--snrs", default="-2,0,2,5,8,10")
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--jsonl", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch
    from ..channel import make_capture
    from ..cli.config import load_spec
    from ..core.spec import ChannelSpec
    from ..golden import GoldenModem
    from ..metrics import JsonlLogger
    from ..pipeline import RxPipeline, StreamRx

    device = open_device(args.device)
    spec = load_spec(args.config)
    gm = GoldenModem(spec)
    rng = np.random.default_rng(0)
    rx = {"fixed": RxPipeline(spec),
          "cfar": RxPipeline(spec, sync_threshold_mode="cfar")}
    lg = JsonlLogger(args.jsonl) if args.jsonl else None
    mf = args.frames + 2

    def rx_capture(mode, cap):
        out = rx[mode].rx_capture(torch.from_numpy(cap).to(device),
                                  max_frames=mf)
        return out["valid"].cpu().numpy(), out["crc_ok"].cpu().numpy()

    # false-alarm side: pure noise through both detectors
    fa = {}
    for mode in rx:
        n_fa, n_samp = 0, 0
        for t in range(args.trials):
            r = np.random.default_rng(500 + t)
            noise = (r.normal(size=100_000) + 1j * r.normal(size=100_000)
                     ).astype(np.complex64) * 0.5
            n_fa += int(rx_capture(mode, noise)[0].sum())
            n_samp += noise.size
        fa[mode] = 1e5 * n_fa / n_samp

    print(f"{'SNR':>5} {'mode':>6} {'det_rate':>9} {'fer':>7} "
          f"{'fa/100k':>8} {'rescued':>8}")
    for snr in [float(s) for s in args.snrs.split(",")]:
        for mode in ("fixed", "cfar"):
            det, ok_n, tx_n = 0, 0, 0
            for t in range(args.trials):
                payloads = rng.integers(
                    0, 2, (args.frames, spec.payload_bits_per_frame)
                ).astype(np.uint8)
                frames = np.stack([gm.modulate_frame(p) for p in payloads])
                ch = ChannelSpec(snr_db=snr, cfo=0.2,
                                 timing_offset=300 + 50 * t)
                cap = make_capture(frames, ch, spec.n_sc, gap=900,
                                   seed=100 + t).astype(np.complex64)
                valid, crc_ok = rx_capture(mode, cap)
                det += int(valid.sum())
                ok_n += int(crc_ok.sum())
                tx_n += args.frames
            det_rate = det / tx_n
            fer = 1.0 - ok_n / max(det, 1)
            # TRACK rescue on the streaming path (cfar mode only: the
            # retry needs detections to exist at low SNR first)
            rescued = None
            if mode == "cfar" and snr <= 5:
                srx = StreamRx(spec, chunk_len=4 * spec.frame_len + 4096,
                               threshold_mode="cfar", track_mode=True,
                               device=device)
                payloads = rng.integers(
                    0, 2, (args.frames, spec.payload_bits_per_frame)
                ).astype(np.uint8)
                frames = np.stack([gm.modulate_frame(p) for p in payloads])
                cap = make_capture(frames,
                                   ChannelSpec(snr_db=snr, cfo=0.2,
                                               timing_offset=400),
                                   spec.n_sc, gap=900, seed=77
                                   ).astype(np.complex64)
                srx.process(cap)
                srx.flush()
                rescued = srx.rescued
            row = {"config": args.config, "snr_db": snr, "mode": mode,
                   "det_rate": round(det_rate, 4), "fer": round(fer, 4),
                   "fa_per_100k": round(fa[mode], 3),
                   "rescued": rescued}
            if lg:
                lg.log(row)
            print(f"{snr:>5.1f} {mode:>6} {det_rate:>9.3f} {fer:>7.3f} "
                  f"{fa[mode]:>8.3f} {str(rescued):>8}")


if __name__ == "__main__":
    main()
