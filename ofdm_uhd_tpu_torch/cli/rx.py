"""RX tool: capture file -> decoded bits + metrics.

Reads the capture on the host, then decodes it with the capture pipeline
(Schmidl-Cox detection) on --device; --aligned decodes back-to-back
frames at known boundaries.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import config as C


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    C.add_common_args(p)
    p.add_argument("--capture", required=True)
    p.add_argument("--bits-out", default=None)
    p.add_argument("--expect-bits", default=None,
                   help="payload npy to compare against (reports BER)")
    p.add_argument("--max-frames", type=int, default=64)
    p.add_argument("--aligned", action="store_true",
                   help="frames are back-to-back from sample 0 (loopback)")
    p.add_argument("--threshold", type=float, default=0.5)
    args = p.parse_args(argv)

    import torch
    from ..io import read_capture
    from ..metrics import RunMetrics
    from ..pipeline import RxPipeline

    spec = C.spec_from_args(args)
    samples, meta = read_capture(args.capture)
    rx = RxPipeline(spec, sync_threshold=args.threshold)
    m = RunMetrics()
    if args.aligned:
        flen = spec.frame_len_radio
        gap = meta.get("gap", 0)
        n = len(samples) // (flen + gap)
        frames = samples[: n * (flen + gap)].reshape(n, flen + gap)[:, :flen]
        out = rx.rx_aligned(torch.from_numpy(frames).to(args.device))
        out["valid"] = torch.ones(n, dtype=torch.bool,
                                  device=out["crc_ok"].device)
    else:
        out = rx.rx_capture(torch.from_numpy(samples).to(args.device),
                            max_frames=args.max_frames)
    m.update_batch(out, len(samples))
    valid = out["valid"].cpu().numpy()
    payloads = out["payload"].cpu().numpy()[valid]
    if args.bits_out:
        np.save(args.bits_out, payloads)
    if args.expect_bits:
        expect = np.load(args.expect_bits)
        nf = min(len(expect), len(payloads))
        nbit = np.prod(expect[:nf].shape)
        nerr = int(np.sum(payloads[:nf] != expect[:nf]))
        print(f"post-FEC BER: {nerr}/{nbit} = {nerr/max(nbit,1):.2e} "
              f"({'bit-exact' if nerr == 0 and nf == len(expect) else 'ERRORS'})",
              file=sys.stderr)
    s = m.summary()
    print(f"frames: {s['frames_detected']} detected, {s['frames_ok']} crc-ok; "
          f"EVM {s['mean_evm_db']:.1f} dB; "
          f"{s['msamples_per_s']:.2f} Msamples/s", file=sys.stderr)


if __name__ == "__main__":
    main()
