"""TX tool: payload bits -> modulated capture file."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import config as C


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    C.add_common_args(p)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--out", required=True, help="output capture (.npy/.iq)")
    p.add_argument("--bits-out", default=None,
                   help="save the payload bits (npy) for loopback checking")
    p.add_argument("--gap", type=int, default=0,
                   help="idle samples between frames")
    args = p.parse_args(argv)

    import torch
    from ..io import write_capture
    from ..pipeline import TxPipeline

    spec = C.spec_from_args(args)
    rng = np.random.default_rng(args.seed)
    payloads = rng.integers(
        0, 2, (args.frames, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = TxPipeline(spec)(
        torch.from_numpy(payloads).to(args.device)).cpu().numpy()
    if args.gap:
        gapz = np.zeros((args.frames, args.gap), dtype=frames.dtype)
        frames = np.concatenate([frames, gapz], axis=1)
    write_capture(args.out, frames.reshape(-1),
                  meta={"config": args.config, "frames": args.frames,
                        "frame_len": spec.frame_len_radio, "gap": args.gap})
    if args.bits_out:
        np.save(args.bits_out, payloads)
    print(f"wrote {args.frames} frames "
          f"({frames.size} samples) to {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
