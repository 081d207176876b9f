"""The 2-stage pipeline-parallel RX against frame-parallel RX on the port:
the port of bench/pp_ab.py.

    python -m ofdm_uhd_tpu_torch.harness.pp_ab [--batch 64] [--iters 3] \\
        [--device cuda] [--jsonl out]

Runs shard/stage_pipeline.rx_aligned_pipelined (2 stages, 4
microbatches) and shard/frame_parallel.rx_frames_sharded on the same two
mesh entries, plus the 8-entry frame row, on C2's aligned frames at 25
dB: each once for its bits (bit_exact: every frame's CRC passes and its
payload is the one sent), then --iters timed runs by the host clock
around a synchronized run. The entries are distinct cards where the
machine has that many, else they share --device (one card, or the
host's cores on the CPU), and the record's `device` says which.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from . import add_device_arg, device_name, open_device, synchronize


def entries(device, n: int) -> tuple[list, str]:
    """n mesh entries: n distinct cards where there are that many, else
    n times `device`; and how the record names them."""
    import torch
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return ([torch.device("cuda", i) for i in range(n)],
                f"{device_name(device)} x {n} cards")
    where = "one card" if device.type == "cuda" else "the host's cores"
    return [device] * n, f"{device_name(device)} ({n} entries sharing " \
                         f"{where})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--jsonl", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    import torch
    from ..channel import apply_channel
    from ..core.spec import ChannelSpec, config
    from ..golden import GoldenModem
    from ..metrics import JsonlLogger
    from ..shard.frame_parallel import rx_frames_sharded
    from ..shard.mesh import make_mesh, make_stage_mesh
    from ..shard.stage_pipeline import rx_aligned_pipelined

    device = open_device(args.device)
    spec = config("c2")
    gm = GoldenModem(spec)
    rng = np.random.default_rng(0)
    payloads = rng.integers(0, 2, (args.batch, spec.payload_bits_per_frame)
                            ).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(p) for p in payloads])
    rx_in = torch.from_numpy(np.stack([
        apply_channel(frames[i], ChannelSpec(snr_db=25.0), spec.n_sc,
                      seed=i) for i in range(args.batch)]
    ).astype(np.complex64)).to(device)

    def timed(name, fn, devs, where):
        out = fn(rx_in)                      # warm-up + correctness
        ok = bool(out["crc_ok"].all())
        pay = np.array_equal(out["payload"].cpu().numpy(), payloads)
        for d in set(devs):
            synchronize(d)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(rx_in)
        for d in set(devs):
            synchronize(d)
        dt = (time.perf_counter() - t0) / args.iters
        print(f"{name:<26} {dt*1e3:9.2f} ms  bit_exact={ok and pay}  "
              f"[{where}]", flush=True)
        return {"mode": name, "ms": round(dt * 1e3, 2),
                "bit_exact": ok and pay, "device": where}

    two, where2 = entries(device, 2)
    eight, where8 = entries(device, 8)
    rows = [
        timed("pp-2stage (2 devices)",
              rx_aligned_pipelined(spec, make_stage_mesh(2, two), n_micro=4),
              two, where2),
        timed("frame-parallel (2 devices)",
              rx_frames_sharded(spec, make_mesh(2, 1, devices=two)),
              two, where2),
        timed("frame-parallel (8 devices)",
              rx_frames_sharded(spec, make_mesh(8, 1, devices=eight)),
              eight, where8),
    ]
    if args.jsonl:
        lg = JsonlLogger(args.jsonl)
        for r in rows:
            r.update({"batch": args.batch, "config": "c2"})
            lg.log(r)


if __name__ == "__main__":
    main()
