"""Stream scaling on the port: frames/s and Msamples/s of StreamRx against
the size of the mesh's time axis, the port of bench/pod.py.

    python -m ofdm_uhd_tpu_torch.harness.pod --config c5 --devices 1,2,4 \\
        [--frames 24] [--iters 5] [--device cuda] [--jsonl out]

Each entry of --devices is a time axis of d entries, make_mesh(1, d,
...): on the card, the first d cards (a size above the cards present is
skipped); on the CPU (--device cpu, or --cpu N: at most N entries) d
`cpu` entries, which share the host's cores. With --distributed, one
process a card (or a CPU process) joins a group through
shard/mesh.py init_distributed, from torchrun's environment as
cli/pod_rx.py does, and d is the whole axis, d / world entries a
process. Each size decodes the capture once (its warm-up and its
frames_ok), then --iters timed passes by the host clock around a
synchronized run, each from a fresh stream state. scaling_eff (the size's
Msamples/s over the first size's times d) is given only when every
entry is a card of its own; otherwise scaling_eff_note says why not.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import add_device_arg, open_device, synchronize


def mesh_entries(device, d: int, world: int, local) -> list | None:
    """This process's entries of a time axis of d, or None where the
    size cannot run: across processes d / world of its own device; on
    the card the first d cards; on the CPU d entries."""
    import torch
    if local is not None:
        return [local] * (d // world) if d % world == 0 else None
    if device.type == "cuda":
        if d > torch.cuda.device_count():
            return None
        return [torch.device("cuda", i) for i in range(d)]
    return [device] * d


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="c5")
    p.add_argument("--devices", default="1")
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--cpu", type=int, default=0,
                   help="run on the CPU with at most N entries (semantics "
                        "only)")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--jsonl", default=None)
    add_device_arg(p)
    args = p.parse_args(argv)

    import torch.distributed as dist
    from ..channel import make_capture
    from ..cli import config as C
    from ..core.spec import ChannelSpec
    from ..core.state import StreamState
    from ..golden import GoldenModem
    from ..pipeline import StreamRx
    from ..shard.mesh import init_distributed, make_mesh

    device = open_device("cpu" if args.cpu else args.device)
    local = (init_distributed(device=str(device))
             if args.distributed else None)
    world = dist.get_world_size() if args.distributed else 1
    spec = C.load_spec(args.config)
    rng = np.random.default_rng(0)
    gm = GoldenModem(spec)
    payloads = rng.integers(
        0, 2, (args.frames, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = np.stack([gm.modulate_frame(pp) for pp in payloads])
    cap = make_capture(frames, ChannelSpec(snr_db=26.0, cfo=0.4),
                       spec.n_sc, gap=300, seed=0).astype(np.complex64)

    base = None
    for t in [int(x) for x in args.devices.split(",")]:
        entries = mesh_entries(device, t, world, local)
        if entries is None or (args.cpu and t > args.cpu):
            print(f"# skip T={t}: cannot lay {t} entries over this "
                  f"machine's devices ({world} process(es))",
                  file=sys.stderr)
            continue
        mesh = make_mesh(1, t, devices=entries)
        rx = StreamRx(spec, mesh=mesh)
        pad = np.zeros((-len(cap)) % rx.chunk_len + rx.chunk_len,
                       np.complex64)
        stream = np.concatenate([cap, pad])
        # warm-up + correctness
        rx.state = StreamState.init(spec, rx.device)
        got = rx.process(stream)
        n_ok = sum(g.crc_ok for g in got)
        synchronize(rx.device)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            rx.state = StreamState.init(spec, rx.device)
            got = rx.process(stream)
        synchronize(rx.device)
        dt = (time.perf_counter() - t0) / args.iters
        msps = len(stream) / dt / 1e6
        fps = n_ok / dt
        eff = 1.0 if base is None else msps / (base * t)
        if base is None:
            base = msps
        rec = {"devices": t, "frames_ok": n_ok, "frames": args.frames,
               "msamples_per_s": round(msps, 2),
               "frames_per_s": round(fps, 1)}
        # scaling efficiency means something only across distinct cards:
        # entries that share a card or the host's cores make it noise
        # (NCCL takes one process a card)
        if args.distributed:
            own = (device.type == "cuda" and len(entries) == 1
                   and dist.get_backend() == "nccl")
        else:
            own = (device.type == "cuda"
                   and len({str(d) for d in entries}) == t)
        if own:
            rec["scaling_eff"] = round(eff, 3)
        else:
            rec["scaling_eff_note"] = ("omitted: the entries share a card "
                                       "or the host's cores")
        print(json.dumps(rec))
        if args.jsonl:
            with open(args.jsonl, "a") as f:
                f.write(json.dumps(rec) + "\n")
    if args.distributed:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
    # its records written and its group destroyed, the process ends without
    # the interpreter's teardown, in which torch's C++ teardown of a
    # process that held a gloo group aborts now and then (shard/spawn.py)
    from ofdm_uhd_tpu_torch.shard.spawn import exit_worker
    exit_worker()
