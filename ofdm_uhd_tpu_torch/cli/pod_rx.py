"""Pod streaming RX: the continuous time-block stream over a device mesh
(config C5), the counterpart of ofdm_uhd_tpu/cli/pod_rx.py.

One process: the mesh's time axis is --devices entries, the first cards
under --device cuda (default: every card), or that many entries of a
named device (--device cuda:0, cpu: a virtual mesh). Across processes,
--distributed: init_distributed() from torchrun's environment (MASTER_ADDR,
MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK), and --devices is the whole
time axis, each process giving devices / world entries of its own device
(cuda:LOCAL_RANK under --device cuda, which needs a card: only --device
cpu runs on the CPU). Every process reads the whole
capture and returns every frame; rank 0 alone writes --bits-out and
--save-state. NCCL takes one process a card; --dist-backend gloo runs
several on one card (or on the CPU). Supports --resume / --save-state.

    torchrun --nproc-per-node 2 -m ofdm_uhd_tpu_torch.cli.pod_rx \\
        --config c5 --capture rx.npy --devices 2
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import config as C


def _mesh_devices(device: str, n: int | None, world: int, local) -> list:
    """This process's mesh entries: n / world of them (n: over all
    processes), of its own device `local` across processes."""
    import torch
    if local is not None:
        return [local] * ((n or world) // world)
    if device == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        n = n or len(cards)
        if not 0 < n <= len(cards):
            raise ValueError(f"pod_rx: {n} entries over {len(cards)} CUDA "
                             "cards (name a device for a virtual mesh; "
                             "--device cpu runs on the CPU)")
        return cards[:n]
    return [torch.device(device)] * (n or 1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    C.add_common_args(p)
    p.add_argument("--capture", required=True)
    p.add_argument("--chunk", type=int, default=None,
                   help="chunk length in samples (default: auto)")
    p.add_argument("--devices", type=int, default=None,
                   help="entries on the time axis, over all processes "
                        "(default: every card, one entry a process)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process: init_distributed() first")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="process group backend (default: nccl on cards, "
                        "gloo on the CPU)")
    p.add_argument("--resume", default=None, help="state .npz to resume from")
    p.add_argument("--save-state", default=None, help="write state .npz at end")
    p.add_argument("--bits-out", default=None)
    args = p.parse_args(argv)

    import torch.distributed as dist
    from ..io import read_capture
    from ..metrics import RunMetrics
    from ..pipeline.stream import StreamRx
    from ..shard.mesh import init_distributed, make_mesh

    local = (init_distributed(backend=args.dist_backend, device=args.device)
             if args.distributed else None)
    world = dist.get_world_size() if args.distributed else 1
    if args.devices is not None and args.devices % world:
        p.error(f"--devices {args.devices} must divide over {world} "
                "processes")
    devices = _mesh_devices(args.device, args.devices, world, local)
    n_dev = len(devices) * world
    spec = C.spec_from_args(args)
    mesh = make_mesh(1, n_dev, devices=devices)
    rx = StreamRx(spec, mesh=mesh, chunk_len=args.chunk)
    if args.resume:
        rx.load_state(args.resume)

    samples, _ = read_capture(args.capture)
    m = RunMetrics()
    frames = rx.process(samples)
    frames += rx.flush()
    m.update_stream(frames)
    m.samples = len(samples)
    m.tracking = rx.tracking()
    if args.save_state:
        rx.save_state(args.save_state)        # rank 0 writes
    rank0 = not args.distributed or dist.get_rank() == 0
    if rank0 and args.bits_out and frames:
        np.save(args.bits_out, np.stack([f.payload for f in frames]))
    s = m.summary()
    print(f"mesh time={n_dev}: {s['frames_detected']} frames, "
          f"{s['frames_ok']} crc-ok; EVM {s['mean_evm_db']:.1f} dB; "
          f"{s['msamples_per_s']:.2f} Msamples/s, "
          f"{s['frames_per_s']:.1f} frames/s", file=sys.stderr)
    if args.distributed:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
