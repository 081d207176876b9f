"""Frame-parallel (data-parallel) TX/RX over a mesh's 'frame' axis: the
counterpart of ofdm_uhd_tpu/shard/frame_parallel.py.

The batch is split in equal parts over the frame axis's devices (column 0
of the time axis), each part runs the chain on its device, and the
results are gathered in batch order on the mesh's first device. The
per-frame chain needs no cross-talk; the one collective is the sum of the
health metrics over the parts (the reference's psum). The reference jits
the whole batch and lets XLA partition it, so its Viterbi algorithm is
chosen at the whole batch B; each part here decodes at that batch too.

Across processes (a mesh made under init_distributed) every process
passes the whole batch; part f runs on the process that owns entry (f,
0), on that entry's device, and the parts are shared with every process
(collectives.py `share`: the reference's replicated outputs), which
gathers them in batch order on its first device and adds the metrics'
per-part terms in part order, as one process adds them. A process that
owns no column-0 entry computes nothing and returns the same result.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.spec import WaveformSpec
from ..pipeline import rx as RXP
from ..pipeline.tx import TxPipeline
from .collectives import ProcessComm
from .mesh import Mesh


def _split(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide over the "
                         f"{n} devices of the frame axis")
    return list(x.chunk(n))


def _parts(mesh: Mesh, x: torch.Tensor, fn: Callable) -> list[dict]:
    """fn (a part on its device -> a dict of tensors) on each part of x
    over the frame axis, by the process that owns the part's entry (f,
    0); -> every part's dict in part order on mesh.first_device, on every
    process."""
    devices = list(mesh.by_row(mesh.devices)[:, 0])
    owned = mesh.by_row(mesh.owned())[:, 0]
    parts = _split(x, len(devices))
    home = mesh.first_device
    outs = {f: fn(parts[f].to(devices[f])) for f in range(len(devices))
            if owned[f]}
    if not mesh.distributed:
        return [{k: v.to(home) for k, v in outs[f].items()}
                for f in range(len(devices))]
    got = ProcessComm(home).share({(f, k): v for f, o in outs.items()
                                   for k, v in o.items()})
    return [{k: v for (g, k), v in got.items() if g == f}
            for f in range(len(devices))]


def tx_frames_sharded(spec: WaveformSpec, mesh: Mesh
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn: payloads [B, bits] -> frames [B, frame_len_radio], B split over
    the frame axis, gathered on the mesh's first device."""
    tx = TxPipeline(spec)

    def run(payloads: torch.Tensor) -> torch.Tensor:
        return torch.cat([o["frames"] for o in _parts(
            mesh, payloads, lambda p: {"frames": tx(p)})])
    return run


def rx_frames_sharded(spec: WaveformSpec, mesh: Mesh, shift: int = 0
                      ) -> Callable[[torch.Tensor], dict]:
    """fn: frames [B, frame_len_radio] -> rx_aligned's result dict, split
    over the frame axis and gathered in batch order on the mesh's first
    device, plus n_ok_global (frames that passed their CRC) and
    mean_evm_global (mean EVM in dB), summed over the parts."""

    def run(frames: torch.Tensor) -> dict:
        b = frames.shape[0]
        outs = _parts(mesh, frames, lambda part: RXP._demod_frames(
            spec, RXP._to_baseband(spec, part), shift, algo_batch=b))
        out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        out["n_ok_global"] = sum(o["crc_ok"].sum(dtype=torch.int32)
                                 for o in outs)
        out["mean_evm_global"] = sum(o["evm_db"].sum() for o in outs) / b
        return out
    return run

