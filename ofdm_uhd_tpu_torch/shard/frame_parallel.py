"""Frame-parallel (data-parallel) TX/RX over a mesh's 'frame' axis: the
counterpart of ofdm_uhd_tpu/shard/frame_parallel.py.

The batch is split in equal parts over the frame axis's devices (column 0
of the time axis), each part runs the chain on its device, and the
results are gathered in batch order on the mesh's first device. The
per-frame chain needs no cross-talk; the one collective is the sum of the
health metrics over the parts (the reference's psum). The reference jits
the whole batch and lets XLA partition it, so its Viterbi algorithm is
chosen at the whole batch B; each part here decodes at that batch too.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.spec import WaveformSpec
from ..pipeline import rx as RXP
from ..pipeline.tx import TxPipeline
from .mesh import Mesh, single_controller


def _frame_devices(mesh: Mesh) -> list[torch.device]:
    return list(mesh.devices.reshape(mesh.shape["frame"], -1)[:, 0])


def _split(x: torch.Tensor, devices: list[torch.device]
           ) -> list[torch.Tensor]:
    if x.shape[0] % len(devices):
        raise ValueError(f"batch {x.shape[0]} does not divide over the "
                         f"{len(devices)} devices of the frame axis")
    return [part.to(d) for part, d in zip(x.chunk(len(devices)), devices)]


def tx_frames_sharded(spec: WaveformSpec, mesh: Mesh
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn: payloads [B, bits] -> frames [B, frame_len_radio], B split over
    the frame axis, gathered on the mesh's first device."""
    single_controller(mesh, "tx_frames_sharded")
    tx = TxPipeline(spec)
    devices = _frame_devices(mesh)

    def run(payloads: torch.Tensor) -> torch.Tensor:
        return torch.cat([tx(p).to(devices[0])
                          for p in _split(payloads, devices)])
    return run


def rx_frames_sharded(spec: WaveformSpec, mesh: Mesh, shift: int = 0
                      ) -> Callable[[torch.Tensor], dict]:
    """fn: frames [B, frame_len_radio] -> rx_aligned's result dict, split
    over the frame axis and gathered in batch order on the mesh's first
    device, plus n_ok_global (frames that passed their CRC) and
    mean_evm_global (mean EVM in dB), summed over the parts."""
    single_controller(mesh, "rx_frames_sharded")
    devices = _frame_devices(mesh)

    def run(frames: torch.Tensor) -> dict:
        b = frames.shape[0]
        outs = [RXP._demod_frames(spec, RXP._to_baseband(spec, part), shift,
                                  algo_batch=b)
                for part in _split(frames, devices)]
        out = {k: torch.cat([o[k].to(devices[0]) for o in outs])
               for k in outs[0]}
        out["n_ok_global"] = sum(o["crc_ok"].sum(dtype=torch.int32).to(
            devices[0]) for o in outs)
        out["mean_evm_global"] = sum(o["evm_db"].sum().to(devices[0])
                                     for o in outs) / b
        return out
    return run
