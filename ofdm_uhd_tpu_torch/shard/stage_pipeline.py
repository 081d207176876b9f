"""Pipeline-parallel RX over a 2-entry ('stage',) mesh: the counterpart of
ofdm_uhd_tpu/shard/stage_pipeline.py.

The chain is cut at the LLR array: stage 0 runs the symbol-domain front
end (resampling, FFT, channel estimate, EQ, CPE, demap) on its device,
stage 1 the bit-domain decode (deinterleave, depuncture, Viterbi,
descramble, CRC) on its own. GPipe over n_micro microbatches: at step k
stage 0 front-ends microbatch k while stage 1 decodes microbatch k - 1,
whose LLRs were handed over with .to() (the reference's ppermute). Eager
launches are asynchronous, so on two cards the stages overlap; on one
(a virtual mesh) they share its queue. Each microbatch decodes at its own
batch, as the reference's stage 1 does inside shard_map. The results are
gathered on the stage-0 device.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.spec import WaveformSpec
from ..pipeline import rx as RXP
from .mesh import Mesh, single_controller

N_STAGES = 2


def rx_aligned_pipelined(spec: WaveformSpec, mesh: Mesh, n_micro: int,
                         shift: int = 0) -> Callable[[torch.Tensor], dict]:
    """fn: frames [B, frame_len_radio] (B divisible by n_micro) ->
    {payload, crc_ok, evm_db}, as rx_aligned's."""
    single_controller(mesh, "rx_aligned_pipelined")
    if mesh.shape.get("stage") != N_STAGES:
        raise ValueError(f"mesh needs a 'stage' axis of size {N_STAGES}, "
                         f"got {dict(mesh.shape)}")
    front_dev, back_dev = mesh.devices

    def run(frames: torch.Tensor) -> dict:
        b = frames.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        micro = frames.to(front_dev).chunk(n_micro)
        evm, payload, crc_ok = [], [], []
        llr = None                  # in flight from stage 0 to stage 1
        for k in range(n_micro + 1):
            nxt = None
            if k < n_micro:
                out = RXP._frontend(spec, RXP._to_baseband(spec, micro[k]),
                                    shift)
                evm.append(out["evm_db"])
                nxt = out["llr"].to(back_dev)
            if llr is not None:
                p, ok = RXP._decode(spec, llr)
                payload.append(p.to(front_dev))
                crc_ok.append(ok.to(front_dev))
            llr = nxt
        return {"payload": torch.cat(payload), "crc_ok": torch.cat(crc_ok),
                "evm_db": torch.cat(evm)}
    return run
