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

Across processes (a mesh made under init_distributed) the stages run on
the processes that own their entries: stage 0 front-ends the
microbatches one after another and posts each one's LLRs to stage 1's
process (collectives.py `send`, the ppermute), which receives them in
the same order, posting microbatch k + 1's receive before it decodes
microbatch k. A process that owns both entries runs as one process does.
Then every process of the group gets the outputs (collectives.py
`share`, the reference's psum over 'stage'): the decode from stage 1,
the EVM from stage 0, on its first device; a process that owns no entry
computes nothing and returns them too.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.spec import WaveformSpec
from ..pipeline import rx as RXP
from .collectives import ProcessComm
from .mesh import Mesh

N_STAGES = 2


def _one_process(spec, micro, shift, front_dev, back_dev) -> dict:
    """Both stages on this process, interleaved as GPipe steps."""
    evm, payload, crc_ok = [], [], []
    llr = None                  # in flight from stage 0 to stage 1
    for k in range(len(micro) + 1):
        nxt = None
        if k < len(micro):
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


def _front(spec, micro, shift, comm, dst) -> dict:
    """Stage 0: each microbatch's front end, its LLRs posted to `dst`."""
    evm, sent = [], []
    for x in micro:
        out = RXP._frontend(spec, RXP._to_baseband(spec, x), shift)
        evm.append(out["evm_db"])
        sent.append(comm.send([out["llr"]], dst))
    for s in sent:
        s.wait()
    return {"evm_db": torch.cat(evm)}


def _back(spec, n_micro, mb, comm, src) -> dict:
    """Stage 1: each microbatch's LLRs from `src`, decoded in order."""
    like = [(torch.float32, (mb, spec.coded_bits_per_frame))]
    payload, crc_ok = [], []
    pending = comm.recv(like, src)
    for k in range(n_micro):
        llr = pending.wait()[0]
        if k + 1 < n_micro:
            pending = comm.recv(like, src)
        p, ok = RXP._decode(spec, llr)
        payload.append(p)
        crc_ok.append(ok)
    return {"payload": torch.cat(payload), "crc_ok": torch.cat(crc_ok)}


def rx_aligned_pipelined(spec: WaveformSpec, mesh: Mesh, n_micro: int,
                         shift: int = 0) -> Callable[[torch.Tensor], dict]:
    """fn: frames [B, frame_len_radio] (B divisible by n_micro) ->
    {payload, crc_ok, evm_db}, as rx_aligned's."""
    if mesh.shape.get("stage") != N_STAGES:
        raise ValueError(f"mesh needs a 'stage' axis of size {N_STAGES}, "
                         f"got {dict(mesh.shape)}")
    front_dev, back_dev = mesh.devices
    owned = mesh.owned()
    comm = ProcessComm(mesh.first_device) if mesh.distributed else None

    def run(frames: torch.Tensor) -> dict:
        b = frames.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
        out = {}
        if owned.all():
            out = _one_process(spec, frames.to(front_dev).chunk(n_micro),
                               shift, front_dev, back_dev)
        elif owned[0]:
            out = _front(spec, frames.to(front_dev).chunk(n_micro), shift,
                         comm, int(mesh.ranks[1]))
        elif owned[1]:
            out = _back(spec, n_micro, b // n_micro, comm,
                        int(mesh.ranks[0]))
        if comm is None:
            return out
        got = comm.share(out)
        return {k: got[k] for k in ("payload", "crc_ok", "evm_db")}
    return run
