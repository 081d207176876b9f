"""The stream step's collectives across processes, on torch.distributed:
the counterpart of the reference's all_gather, psum and all_to_all over
a mesh that spans hosts (ofdm_uhd_tpu/shard/time_parallel.py).

The mesh's time axis gives every process the same number n of
neighbouring shards, in rank order, so shard order is rank order. Two
collectives serve the whole protocol:

  gather     every process's rows [n, ...] of some tensors, one
             all_gather for them all, -> [T, ...] each in shard order on
             every process: the step's outputs (all_gather), the per-shard
             terms of the tracker sums (psum: the caller adds the gathered
             rows itself, in one order on every process, never by
             all_reduce, whose ring order would round otherwise) and the
             TRACK predicates;
  exchange   one block to each other process and one from each
             (all_to_all_single): the slot transpose of the reshard.

Tensors go over the wire as their bytes (uint8), so every dtype (complex,
bool) moves bit for bit and both backends take it. Under NCCL the bytes
stay on this process's card. Gloo moves CPU tensors only: under gloo with
CUDA tensors (two processes sharing one card, which NCCL refuses) this
module stages the bytes through pinned host memory by its own code path
(`staged`), and never changes the backend. With one process each
collective returns its input's rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_ALIGN = 8      # byte offset of every packed tensor: any dtype views there


def _to_bytes(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    if x.is_complex():
        x = torch.view_as_real(x)
    return x.reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    if dtype.is_complex:
        real = b.view(torch.float32 if dtype == torch.complex64
                      else torch.float64)
        return torch.view_as_complex(real.view(tuple(shape) + (2,)))
    return b.view(dtype).view(tuple(shape))


def _pack(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The parts' bytes, each padded to _ALIGN, in one uint8 tensor."""
    chunks = []
    for p in parts:
        b = _to_bytes(p.to(device))
        pad = -b.numel() % _ALIGN
        chunks.append(torch.nn.functional.pad(b, (0, pad)) if pad else b)
    return torch.cat(chunks) if chunks else torch.empty(
        0, dtype=torch.uint8, device=device)


def _unpack(buf: torch.Tensor, like: list[tuple]) -> list[torch.Tensor]:
    """like: (dtype, shape) of each packed part."""
    out, off = [], 0
    for dtype, shape in like:
        n = torch.Size(shape).numel() * torch.empty(
            0, dtype=dtype).element_size()
        out.append(_from_bytes(buf[off:off + n], dtype, shape))
        off += n + (-n % _ALIGN)
    return out


class ProcessComm:
    """The default process group as the stream step uses it; results land
    on `device`, this process's first mesh entry."""

    def __init__(self, device: torch.device):
        self.device = device
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        # gloo takes host tensors only: stage a card's bytes through
        # pinned host memory
        self.staged = (dist.get_backend() == "gloo"
                       and device.type == "cuda")

    def _wire(self, buf: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return buf
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(buf)
        return host

    def gather(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """parts: this process's rows [n, ...] of each tensor (on any of
        its devices), the same shapes in every process -> each [world * n,
        ...] in shard order on `device`, from one all_gather."""
        buf = self._wire(_pack(parts, self.device))
        bufs = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(bufs, buf)
        like = [(p.dtype, p.shape) for p in parts]
        per_rank = [_unpack(b.to(self.device), like) for b in bufs]
        return [torch.cat([r[i] for r in per_rank])
                for i in range(len(parts))]

    def exchange(self, blocks: list[torch.Tensor | None]
                 ) -> list[torch.Tensor | None]:
        """blocks[r]: this process's block for process r (None for
        itself), every block of one shape and dtype, as each other
        process sends this one -> the block each process r sent here (None
        for itself), on `device`, from one all_to_all_single."""
        sent = [b for b in blocks if b is not None]
        if not sent:
            return [None] * self.world
        dtype, shape = sent[0].dtype, sent[0].shape
        nbytes = _to_bytes(sent[0]).numel()
        size = nbytes + (-nbytes % _ALIGN)          # as _pack pads it
        split = [0 if b is None else size for b in blocks]
        buf = self._wire(_pack(sent, self.device))
        out = torch.empty(sum(split), dtype=torch.uint8, device=buf.device,
                          pin_memory=self.staged)
        dist.all_to_all_single(out, buf, split, split)
        out = out.to(self.device)
        got, off = [], 0
        for n in split:
            got.append(_from_bytes(out[off:off + nbytes], dtype, shape)
                       if n else None)
            off += n
        return got
