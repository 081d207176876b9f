"""Collectives across processes, on torch.distributed: the counterpart of
the reference's all_gather, psum, all_to_all and ppermute over a mesh
that spans hosts (ofdm_uhd_tpu/shard/time_parallel.py, frame_parallel.py,
stage_pipeline.py).

A `ProcessComm` works on one process group: the default group, or the
subgroup of one frame row of a mesh (mesh.py `row_group`), whose
processes run that row's stream. A row's time axis gives each of its
processes the same number n of neighbouring shards, in rank order, so
shard order is group-rank order. The operations:

  gather     every process's rows [n, ...] of some tensors, one
             all_gather for them all, -> [T, ...] each in shard order on
             every process: the step's outputs (all_gather), the per-shard
             terms of the tracker sums (psum: the caller adds the gathered
             rows itself, in one order on every process, never by
             all_reduce, whose ring order would round otherwise) and the
             TRACK predicates;
  exchange   one block to each other process and one from each
             (all_to_all_single): the slot transpose of the reshard;
  share      each process's named results (any number and shapes, or
             none) -> all of them on every process: one all_gather of
             their names, dtypes and shapes, then one of their bytes,
             each process's padded to the longest. The frame axis's parts
             and the stage pipeline's outputs, which the reference
             replicates (its replicated outputs, its psum over 'stage');
  send, recv one process's tensors to one other (isend / irecv), each
             returning a handle to wait on: the stage pipeline's LLR
             handoff (the reference's ppermute 0 -> 1).

Tensors go over the wire as their bytes (uint8), so every dtype (complex,
bool) moves bit for bit and both backends take it. Under NCCL the bytes
stay on this process's card. Gloo moves CPU tensors only: under gloo with
CUDA tensors (processes sharing one card, which NCCL refuses) this
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


def _nbytes(dtype: torch.dtype, shape, padded: bool = True) -> int:
    """A part's bytes: as _pack lays it out, padded to _ALIGN, or with
    padded=False its own."""
    n = torch.Size(shape).numel() * torch.empty(0, dtype=dtype).element_size()
    return n + (-n % _ALIGN) if padded else n


def _pack(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The parts' bytes, each padded to _ALIGN, in one uint8 tensor."""
    chunks = []
    for p in parts:
        b = _to_bytes(p.to(device))
        pad = -b.numel() % _ALIGN
        chunks.append(torch.nn.functional.pad(b, (0, pad)) if pad else b)
    if len(chunks) == 1:
        return chunks[0]
    return torch.cat(chunks) if chunks else torch.empty(
        0, dtype=torch.uint8, device=device)


def _unpack(buf: torch.Tensor, like: list[tuple]) -> list[torch.Tensor]:
    """like: (dtype, shape) of each packed part."""
    out, off = [], 0
    for dtype, shape in like:
        n = _nbytes(dtype, shape, padded=False)
        out.append(_from_bytes(buf[off:off + n], dtype, shape))
        off += _nbytes(dtype, shape)
    return out


class Pending:
    """A posted send or receive: wait() -> None for a send, the received
    tensors (on the comm's device) for a receive. The handle keeps the
    wire buffer alive until then."""

    def __init__(self, work, buf: torch.Tensor, like, device):
        self.work, self.buf, self.like, self.device = work, buf, like, device

    def wait(self) -> list[torch.Tensor] | None:
        self.work.wait()
        if self.like is None:
            return None
        return _unpack(self.buf.to(self.device), self.like)


class ProcessComm:
    """One process group (None: the default group) as the sharded paths
    use it; results land on `device`, one of this process's devices."""

    def __init__(self, device: torch.device, group=None):
        self.device = device
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        # gloo takes host tensors only: stage a card's bytes through
        # pinned host memory
        self.staged = (dist.get_backend(group) == "gloo"
                       and device.type == "cuda")

    def _wire(self, buf: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return buf
        host = torch.empty(buf.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(buf)
        return host

    def _buffer(self, n: int) -> torch.Tensor:
        """An empty wire buffer of n bytes."""
        if self.staged:
            return torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return torch.empty(n, dtype=torch.uint8, device=self.device)

    def gather(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """parts: this process's rows [n, ...] of each tensor (on any of
        its devices), the same shapes in every process -> each [world * n,
        ...] in shard order on `device`, from one all_gather."""
        buf = self._wire(_pack(parts, self.device))
        bufs = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(bufs, buf, group=self.group)
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
        nbytes = _nbytes(dtype, shape, padded=False)
        size = _nbytes(dtype, shape)
        split = [0 if b is None else size for b in blocks]
        buf = self._wire(_pack(sent, self.device))
        out = self._buffer(sum(split))
        dist.all_to_all_single(out, buf, split, split, group=self.group)
        out = out.to(self.device)
        got, off = [], 0
        for n in split:
            got.append(_from_bytes(out[off:off + nbytes], dtype, shape)
                       if n else None)
            off += n
        return got

    def share(self, items: dict) -> dict:
        """items: this process's tensors by name (names no other process
        uses; none at all for a process that computed nothing) -> every
        process's, by name, on `device`, bit for bit: one all_gather of
        the names, dtypes and shapes, then one all_gather of the bytes,
        each process's padded to the longest."""
        like = [(k, v.dtype, tuple(v.shape)) for k, v in items.items()]
        likes = [None] * self.world
        dist.all_gather_object(likes, like, group=self.group)
        sizes = [sum(_nbytes(d, s) for _, d, s in lk) for lk in likes]
        buf = _pack(list(items.values()), self.device)
        buf = self._wire(torch.nn.functional.pad(
            buf, (0, max(sizes) - buf.numel())))
        bufs = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(bufs, buf, group=self.group)
        out = {}
        for b, lk in zip(bufs, likes):
            got = _unpack(b.to(self.device), [(d, s) for _, d, s in lk])
            out.update(zip((k for k, _, _ in lk), got))
        return out

    def send(self, parts: list[torch.Tensor], dst: int) -> Pending:
        """Post this process's parts to process `dst` (a global rank), as
        one packed buffer; the receiver posts recv with their dtypes and
        shapes. Under NCCL the send is ordered after the work that wrote
        the parts on this process's current stream."""
        buf = self._wire(_pack(parts, self.device))
        return Pending(dist.isend(buf, dst), buf, None, self.device)

    def recv(self, like: list[tuple], src: int) -> Pending:
        """Post the receive of the parts process `src` (a global rank)
        sends, like = their (dtype, shape); wait() returns them on
        `device`, read after the transfer has landed."""
        buf = self._buffer(sum(_nbytes(d, s) for d, s in like))
        return Pending(dist.irecv(buf, src), buf, like, self.device)
