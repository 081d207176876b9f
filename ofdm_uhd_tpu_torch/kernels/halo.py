"""The time-sharded stream's halo exchange: hand kernel + plain version.

Replaces ofdm_uhd_tpu/kernels/pallas_halo.py:halo_from_right_pallas (CUDA
source: csrc/halo.cu). The shards' extended blocks are rows [Cb + H] of
one tensor per device (`ext`, devices in time order, each holding
neighbouring shards): row i holds shard i's block [:Cb] and, once the
exchange has run, its halo [Cb:] = the head [:H] of row i + 1 (the
reference's ppermute from shard i + 1 to shard i). The last shard's halo
is the caller's to fill (the fresh tail), as in the reference.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, policy

MAX_PAIRS = 64          # shards a device can hold (the kernel's parameters)
_PEERS: set = set()     # (device, peer) card pairs with peer access enabled


def halo_plain(ext: list[torch.Tensor], cb: int, h: int) -> None:
    """The exchange as shard-to-shard copies: halo_i <- heads[i + 1]
    moved to shard i's device (copy_ moves across devices as .to())."""
    rows = [r for e in ext for r in e.unbind(0)]
    for left, right in zip(rows[:-1], rows[1:]):
        left[cb:cb + h].copy_(right[:h])


def _check(ext: list[torch.Tensor], cb: int, h: int) -> None:
    for e in ext:
        if (e.dtype != torch.complex64 or e.dim() != 2
                or e.shape[1] != cb + h or e.shape[0] > MAX_PAIRS):
            raise ValueError(f"halo: need c64 [T_d <= {MAX_PAIRS}, cb + h = "
                             f"{cb + h}] per device; got {e.dtype} "
                             f"{tuple(e.shape)}")
        build.check_inputs("halo", e)
    devices = [e.device for e in ext]
    if len(set(devices)) != len(devices):
        raise ValueError("halo: one tensor per device")


def _enable_peer(dev: torch.device, peer: torch.device) -> None:
    """Let `dev` read `peer`'s memory (once per pair)."""
    if (dev.index, peer.index) in _PEERS:
        return
    err = build.library().ofdm_enable_peer_access(dev.index, peer.index)
    if err == 0:
        _PEERS.add((dev.index, peer.index))
    else:
        raise RuntimeError(
            f"halo: {dev} cannot read {peer}'s memory (peer access: "
            f"{build.library().ofdm_error_string(err).decode()}); the "
            "halo kernel reads its neighbour's head in place and does not "
            "stage it through the host")


def _halo_cuda(ext: list[torch.Tensor], cb: int, h: int) -> None:
    """One launch per destination device, on its current stream. Where
    shard i + 1 lies on another card the kernel reads its head by peer
    access, after that card's stream has written it (an event), and that
    card's stream waits for the read before it goes on."""
    _check(ext, cb, h)
    lib = build.library()
    row = 8 * (cb + h)                          # bytes per shard row
    for g, e in enumerate(ext):
        base, n_rows = e.data_ptr(), e.shape[0]
        src = [base + (j + 1) * row for j in range(n_rows - 1)]
        dst = [base + j * row + 8 * cb for j in range(n_rows - 1)]
        nxt = ext[g + 1] if g + 1 < len(ext) else None
        if nxt is not None:
            _enable_peer(e.device, nxt.device)
            src.append(nxt.data_ptr())
            dst.append(base + (n_rows - 1) * row + 8 * cb)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(nxt.device))
            torch.cuda.current_stream(e.device).wait_event(ready)
        if not src:
            continue
        err = lib.ofdm_halo_from_right((ctypes.c_void_p * len(src))(*src),
                                       (ctypes.c_void_p * len(dst))(*dst),
                                       len(src), h, build.stream_ptr(e.device))
        build.check(err, "halo")
        policy.count_launch("halo")
        if nxt is not None:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(e.device))
            torch.cuda.current_stream(nxt.device).wait_event(done)


def halo_from_right(ext: list[torch.Tensor], cb: int, h: int) -> None:
    """Fill each shard i < T - 1's halo, ext row i [cb:cb + h], with the
    head of row i + 1, in place: K10 on CUDA tensors, the plain version on
    CPU tensors."""
    if policy.use_kernel(ext[0]):
        _halo_cuda(ext, cb, h)
    else:
        halo_plain(ext, cb, h)
