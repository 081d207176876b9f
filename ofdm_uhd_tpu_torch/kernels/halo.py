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
import dataclasses

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


@dataclasses.dataclass
class _Launch:
    """One destination device's launch: its (source, destination) pointer
    pairs as the C entry takes them, and, where shard i + 1 lies on
    another card, that card and the two events that order the two
    cards' streams (its head written before the read; the read done
    before that card writes again)."""
    device: torch.device
    src: ctypes.Array
    dst: ctypes.Array
    pairs: int
    peer: torch.device | None = None
    ready: torch.cuda.Event | None = None
    done: torch.cuda.Event | None = None


def _plan(ext: list[torch.Tensor], cb: int, h: int) -> list[_Launch]:
    """The per-call setup of a launch over the buffers `ext`: pointer
    arrays, peer access, events."""
    _check(ext, cb, h)
    row = 8 * (cb + h)                          # bytes per shard row
    plan = []
    for g, e in enumerate(ext):
        base, n_rows = e.data_ptr(), e.shape[0]
        src = [base + (j + 1) * row for j in range(n_rows - 1)]
        dst = [base + j * row + 8 * cb for j in range(n_rows - 1)]
        nxt = ext[g + 1] if g + 1 < len(ext) else None
        if nxt is not None:
            _enable_peer(e.device, nxt.device)
            src.append(nxt.data_ptr())
            dst.append(base + (n_rows - 1) * row + 8 * cb)
        if not src:
            continue
        launch = _Launch(e.device, (ctypes.c_void_p * len(src))(*src),
                         (ctypes.c_void_p * len(dst))(*dst), len(src))
        if nxt is not None:
            launch.peer = nxt.device
            launch.ready, launch.done = torch.cuda.Event(), torch.cuda.Event()
        plan.append(launch)
    return plan


def _launch(plan: list[_Launch], h: int) -> None:
    """One launch per destination device, on its current stream. Where
    shard i + 1 lies on another card the kernel reads its head by peer
    access, after that card's stream has written it (an event), and that
    card's stream waits for the read before it goes on."""
    lib = build.library()
    for p in plan:
        if p.peer is not None:
            p.ready.record(torch.cuda.current_stream(p.peer))
            torch.cuda.current_stream(p.device).wait_event(p.ready)
        err = lib.ofdm_halo_from_right(p.src, p.dst, p.pairs, h,
                                       build.stream_ptr(p.device))
        build.check(err, "halo")
        policy.count_launch("halo")
        if p.peer is not None:
            p.done.record(torch.cuda.current_stream(p.device))
            torch.cuda.current_stream(p.peer).wait_event(p.done)


class HaloExchange:
    """The exchange over fixed buffers, one tensor per device (a stream
    step's shard rows, written anew every step): K10's per-call setup
    (each destination device's pointer arrays, the peer check, the two
    ordering events of a pair of cards) is built at the first launch and
    reused by every later one. Each call takes the kernel or the plain
    version by the buffers' device, as halo_from_right does."""

    def __init__(self, ext: list[torch.Tensor], cb: int, h: int):
        self.ext, self.cb, self.h = ext, cb, h
        self._plan = None

    def __call__(self) -> None:
        if policy.use_kernel(self.ext[0]):
            if self._plan is None:
                self._plan = _plan(self.ext, self.cb, self.h)
            _launch(self._plan, self.h)
        else:
            halo_plain(self.ext, self.cb, self.h)


def halo_from_right(ext: list[torch.Tensor], cb: int, h: int) -> None:
    """Fill each shard i < T - 1's halo, ext row i [cb:cb + h], with the
    head of row i + 1, in place: K10 on CUDA tensors (its setup built for
    this call), the plain version on CPU tensors."""
    HaloExchange(ext, cb, h)()
