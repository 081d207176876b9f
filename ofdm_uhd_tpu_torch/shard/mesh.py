"""Device meshes: the counterpart of ofdm_uhd_tpu/shard/mesh.py.

A `Mesh` is a grid of torch devices with named axes: ('frame', 'time')
for the batched and streaming receivers, ('stage',) for the pipelined RX.
Outside a process group one process drives every device of the grid (a
single controller), and a device may appear more than once:
`make_mesh(1, 4, ["cuda:0"] * 4)` is a four-shard time axis on one card,
and `make_mesh(1, 4, ["cpu"] * 4)` the same on the CPU. That is the
port's virtual mesh, the counterpart of the reference's virtual CPU
devices (XLA's forced host device count): every line of the sharded
protocol runs, with one device doing all the shards' work.

Across processes (`init_distributed`, the reference's
jax.distributed.initialize): each process names its own entries, and
`make_mesh` joins them in rank order into one mesh whose `ranks` array
gives each entry's owning process. A process drives only its own
entries (`owned`); the stream step (time_parallel.py) runs over the
processes of one frame row (`row_ranks`, `row_group`), the frame axis
and the stage pipeline over every process, and each moves what crosses
processes with torch.distributed (shard/collectives.py): NCCL between
cards, one process a card, and gloo on the CPU (or, asked for by name,
on CUDA tensors staged through host memory, which lets processes share
one card).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """devices: an object array of torch.device, one array axis per name;
    ranks: the process that owns each entry (same shape), or None for a
    single-controller mesh."""
    devices: np.ndarray
    axis_names: tuple[str, ...]
    ranks: np.ndarray | None = None
    # the frame rows' process groups, made by row_group on first use
    _row_groups: dict = dataclasses.field(default_factory=dict,
                                          init=False, repr=False)

    @property
    def shape(self) -> collections.OrderedDict:
        """Axis name -> size, in axis order (as jax.sharding.Mesh.shape)."""
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def distributed(self) -> bool:
        """Built under a process group: its entries belong to processes."""
        return self.ranks is not None

    def owned(self) -> np.ndarray:
        """Which entries this process drives (bool, the mesh's shape):
        every one on a single controller."""
        if self.ranks is None:
            return np.ones(self.devices.shape, bool)
        return self.ranks == dist.get_rank()

    @property
    def first_device(self) -> torch.device:
        """The device that holds a sharded computation's inputs, carried
        state and gathered outputs: the mesh's first entry, or across
        processes this process's first entry (where it owns none, its own
        device, init_distributed's)."""
        mine = self.owned().reshape(-1)
        if not mine.any():
            return local_device()
        return self.devices.reshape(-1)[np.argmax(mine)]

    def by_row(self, a: np.ndarray) -> np.ndarray:
        """a (the mesh's shape) as [frame rows, entries a row]."""
        return a.reshape(self.shape["frame"], -1)

    def own_rows(self) -> list[int]:
        """The frame rows that hold an entry of this process."""
        return [int(f) for f in np.nonzero(
            self.by_row(self.owned()).any(1))[0]]

    def row_ranks(self, row: int) -> list[int]:
        """The processes that own entries of frame row `row`, in rank
        order ([0] on a single controller)."""
        if self.ranks is None:
            return [0]
        return sorted({int(r) for r in self.by_row(self.ranks)[row]})

    def row_group(self, row: int):
        """The process group of frame row `row`'s processes: None for a
        row of one process, which needs none; the default group where they
        are all the processes. The first call makes every row's group of
        two processes or more on this process, row by row: new_group is
        collective over the default group, so every process makes them
        all, in one order, even those it is not in."""
        if not self._row_groups:
            world = list(range(dist.get_world_size()))
            for f in range(self.shape["frame"]):
                ranks = self.row_ranks(f)
                self._row_groups[f] = (
                    None if len(ranks) == 1 else dist.group.WORLD
                    if ranks == world else dist.new_group(ranks))
        return self._row_groups[row]


_LOCAL: list = []          # this process's default device, once joined
_CPU_GROUP: list = []      # under NCCL: a gloo group for the placements


def local_device() -> torch.device:
    """This process's default device, as init_distributed chose it."""
    if not _LOCAL:
        raise ValueError("local_device: join a process group with "
                         "init_distributed first")
    return _LOCAL[0]


def _local_rank(process_id: int | None) -> int:
    """The process's index on its host: LOCAL_RANK (torchrun), else the
    process id given, else RANK."""
    for v in (os.environ.get("LOCAL_RANK"), process_id,
              os.environ.get("RANK")):
        if v is not None:
            return int(v)
    return 0


def _default_device(device, backend: str | None, local: int
                    ) -> torch.device:
    """The device a process joins with: `device` as named; a bare 'cuda'
    is the card cuda:local. Under NCCL (the default on cards) that card
    must exist, one rank a card; only a group asked for as gloo shares
    cards, local modulo their count. A card that is not there raises:
    the CPU only where it is named."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"init_distributed: {dev} asked for and this "
                           "host has no CUDA card (device='cpu' joins on "
                           "the CPU)")
    count = torch.cuda.device_count()
    index = dev.index
    if index is None:
        index = local % count if backend == "gloo" else local
    if index >= count:
        raise ValueError(
            f"nccl: local rank {local} has no card of its own (this host "
            f"has {count}); NCCL takes one rank a card (run two ranks on "
            "one card under gloo)" if dev.index is None else
            f"init_distributed: {dev} is not a card of this host ({count})")
    return torch.device("cuda", index)


def select_backend(placements: list, backend: str | None = None) -> str:
    """The process group's backend for these placements, one (host, [device
    names]) per rank: `backend` if given, else 'nccl' where every device
    is a CUDA card and 'gloo' where every one is the CPU. NCCL takes one
    rank a card: two ranks that name one card of one host raise
    ValueError (use gloo, which stages CUDA tensors through host memory)."""
    kinds = {torch.device(d).type for _, devs in placements for d in devs}
    if backend is None:
        if kinds == {"cuda"}:
            backend = "nccl"
        elif kinds == {"cpu"}:
            backend = "gloo"
        else:
            raise ValueError(f"no backend for devices of kinds {kinds}: "
                             "name one")
    if backend == "nccl":
        if kinds != {"cuda"}:
            raise ValueError(f"nccl moves CUDA tensors only, not {kinds}")
        owner: dict = {}
        for rank, (host, devs) in enumerate(placements):
            for d in {torch.device(d) for d in devs}:
                card = (host, d.index if d.index is not None else 0)
                if owner.setdefault(card, rank) != rank:
                    raise ValueError(
                        f"nccl: ranks {owner[card]} and {rank} both drive "
                        f"{d} of {host}; NCCL takes one rank a card (run "
                        "two ranks on one card under gloo)")
    return backend


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     device="cuda") -> torch.device:
    """Multi-process / multi-host bring-up: the counterpart of the
    reference's jax.distributed.initialize, on torch.distributed.

    With no arguments the group comes from the environment torchrun sets
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK); with them,
    from tcp://coordinator ('host:port'), num_processes and process_id.
    device: this process's default device (`local_device`), by default
    the card cuda:LOCAL_RANK; 'cpu' joins on the CPU. Backend: nccl on a
    card, gloo on the CPU, or `backend` as given. NCCL takes one rank a
    card: a rank whose card is missing, or two ranks on one card, raise
    ValueError before any NCCL communication (the placements are checked
    over a gloo group). Returns the default device, made current."""
    if coordinator is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise ValueError(f"init_distributed: no coordinator given and "
                             f"{missing} unset (launch with torchrun, or "
                             "pass coordinator, num_processes, process_id)")
        kw = {"init_method": "env://"}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed: a coordinator needs "
                             "num_processes and process_id")
        kw = {"init_method": f"tcp://{coordinator}",
              "world_size": num_processes, "rank": process_id}
    backend = select_backend([(socket.gethostname(),
                               [torch.device(device).type])], backend)
    dev = _default_device(device, backend, _local_rank(process_id))
    _CPU_GROUP.clear()
    dist.init_process_group(backend, timeout=datetime.timedelta(minutes=5),
                            **kw)
    if backend == "nccl":
        # every rank's card, gathered over gloo before NCCL runs at all
        _CPU_GROUP[:] = [dist.new_group(backend="gloo")]
        try:
            _placements([dev])
        except ValueError:
            dist.destroy_process_group()
            _CPU_GROUP.clear()
            raise
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _LOCAL[:] = [dev]
    return dev


def _device_list(devices) -> list[torch.device]:
    if devices is None:
        if dist.is_initialized():
            return [local_device()]
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _grid(devs: list[torch.device], shape: tuple[int, ...]) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return grid.reshape(shape)


def _placements(devs: list[torch.device]) -> list:
    """Every rank's (host, [device names]), gathered in rank order over
    gloo (under NCCL, its own CPU group: no NCCL call before the check),
    and checked: as many entries in each, and under NCCL one rank a
    card."""
    mine = (socket.gethostname(), [str(d) for d in devs])
    placements = [None] * dist.get_world_size()
    dist.all_gather_object(placements, mine,
                           group=_CPU_GROUP[0] if _CPU_GROUP else None)
    counts = {len(p[1]) for p in placements}
    if len(counts) != 1:
        raise ValueError(f"every process must name as many mesh entries; "
                         f"got {[len(p[1]) for p in placements]} by rank")
    select_backend(placements, dist.get_backend())
    return placements


def _global(devs: list[torch.device]):
    """Under a process group: every rank's entries joined in rank order
    (one gather), and their ranks; else (devs, None)."""
    if not dist.is_initialized():
        return devs, None
    placements = _placements(devs)
    all_devs = [torch.device(d) for _, ds in placements for d in ds]
    ranks = [r for r, (_, ds) in enumerate(placements) for _ in ds]
    return all_devs, ranks


def make_mesh(n_frame: int = 1, n_time: int = 1, devices=None) -> Mesh:
    """A ('frame', 'time') mesh over the given devices (torch devices or
    names, repeats allowed), by default every CUDA card. The first
    n_frame * n_time entries are used, row-major. Under a process group,
    `devices` are this process's entries (by default its one device),
    the same count in every process, joined in rank order."""
    devs, ranks = _global(_device_list(devices))
    need = n_frame * n_time
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(_grid(devs[:need], (n_frame, n_time)), ("frame", "time"),
                None if ranks is None
                else np.array(ranks[:need]).reshape(n_frame, n_time))


def single_mesh(device) -> Mesh:
    """A (1, 1) ('frame', 'time') mesh of one device, driven by this
    process alone, with or without a process group."""
    return Mesh(_grid([torch.device(device)], (1, 1)), ("frame", "time"))


def make_stage_mesh(n_stage: int = 2, devices=None) -> Mesh:
    """A 1-D ('stage',) mesh for the pipelined RX (stage_pipeline.py)."""
    devs, ranks = _global(_device_list(devices))
    if len(devs) < n_stage:
        raise ValueError(f"need {n_stage} devices, have {len(devs)}")
    return Mesh(_grid(devs[:n_stage], (n_stage,)), ("stage",),
                None if ranks is None else np.array(ranks[:n_stage]))
