"""Device meshes: the counterpart of ofdm_uhd_tpu/shard/mesh.py.

A `Mesh` is a grid of torch devices with named axes: ('frame', 'time')
for the batched and streaming receivers, ('stage',) for the pipelined RX.
One process drives every device of the grid (a single controller), and a
device may appear more than once: `make_mesh(1, 4, ["cuda:0"] * 4)` is a
four-shard time axis on one card, and `make_mesh(1, 4, ["cpu"] * 4)` the
same on the CPU. That is the port's virtual mesh, the counterpart of the
reference's virtual CPU devices (XLA's forced host device count): every
line of the sharded protocol runs, with one device doing all the shards'
work. Meshes across processes or hosts (`init_distributed`) are not
ported.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """devices: an object array of torch.device, one array axis per name."""
    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> collections.OrderedDict:
        """Axis name -> size, in axis order (as jax.sharding.Mesh.shape)."""
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def first_device(self) -> torch.device:
        """The device that holds a sharded computation's inputs, carried
        state and gathered outputs."""
        return self.devices.flat[0]


def _device_list(devices) -> list[torch.device]:
    if devices is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def _grid(devs: list[torch.device], shape: tuple[int, ...]) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return grid.reshape(shape)


def make_mesh(n_frame: int = 1, n_time: int = 1, devices=None) -> Mesh:
    """A ('frame', 'time') mesh over the given devices (torch devices or
    names, repeats allowed), by default every CUDA card. The first
    n_frame * n_time entries are used, row-major."""
    devs = _device_list(devices)
    need = n_frame * n_time
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(_grid(devs[:need], (n_frame, n_time)), ("frame", "time"))


def make_stage_mesh(n_stage: int = 2, devices=None) -> Mesh:
    """A 1-D ('stage',) mesh for the pipelined RX (stage_pipeline.py)."""
    devs = _device_list(devices)
    if len(devs) < n_stage:
        raise ValueError(f"need {n_stage} devices, have {len(devs)}")
    return Mesh(_grid(devs[:n_stage], (n_stage,)), ("stage",))


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-process / multi-host bring-up (the reference's
    jax.distributed.initialize): not ported."""
    raise NotImplementedError(
        "meshes across processes or hosts (torch.distributed with NCCL) "
        "come with a later slice; one process drives every device of a "
        "Mesh")
