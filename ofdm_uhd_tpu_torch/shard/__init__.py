"""The sharding layer, the counterpart of ofdm_uhd_tpu/shard/: device
meshes (mesh.py), frame-parallel batched TX/RX (frame_parallel.py), the
time-sharded stream step with its halo exchange, summed tracker and slot
reshard (time_parallel.py), and the 2-stage pipelined RX
(stage_pipeline.py). One process drives every device of a mesh, or, on
a mesh that spans processes (mesh.init_distributed), its own devices,
each of them moving what crosses processes with torch.distributed
(collectives.py)."""

from .mesh import make_mesh
from .frame_parallel import rx_frames_sharded, tx_frames_sharded

__all__ = ["make_mesh", "rx_frames_sharded", "tx_frames_sharded"]
