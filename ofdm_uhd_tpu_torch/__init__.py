"""ofdm_uhd_tpu_torch — the OFDM modem ported to PyTorch and CUDA (Hopper).

A second package beside the JAX reference `ofdm_uhd_tpu/`; it imports
torch and never jax (nor the reference package). The layout mirrors the
reference so each module's counterpart is found by name:

  core/      WaveformSpec and constants (NumPy copy of the reference's)
  golden/    the NumPy helpers the host tables are derived from
  phy/       tables, bits (FEC/CRC), QAM, frame (FFT/EQ/CPE), AGC, sync
  kernels/   hand-written CUDA kernels (csrc/*.cu), each beside its plain
             PyTorch version; policy.py dispatches on the tensor's device
             and picks formulations from the spec as the reference does
  channel/   impairment models (NumPy)
  pipeline/  RxPipeline (capture-mode RX), TxPipeline and StreamRx
  shard/     device meshes, the stream over a mesh's time axis, the
             frame-parallel TX/RX and the 2-stage pipelined RX
  convert.py spec / tables from the reference's plain data
  bench_lib.py  synthetic captures (build_capture) without JAX

A CPU tensor takes each kernel's plain PyTorch version; a CUDA tensor
launches the hand kernel (built from csrc/ at first use) or raises. The
entry points that create tensors (StreamRx, StreamState, build_capture)
default to the CUDA card; pass device='cpu' for the CPU.
"""

import torch

__version__ = "0.1.0"

# Exact float32 matmuls: the 0/1 selection products and the CRC matmul
# must be exact, and reduced precision corrupted Viterbi path metrics in
# the reference (ofdm_uhd_tpu/__init__.py pins the same).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
