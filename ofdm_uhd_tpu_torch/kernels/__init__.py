"""Hand-written CUDA kernels (csrc/), each beside its plain PyTorch version.

localize.py, extract.py, scfront.py and sync.py (the boxcar S&C
correlator, whose plain version is also scfront.py's) hold one kernel
each, fft.py two (the FFT and its CP-fused forms), viterbi.py two (whole
sequence and windowed), fir.py four (the strided FIR / decimation and the
polyphase interpolation, each in exact float32 and in the bf16 tier on the
tensor cores), halo.py one (the time-sharded stream's halo
exchange, one launch per device), banded.py one entry each for the FIR,
decimation, interpolation and S&C sums of the banded tier (K8, on the
tensor cores at float32 accuracy: csrc/banded.cu); csrc/shift.cu holds
the shifted-FMA tier of research/shift.py, csrc/banded.cu also the
interleaved tier of research/fir_ilv.py (the same entries), and csrc/deframe.cu the bulk-copy
extraction of research/deframe.py. No user path runs banded.py or
research/: the wrapper launches the kernel for a CUDA
tensor and runs the plain version for a CPU tensor (policy.py, which also
routes formulations by the spec as the reference does). build.py
compiles csrc/ at first use.
"""
