"""Hand-written CUDA kernels (csrc/), each beside its plain PyTorch version.

localize.py, extract.py, fft.py, viterbi.py and scfront.py hold one
kernel each, fir.py two (the strided FIR / decimation and the polyphase
interpolation): the wrapper launches the kernel for a CUDA tensor and runs
the plain version for a CPU tensor (policy.py). build.py compiles csrc/ at
first use. sync.py is the plain S&C correlator, scfront.py's plain version.
"""
