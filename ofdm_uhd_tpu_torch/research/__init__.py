"""The counterpart of ofdm_uhd_tpu/research/: filter tiers, a frame
extractor and Viterbi decoders the reference keeps as measured A/B
baselines or dead ends and never routes. No user path
(RxPipeline, TxPipeline, StreamRx, policy.choose) imports from here.

  shift   the shifted-FMA filter tier (K11): 'same' FIR, phase-split
          decimation, branch-row interpolation (csrc/shift.cu) and its S&C
          correlator (the sccorr kernel, counted as shift_sc)
  fir_ilv the FIR family on the interleaved (re, im) layout (K13): K8's
          csrc/banded.cu on the complex64 rows, float32 on the tensor
          cores
  deframe frame extraction by one bulk copy per frame (K12, csrc/
          deframe.cu), with zeros at negative offsets
  viterbi_variants
          the whole-sequence Viterbi decode restructured three ways
          (state-major metrics, radix-4 steps, both), plain PyTorch and
          bit-exact with kernels/viterbi.py viterbi_plain; held on the
          card against K4 at every group size
"""
