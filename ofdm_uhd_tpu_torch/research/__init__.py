"""The counterpart of ofdm_uhd_tpu/research/: filter tiers the reference
keeps as measured A/B baselines and never routes. No user path
(RxPipeline, TxPipeline, StreamRx, policy.choose) imports from here.

  shift   the shifted-FMA filter tier (K11): 'same' FIR, phase-split
          decimation, branch-row interpolation (csrc/shift.cu) and its S&C
          correlator (the sccorr kernel, counted as shift_sc)
"""
