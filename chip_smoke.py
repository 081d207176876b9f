"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths through their user entry points, and the filter
tiers and frame extractor that no path runs, in phases; each prints its
findings on a line of its own:

  C3, the capture-mode RX chain `RxPipeline(config("c3")).rx_capture_sc16(
      iq, max_frames)` at the size the repository's bench.py judges (8
      captures x 1024 frames, gap 300, sc16), and once more with
      `sync_threshold_mode="cfar"`, which must give its plain-forced run's
      slots (its slots that differ from the fixed run's are counted);
  files, the file-to-bits tools: one C3 capture of 1024 frames (gap 300,
      SNR 28 dB, CFO 0.8, seed 0) written by io.write_capture as an sc16
      .iq file with its sidecar and decoded bit-exact by `python -m
      ofdm_uhd_tpu_torch.cli.rx` in a subprocess, then by `cli.rx.main`
      in this process under the launch counters (K6, K1, K2, K3, K4w: the
      windowed decoder is the reference's choice at 1032 slots); the
      native sc16 deframer built by g++ and equal to NumPy's conversion;
      those five kernels held against their plain versions on the file's
      samples (one fc32 row, 1032 slots); the golden chain
      (`GoldenModem.rx_capture`) on bench.py's 5-frame slice, equal to
      the card's slots that lie wholly inside it (every one of them) and
      timed on the host CPU (the yardstick a benchmark divides by); a
      tool's start-up timed in a subprocess; the pinned fixtures
      tests/fixtures/golden_c{1,2,3}.npz decoded to their payloads and
      starts; C4's `cli.tx` (32 frames, the TX's K3 inverse and K7
      interpolation on the card) to a file and `cli.rx` on it; C2's
      `cli.loopback --sync` over multipath (64 frames);
  bench, the bench tool (`python -m ofdm_uhd_tpu_torch.cli.bench`) at the
      reference's r5 operating points, BENCH_ITERS timed passes each: C1
      capture sc16 (4096 frames) as a subprocess, then in this process
      under the launch counters C1 capture sc16 under `xla`, C1 aligned,
      C2 capture (4096 frames each), C3 capture sc16 (8 x 1024) and C5's
      stream host-fed sc16 (chunk 129,024, K = 16) and resident fc32
      (chunk 4,128,768, K = 4) over 4096 frames; each record must count
      every frame (`frames_ok`), each run launch its path's kernels and
      no other (the TX's inverse FFT counts with the path's); C1's
      capture once more with --trace-dir, whose torch.profiler trace must
      name every kernel of its path among its device events (its busy
      share read from them); the path's kernels held against their
      plain versions at C1's and C2's capture shapes (the C3 and C5
      shapes are held in their own phases);
  harness, the bench/ harnesses as tools of the port (ofdm_uhd_tpu_torch/
      harness/): `python -m ...harness.stages` at C3's headline shape
      (8 x 1024, 'auto'), its record's keys and frame counts checked,
      and `harness.roofline --stages-jsonl` on it, as subprocesses; then
      in this process under the launch counters stages under 'pallas' at
      C2 (4 x 128 frames), sweeps (C2, 10 and 14
      dB, flat and multipath), detect_sweep (C3, 5 and 15 dB, 2 trials),
      evm_budget (C2, 32 frames), pod (C5 over the cards present, up to
      two) and pp_ab (its entries sharing the card), each launching its
      path's kernels and no other; the sweeps', detect's and EVM's records
      equal to those of the same runs on the CPU (`--device cpu`
      subprocesses started first): counts and FER exactly, pre-FEC
      decisions within PRE_FEC_TOL_BITS, EVM within 0.01 dB; pod and
      pp_ab decoding every frame;
  C4, the resampled chain: `TxPipeline(config("c4"))` builds 8 captures x
      32 frames on the card (the reference's C4 row: gap 300, timing offset
      100, SNR 28 dB, CFO 0.8 / 8 at the radio rate, no phase noise, fc32)
      and `RxPipeline(config("c4")).rx_capture(capture, max_frames)`
      decimates by 8 and decodes them;
  c4_bf16, C4 under the reference's own gate setting for its bf16 filter
      tier, `config("c4").with_(filter_precision="bf16",
      kernel_backend="pallas")`: the same captures and traffic, built by
      the port's TX through the bf16 interpolation kernel and decimated by
      the bf16 strided kernel (both on the tensor cores), then the S&C
      front end, the FFT kernel (1024 points: the CP-fused one stops at
      512) and the windowed Viterbi kernel at 256/64, as the reference
      routes 'pallas'; the exact FIR kernels never run there;
  C5, the stream: `StreamRx(config("c5").with_(kernel_backend="auto"))` on
      the reference bench's capture (4096 frames from the port's TxPipeline
      on the card, gap 300, SNR 28 dB, CFO 0.8, timing offset 100, seed 0)
      at its two operating points: resident fc32 (chunk 4,128,768, K = 4,
      the K-step chunk stacks staged on the card, `process_device`) and
      host-fed sc16 (chunk 129,024, K = 16, `process` + `flush` from host
      memory); both decode through the windowed Viterbi kernel (512/96 and
      256/64). Then the TRACK retry's burst case at full width;
  c3_pallas, bench.py's `pallas-sc16` variant: C3's captures, built by
      `TxPipeline(config("c3").with_(kernel_backend="pallas"))` on the card
      (the fused IFFT + CP kernel), through `RxPipeline(...).rx_capture_sc16`
      under the same spec: the fused CP-strip FFT kernel, and the windowed
      Viterbi kernel at 256/64, as the reference routes 'pallas';
  c2_pallas, the reference bench's C2 capture row under --backend pallas:
      32 captures x 128 frames (gap 300, SNR 28 dB, CFO 0.8, timing offset
      100, sc16), built and decoded as c3_pallas, with the boxcar S&C
      correlator kernel (l = 32) and the whole-sequence Viterbi kernel;
  variants, the reference's three restructured whole-sequence decoders
      (research/viterbi_variants.py: state-major metrics, radix-4 steps,
      both; viterbi_plain's bits in the port, which no path routes) on the
      card, at C3's trellis length (64 decodable rows and 16 of tied
      integer LLRs, 6912 steps) and on an odd batch (6911 steps, where the
      radix-4 forms fall back to K4), once each: each one's bits equal to
      K4's at every group size;
  c5_sharded, the shard/ layer on a virtual mesh (several mesh entries on
      the one card): C5's capture at the resident point over
      `StreamRx(spec, mesh=make_mesh(1, 4, [cuda:0] * 4))` (Cb 1,032,192,
      258 slots a shard) three times, with the halos moved as the
      reference's ppermute, by the halo kernel (`pallas_halo=True`), and
      with the slot reshard (`reshard=True`); the steps and kernels on the
      first window's shard rows [4, Cb + H], each kernel held against its
      plain version there, the halo kernel on that window's blocks;
      `rx_frames_sharded` over a (4, 1) mesh and `rx_aligned_pipelined`
      over 2 stages on 4096 C3 frames built by the port's TX on the card
      (SNR 28 dB), against `RxPipeline.rx_aligned`; and, with two cards or
      more, a (1, 2) mesh over two cards with the halo kernel's peer read;
  distributed, the stream over a mesh that spans processes: the resident
      point over (1, 4) in two worker processes of its own (chip_smoke.py
      --worker) on the card, gloo between them (NCCL takes one process a
      card), 2 shards each, with the halo kernel, the reshard and the
      TRACK retry; first the path's kernels held against their plain
      versions at one worker's shapes (its 2 rows [2, Cb + H] of the
      window, its 2 f2 = 520 slots after the reshard's padding, K4w at
      the windows the algorithm takes at f2, K10 over its 2 shards); each
      worker's starts, crc_ok and payloads equal to the
      in-process c5_sharded reshard run's, its state one replica, its
      launches counted (K6, K1, K2, K3, K4w and K10, no other); then
      cli.pod_rx --distributed as two processes on the capture in a .npy
      file, its bits the in-process run's; with two cards or more, NCCL
      on 2 and 4 cards, one process a card, timed in interleaved rounds
      against the one-process, one-card receiver. A worker that fails,
      hangs past DIST_TIMEOUT_S (all are then killed) or disagrees fails
      the script;
  axes_distributed, the frame and stage axes and the stream on a 2-D
      mesh, across processes: first their kernels held at one worker's
      shapes (K3 and K4 on a quarter of c5_sharded's 4096-frame C3 batch,
      a frame part and a stage microbatch alike: C3's 'xla' route decodes
      whole sequences at every batch; the (2, 2) stream's K6, K1, K2, K3,
      K4w on one shard's row of a frame row of two, and the (2, 4)
      stream's on two shards' rows of a frame row of four, with K10
      between them), then AXES_WORLD worker processes (chip_smoke.py
      --worker --steps) sharing the card under gloo, in one spawn:
      rx_frames_sharded over (4, 1), rx_aligned_pipelined with its stages
      on ranks 0 and 1 (ranks 2 and 3 own no entry) and C5's resident
      stream over (2, 2) and over (2, 4) (each frame row a replica over
      two processes, with one shard each or two, the halo kernel between
      a process's two; reshard, TRACK); every rank's result bit-equal to
      the in-process runs (c5_sharded's frame and stage axes, the stream
      on a (2, 2) and a (2, 4) virtual mesh; EVM within 0.01 dB) and its
      launches per rank logged; with two cards or more, NCCL, one process
      a card: the frame axis (2, 1) and the stage axis on 2 cards (K3 and
      K4 also held on a frame part of half the batch, the shapes those
      ranks launch at), the frame batch and the stream on (2, 2) on 4,
      checked the same way, their launches logged under the path, and
      timed in ROUNDS_DIST interleaved rounds against one process over
      the same cards and one process on one card, beside the card's name
      and power limit;
  shift, the shifted-FMA tier (research/shift.py: fir_shift,
      polyphase_decim_shift, polyphase_interp_shift, sc_correlate_shift),
      which the reference keeps as an A/B baseline and no user path runs:
      bench/kernels_ab.py's K11 rows (a seed-0 signal of 2^20 samples: the
      193- and 3-tap FIR, the 8x decimation, the S&C correlator at l = 128;
      the 8x interpolation over 2^17) and C4's decimation [8, 4,138,472]
      and TX interpolation [32, 16128] at full width, each kernel held
      against its plain version, its in-kernel time in turns with its
      library call's (conv1d, conv_transpose1d) and its wrapper's host
      time a call, at C4 beside the exact K7 kernel on the same input (the
      A/B of the two exact filter designs);
  tiers, the last three TPU kernels' counterparts, which no user path
      runs either: the banded tier K8 (kernels/banded.py: fir_banded,
      polyphase_decim_banded with ceil(n/m) outputs,
      polyphase_interp_banded, sc_correlate_banded) and the interleaved
      tier K13 (research/fir_ilv.py), both on csrc/banded.cu (3xTF32 on
      the tensor cores, complex64 rows read in place), and K13 at the
      reference's DEFAULT precision on csrc/fir_bf16.cu (the bf16 tier),
      at scripts/tpu_session.py's FIR rows ([16, 8192],
      193 taps, by 8) and at C4's width (the decimation input and TX
      frames the shift phase takes), K8's S&C at l = 128 on the shift
      phase's 2^20 signal and on C3's captures [8, 4,436,068], and the
      bulk-copy deframer K12 (research/deframe.py, csrc/deframe.cu) on
      C3's extraction input (8208 detected offsets) and on negative, odd,
      in-range and past-n offsets; each held against its plain version,
      its in-kernel time in turns with its library call's (conv1d,
      conv_transpose1d) where there is one, with the exact K7 and K11
      beside K8 and K13 at C4 in turns (the four-way A/B of exact float32
      filter designs), K9 beside K8's S&C and K2 beside K12 (equal on
      offsets in [0, n]).
  big_nsc, RxPipeline.rx_capture_sc16 at n_sc = 4096, 16384 and 32768
      (QPSK, CP n/8, 2 data symbols, 4 captures x 4 frames built by the
      port's TX on the card): K3 in one launch at 4096 and by its
      two-pass route above (the column pass, then the row pass, which
      stores in natural order), the S&C split route at l = 2048, 8192 and
      16384 (the span pass to S_W, the stride pass over the residue
      chains mod W), each pass against its plain step and the route
      against the plain version, timed in-kernel, its bits checked against
      the tile kernel at 2048 and logged as a digest; then K3 alone at N =
      4096 .. 65536 beside torch.fft.fft, with every split N1 x N2 of the
      route (and one launch at 8192) timed in turns.
  Wherever the S&C tile kernel (K6, or K9 at c2_pallas) is held, it is
  also timed in-kernel, and its P and M (or R) are checked bit for bit
  against the split route's and logged as a digest, by which the runs of
  two checkouts compare.
  Wherever the windowed Viterbi kernel (K4w, one thread a window) is
  held, its previous body (one warp a window, which no path runs) is held
  beside it and both are timed in turns, with their ACS rates; the warp
  body has one counted run of its own on c3_pallas's LLRs (k4w_ab).
  Wherever the whole-sequence Viterbi kernel (K4) is held (C3, C4,
  c2_pallas, big_nsc), every group size it takes (4, 8, 16, 32 lanes a
  sequence) is checked bit for bit and timed in turns with its ACS rate,
  and the forward pass alone in turns with the whole decode (the
  traceback's share).

  1. device:  a CUDA card must be present; prints the card's name and
              power limit as nvidia-smi reports them;
  2. build:   builds the hand kernels from ofdm_uhd_tpu_torch/kernels/csrc
              (one nvcc per source, sm_90a, started together) into
              build/ofdm_uhd_tpu_torch/, and prints each kernel's
              registers and spilled bytes (ptxas -v);
  then for C3, C4, c4_bf16, C5 (and c5_sharded), c3_pallas and c2_pallas
  in turn (and last the shift and tiers phases, whose counted runs stand
  for their slices):
  3. input:   the captures, built by the port's TxPipeline on the card
              (C4's interpolation is the interp kernel, c4_bf16's the
              interp_bf16 kernel; the 'pallas' paths' IFFT + CP the
              ifftcp kernel), with the TX's launches counted (C4, c4_bf16,
              'pallas');
  4. stages:  runs the chain's steps one at a time on the whole batch (C5:
              on the first step's window of each operating point;
              c5_sharded: on that window's shard rows) and times each
              (CUDA events, median of 5);
  5. kernels: holds each kernel against its plain PyTorch version on the
              card, on the inputs those steps gave it, and times both
              (CUDA events, median of 5), beside its bound (the larger of
              its bytes at 3.35 TB/s and its operations at 67 TFLOP/s, or
              989 TFLOP/s bf16 for the bf16 tier's useful products) and,
              where one PyTorch call computes the same function, that
              call's time (library_ms: torch.fft.fft, conv1d,
              conv_transpose1d, on bf16 planes and weights for the bf16
              tier, and for K2 advanced indexing on an unfold view with
              the offsets clamped inside the capture, also in-kernel in
              turns with K2; the port never calls them); the FFT kernels (K3
              both ways, K5 RX and TX) also in-kernel, in turns with
              torch.fft's call (ortho; for K5 TX torch.fft.ifft without
              the prefix), and torch.fft's unscaled call beside them; C5
              also holds the windowed Viterbi at both geometries and
              times the whole-sequence kernel on the same LLRs;
  6. slice:   decodes every frame, which must match the sent payloads bit
              for bit, with the launch count of every kernel of the path
              > 0 over that run, and no shift_*, banded_*, ilv_* or deframe
              kernel; times the chain
              with the kernels and with the plain versions forced,
              requires the plain run's frame
              starts (capture paths: `d`, `valid` and the valid slots'
              payloads; C5: starts and payloads) to equal the kernel
              run's, and reads the card's busy share (torch.profiler).

Then it prints one JSON line with the per-kernel results and, last, the
line {"ok": true, "device": {...}}. Any failure exits non-zero before
that line. Usage: python3 chip_smoke.py [--out FILE.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_CAPS, GAP = 8, 300
C3_FRAMES = 1024
C4_FRAMES = 32
C5_FRAMES, C5_OFFSET = 4096, 100
C5_RESIDENT = (4_128_768, 4)     # (chunk, steps per dispatch), fc32
C5_HOSTFED = (129_024, 16)       # sc16
C2_CAPS, C2_FRAMES = 32, 128
# the files phase: one C3 capture of FILES_FRAMES frames through an sc16
# file, C4's TX of FILES_C4_FRAMES frames through a file, C2's loopback
FILES_FRAMES = 1024
FILES_C4_FRAMES, FILES_C2_FRAMES = 32, 64
FIXTURES = ("c1", "c2", "c3")      # tests/fixtures/golden_<name>.npz
# the bench phase: cli.bench's timed passes a run, the C1 and C2 runs'
# frames, and the C3 run's captures x frames (bench.py's headline shape);
# the C5 runs take C5_FRAMES, C5_HOSTFED and C5_RESIDENT
BENCH_ITERS = 5
BENCH_FRAMES = 4096
BENCH_C3 = (N_CAPS, C3_FRAMES)
# the kernels the files phase's C3 RX launches: one capture's 1032 slots
# are a decode batch of at most 2048, where the reference's policy (and
# the port's, kernels/policy.py viterbi_impl) picks the windowed decoder
FILES_PATH = ("scfront", "localize", "extract", "fft", "viterbi_windowed")
# the golden chain's eps against the card's: both estimate one CFO from
# differently chosen plateau samples (the reference's own pipeline lies
# up to 1.1e-3 from its golden chain on C3 captures), 25x tighter than the
# 0.05 to which the reference's tests hold either to the true CFO
GOLDEN_EPS_TOL = 2e-3
# the harness phase: stages at C3's headline shape (N_CAPS x C3_FRAMES),
# the sweeps at C2 (10 dB: some frames fail; 14 dB: none), detect_sweep
# at C3 (5 dB: CFAR and the TRACK rescue; 15 dB: frames decode)
HARNESS_STAGES_CONFIG = "c3"
STAGES_KEYS = {"ts", "config", "backend", "device", "n_samples", "batch",
               "frames", "cfo", "mf", "frame_len", "stages_ms", "steps_ms",
               "frames_ok"}
HARNESS_SNRS, HARNESS_SWEEP_FRAMES = "10,14", 30
HARNESS_DETECT_SNRS, HARNESS_TRIALS = "5,15", 2
HARNESS_EVM_FRAMES, HARNESS_POD_FRAMES, HARNESS_PP_BATCH = 32, 24, 64
# the card's hard decisions against the CPU's: the FFT kernel and
# torch.fft's CPU transform round differently (~1e-7 of |y|), so a QAM
# decision that lies within that of a boundary can go either way; at
# C2's SNR points a few such decisions in 30 frames' 69,120 bits are
# possible, not expected
PRE_FEC_TOL_BITS = 4
EVM_TOL_DB = 0.01       # PERF.md §2: the port against the reference
C5_SHARDS = 4                    # the virtual mesh's time axis, on one card
ROUNDS_SHARDED = 5               # interleaved timing rounds of c5_sharded
# the distributed phase: C5's resident point over a (1, C5_SHARDS) mesh
# that spans DIST_WORLD processes (gloo on one card; NCCL, one process a
# card, on 2 and 4 cards where there are that many); a worker or pod_rx
# process still running after DIST_TIMEOUT_S is hung: all are killed
DIST_WORLD = 2
DIST_TIMEOUT_S = 420
ROUNDS_DIST = 3                  # interleaved timing rounds across cards
AXES_FRAMES, AXES_SNR = 4096, 28.0   # the frame and stage axes' C3 batch
AXES_MICRO = 4                   # the stage axis's microbatches
# the distributed axes phase: AXES_WORLD processes under gloo on one card
# (frame axis (4, 1), stage axis, the stream on (2, 2)); NCCL, one process
# a card, on 2 and 4 cards where there are that many
AXES_WORLD = 4
# the variants phase: the reference's three restructured whole-sequence
# decoders against K4 at C3's trellis length (K4 at C3 decodes rows of
# 6912 steps): VARIANT_ROWS (decodable, tied) rows, and an odd batch
# (decodable rows, tied rows, steps) for the radix-4 forms' fallback
VARIANTS = ("viterbi_decode_smaj", "viterbi_decode_radix4",
            "viterbi_decode_smaj_radix4")
VARIANT_STEPS = 6912
VARIANT_ROWS = (64, 16)
VARIANT_ODD = (8, 8, 6911)
REPS = 5
REPS_STREAM = 2
SLOW_S = 1.0            # a plain version slower than this is timed once
HOST_REPS = 200         # calls a wrapper's host time is taken over
REL_TOL = 1e-5          # FIR / FFT / S&C P: max error within 1e-5 * max|y|
M_TOL = 1e-5            # S&C metric M: absolute (M lies in [0, ~1])
R_TOL = 1e-5            # S&C R: relative, sample by sample

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# a kernel's bound is the larger of its bytes over HBM_BPS and its
# operations over F32_OPS (float32 outside the tensor cores) or, for the
# bf16 filter tier's products on the tensor cores, BF16_OPS, or, for the
# banded tier's three TF32 products per multiply-add (3xTF32), TF32_OPS
HBM_BPS = 3.35e12
F32_OPS = 67e12
BF16_OPS = 989e12
TF32_OPS = 495e12

KERNEL_INFO = {
    "localize": ("ofdm_uhd_tpu_torch/kernels/csrc/localize.cu",
                 "ofdm_uhd_tpu/kernels/pallas_localize.py:117"),
    "extract": ("ofdm_uhd_tpu_torch/kernels/csrc/extract.cu",
                "ofdm_uhd_tpu/kernels/pallas_extract.py:108"),
    "fft": ("ofdm_uhd_tpu_torch/kernels/csrc/fft.cu",
            "ofdm_uhd_tpu/kernels/pallas_fft.py:185"),
    "viterbi": ("ofdm_uhd_tpu_torch/kernels/csrc/viterbi.cu",
                "ofdm_uhd_tpu/kernels/pallas_viterbi.py:324"),
    "viterbi_windowed": ("ofdm_uhd_tpu_torch/kernels/csrc/viterbi.cu",
                         "ofdm_uhd_tpu/kernels/pallas_viterbi.py:285"),
    # K4w's previous body (one warp a window), the A/B baseline no path
    # runs; held and timed in turns beside K4w wherever K4w is held
    "viterbi_windowed_warp": ("ofdm_uhd_tpu_torch/kernels/csrc/viterbi.cu",
                              "ofdm_uhd_tpu/kernels/pallas_viterbi.py:285"),
    # K3's two-pass route above one launch (big_nsc): the column pass
    # (with the twiddles) and the row pass (natural-order store)
    "fft_columns": ("ofdm_uhd_tpu_torch/kernels/csrc/fft.cu",
                    "ofdm_uhd_tpu/kernels/pallas_fft.py:185"),
    "fft_rows_t": ("ofdm_uhd_tpu_torch/kernels/csrc/fft.cu",
                   "ofdm_uhd_tpu/kernels/pallas_fft.py:185"),
    # the S&C split route above the tile route's lags (big_nsc): K6's (and
    # K9's) sums in two passes (csrc/scfront_split.cuh)
    "sc_span": ("ofdm_uhd_tpu_torch/kernels/csrc/scfront.cu",
                "ofdm_uhd_tpu/kernels/pallas_scfront.py:103"),
    "sc_stride": ("ofdm_uhd_tpu_torch/kernels/csrc/scfront.cu",
                  "ofdm_uhd_tpu/kernels/pallas_scfront.py:103"),
    "fir": ("ofdm_uhd_tpu_torch/kernels/csrc/fir.cu",
            "ofdm_uhd_tpu/kernels/pallas_fir_mxu.py:154"),
    "interp": ("ofdm_uhd_tpu_torch/kernels/csrc/fir.cu",
               "ofdm_uhd_tpu/kernels/pallas_fir_mxu.py:176"),
    # the same TPU kernels at Precision.DEFAULT (1-pass bf16 products)
    "fir_bf16": ("ofdm_uhd_tpu_torch/kernels/csrc/fir_bf16.cu",
                 "ofdm_uhd_tpu/kernels/pallas_fir_mxu.py:154"),
    "interp_bf16": ("ofdm_uhd_tpu_torch/kernels/csrc/fir_bf16.cu",
                    "ofdm_uhd_tpu/kernels/pallas_fir_mxu.py:176"),
    "scfront": ("ofdm_uhd_tpu_torch/kernels/csrc/scfront.cu",
                "ofdm_uhd_tpu/kernels/pallas_scfront.py:103"),
    "cpfft": ("ofdm_uhd_tpu_torch/kernels/csrc/fft.cu",
              "ofdm_uhd_tpu/kernels/pallas_fft.py:191"),
    "ifftcp": ("ofdm_uhd_tpu_torch/kernels/csrc/fft.cu",
               "ofdm_uhd_tpu/kernels/pallas_fft.py:204"),
    "sccorr": ("ofdm_uhd_tpu_torch/kernels/csrc/scfront.cu",
               "ofdm_uhd_tpu/kernels/pallas_sync.py:55"),
    "halo": ("ofdm_uhd_tpu_torch/kernels/csrc/halo.cu",
             "ofdm_uhd_tpu/kernels/pallas_halo.py:59"),
    # the shifted-FMA tier (K11), which no user path runs; its S&C
    # correlator is served by the sccorr kernel
    "shift_fir": ("ofdm_uhd_tpu_torch/kernels/csrc/shift.cu",
                  "ofdm_uhd_tpu/research/pallas_shift.py:133"),
    "shift_decim": ("ofdm_uhd_tpu_torch/kernels/csrc/shift.cu",
                    "ofdm_uhd_tpu/research/pallas_shift.py:332"),
    "shift_interp": ("ofdm_uhd_tpu_torch/kernels/csrc/shift.cu",
                     "ofdm_uhd_tpu/research/pallas_shift.py:405"),
    "shift_sc": ("ofdm_uhd_tpu_torch/kernels/csrc/scfront.cu",
                 "ofdm_uhd_tpu/research/pallas_shift.py:281"),
    # the banded tier (K8) and the interleaved tier (K13) on one kernel
    # source, and the bulk-copy deframer (K12), which no user path runs
    "banded_fir": ("ofdm_uhd_tpu_torch/kernels/csrc/banded.cu",
                   "ofdm_uhd_tpu/kernels/pallas_fir.py:133"),
    "banded_decim": ("ofdm_uhd_tpu_torch/kernels/csrc/banded.cu",
                     "ofdm_uhd_tpu/kernels/pallas_fir.py:174"),
    "banded_interp": ("ofdm_uhd_tpu_torch/kernels/csrc/banded.cu",
                      "ofdm_uhd_tpu/kernels/pallas_fir.py:150"),
    "banded_sc": ("ofdm_uhd_tpu_torch/kernels/csrc/banded.cu",
                  "ofdm_uhd_tpu/kernels/pallas_sync.py:40"),
    "ilv_fir": ("ofdm_uhd_tpu_torch/kernels/csrc/banded.cu",
                "ofdm_uhd_tpu/research/pallas_fir_ilv.py:63"),
    "ilv_decim": ("ofdm_uhd_tpu_torch/kernels/csrc/banded.cu",
                  "ofdm_uhd_tpu/research/pallas_fir_ilv.py:108"),
    "ilv_interp": ("ofdm_uhd_tpu_torch/kernels/csrc/banded.cu",
                   "ofdm_uhd_tpu/research/pallas_fir_ilv.py:155"),
    # the interleaved tier at the reference's DEFAULT precision (one bf16
    # pass), on the bf16 filter tier's kernel source
    "ilv_fir_bf16": ("ofdm_uhd_tpu_torch/kernels/csrc/fir_bf16.cu",
                     "ofdm_uhd_tpu/research/pallas_fir_ilv.py:63"),
    "ilv_decim_bf16": ("ofdm_uhd_tpu_torch/kernels/csrc/fir_bf16.cu",
                       "ofdm_uhd_tpu/research/pallas_fir_ilv.py:108"),
    "ilv_interp_bf16": ("ofdm_uhd_tpu_torch/kernels/csrc/fir_bf16.cu",
                        "ofdm_uhd_tpu/research/pallas_fir_ilv.py:155"),
    "deframe": ("ofdm_uhd_tpu_torch/kernels/csrc/deframe.cu",
                "ofdm_uhd_tpu/research/pallas_deframe.py:53"),
}
# the kernels each path's RX launches (C4's interp runs in its TX, and
# the 'pallas' paths' ifftcp in theirs)
C3_PATH = ("scfront", "localize", "extract", "fft", "viterbi")
C4_PATH = ("fir",) + C3_PATH
C4_BF16_PATH = ("fir_bf16", "scfront", "localize", "extract", "fft",
                "viterbi_windowed")
C5_PATH = ("scfront", "localize", "extract", "fft", "viterbi_windowed")
C3_PALLAS_PATH = ("scfront", "localize", "extract", "cpfft",
                  "viterbi_windowed")
C2_PALLAS_PATH = ("sccorr", "localize", "extract", "cpfft", "viterbi")
# the shift phase's launches; no slice may launch any of them
SHIFT_PATH = ("shift_fir", "shift_decim", "shift_interp", "shift_sc")
# bench/kernels_ab.py's K11 rows: a seed-0 complex64 signal of SHIFT_N
# samples through the 193-tap FIR (and the 3-tap one), the 8x decimation
# and the S&C correlator at l = 128; the 8x interpolation over SHIFT_N / 8
SHIFT_N = 1 << 20
SHIFT_M = 8
SHIFT_SC_L = 128
# the tiers phase's launches (K8, K13, K12); no slice may launch any of them
TIERS_PATH = ("banded_fir", "banded_decim", "banded_interp", "banded_sc",
              "ilv_fir", "ilv_decim", "ilv_interp", "ilv_fir_bf16",
              "ilv_decim_bf16", "ilv_interp_bf16", "deframe")
# K4w's warp body, the A/B baseline: no slice may launch it either
OFF_PATH = SHIFT_PATH + TIERS_PATH + ("viterbi_windowed_warp",)
# scripts/tpu_session.py:133-150's FIR rows: seed-0 complex64 [16, 8192]
# through the 193-tap FIR, the 8x interpolation and the 8x decimation
TIERS_SESSION = (16, 8192)


# big_nsc: RxPipeline at FFT sizes above the chain's own, QPSK, CP n/8, 2
# data symbols (LTE / NR carriers run 2048-4096 points, DVB-T2's 16K and
# 32K modes 16384 and 32768): K3 in one launch at 4096, the two-pass
# route above, and the S&C split route; BIG_CAPS captures of BIG_FRAMES
# frames each (gap 300, build_capture's default channel, seeds 0..)
BIG_NSC = (4096, 16384, 32768)
BIG_CAPS, BIG_FRAMES = 4, 4
# K3 alone at N = 4096 .. 65536, seed-0 rows of BIG_FFT_SAMPLES in all
BIG_FFT_NS = tuple(1 << k for k in range(12, 17))
BIG_FFT_SAMPLES = 1 << 23


class SmokeFailure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median device milliseconds of fn over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps: int = 20) -> float | None:
    """Device milliseconds of one run of fn without the host's launch
    overhead, which events around one call also read where it exceeds the
    kernel: a spin kernel (~20 ms) holds the card while the host enqueues
    reps runs between two events, so the card runs them back to back; None
    if the host took longer to enqueue them than the spin lasted."""
    fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spin.record()
    torch.cuda._sleep(40_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if host_ms >= spin.elapsed_time(start):
        return None
    return start.elapsed_time(end) / reps


def host_us(torch, fn, reps: int = HOST_REPS) -> float:
    """Host microseconds of one call of fn, over reps calls after a
    warm-up with no synchronisation between them: the wrapper's work and
    the launch's enqueue, not the device's."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def bound(nbytes: float, ops: float, peak: float = F32_OPS
          ) -> tuple[float, str]:
    """The least time the card could take for a function that moves
    `nbytes` (each input read once, each output written once) and does
    `ops` operations at `peak` per second (float32 by default): (ms,
    'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_fft(rows, n_in, n, n_out) -> tuple[float, float]:
    """(bytes, flops) of `rows` n-point complex FFTs reading n_in and
    writing n_out complex64 samples a row: 5 n log2 n flops a transform."""
    return 8.0 * rows * (n_in + n_out), 5.0 * rows * n * (n.bit_length() - 1)


def work_sc(rows, n, l, metric: bool) -> tuple[float, float]:
    """(bytes, flops) of the S&C front end (metric) or correlator over
    [rows, n] complex64: 8 B read a sample, 12 B written an output (P and
    M or R); per output 6 flops for the lag product, 4 for the energy,
    log2(l) adds for each of P's planes and log2(2l) for the energy's,
    one for R, and 8 for the metric."""
    nd = n - 2 * l + 1
    lg = l.bit_length() - 1
    per = 11 + 2 * lg + lg + 1 + (8 if metric else 0)
    return 8.0 * rows * n + 12.0 * rows * nd, float(rows * nd * per)


def work_filter(rows, n_in, n_out, taps, peak=F32_OPS
                ) -> tuple[float, float, float]:
    """(bytes, flops, peak) of a real-tap filter of complex64 rows [rows,
    n_in] -> [rows, n_out]: each sample read once and each output written
    once (8 B), and 2 FMAs (4 flops) per output and tap it needs."""
    return 8.0 * rows * (n_in + n_out), 4.0 * taps * rows * n_out, peak


def work_tf32(rows, n_in, n_out, taps) -> tuple[float, float, float]:
    """(bytes, flops, peak) of a real-tap filter on the banded tier: each
    sample read once and each output written once (8 B), and its useful
    multiply-adds (2 per complex output and tap) as three TF32 products
    each (3xTF32) at the TF32 peak."""
    return 8.0 * rows * (n_in + n_out), 12.0 * taps * rows * n_out, TF32_OPS


def work_sc_banded(rows, n, l) -> tuple[float, float, float]:
    """(bytes, flops, peak) of the banded tier's S&C over [rows, n]
    complex64: 8 B read a sample, 12 B written an output (P and R); per
    output 4l multiply-adds with a band of ones (l for each of P's planes,
    2l for R's), two TF32 products each (the ones have no low part)."""
    nd = n - 2 * l + 1
    return 8.0 * rows * n + 12.0 * rows * nd, 16.0 * l * rows * nd, TF32_OPS


def work_extract(n, ds, frame_len) -> tuple[float, float]:
    """(bytes, 0) of a frame extraction from rows of n samples at offsets
    ds: the in-capture part of each frame read (none at a negative offset:
    a zero frame), the offsets read, the frames written."""
    inside = int(((n - ds.long()).clamp(0, frame_len) * (ds >= 0)).sum())
    return 8.0 * inside + 4.0 * ds.numel() + 8.0 * ds.numel() * frame_len, 0.0


def work_viterbi(rows, n, steps) -> tuple[float, float]:
    """(bytes, ops) of a K=7 decode of [rows, 2n] float32 LLRs into [rows,
    n] bits over `steps` trellis steps in all (windows overlap): per step
    and state, two branch-metric adds, a compare and a select."""
    return 4.0 * rows * 2 * n + rows * n, 256.0 * steps


def card_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def phase_device(torch) -> dict:
    check(torch.cuda.is_available(), "no CUDA device: the port's kernels "
          "run only on an NVIDIA GPU")
    card = card_line()
    log(card)
    log(f"phase device: ok  torch {torch.__version__} cuda "
        f"{torch.version.cuda}  python {sys.version.split()[0]}  "
        f"devices {torch.cuda.device_count()}")
    return {"card": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> dict:
    from ofdm_uhd_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library(verbose=True)
    secs = time.perf_counter() - t0
    for line in build.build_log().splitlines():
        if "error" in line:
            print(line, file=sys.stderr)
    regs = kernel_registers(build.build_log())
    check(bool(regs), "build: the ptxas report names no kernel's registers")
    for name, (n, spill) in regs.items():
        log(f"build: {name} {n} registers, {spill} bytes spilled")
    log(f"phase build: ok  {secs:.1f} s into {build.build_dir()}")
    return {"build_s": secs, "registers": regs}


def kernel_registers(ptxas_log: str) -> dict:
    """{kernel: [registers a thread, bytes spilled (stores + loads)]} from
    `nvcc -Xptxas -v` output, each entry function by its short name
    (`fft_cp_kernel<8>` for a template over one int)."""
    out, name, spill = {}, None, 0
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = short_name(m.group(1)), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = [int(m.group(1)), spill]
            name = None
    return out


def short_name(mangled: str) -> str:
    """The last identifier of an Itanium-mangled function name, with its
    int template argument if it has one."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    ident, i = mangled, 0
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        ident, i = s[j:j + int(s[i:j])], j + int(s[i:j])
    m = re.match(r"ILi(\d+)E", s[i:])
    return f"{ident}<{m.group(1)}>" if m else ident


def make_input_c3(torch, spec, device):
    """The bench's captures: seeds 0..7, as sc16 planes [2, C, n] on device,
    plus the sent payloads [C, F, bits]."""
    import numpy as np
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    t0 = time.perf_counter()
    built = [build_capture(spec, C3_FRAMES, GAP, seed=s, device=device)
             for s in range(N_CAPS)]
    caps = np.stack([c for c, _ in built])
    pays = np.stack([p for _, p in built])
    iq = torch.from_numpy(to_sc16(caps)).to(device)
    log(f"c3 input: {N_CAPS} captures x {caps.shape[1]} samples, "
        f"{C3_FRAMES} frames each, built in {time.perf_counter() - t0:.1f} s")
    return iq, torch.from_numpy(pays).to(device)


def make_input_pallas(torch, spec, label, n_caps, n_frames, device,
                      **channel):
    """Captures of seeds 0..n_caps-1 (each its own payloads) from the
    port's TxPipeline on the card under the spec's kernel_backend, with the
    TX's launches counted: sc16 planes [2, C, n] on device, the sent
    payloads [C, F, bits], the TX's launch counts, and the grid of the
    first capture's frames [F, n_syms, n_sc] (the input K5 TX was given)."""
    import numpy as np
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    from ofdm_uhd_tpu_torch.kernels import policy
    from ofdm_uhd_tpu_torch.phy import frame, qam
    from ofdm_uhd_tpu_torch.pipeline import TxPipeline
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    policy.reset_launches()
    built = [build_capture(spec, n_frames, GAP, seed=s, device=device,
                           **channel) for s in range(n_caps)]
    torch.cuda.synchronize()
    launches = policy.launches()
    check(launches["ifftcp"] == n_caps and launches["fft"] == 0,
          f"{label} input: the TX launched {launches}, not the ifftcp "
          "kernel once a capture")
    caps = np.stack([c for c, _ in built])
    pays = torch.from_numpy(np.stack([p for _, p in built])).to(device)
    iq = torch.from_numpy(to_sc16(caps)).to(device)
    syms = qam.qam_map(TxPipeline(spec).encode(pays[0]), spec.modulation)
    grid = frame.build_grid(spec, syms.reshape(-1, spec.n_data_syms,
                                               spec.n_data_sc))
    log(f"{label} input: {n_caps} captures x {caps.shape[1]} samples, "
        f"{n_frames} frames each, sc16, built in "
        f"{time.perf_counter() - t0:.1f} s; TX launches {launches}")
    return iq, pays, launches, grid


def make_input_c4(torch, spec, device, label="c4"):
    """The reference's C4 row: seeds 0..7, fc32 captures [C, n] on device,
    the sent payloads [C, F, bits], the TX's launch counts, and the
    baseband frames its interpolation took (the input of the interp kernel
    of the spec's filter tier, which alone must have run)."""
    import numpy as np
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.kernels import policy
    from ofdm_uhd_tpu_torch.pipeline import TxPipeline
    tier = policy.filter_precision(spec, "interp", spec.resample_l)
    interp, other = (("interp_bf16", "interp") if tier == "bf16"
                     else ("interp", "interp_bf16"))
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    policy.reset_launches()
    built = [build_capture(spec, C4_FRAMES, GAP, seed=s, snr_db=28.0,
                           cfo=0.8 / spec.resample_l, phase_noise_std=0.0,
                           timing_offset=100, device=device)
             for s in range(N_CAPS)]
    torch.cuda.synchronize()
    launches = policy.launches()
    check(launches[interp] > 0 and launches[other] == 0,
          f"{label} input: the TX launched {launches}, not the {interp} "
          "kernel alone")
    caps = torch.from_numpy(np.stack([c for c, _ in built])).to(device)
    pays = torch.from_numpy(np.stack([p for _, p in built])).to(device)
    base = TxPipeline(spec).baseband(pays[0])
    log(f"{label} input: {N_CAPS} captures x {caps.shape[1]} radio samples, "
        f"{C4_FRAMES} frames each, fc32, built in "
        f"{time.perf_counter() - t0:.1f} s; TX launches {launches}")
    return caps, pays, base, launches


def phase_stages(torch, spec, label, x, max_frames, front=None,
                 algo_batch=None, slots=None) -> tuple[dict, dict]:
    """The steps of pipeline/rx.py:_rx_capture one at a time, on the whole
    batch (harness/stages.py chain_steps): each step's device time (CUDA
    events, median of 5, so steps do not overlap) and each kernel's inputs
    as the main path produces them. x: sc16 planes [2, C, n] (C3) or fc32
    radio-rate captures [C, n] (C4); front, algo_batch, slots: as
    chain_steps takes them (c5_sharded: the window's AGC and the halo
    exchange into the shards' rows, one shard's slots, the reshard's
    padding)."""
    from ofdm_uhd_tpu_torch.harness.stages import chain_steps
    ins, ms = chain_steps(spec, x, max_frames, lambda fn: cuda_ms(torch, fn),
                          front=front, algo_batch=algo_batch, slots=slots)
    log(f"{label} stages: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f" ms; sum {sum(ms.values()):.1f} ms")
    return ins, ms


def device_busy_share(torch, run) -> dict:
    """Share of one dispatch's wall time in which the card ran a kernel or
    copy, from a torch.profiler trace (CUPTI); None where the trace shows
    no device activity."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = covered(spans)
    if not spans:
        return {"busy_share": None, "traced_wall_ms": wall_us / 1e3}
    return {"busy_share": busy / wall_us, "traced_wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3, "device_events": len(spans)}


def covered(spans) -> float:
    """The length of the union of (start, end) spans."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def held(torch, name, run_k, run_p, tol, shape, work,
         library=None) -> dict:
    """Run a kernel wrapper and its plain version on the same inputs,
    require tol(kernel, plain) -> (ok, err), and time both; work = (bytes,
    operations[, peak operations per second]) of the function on these
    inputs, for its bound; library:
    one PyTorch call computing the same function (timed as library_ms),
    or None where there is none. A plain version slower than SLOW_S is
    timed once after its warm-up, not REPS times."""
    y_k = run_k()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_p = run_p()
    torch.cuda.synchronize()
    plain_reps = 1 if time.perf_counter() - t0 > SLOW_S else REPS
    ok, err = tol(y_k, y_p)
    check(ok, f"{name}: kernel differs from the plain version by {err}")
    bound_ms, bound_by = bound(*work)
    return {"max_abs_err": err, "shape": list(shape),
            "ms": cuda_ms(torch, run_k),
            "plain_ms": cuda_ms(torch, run_p, plain_reps),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if library is None else cuda_ms(torch,
                                                              library)}


def rel_close(y_k, y_p) -> tuple[bool, float]:
    err = float((y_k - y_p).abs().max())
    return err <= REL_TOL * float(y_p.abs().max()), err


def sc_close(k, p) -> tuple[bool, float]:
    """(P, R) pairs of the S&C correlator: P within REL_TOL of max|P|, R
    within R_TOL sample by sample."""
    ok_p, err = rel_close(k[0], p[0])
    rel = float(((k[1] - p[1]).abs() / p[1].abs().clamp_min(1e-30)).max())
    return ok_p and rel <= R_TOL, max(err, rel)


def scfront_close(k, p) -> tuple[bool, float]:
    """(P, M) pairs: M within M_TOL absolute, P within REL_TOL of max|P|."""
    ok_p, _ = rel_close(k[0], p[0])
    err = float((k[1] - p[1]).abs().max())
    return ok_p and err <= M_TOL, err


def log_kernels(label, res) -> None:
    for k, v in res.items():
        lib = v["library_ms"]
        log(f"{label} kernels: {k:9s} ok  {v['shape']}  kernel "
            f"{v['ms']:.3f} ms  plain {v['plain_ms']:.3f} ms  bound "
            f"{v['bound_ms']:.3f} ms ({v['bound_by']})  library "
            + ("none" if lib is None else f"{lib:.3f} ms")
            + f"  max_abs_err {v['max_abs_err']:.3g}"
            + (f"  contiguous {v['ms_contiguous']:.3f} ms"
               if "ms_contiguous" in v else "")
            + (f"  in-kernel {v['device_ms']:.4f} ms"
               if v.get("device_ms") is not None else "")
            + (f"  found {v['found']}" if "found" in v else "")
            + (f"  library in-kernel {v['library_device_ms']:.4f} ms"
               if v.get("library_device_ms") is not None else "")
            + (f"  host {v['host_us']:.1f} us a call"
               if "host_us" in v else "")
            + (f"  unscaled {v['library_unscaled_ms']:.4f} ms"
               if v.get("library_unscaled_ms") is not None else ""))


def library_fir(torch, x, taps, stride, dtype=None):
    """One PyTorch call computing the strided 'same' FIR of x [R, n] (the
    fir kernel's function): conv1d over x's (re, im) planes, made before
    the call, with the taps reversed and the 'same' padding. dtype
    torch.bfloat16: planes and weights in bf16 (the fir_bf16 kernel's
    function, but cuDNN rounds the output to bf16 where the kernel keeps
    float32)."""
    import torch.nn.functional as F
    from ofdm_uhd_tpu_torch.kernels import fir
    _, w, pad = fir._corr_weights(taps)       # pad both sides (odd taps)
    planes = torch.cat([x.real, x.imag])[:, None, :].contiguous()
    wt = torch.from_numpy(w.copy()).to(x.device)[None, None, :]
    if dtype is not None:
        planes, wt = planes.to(dtype), wt.to(dtype)
    return lambda: F.conv1d(planes, wt, stride=stride, padding=pad)


def library_interp(torch, x, l, taps, dtype=None):
    """One PyTorch call computing the L-fold polyphase interpolation of x
    [R, n] (the interp kernel's function): conv_transpose1d over x's (re,
    im) planes with the prototype times L, cropped to the 'same'
    alignment; dtype as library_fir's."""
    import numpy as np
    import torch.nn.functional as F
    h = (np.asarray(taps, np.float64) * l).astype(np.float32)
    planes = torch.cat([x.real, x.imag])[:, None, :].contiguous()
    wt = torch.from_numpy(h).to(x.device)[None, None, :]
    if dtype is not None:
        planes, wt = planes.to(dtype), wt.to(dtype)
    return lambda: F.conv_transpose1d(planes, wt, stride=l,
                                      padding=(len(h) - 1) // 2,
                                      output_padding=l - 1)


def phase_kernels(torch, spec, label, ins, names=C3_PATH) -> dict:
    """The kernels of this path's RX named in `names`, each against its
    plain version on the inputs this path's steps gave it, with its bound
    and, where one PyTorch call computes the same function, that call's
    time."""
    from ofdm_uhd_tpu_torch.kernels import (extract, fft, localize, scfront,
                                            sync, viterbi)
    cap, llr = ins["cap"], ins["llr"]
    rows, n = cap.shape
    l = spec.n_sc // 2

    def hold_scfront():
        # S&C front end at l = n_sc / 2 (128 on C3, 512 on C4)
        res = held(torch, "scfront", lambda: scfront._scfront_cuda(cap, l),
                   lambda: scfront.sc_frontend_plain(cap, l), scfront_close,
                   cap.shape, work_sc(rows, n, l, metric=True))
        return sc_tile_bits(torch, label, res, "scfront", cap, l, True)

    def hold_sccorr():
        # S&C correlator at l = n_sc / 2 (32 on C2)
        res = held(torch, "sccorr", lambda: sync._sccorr_cuda(cap, l),
                   lambda: sync.sc_correlate_plain(cap, l), sc_close,
                   cap.shape, work_sc(rows, n, l, metric=False))
        return sc_tile_bits(torch, label, res, "sccorr", cap, l, False)

    def hold_localize():
        # d exact, eps within 1e-6; the work is what this run's found
        # candidates read: span metric samples and one P sample each
        args = (ins["m"], ins["p"], ins["cand"], spec.sym_len, spec.cp)
        found = int((ins["cand"] < ins["m"].shape[1]).sum())

        def close(k, p):
            err = float((k[1] - p[1]).abs().max())
            return bool(torch.equal(k[0], p[0])) and err <= 1e-6, err
        res = held(torch, "localize",
                   lambda: localize._localize_cuda(*args, 0.9),
                   lambda: localize.localize_plain(*args), close,
                   ins["cand"].shape,
                   (12.0 * ins["cand"].numel()
                    + found * (4.0 * spec.sym_len + 8),
                    3.0 * found * spec.sym_len))
        # events around one call read the launch: the in-kernel time too
        res["device_ms"] = device_ms(
            torch, lambda: localize._localize_cuda(*args, 0.9))
        res["found"] = found
        return res

    def hold_extract():
        # bit-exact copy; reads the in-capture part of each frame. Library:
        # advanced indexing on an unfold view, the function where no
        # offset runs past the capture (the offsets clamped to n - fl
        # before the call; equal to the kernel's frames on the slots whose
        # offset lies in [0, n - fl]), in-kernel in turns with K2
        fl, ds = spec.frame_len, ins["ds"]
        rows_i = torch.arange(rows, device=cap.device)[:, None]
        start = ds.long().clamp(0, n - fl)
        inside = (ds >= 0) & (ds <= n - fl)

        def gather():
            return cap.unfold(-1, fl, 1)[rows_i, start]

        def close(k, p):
            return (bool(torch.equal(torch.view_as_real(k),
                                     torch.view_as_real(p))),
                    float((k - p).abs().max()))
        res = held(torch, "extract",
                   lambda: extract._extract_cuda(cap, ds, fl),
                   lambda: extract.extract_plain(cap, ds, fl), close,
                   (ds.numel(), fl), work_extract(n, ds, fl), gather)
        same, err = close(gather()[inside],
                          extract._extract_cuda(cap, ds, fl)[inside])
        check(same, f"{label} extract: the unfold gather differs from K2 "
              f"by {err} on the offsets inside the capture")
        library_in_turns(torch, res,
                         lambda: extract._extract_cuda(cap, ds, fl), gather)
        res["library_slots"] = int(inside.sum())
        return res

    def hold_fft():
        # forward on the RX windows and inverse on their grid: within 1e-5
        # of max|X| against torch.fft (norm="ortho")
        grid, syms, st = ins["grid"], ins["syms"], ins["start"]
        w = syms[..., st:st + spec.n_sc].contiguous()
        return {"fft": hold_fft_on(w, False),
                "fft_inverse": hold_fft_on(grid, True)}

    def hold_fft_on(x, inverse):
        # K3 on x [..., n_sc], in-kernel in turns with torch.fft's call
        lib = torch.fft.ifft if inverse else torch.fft.fft
        nsc = spec.n_sc
        res = held(torch, "ifft" if inverse else "fft",
                   lambda: fft._fft_cuda(x, inverse),
                   lambda: fft.fft_plain(x, inverse), rel_close, x.shape,
                   work_fft(x.numel() // nsc, nsc, nsc, nsc),
                   lambda: lib(x, norm="ortho"))
        fft_in_turns(torch, res, lambda: fft._fft_cuda(x, inverse),
                     lambda: lib(x, norm="ortho"),
                     lambda: lib(x, norm="forward" if inverse
                                 else "backward"))
        return res

    def hold_cpfft():
        # K5 RX on the symbol rows, in place: within 1e-5 of max|X|; the
        # bound reads only the n-sample windows (the CP it strips is whole
        # 32 B sectors, never fetched). ms_contiguous: the same launch on
        # the windows copied out (row stride n), which parts the strided
        # read's cost from the kernel's; bit for bit the fft kernel's
        # output on those windows, since both run the one body
        syms, st, nsc = ins["syms"], ins["start"], spec.n_sc
        r = syms.numel() // spec.sym_len
        view = syms[..., st:st + nsc]
        res = held(torch, "cpfft",
                   lambda: fft._fft_cp_cuda("cpfft", syms, nsc, st, 0, False),
                   lambda: fft.cp_strip_fft_plain(syms, st, nsc), rel_close,
                   syms.shape, work_fft(r, nsc, nsc, nsc),
                   lambda: torch.fft.fft(view, norm="ortho"))
        fft_in_turns(torch, res,
                     lambda: fft._fft_cp_cuda("cpfft", syms, nsc, st, 0,
                                              False),
                     lambda: torch.fft.fft(view, norm="ortho"),
                     lambda: torch.fft.fft(view, norm="backward"))
        w = view.contiguous()
        y_c = fft._fft_cp_cuda("cpfft", w, nsc, 0, 0, False)
        check(torch.equal(y_c, fft._fft_cp_cuda("cpfft", syms, nsc, st, 0,
                                                False)),
              "cpfft: the contiguous windows transform otherwise")
        check(torch.equal(y_c, fft._fft_cuda(w, False)),
              "cpfft: the fft kernel transforms the windows otherwise")
        res["ms_contiguous"] = cuda_ms(
            torch, lambda: fft._fft_cp_cuda("cpfft", w, nsc, 0, 0, False))
        return res

    def hold_viterbi():
        # whole-sequence K4: bit-exact with the plain scan at every group
        # size, timed in turns
        return hold_k4(torch, llr, label)

    def hold_viterbi_windowed():
        # K4w at the fused decoder's 256/64 windows: bit-exact, and the
        # warp baseline beside it
        return hold_windowed(torch, llr, viterbi.FUSED_WINDOW, label)

    holds = {"scfront": hold_scfront, "sccorr": hold_sccorr,
             "localize": hold_localize, "extract": hold_extract,
             "fft": hold_fft, "cpfft": hold_cpfft, "viterbi": hold_viterbi,
             "viterbi_windowed": hold_viterbi_windowed}
    res = {}
    for k in names:
        got = holds[k]()
        res.update(got if k in ("fft", "viterbi_windowed") else {k: got})
    log_kernels(label, res)
    return res


def bits_digest(*ts) -> str:
    """A digest of the tensors' bytes, to compare two runs' outputs."""
    h = hashlib.blake2b(digest_size=8)
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def sc_tile_bits(torch, label, res, kernel, cap, l, metric) -> dict:
    """K6's (metric) or K9's tile launch on the path's captures cap [C, n]
    at lag l, after its hold `res`: the same bits (P and M or R) as the
    split route (ofdm_sc_span, ofdm_sc_stride: the same adds in two
    passes), checked; its in-kernel time (device_ms); and a digest of its
    bits (`bits`), by which the runs of two checkouts on the same inputs
    are compared."""
    from ofdm_uhd_tpu_torch.kernels import sync
    tile = sync.sc_kernels(kernel, cap, l, metric)
    split = sync.split_route(cap, l, metric, sync._span_cuda,
                             sync._stride_cuda)
    check(all(bool(torch.equal(a, b)) for a, b in zip(tile, split)),
          f"{label} {kernel}: the tile route's bits differ from the split "
          "route's")
    res["bits"] = bits_digest(*tile)
    del tile, split
    res["device_ms"] = device_ms(torch, lambda: sync.sc_kernels(
        kernel, cap, l, metric))
    t = res["device_ms"]
    log(f"{label} {kernel}: bit for bit the split route's P and "
        f"{'M' if metric else 'R'}, digest {res['bits']}; in-kernel "
        + ("none" if t is None else f"{t:.4f} ms"))
    return res


def hold_k4(torch, llr, label) -> dict:
    """K4 on llr [B, 2n] against its plain version, bit-exact, at the group
    size k4_group picks (the timed check) and at every other one (each
    bit-exact too); all in-kernel in turns (each group size twice,
    mirrored), each with its ACS rate (state-steps a second: 64 states x B
    x n steps over the in-kernel time); and the forward alone (no
    traceback) at the picked size in turns with the whole decode, whose
    difference is the traceback's share."""
    from ofdm_uhd_tpu_torch.kernels import viterbi

    def close(k, p):
        bad = int((k != p).sum())
        return bad == 0, float(bad)
    b, n = llr.shape[0], llr.shape[1] // 2
    group = viterbi.k4_group(b, torch.cuda.get_device_properties(
        llr.device).multi_processor_count)
    res = held(torch, "viterbi", lambda: viterbi._viterbi_cuda(llr),
               lambda: viterbi.viterbi_plain(llr), close, llr.shape,
               work_viterbi(b, n, b * n))
    want = viterbi._viterbi_cuda(llr)        # the plain version's bits
    runs = {}
    for g in viterbi.K4_GROUPS:
        ok, bad = close(viterbi._viterbi_cuda(llr, g), want)
        check(ok, f"{label} viterbi, group {g}: {bad} bits differ from the "
              "plain version's")
        runs[f"g{g}"] = lambda g=g: viterbi._viterbi_cuda(llr, g)
    turns = in_turns(torch, runs, tuple(runs))
    state_steps = 64.0 * b * n
    res["group"] = group
    res["groups"] = {}
    for g in viterbi.K4_GROUPS:
        got = [t for t in turns[f"g{g}"] if t is not None]
        ms = statistics.mean(got) if got else None
        res["groups"][g] = {"device_ms": ms,
                            "device_ms_turns": turns[f"g{g}"],
                            "acs_per_s": (state_steps / (ms * 1e-3)
                                          if ms else None)}
    res["device_ms"] = res["groups"][group]["device_ms"]
    res["acs_per_s"] = res["groups"][group]["acs_per_s"]
    split = in_turns(torch, {
        "decode": lambda: viterbi._viterbi_cuda(llr, group),
        "forward": lambda: viterbi._viterbi_cuda(llr, group,
                                                 traceback=False)},
        ("decode", "forward"))
    means = {k: statistics.mean([t for t in v if t is not None] or [0.0])
             for k, v in split.items()}
    res["forward_ms_turns"] = split["forward"]
    res["traceback_share"] = (1.0 - means["forward"] / means["decode"]
                              if means["decode"] else None)
    log(f"{label} K4 on {list(llr.shape)} ({b} sequences of {n} steps), "
        f"group {group}; in-kernel in turns: {fmt_turns(turns)} ms; ACS "
        "rate " + ", ".join(
            f"g{g} {r['acs_per_s']:.3e}" if r["acs_per_s"] else f"g{g} none"
            for g, r in res["groups"].items())
        + f" state-steps/s; forward alone vs decode: {fmt_turns(split)} ms"
        + (f", traceback share {res['traceback_share']:.3f}"
           if res["traceback_share"] is not None else ""))
    return res


def hold_windowed(torch, llr, geometry, label) -> dict:
    """K4w at `geometry` (window, overlap) against its plain version on
    llr [B, 2n], bit-exact, and the warp baseline (its previous body) on
    the same LLRs, also bit-exact; both in-kernel in turns (K4w, warp,
    warp, K4w), with each one's ACS rate (state-steps a second: 64 states
    x windows x e steps over the in-kernel time). Returns
    {"viterbi_windowed": ..., "viterbi_windowed_warp": ...}."""
    from ofdm_uhd_tpu_torch.kernels import viterbi

    def close(k, p):
        bad = int((k != p).sum())
        return bad == 0, float(bad)
    b, n = llr.shape[0], llr.shape[1] // 2
    _, e, starts = viterbi.window_geometry(n, *geometry)

    def run_k():
        return viterbi._viterbi_windowed_cuda(llr, *geometry)

    def run_w():
        return viterbi._viterbi_windowed_warp_cuda(llr, *geometry)
    res = held(torch, f"viterbi_windowed {geometry}", run_k,
               lambda: viterbi.viterbi_windowed_plain(llr, *geometry),
               close, llr.shape, work_viterbi(b, n, b * len(starts) * e))
    ok, bad = close(run_w(), run_k())
    check(ok, f"viterbi_windowed_warp {geometry}: {bad} bits differ from "
          "K4w's")
    warp = {**res, "max_abs_err": bad, "ms": cuda_ms(torch, run_w)}
    turns = in_turns(torch, {"kernel": run_k, "warp": run_w},
                     ("kernel", "warp"))
    state_steps = 64.0 * b * len(starts) * e
    for r, name in ((res, "kernel"), (warp, "warp")):
        got = [t for t in turns[name] if t is not None]
        r["device_ms"] = statistics.mean(got) if got else None
        r["device_ms_turns"] = turns[name]
        r["acs_per_s"] = (state_steps / (r["device_ms"] * 1e-3)
                          if r["device_ms"] else None)
    log(f"{label} K4w {geometry} on {list(llr.shape)} ({b * len(starts)} "
        f"windows of {e} steps), in-kernel in turns: {fmt_turns(turns)} "
        "ms; ACS rate " + ", ".join(
            f"{k} {r['acs_per_s']:.3e}" if r["acs_per_s"] else f"{k} none"
            for k, r in (("K4w", res), ("warp", warp)))
        + " state-steps/s")
    return {"viterbi_windowed": res, "viterbi_windowed_warp": warp}


def phase_kernel_ifftcp(torch, spec, label, grid) -> dict:
    """K5 TX on the grid of one capture's frames [F, n_syms, n_sc], as the
    TX built it: within 1e-5 of max|x| against ifft + cat. No one PyTorch
    call computes the prefixed rows; torch.fft.ifft of the grid (no
    prefix) is timed in turns beside it, as information."""
    from ofdm_uhd_tpu_torch.kernels import fft
    n, cp = spec.n_sc, spec.cp
    r = grid.numel() // n

    def run_k():
        return fft._fft_cp_cuda("ifftcp", grid, n, 0, cp, True)
    res = {"ifftcp": held(torch, "ifftcp", run_k,
                          lambda: fft.ifft_cp_plain(grid, cp), rel_close,
                          grid.shape, work_fft(r, n, n, n + cp))}
    fft_in_turns(torch, res["ifftcp"], run_k,
                 lambda: torch.fft.ifft(grid, norm="ortho"),
                 lambda: torch.fft.ifft(grid, norm="forward"))
    log_kernels(label + " tx", res)
    return res


def library_in_turns(torch, res, run_k, library) -> None:
    """Add to a kernel's check its in-kernel ms and its library call's,
    taken in turns (kernel, library, library, kernel): device_ms and
    library_device_ms, the means of their two turns (each list in
    *_turns)."""
    turns = in_turns(torch, {"kernel": run_k, "library": library},
                     ("kernel", "library"))
    for key, name in (("device_ms", "kernel"),
                      ("library_device_ms", "library")):
        got = [t for t in turns[name] if t is not None]
        res[key] = statistics.mean(got) if got else None
        res[key + "_turns"] = turns[name]


def fft_in_turns(torch, res, run_k, ortho, unscaled) -> None:
    """library_in_turns of an FFT kernel with torch.fft's call (ortho), and
    library_unscaled_ms, torch.fft's call without a scale (norm="backward"
    forward, norm="forward" inverse: cuFFT's transform and no scaling
    pass), as information."""
    library_in_turns(torch, res, run_k, ortho)
    res["library_unscaled_ms"] = device_ms(torch, unscaled)


def phase_kernels_fir(torch, spec, label, ins, base) -> dict:
    """The FIR kernels of the spec's filter tier: the decimation of the
    padded radio-rate captures and the TX's interpolation of its baseband
    frames; the exact tier also the stride-1 FIR of the decimated captures.
    Each decimation and the stride-1 FIR also get their in-kernel time in
    turns with their conv1d's (library_in_turns). The bf16 tier's bound
    counts its useful products at the bf16 peak."""
    from ofdm_uhd_tpu_torch.kernels import fir, policy
    from ofdm_uhd_tpu_torch.phy import tables
    res = {}
    lr = spec.resample_l
    taps = tables.resample_filter(lr, spec.resample_m)
    nt = len(taps)
    bf16 = policy.filter_precision(spec, "decim", lr) == "bf16"
    peak, dtype = (BF16_OPS, torch.bfloat16) if bf16 else (F32_OPS, None)
    dname, iname = ("fir_bf16", "interp_bf16") if bf16 else ("fir", "interp")
    strided = fir._strided_bf16_cuda if bf16 else fir._strided_cuda
    decim = fir.decim_plain_bf16 if bf16 else fir.decim_plain
    interp = fir._interp_bf16_cuda if bf16 else fir._interp_cuda
    interp_plain = fir.interp_plain_bf16 if bf16 else fir.interp_plain

    def work(x, stride):
        r, n_in = x.shape
        return work_filter(r, n_in, n_in // stride, nt, peak)
    xin = ins["radio"]
    lib = library_fir(torch, xin, taps, lr, dtype)
    res[dname] = held(torch, f"{dname} decim",
                      lambda: strided(xin, taps, lr),
                      lambda: decim(xin, lr, taps), rel_close, xin.shape,
                      work(xin, lr), lib)
    # in-kernel, in turns with conv1d's (cuDNN): no launch gap in either
    library_in_turns(torch, res[dname], lambda: strided(xin, taps, lr), lib)
    del lib
    if not bf16:
        dec = ins["dec"]
        lib = library_fir(torch, dec, taps, 1)
        res["fir_stride1"] = held(torch, "fir", lambda: fir._strided_cuda(
            dec, taps, 1), lambda: fir.decim_plain(dec, 1, taps), rel_close,
            dec.shape, work(dec, 1), lib)
        library_in_turns(torch, res["fir_stride1"],
                         lambda: fir._strided_cuda(dec, taps, 1), lib)
        del lib
    r, nb = base.shape
    branch = fir.branch_matrix(taps, lr)[0].shape[1]
    res[iname] = held(torch, iname, lambda: interp(base, lr, taps),
                      lambda: interp_plain(base, lr, taps), rel_close,
                      base.shape, work_filter(r, nb, nb * lr, branch, peak),
                      library_interp(torch, base, lr, taps, dtype))
    # events around one call read the host's launch overhead where it
    # exceeds the kernel (the interpolation): the in-kernel time
    res[iname]["device_ms"] = device_ms(torch, lambda: interp(base, lr, taps))
    log_kernels(label, res)
    return res


def phase_slice(torch, spec, label, x, x2, pays, max_frames, path,
                sc16, absent=()) -> dict:
    """Decode every frame of x through the entry point (rx_capture_sc16 for
    sc16 planes, rx_capture for fc32), check it, and time it against the
    plain-forced chain; x2 is a second, distinct buffer of the same shape
    for the timed loop; `absent`: kernels the path must never launch."""
    from ofdm_uhd_tpu_torch.kernels import policy
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline

    def entry(rx):
        return rx.rx_capture_sc16 if sc16 else rx.rx_capture

    n_caps, n_frames = pays.shape[0], pays.shape[1]
    run = entry(RxPipeline(spec, diag=True))
    torch.cuda.synchronize()
    policy.reset_launches()
    out = run(x, max_frames=max_frames)
    torch.cuda.synchronize()
    launches = policy.launches()
    for k in path:
        check(launches[k] > 0, f"{label}: the main path never launched the "
              f"{k} kernel")
    for k in absent + OFF_PATH:
        check(launches[k] == 0, f"{label}: the main path launched the {k} "
              f"kernel {launches[k]} times")
    crc = out["crc_ok"][:, :n_frames]
    n_ok = int(crc.sum())
    exact = bool(torch.equal(out["payload"][:, :n_frames], pays))
    n_valid = int(out["valid"].sum())
    check(n_ok == n_caps * n_frames and exact and n_valid == n_ok,
          f"{label} slice: {n_ok}/{n_caps * n_frames} crc_ok, payload exact "
          f"{exact}, {n_valid} valid slots")
    for k in ("evm_db", "eps"):
        check(bool(torch.isfinite(out[k]).all()), f"{label}: {k} not finite")
    check(not bool(out["det_sat"].any()), f"{label}: candidate overflow")
    evm = float(out["evm_db"][:, :n_frames].mean())
    # the reference's bench averages over every slot, empty ones included
    evm_slots = float(out["evm_db"].mean())
    log(f"{label} slice: ok  {n_ok}/{n_caps * n_frames} frames crc_ok and "
        f"bit-exact, mean EVM {evm:.2f} dB over the frames, {evm_slots:.2f} "
        f"dB over all {max_frames} slots, launches {launches}")

    # timing: two distinct buffers, every output kept alive, CUDA events
    # around the dispatches
    fast = entry(RxPipeline(spec, diag=False))
    xs = [x, x2]
    samples = n_caps * x.shape[-1]            # at the radio rate

    def timed(reps):
        for xi in xs[:reps]:                  # warm the buffers it times
            fast(xi, max_frames=max_frames)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        outs = [fast(xs[i % 2], max_frames=max_frames) for i in range(reps)]
        end.record()
        end.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / reps
        dev = start.elapsed_time(end) / reps
        check(all(bool(o["crc_ok"][:, :n_frames].all()) for o in outs),
              f"{label}: a timed dispatch failed its CRC gate")
        return dev, host, outs[0]

    ms, host_ms, _ = timed(REPS)
    busy = device_busy_share(torch, lambda: fast(x, max_frames=max_frames))
    with policy.plain_versions():
        plain_ms, plain_host_ms, plain_out = timed(1)
    valid = out["valid"]
    for k, a, b in (("d", plain_out["d"], out["d"]),
                    ("valid", plain_out["valid"], valid),
                    ("payload", plain_out["payload"][valid],
                     out["payload"][valid])):
        check(bool(torch.equal(a, b)), f"{label}: {k} of the plain-forced "
              "run differs from the kernel run's")
    res = {"ms_per_dispatch": ms, "host_ms_per_dispatch": host_ms,
           "msps": samples / (ms * 1e3),
           "plain_ms_per_dispatch": plain_ms,
           "plain_msps": samples / (plain_ms * 1e3),
           "evm_db_mean": evm, "evm_db_mean_slots": evm_slots,
           "launches": launches,
           "frames_ok": n_ok, "profile": busy}
    log(f"{label} slice: d, valid and payloads equal to the plain-forced "
        "run; kernels "
        f"{ms:.1f} ms/dispatch ({res['msps']:.1f} Msamples/s, host "
        f"{host_ms:.1f} ms), plain versions {plain_ms:.1f} ms/dispatch "
        f"({res['plain_msps']:.1f} Msamples/s), {samples} samples per "
        "dispatch")
    share = busy["busy_share"]
    log(f"{label} slice: device busy share under torch.profiler: " + (
        "not measured (no device events in the trace)" if share is None else
        f"{share:.3f} of {busy['traced_wall_ms']:.1f} ms "
        f"({busy['device_events']} device events)"))
    return res


def run_c3(torch, config, device) -> dict:
    spec = config("c3")
    iq, pays = make_input_c3(torch, spec, device)
    max_frames = C3_FRAMES + 2
    ins, stages = phase_stages(torch, spec, "c3", iq, max_frames)
    kernels = phase_kernels(torch, spec, "c3", ins)
    m = ins["m"]
    tier_inputs = (ins["cap"], ins["ds"])
    del ins
    sl = phase_slice(torch, spec, "c3", iq, iq ^ 1, pays, max_frames,
                     C3_PATH, sc16=True)
    cfar = phase_cfar(torch, spec, "c3", iq, pays, max_frames, m)
    return {"stages_ms": stages, "kernels": kernels, "slice": sl,
            "cfar": cfar, "tier_inputs": tier_inputs}


def run_tool(phase, tool, *args) -> subprocess.CompletedProcess:
    """`python -m ofdm_uhd_tpu_torch.cli.<tool> args` from the checkout's
    root, as a user runs it; the finished process, after a zero exit."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", f"ofdm_uhd_tpu_torch.cli.{tool}", *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    check(res.returncode == 0, f"{phase}: cli.{tool} exited "
          f"{res.returncode}: {res.stderr[-2000:]}")
    log(f"{phase}: cli.{tool} {' '.join(args)}: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s; " + " | ".join(
            line for line in res.stderr.splitlines() if line.strip()))
    return res


STARTUP = """import sys, time
t0 = time.perf_counter()
import torch
from ofdm_uhd_tpu_torch.cli import rx
t1 = time.perf_counter()
if torch.device(sys.argv[1]).type == "cuda":
    from ofdm_uhd_tpu_torch.kernels import build
    build.library()
t2 = time.perf_counter()
torch.zeros(1, device=sys.argv[1]).cpu()
t3 = time.perf_counter()
print(t1 - t0, t2 - t1, t3 - t2)
"""


def tool_startup(dev) -> dict:
    """What a tool's subprocess spends before its work: one process that
    imports cli.rx (torch with it), loads the kernel library (as built by
    phase_build) and makes the device's context, then exits. Its wall time
    from spawn to exit, and the three steps on its own clock."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", STARTUP, dev], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"files: the start-up probe exited "
          f"{res.returncode}: {res.stderr[-2000:]}")
    imports, library, context = map(float, res.stdout.split())
    log(f"files: a tool's start-up on {dev}: {wall:.2f} s from spawn to "
        f"exit; imports (cli.rx, torch) {imports:.2f} s, kernel library "
        f"load {library:.2f} s, device context {context:.2f} s (host clock)")
    return {"wall_s": wall, "imports_s": imports, "library_s": library,
            "context_s": context}


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo's first processor gives it (model
    name, vendor, family, model, clock), and the core count."""
    import platform
    keys = ("model name", "vendor_id", "cpu family", "model", "cpu MHz")
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                k, _, v = line.partition(":")
                if k.strip() in keys:
                    info[k.strip()] = v.strip()
    except OSError:
        pass
    name = info.pop("model name", None) or platform.processor() or \
        platform.machine()
    rest = ", ".join(f"{k} {info[k]}" for k in keys if k in info)
    return f"{name} ({rest}), {os.cpu_count()} cores" if rest else \
        f"{name}, {os.cpu_count()} cores"


def run_files(torch, config, device) -> dict:
    """The file-to-bits tools on the card: (a) one C3 capture of 1024
    frames (bench_lib.build_capture: gap 300, SNR 28 dB, CFO 0.8, seed 0),
    scaled to full scale and written by io.write_capture as an sc16 .iq
    file with its sidecar, decoded by `cli.rx` in a subprocess and once in
    this process under the launch counters (the path's RX kernels, no
    other: K4w decodes, as the reference's policy picks at 1032 slots);
    (b) the native deframer built and used by read_capture, equal
    to NumPy's conversion of that file, and the path's kernels held
    against their plain versions on the samples it read (the row cli.rx
    decodes); (c) the golden chain (GoldenModem.rx_capture) on bench.py's
    slice of it, the first 5 * frame_len samples as complex128: as many
    frames as the card's valid slots that lie wholly inside the slice,
    with their starts and payloads, and eps within GOLDEN_EPS_TOL, timed
    on the host CPU; (d) the pinned fixtures through
    RxPipeline.rx_capture on the card; (e) C4 through `cli.tx` and
    `cli.rx` (.npy); (f) C2's `cli.loopback --sync` with multipath; then
    a tool's start-up alone (tool_startup)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    from ofdm_uhd_tpu_torch.bench_lib import build_capture
    from ofdm_uhd_tpu_torch.cli import rx as cli_rx
    from ofdm_uhd_tpu_torch.golden import GoldenModem
    from ofdm_uhd_tpu_torch.io import native, read_capture, write_capture
    from ofdm_uhd_tpu_torch.cli.config import load_spec
    from ofdm_uhd_tpu_torch.kernels import policy, viterbi
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline

    t_phase = time.perf_counter()
    spec, tool_spec = config("c3"), load_spec("c3")
    dev = str(device)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) C3 from an sc16 file
        cap, pays = build_capture(spec, FILES_FRAMES, GAP, seed=0,
                                  device=device)
        # full scale without clipping: the AGC takes the level out
        scale = 1.0 / float(np.abs(np.stack([cap.real, cap.imag])).max())
        path = os.path.join(tmp, "c3.iq")
        bits = os.path.join(tmp, "c3_bits.npy")
        write_capture(path, cap * scale, fmt="sc16",
                      meta={"config": "c3", "frames": FILES_FRAMES,
                            "gap": GAP})
        np.save(bits, pays)
        rx_args = ["--config", "c3", "--capture", path, "--expect-bits",
                   bits, "--max-frames", str(FILES_FRAMES + 8),
                   "--device", dev]
        err = run_tool("files", "rx", *rx_args).stderr
        check("(bit-exact)" in err and f"{FILES_FRAMES} crc-ok" in err,
              f"files: cli.rx at c3 was not bit-exact: {err[-500:]}")
        torch.cuda.synchronize()
        policy.reset_launches()
        said = io.StringIO()
        with contextlib.redirect_stderr(said):
            cli_rx.main(rx_args)
        torch.cuda.synchronize()
        launches = policy.launches()
        for k in FILES_PATH:
            check(launches[k] > 0, f"files: cli.rx never launched the {k} "
                  "kernel")
        for k in OFF_PATH:
            check(launches[k] == 0, f"files: cli.rx launched the {k} "
                  f"kernel {launches[k]} times")
        check("(bit-exact)" in said.getvalue(), "files: cli.rx in process "
              f"was not bit-exact: {said.getvalue()}")
        log(f"files: c3 sc16 file {os.path.getsize(path)} bytes, "
            f"{len(cap)} samples; cli.rx in process: "
            f"{said.getvalue().strip()}; launches {launches}")
        res["launches"] = launches

        # (b) the native deframer
        check(native.available(), "files: the native deframer did not "
              "build; read_capture fell back to NumPy")
        t0 = time.perf_counter()
        samples, meta = read_capture(path)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        raw = np.fromfile(path, dtype=np.int16).astype(np.float32)
        ref = ((raw[0::2] + 1j * raw[1::2]) / 32767.0).astype(np.complex64)
        numpy_s = time.perf_counter() - t0
        check(np.array_equal(samples.view(np.float32), ref.view(np.float32)),
              "files: the native deframer differs from NumPy's conversion")
        res["native"] = {"library": str(native.library_path()),
                         "read_s": native_s, "numpy_s": numpy_s}
        log(f"files: native deframer {native.library_path()} used, equal "
            f"to NumPy's conversion bit for bit; read_capture {native_s:.3f}"
            f" s, NumPy's conversion {numpy_s:.3f} s (host clock)")

        # the path's kernels held against their plain versions on the
        # file's samples, one fc32 row, under the spec cli.rx loads
        # (configs/c3.json: kernel_backend 'auto', where config("c3") has
        # 'xla'); K4w at the windows the algorithm chosen at its slots
        # decodes with ('windowed' 512/96 at 1032, 'fused' 256/64 at <= 96)
        ins, res["stages_ms"] = phase_stages(
            torch, tool_spec, "files",
            torch.from_numpy(samples)[None].to(device), FILES_FRAMES + 8)
        res["kernels"] = phase_kernels(torch, tool_spec, "files", ins,
                                       names=FILES_PATH[:-1])
        algorithm = policy.viterbi_impl(0, ins["llr"].shape[0],
                                        tool_spec.kernel_backend,
                                        tool_spec.viterbi_mode)
        check(algorithm in ("windowed", "fused"), f"files: cli.rx's spec "
              f"decodes its slots by {algorithm}, not K4w")
        geometry = (viterbi.XLA_WINDOW if algorithm == "windowed"
                    else viterbi.FUSED_WINDOW)
        vit = {f"{k}_{geometry[0]}": v for k, v in hold_windowed(
            torch, ins["llr"], geometry, "files").items()}
        log_kernels("files", vit)
        res["kernels"].update(vit)
        del ins

        # (c) the golden yardstick on bench.py's slice
        n = min(len(samples), 5 * spec.frame_len)
        gm = GoldenModem(spec)
        t0 = time.perf_counter()
        gold = gm.rx_capture(samples[:n].astype(np.complex128))
        gold_s = time.perf_counter() - t0
        out = RxPipeline(tool_spec).rx_capture(
            torch.from_numpy(samples).to(device),
            max_frames=FILES_FRAMES + 8)
        valid = out["valid"].cpu().numpy()
        d_card = out["d"].cpu().numpy()[valid]
        pay_card = out["payload"].cpu().numpy()[valid]
        eps_card = out["eps"].cpu().numpy()[valid]
        inside = int((d_card + spec.frame_len <= n).sum())
        check(inside > 0 and len(gold) == inside,
              f"files: golden found {len(gold)} frames in the slice, the "
              f"card {inside} wholly inside it")
        for i, (d, eps, r) in enumerate(gold):
            check(r.crc_ok and d == d_card[i]
                  and abs(eps - eps_card[i]) <= GOLDEN_EPS_TOL
                  and np.array_equal(r.payload, pay_card[i])
                  and np.array_equal(r.payload, pays[i]),
                  f"files: golden frame {i} (start {d}, eps {eps}, crc "
                  f"{r.crc_ok}) differs from the card's slot (start "
                  f"{d_card[i]}, eps {eps_card[i]})")
        cpu = host_cpu()
        res["golden"] = {"samples": n, "frames": len(gold), "s": gold_s,
                         "msps": n / gold_s / 1e6, "host_cpu": cpu}
        log(f"files: GoldenModem.rx_capture on bench.py's slice ({n} "
            f"samples, {len(gold)} frames): starts and payloads equal to the "
            f"first slots on {dev}; {gold_s:.3f} s, {n / gold_s / 1e6:.4f} "
            f"Msamples/s on the host CPU ({cpu})")

        # (d) the pinned fixtures
        for name in FIXTURES:
            z = np.load(os.path.join(ROOT, "tests", "fixtures",
                                     f"golden_{name}.npz"))
            k = len(z["payloads"])
            out = RxPipeline(config(name)).rx_capture(
                torch.from_numpy(z["capture"]).to(device), max_frames=6)
            valid = out["valid"].cpu().numpy()
            check(int(valid.sum()) == k and valid[:k].all()
                  and bool(out["crc_ok"][:k].all())
                  and np.array_equal(out["payload"][:k].cpu().numpy(),
                                     z["payloads"])
                  and np.array_equal(out["d"][:k].cpu().numpy(), z["starts"]),
                  f"files: fixture golden_{name} did not decode to its "
                  "pinned payloads and starts")
        log(f"files: fixtures {', '.join(FIXTURES)} decoded on {dev} to "
            "their pinned payloads and starts")

        # (e) C4 through the files
        c4 = os.path.join(tmp, "c4.npy")
        c4_bits = os.path.join(tmp, "c4_bits.npy")
        run_tool("files", "tx", "--config", "c4", "--frames",
                 str(FILES_C4_FRAMES), "--gap", str(GAP), "--out", c4,
                 "--bits-out", c4_bits, "--device", dev)
        err = run_tool("files", "rx", "--config", "c4", "--capture", c4,
                       "--expect-bits", c4_bits, "--max-frames",
                       str(FILES_C4_FRAMES + 8), "--device", dev).stderr
        check("(bit-exact)" in err, f"files: c4 tx -> rx: {err[-500:]}")

        # (f) C2 loopback
        err = run_tool("files", "loopback", "--config", "c2", "--frames",
                       str(FILES_C2_FRAMES), "--snr", "25", "--multipath",
                       "1,0.3-0.2j", "--sync", "--device", dev).stderr
        check("post-FEC BIT-EXACT" in err, f"files: c2 loopback: {err}")
    res["startup"] = tool_startup(dev)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase files: ok  in {res['phase_s']:.1f} s")
    return res


# the device symbols by which a trace names each kernel of the bench's
# traced run (torch.profiler's Chrome trace, demangled): any one of them;
# K4 by its two bodies' names, which K4w's bodies do not contain
TRACE_SYMBOLS = {"scfront": ("scfront_kernel",), "localize": ("localize",),
                 "extract": ("extract_kernel",), "fft": ("fft_cp_kernel",),
                 "viterbi": ("viterbi_k7_group_kernel",
                             "viterbi_k7_butterfly_kernel"),
                 "viterbi_windowed": ("viterbi_k7_window_kernel",)}
# the trace's device events: kernels, copies and sets
TRACE_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def bench_runs() -> list:
    """The bench phase's runs: (label, cli.bench arguments, the kernels the
    run launches, the frames its record must count). The first runs as a
    subprocess, the rest in this process."""
    f, (caps, f3) = str(BENCH_FRAMES), BENCH_C3
    c5 = ("--config", "c5", "--mode", "stream", "--frames", str(C5_FRAMES))
    c1 = ("--config", "c1", "--mode", "capture", "--input", "sc16",
          "--frames", f)
    return [
        ("c1 capture sc16 auto", [*c1], C3_PATH, BENCH_FRAMES),
        ("c1 capture sc16 xla", [*c1, "--backend", "xla"], C3_PATH,
         BENCH_FRAMES),
        ("c1 aligned", ["--config", "c1", "--mode", "aligned", "--frames",
                        f], ("fft", "viterbi"), BENCH_FRAMES),
        ("c2 capture", ["--config", "c2", "--mode", "capture", "--frames",
                        f], C3_PATH, BENCH_FRAMES),
        ("c3 capture sc16", ["--config", "c3", "--mode", "capture",
                             "--input", "sc16", "--caps", str(caps),
                             "--frames", str(f3)], C3_PATH, caps * f3),
        ("c5 stream sc16", [*c5, "--input", "sc16", "--chunk",
                            str(C5_HOSTFED[0]), "--ksteps",
                            str(C5_HOSTFED[1])], C5_PATH,
         C5_FRAMES * BENCH_ITERS),
        ("c5 stream resident fc32", [*c5, "--chunk", str(C5_RESIDENT[0]),
                                     "--ksteps", str(C5_RESIDENT[1]),
                                     "--resident"], C5_PATH,
         C5_FRAMES * BENCH_ITERS),
    ]


def bench_record(label, stdout, frames) -> dict:
    """The record a bench run printed on its last line, which must count
    `frames` frames, with its time a dispatch (capture and aligned: one
    call; stream: one K-step dispatch) from its frames_ok / frames_per_s
    and, for the stream, its Msamples/s and chunk_len x ksteps (C5's radio
    chunk is its baseband chunk)."""
    lines = stdout.strip().splitlines()
    check(bool(lines), f"bench {label}: no record printed")
    rec = json.loads(lines[-1])
    check(rec["frames_ok"] == frames and rec.get("frames", frames) == frames,
          f"bench {label}: {rec['frames_ok']} frames ok of "
          f"{rec.get('frames', frames)}, sent {frames}")
    s = rec["frames_ok"] / rec["frames_per_s"]
    if rec["mode"].startswith("stream"):
        n = rec["msamples_per_s"] * 1e6 * s / (rec["chunk_len"]
                                                * rec["ksteps"])
        s /= n
    return {"record": rec, "ms_per_dispatch": s * 1e3}


def counted_run(torch, label, main, argv, path) -> tuple[str, dict, float]:
    """A tool's main(argv) in this process under the launch counters,
    its standard output kept: every kernel of `path` launched, no other.
    Returns (its output, the launches, the run's wall seconds)."""
    import contextlib
    import io
    from ofdm_uhd_tpu_torch.kernels import policy
    torch.cuda.synchronize()
    policy.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = policy.launches()
    for k, n in launches.items():
        check((n > 0) == (k in path), f"{label}: the run launched the "
              f"{k} kernel {n} times")
    return out.getvalue(), launches, wall


def bench_in_process(torch, label, argv, path, frames) -> dict:
    """One cli.bench run through its main(argv) under the launch counters:
    every kernel of `path` launched, no other; its record read back."""
    from ofdm_uhd_tpu_torch.cli import bench
    out, launches, wall = counted_run(torch, f"bench {label}", bench.main,
                                      argv, path)
    res = {**bench_record(label, out, frames),
           "launches": launches, "run_s": wall}
    log(f"bench {label}: {json.dumps(res['record'])}; "
        f"{res['ms_per_dispatch']:.3f} ms a dispatch; launches "
        f"{nonzero(launches)}; the run {wall:.1f} s with its input build")
    return res


def read_trace(trace_dir) -> tuple[list, float]:
    """The Chrome trace torch.profiler wrote into trace_dir: its device
    events [(category, name, start us, end us)] and the span of all its
    timed events (us)."""
    import glob
    files = glob.glob(os.path.join(trace_dir, "*.json"))
    check(len(files) == 1, f"bench: {len(files)} trace files in the trace "
          "directory")
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    check(bool(events), "bench: the trace holds no timed event")
    dev = [(e.get("cat", ""), e.get("name", ""), float(e["ts"]),
            float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat", "") in TRACE_DEVICE]
    span = (max(float(e["ts"]) + float(e["dur"]) for e in events)
            - min(float(e["ts"]) for e in events))
    return dev, span


def check_trace(label, trace_dir, path) -> dict:
    """Every kernel of `path` named among the trace's device kernels, and
    the card's busy share over the trace's span (the union of its device
    events)."""
    dev, span = read_trace(trace_dir)
    names = [n for c, n, _, _ in dev if c == "kernel"]
    counts = {k: sum(any(s in n for s in TRACE_SYMBOLS[k]) for n in names)
              for k in path}
    for k, n in counts.items():
        check(n > 0, f"bench {label}: the trace names no {k} kernel "
              f"({' or '.join(TRACE_SYMBOLS[k])}) among its {len(names)} "
              "device kernels")
    busy = covered([(a, b) for _, _, a, b in dev])
    res = {"kernel_events": counts, "device_events": len(dev),
           "span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
           "busy_share": busy / span if span else None}
    log(f"bench {label}: the trace names every kernel of the path among "
        f"its device events {counts} ({len(dev)} device events); busy "
        f"share {res['busy_share']:.3f} of {res['span_ms']:.1f} ms")
    return res


def run_bench(torch, device) -> dict:
    """The bench tool at the reference's r5 operating points (bench_runs):
    the first run as a `python -m` subprocess, the rest in this process,
    each record counting every frame; C1's capture once more under
    --trace-dir, its trace checked for the card's kernels; then the path's
    kernels held against their plain versions at C1's and C2's capture
    shapes, as the tool builds them (bench_lib.build_capture: seed 0, gap
    300, SNR 28 dB, CFO 0.8, timing offset 100, no phase noise), and the
    aligned run's kernels (fft, viterbi) on its own input
    (cli.bench.aligned_input: C1's TX frames back to back, no CFO)."""
    import tempfile

    import numpy as np
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    from ofdm_uhd_tpu_torch.cli.config import load_spec
    t_phase = time.perf_counter()
    dev, it = str(device), ["--iters", str(BENCH_ITERS)]
    runs = bench_runs()
    label, argv, _, frames = runs[0]
    proc = run_tool("bench", "bench", *argv, *it, "--device", dev)
    first = bench_record(label, proc.stdout, frames)
    log(f"bench {label} (python -m): {json.dumps(first['record'])}; "
        f"{first['ms_per_dispatch']:.3f} ms a dispatch")
    res = {"subprocess": {label: first}, "runs": {
        label: bench_in_process(torch, label, [*argv, *it, "--device", dev],
                                path, frames)
        for label, argv, path, frames in runs[1:]}}
    label, argv, path, frames = runs[0]
    with tempfile.TemporaryDirectory() as tmp:
        r = bench_in_process(torch, f"{label}, traced",
                             [*argv, "--iters", "2", "--device", dev,
                              "--trace-dir", tmp], path, frames)
        r["trace"] = check_trace(f"{label}, traced", tmp, path)
    res["traced"] = r
    counted = [*res["runs"].values(), r]
    res["launches"] = {k: sum(c["launches"][k] for c in counted)
                       for k in r["launches"]}

    res["kernels"] = {}
    for name, sc16 in (("c1", True), ("c2", False)):
        spec = load_spec(name)
        cap, _ = build_capture(spec, BENCH_FRAMES, GAP, seed=0, snr_db=28.0,
                               cfo=0.8, phase_noise_std=0.0,
                               timing_offset=100, device=device)
        x = torch.from_numpy(to_sc16(cap[None]) if sc16
                             else cap[None].astype(np.complex64)).to(device)
        ins, _ = phase_stages(torch, spec, f"bench {name}", x,
                              BENCH_FRAMES + 2)
        held_here = phase_kernels(torch, spec, f"bench {name}", ins)
        res["kernels"].update({f"{k}_{name}": v for k, v in held_here.items()})
        del ins, x
    spec = load_spec("c1")
    held_here = phase_kernels(torch, spec, "bench c1 aligned",
                              aligned_ins(torch, spec, device),
                              ("fft", "viterbi"))
    res["kernels"].update({f"{k}_c1_aligned": v
                           for k, v in held_here.items()})
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase bench: ok  in {res['phase_s']:.1f} s")
    return res


def harness_runs() -> dict:
    """The harness phase's in-process runs on the card: {label: (the
    harness's arguments, the kernels the run launches)}, the harness
    named by the label's first word; stages under 'pallas' at C2 (the
    boxcar correlator K9, the CP-fused FFT K5 both ways), the detect and
    evm runs and the sweeps' two channels also run on the CPU."""
    return {
        "stages pallas": (("--config", "c2", "--backend", "pallas",
                           "--frames", "128", "--batch", "4", "--iters",
                           "2"),
                          ("sccorr", "localize", "extract", "cpfft",
                           "ifftcp", "viterbi", "viterbi_windowed")),
        "sweeps": (("--config", "c2", "--snrs", HARNESS_SNRS, "--frames",
                    str(HARNESS_SWEEP_FRAMES)), ("fft", "viterbi")),
        "sweeps multipath": (("--config", "c2", "--snrs", HARNESS_SNRS,
                              "--frames", str(HARNESS_SWEEP_FRAMES),
                              "--multipath", "c2"), ("fft", "viterbi")),
        "detect_sweep": (("--config", "c3", "--snrs", HARNESS_DETECT_SNRS,
                          "--trials", str(HARNESS_TRIALS)),
                         ("scfront", "localize", "extract", "fft",
                          "viterbi_windowed")),
        "evm_budget": (("--config", "c2", "--frames",
                        str(HARNESS_EVM_FRAMES)), C3_PATH),
        "pod": (("--config", "c5", "--frames", str(HARNESS_POD_FRAMES),
                 "--iters", "2"), C5_PATH),
        "pp_ab": (("--batch", str(HARNESS_PP_BATCH), "--iters", "2"),
                  ("fft", "viterbi")),
    }


def harness_tool(name, *args) -> subprocess.Popen:
    """`python -m ofdm_uhd_tpu_torch.harness.<name> args` from the
    checkout's root, started."""
    return subprocess.Popen(
        [sys.executable, "-m", f"ofdm_uhd_tpu_torch.harness.{name}", *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def harness_in_process(torch, label, name, argv, path) -> dict:
    """One harness run through its main(argv) on the card under the launch
    counters (counted_run); its --jsonl records read back."""
    import importlib
    import tempfile

    from ofdm_uhd_tpu_torch.harness import read_jsonl
    mod = importlib.import_module(f"ofdm_uhd_tpu_torch.harness.{name}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.jsonl")
        _, launches, wall = counted_run(torch, f"harness {label}", mod.main,
                                        [*argv, "--jsonl", out], path)
        recs = read_jsonl(out)
    log(f"harness {label} (card): {len(recs)} records in {wall:.1f} s; "
        f"launches {nonzero(launches)}")
    return {"records": recs, "launches": launches, "run_s": wall}


def same_records(label, card, cpu) -> dict:
    """The card's records against the CPU's, key by key: counts, rates
    and FER exactly; pre-FEC errors within PRE_FEC_TOL_BITS; EVM within
    EVM_TOL_DB; the analytic columns to 1e-12. Returns the largest
    differences."""
    check(len(card) == len(cpu), f"harness {label}: {len(card)} card records"
          f" against {len(cpu)} on the CPU")
    from ofdm_uhd_tpu_torch.cli.config import load_spec
    worst = {"pre_fec_bits": 0, "evm_db": 0.0}
    for a, b in zip(card, cpu):
        for k in a:
            if k == "ts":
                continue
            if k == "evm_db":
                ea = a[k] if isinstance(a[k], dict) else {"": a[k]}
                eb = b[k] if isinstance(b[k], dict) else {"": b[k]}
                check(ea.keys() == eb.keys(), f"harness {label}: rows")
                d = max(abs(ea[r] - eb[r]) for r in ea)
                worst["evm_db"] = max(worst["evm_db"], d)
                check(d <= EVM_TOL_DB, f"harness {label}: EVM {ea} on the "
                      f"card against {eb} on the CPU")
            elif k == "pre_fec_ber":
                bits = a["frames"] * load_spec(
                    a["config"]).coded_bits_per_frame
                d = round(abs(a[k] - b[k]) * bits)
                worst["pre_fec_bits"] = max(worst["pre_fec_bits"], d)
                check(d <= PRE_FEC_TOL_BITS, f"harness {label}: {d} pre-FEC "
                      f"bit decisions differ at {a['snr_db']} dB")
            elif k in ("theory_ber", "chain_expected_ber"):
                check(abs(a[k] - b[k]) <= 1e-12 * abs(b[k]),
                      f"harness {label}: {k} {a[k]} against {b[k]}")
            else:
                check(a[k] == b[k], f"harness {label}: {k} {a[k]} on the "
                      f"card, {b[k]} on the CPU ({a})")
    return worst


def run_harness(torch, device) -> dict:
    """The bench/ harnesses as tools of the port (ofdm_uhd_tpu_torch/
    harness/): the CPU runs of sweeps (flat and multipath), detect_sweep
    and evm_budget started first as `python -m` subprocesses (--device
    cpu); stages as a `python -m` subprocess on the card at C3's headline
    shape, its record's keys and frame counts checked, and roofline
    --stages-jsonl on that record; then every harness in this process on
    the card under the launch counters (pod over the cards present, up to
    two; pp_ab's entries sharing one card where there is one), each
    counting every frame; the card's sweep, detect and EVM records equal
    to the CPU's (same_records)."""
    import tempfile

    from ofdm_uhd_tpu_torch.harness import read_jsonl
    t_phase = time.perf_counter()
    runs = harness_runs()
    dev = str(device)
    res = {"kernels": {}, "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        cpu = {label: (harness_tool(label.split()[0], *argv, "--device",
                                    "cpu", "--jsonl",
                                    os.path.join(tmp, f"{i}.jsonl")),
                       os.path.join(tmp, f"{i}.jsonl"))
               for i, (label, (argv, _)) in enumerate(runs.items())
               if label.split()[0] in ("sweeps", "detect_sweep",
                                        "evm_budget")}
        try:
            stages_out = os.path.join(tmp, "stages.jsonl")
            t0 = time.perf_counter()
            proc = harness_tool(
                "stages", "--config", HARNESS_STAGES_CONFIG, "--backend",
                "auto", "--frames", str(C3_FRAMES), "--batch", str(N_CAPS),
                "--iters", str(REPS), "--device", dev, "--jsonl", stages_out)
            _, err = proc.communicate(timeout=900)
            check(proc.returncode == 0, f"harness stages exited "
                  f"{proc.returncode}: {err[-2000:]}")
            (rec,) = read_jsonl(stages_out)
            log(f"harness stages (python -m, {time.perf_counter() - t0:.1f}"
                f" s): {json.dumps(rec)}")
            check(set(rec) == STAGES_KEYS, f"harness stages: the record's "
                  f"keys {sorted(rec)}")
            rows = {"corr", "detect", "det+ext", "frontend", "decode",
                    "vit-win", "full"}
            rows |= {f"{k}-x{N_CAPS}" for k in ("full", "corr", "detect",
                                                "det+ext")}
            check(set(rec["stages_ms"]) == rows, "harness stages: its "
                  f"stages {sorted(rec['stages_ms'])}")
            check(rec["frames_ok"] == {"full": C3_FRAMES, f"full-x{N_CAPS}":
                                       N_CAPS * C3_FRAMES},
                  f"harness stages: full decoded {rec['frames_ok']}")
            check(rec["device"] == torch.cuda.get_device_name(device),
                  f"harness stages: device {rec['device']}")
            res["stages"] = rec
            proc = harness_tool("roofline", "--config", HARNESS_STAGES_CONFIG,
                                "--stages-jsonl", stages_out, "--device", dev)
            out, err = proc.communicate(timeout=300)
            check(proc.returncode == 0 and "cross-check" in out,
                  f"harness roofline exited {proc.returncode}: {err[-2000:]}")
            log("harness roofline: " + " | ".join(
                line.strip() for line in out.splitlines() if line.strip()))
            res["roofline"] = out
            n_cards = min(torch.cuda.device_count(), 2)
            for label, (argv, path) in runs.items():
                name = label.split()[0]
                if name == "pod":
                    argv = (*argv, "--devices",
                            ",".join(str(d) for d in range(1, n_cards + 1)))
                res["runs"][label] = harness_in_process(
                    torch, label, name, [*argv, "--device", dev], path)
            for label, (proc, path) in cpu.items():
                _, err = proc.communicate(timeout=900)
                check(proc.returncode == 0, f"harness {label} (cpu) exited "
                      f"{proc.returncode}: {err[-2000:]}")
                card_recs = res["runs"][label]["records"]
                res["runs"][label]["cpu_records"] = read_jsonl(path)
                res["runs"][label]["worst"] = same_records(
                    label, card_recs, res["runs"][label]["cpu_records"])
                log(f"harness {label}: the card's records equal the CPU's "
                    f"(largest differences {res['runs'][label]['worst']}): "
                    + json.dumps([{k: v for k, v in r.items() if k != "ts"}
                                  for r in card_recs]))
        finally:
            for proc, _ in cpu.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    for r in res["runs"]["pod"]["records"]:
        check(r["frames_ok"] == r["frames"], f"harness pod: {r}")
    for r in res["runs"]["pp_ab"]["records"]:
        check(r["bit_exact"], f"harness pp_ab: {r}")
    log("harness pod: " + json.dumps(res["runs"]["pod"]["records"]))
    log("harness pp_ab: " + json.dumps(res["runs"]["pp_ab"]["records"]))
    res["launches"] = {k: sum(r["launches"][k] for r in res["runs"].values())
                       for k in next(iter(res["runs"].values()))["launches"]}
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase harness: ok  in {res['phase_s']:.1f} s")
    return res


def aligned_ins(torch, spec, device) -> dict:
    """The inputs RxPipeline.rx_aligned gives its kernels on the bench
    tool's aligned input (seed 0, BENCH_FRAMES frames): the steps of
    pipeline/rx.py:_demod_frames up to the decode, in the keys
    phase_stages gives them (`cap`: the baseband frames)."""
    import numpy as np
    from ofdm_uhd_tpu_torch.cli.bench import aligned_input
    from ofdm_uhd_tpu_torch.pipeline import TxPipeline, rx
    pays = np.random.default_rng(0).integers(
        0, 2, (BENCH_FRAMES, spec.payload_bits_per_frame)).astype(np.uint8)
    fr = TxPipeline(spec)(torch.from_numpy(pays).to(device)).cpu().numpy()
    return demod_ins(torch, spec, rx._to_baseband(spec, torch.from_numpy(
        aligned_input(spec, fr).astype(np.complex64)).to(device)))


def demod_ins(torch, spec, x) -> dict:
    """The inputs pipeline/rx.py:_demod_frames gives its kernels on
    baseband frames x [B, frame_len], up to the decode, in the keys
    phase_stages gives them (`cap`: the frames)."""
    from ofdm_uhd_tpu_torch.phy import bits, frame
    from ofdm_uhd_tpu_torch.pipeline import rx
    shift = min(4, spec.cp // 4)
    grid = frame.ofdm_demodulate(spec, x, shift)
    h = frame.estimate_channel(spec, grid)
    data = frame.track_phase(spec, frame.equalize(spec, grid, h))[0]
    llr = bits.deinterleave_soft(rx._demap(spec, data, h)[0],
                                 spec.coded_bits_per_sym)
    llr = bits.depuncture_llr(llr, spec.fec_rate,
                              2 * spec.uncoded_bits_per_frame)
    return {"cap": x, "syms": x.reshape(x.shape[0], spec.n_syms,
                                        spec.sym_len),
            "start": spec.cp - shift, "grid": grid,
            "llr": llr.contiguous()}


def phase_cfar(torch, spec, label, iq, pays, max_frames, m) -> dict:
    """The CFAR threshold mode on the path's captures, run once through
    `RxPipeline(spec, sync_threshold_mode="cfar").rx_capture_sc16`: it
    must give the plain-forced CFAR run's d, valid and payloads (the plain
    versions, which the CPU tests hold to the reference's CFAR detection).
    Reported beside it: the slots whose d differs from the fixed run's and
    the sent frames each mode decodes (the reference's CFAR anchors a C3
    frame early here and again; tests/test_torch_cfar.py), each capture's
    threshold on the metric m [C, nd] the stages gave, and that
    threshold's time (one sort of every row; CUDA events)."""
    from ofdm_uhd_tpu_torch.kernels import policy
    from ofdm_uhd_tpu_torch.phy import sync
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline

    def run(mode):
        return RxPipeline(spec, diag=False, sync_threshold_mode=mode
                          ).rx_capture_sc16(iq, max_frames=max_frames)
    out = {mode: run(mode) for mode in ("fixed", "cfar")}
    with policy.plain_versions():
        plain = run("cfar")
    for k in ("d", "valid", "payload"):
        check(bool(torch.equal(out["cfar"][k], plain[k])),
              f"{label} cfar: {k} differs from the plain-forced run's")
    n = pays.shape[1]
    sent = {mode: int((o["crc_ok"][:, :n] & (o["payload"][:, :n] == pays)
                       .all(-1)).sum()) for mode, o in out.items()}
    moved = int((out["cfar"]["d"] != out["fixed"]["d"]).sum())
    thr = sync.cfar_threshold(m, 0.5, 16.0)[:, 0].tolist()
    ms = cuda_ms(torch, lambda: sync.cfar_threshold(m, 0.5, 16.0))
    log(f"{label} cfar: ok  d, valid and payloads equal to the plain-forced "
        f"CFAR run's; sent frames decoded: cfar {sent['cfar']}, fixed "
        f"{sent['fixed']} of {pays.shape[0] * n}; {moved} slots with "
        f"another d than the fixed run's; thresholds "
        f"{[f'{t:.4g}' for t in thr]}; threshold of {list(m.shape)} in "
        f"{ms:.3f} ms")
    return {"frames_ok": sent, "slots_moved": moved, "thresholds": thr,
            "threshold_ms": ms, "metric_shape": list(m.shape)}


def run_c4(torch, config, device, label="c4", spec=None, path=C4_PATH,
           absent=("fir_bf16", "interp_bf16")) -> dict:
    """C4's row (8 captures x 32 frames, fc32) under `spec` (default
    config("c4")): its TX builds the captures, and rx_capture decodes them
    through `path`'s kernels, launching none of `absent`."""
    spec = spec or config("c4")
    caps, pays, base, tx_launches = make_input_c4(torch, spec, device, label)
    max_frames = C4_FRAMES + 2
    ins, stages = phase_stages(torch, spec, label, caps, max_frames)
    kernels = {**phase_kernels(torch, spec, label, ins, path[1:]),
               **phase_kernels_fir(torch, spec, label, ins, base)}
    radio = ins["radio"]
    del ins
    x2 = caps * torch.tensor(1 + 1e-6, dtype=torch.float32, device=device)
    sl = phase_slice(torch, spec, label, caps, x2, pays, max_frames, path,
                     sc16=False, absent=absent)
    return {"stages_ms": stages, "kernels": kernels, "slice": sl,
            "tx_launches": tx_launches, "fir_inputs": (radio, base)}


def run_c4_bf16(torch, config, device, c4) -> dict:
    """C4 under the reference's gate setting for its bf16 filter tier
    (tests/kernels/test_mxu_fir.py:80-99: filter_precision='bf16',
    kernel_backend='pallas'), on the same traffic; its mean EVM beside the
    exact C4 run's (`c4`)."""
    spec = config("c4").with_(filter_precision="bf16",
                              kernel_backend="pallas")
    res = run_c4(torch, config, device, "c4_bf16", spec, C4_BF16_PATH,
                 absent=("fir", "interp"))
    del res["fir_inputs"]
    evm, evm_exact = (r["slice"]["evm_db_mean"] for r in (res, c4))
    log(f"c4_bf16 slice: mean EVM {evm:.2f} dB over the frames, exact C4 "
        f"{evm_exact:.2f} dB")
    return res


def run_pallas(torch, config, device, name, label, n_caps, n_frames, path,
               **channel) -> dict:
    """A kernel_backend='pallas' path: the spec's TX builds the captures
    (K5 TX), and rx_capture_sc16 decodes them through `path`'s kernels.
    Where the path runs K4w, its LLRs stay in the result ("llr") for the
    warp body's counted run (run_k4w_ab)."""
    spec = config(name).with_(kernel_backend="pallas")
    iq, pays, tx_launches, grid = make_input_pallas(
        torch, spec, label, n_caps, n_frames, device, **channel)
    max_frames = n_frames + 2
    ins, stages = phase_stages(torch, spec, label, iq, max_frames)
    kernels = {**phase_kernels(torch, spec, label, ins, path),
               **phase_kernel_ifftcp(torch, spec, label, grid)}
    llr = ins["llr"] if "viterbi_windowed" in path else None
    del ins, grid
    sl = phase_slice(torch, spec, label, iq, iq ^ 1, pays, max_frames, path,
                     sc16=True)
    out = {"stages_ms": stages, "kernels": kernels, "slice": sl,
           "tx_launches": tx_launches}
    if llr is not None:
        out["llr"] = llr
    return out


def run_k4w_ab(torch, llr) -> dict:
    """One counted run of K4w's warp body, the A/B baseline no path runs
    (held and timed in turns beside K4w wherever K4w is held), on
    c3_pallas's LLRs at 256/64: it alone launches."""
    from ofdm_uhd_tpu_torch.kernels import policy, viterbi
    torch.cuda.synchronize()
    policy.reset_launches()
    viterbi._viterbi_windowed_warp_cuda(llr, *viterbi.FUSED_WINDOW)
    torch.cuda.synchronize()
    launches = policy.launches()
    check(launches["viterbi_windowed_warp"] == 1
          and sum(launches.values()) == 1,
          f"k4w_ab: the counted run launched {launches}")
    log(f"k4w_ab: ok  one counted launch of the warp body on "
        f"{list(llr.shape)}")
    return {"kernels": {}, "launches": launches}


def variant_llrs(torch, device, rows, ties, steps, seed) -> tuple:
    """([rows + ties, 2 steps] float32 LLRs on the card, the sent bits of
    the first `rows`): `rows` decodable as scripts/r5_probe_vit.py makes
    them (seeded bits through conv_encode, +-1 plus 0.45 Gaussian noise),
    each row's last 6 bits zero, as a frame's tail, so that the trellis
    ends in state 0 where the decoders trace back from; then `ties` rows
    of integers in {-2, ..., 2}, whose path metrics tie often (a tie keeps
    predecessor 0)."""
    import numpy as np
    from ofdm_uhd_tpu_torch.phy.bits import conv_encode
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (rows, steps)).astype(np.uint8)
    bits[:, -6:] = 0
    clean = (1.0 - 2.0 * conv_encode(torch.from_numpy(bits)).numpy()
             ).astype(np.float32)
    noisy = clean + 0.45 * rng.normal(size=clean.shape).astype(np.float32)
    tied = rng.integers(-2, 3, (ties, 2 * steps)).astype(np.float32)
    llr = torch.from_numpy(np.concatenate([noisy, tied])).to(device)
    return llr, bits


def run_variants(torch, device) -> dict:
    """The reference's three restructured whole-sequence decoders
    (research/viterbi_variants.py: state-major, radix-4, both; in the port
    viterbi_plain's bits, which no path routes) against K4 at every group
    size: at C3's trellis length (VARIANT_STEPS), a batch of VARIANT_ROWS
    decodable and tied rows, and an odd batch (VARIANT_ODD), where the
    radix-4 forms fall back to kernels/viterbi.py viterbi, K4 on the card.
    One counted run of each on both batches (its only launches: K4 for
    each radix-4 form's fallback), every result equal to K4's bits at
    G = 4, 8, 16 and 32. Untimed: K4 is timed against viterbi_plain on
    every path that runs it."""
    from ofdm_uhd_tpu_torch.kernels import policy, viterbi
    from ofdm_uhd_tpu_torch.research import viterbi_variants
    rows, ties = VARIANT_ROWS
    even, sent = variant_llrs(torch, device, rows, ties, VARIANT_STEPS, 0)
    odd, _ = variant_llrs(torch, device, *VARIANT_ODD, 1)
    batches = {"even": even, "odd": odd}
    torch.cuda.synchronize()
    policy.reset_launches()
    t0 = time.perf_counter()
    got = {(name, key): getattr(viterbi_variants, name)(x)
           for name in VARIANTS for key, x in batches.items()}
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = policy.launches()
    fallbacks = sum("radix4" in name for name in VARIANTS)
    check(launches["viterbi"] == fallbacks
          and sum(launches.values()) == fallbacks,
          f"variants: the counted run launched {launches}, not K4 once for "
          "each radix-4 form's fallback at odd n")
    for key, x in batches.items():
        for g in viterbi.K4_GROUPS:
            want = viterbi._viterbi_cuda(x, g)
            for name in VARIANTS:
                bad = int((got[(name, key)] != want).sum())
                check(got[(name, key)].shape == want.shape and bad == 0,
                      f"variants: {name} on the {key} batch "
                      f"{list(x.shape)} differs from K4 at group {g} in "
                      f"{bad} bits")
    errors = int((got[(VARIANTS[0], "even")][:rows].cpu().numpy()
                  != sent).sum())
    check(errors <= 1e-3 * sent.size, f"variants: the decodable rows "
          f"decode with {errors} bit errors in {sent.size}")
    log(f"variants: ok  {', '.join(VARIANTS)} equal to K4's bits at groups "
        f"{', '.join(map(str, viterbi.K4_GROUPS))} on {list(even.shape)} "
        f"({rows} decodable rows, {errors} bit errors, and {ties} tied rows "
        f"of {VARIANT_STEPS} steps) and {list(odd.shape)} (odd); the "
        f"counted run {run_s:.1f} s, launches {nonzero(launches)}")
    return {"kernels": {}, "launches": launches, "shape": list(even.shape),
            "odd_shape": list(odd.shape), "counted_run_s": run_s}


def run_c3_pallas(torch, config, device) -> dict:
    """bench.py's `pallas-sc16` variant: C3's captures (8 x 1024 frames,
    seeds 0-7, build_capture's defaults) under kernel_backend='pallas'."""
    return run_pallas(torch, config, device, "c3", "c3_pallas", N_CAPS,
                      C3_FRAMES, C3_PALLAS_PATH)


def run_c2_pallas(torch, config, device) -> dict:
    """The reference bench's C2 capture row (ofdm_uhd_tpu/cli/bench.py:
    77-93: 32 captures x 128 frames, gap 300, SNR 28 dB, CFO 0.8, timing
    offset 100, no phase noise, sc16) under --backend pallas."""
    return run_pallas(torch, config, device, "c2", "c2_pallas", C2_CAPS,
                      C2_FRAMES, C2_PALLAS_PATH, snr_db=28.0, cfo=0.8,
                      phase_noise_std=0.0, timing_offset=100)


def run_shift(torch, device, c4_inputs) -> dict:
    """The shifted-FMA tier (K11, research/shift.py), which no user path
    runs, on bench/kernels_ab.py's K11 rows and on C4's decimation and TX
    interpolation at full width (c4_inputs: the padded radio captures [8,
    4,138,472] the exact decimation kernel was held on, and the TX's
    baseband frames [32, 16128]). One counted run of the four functions at
    every shape (this phase's main path: every shift_* kernel launches, no
    other kernel does), then each kernel held against its plain version
    with its bound, plain, library and in-kernel times (where there is a
    library call, its in-kernel time too, in turns with the kernel) and
    its public wrapper's host time a call (host_us); at C4 the exact K7
    kernel on the same input beside it, in turns (K7, K11, K11, K7, each
    in-kernel); and the S&C energy formed as the TPU kernel forms it (re*re
    + im*im) against K9's |r|^2."""
    import numpy as np
    from ofdm_uhd_tpu_torch.kernels import fir, policy, sync
    from ofdm_uhd_tpu_torch.phy import tables
    from ofdm_uhd_tpu_torch.research import shift
    taps = tables.resample_filter(SHIFT_M, 1)
    taps3 = np.asarray([0.25, 0.5, 0.25], np.float32)
    nt, branch = len(taps), fir.branch_matrix(taps, SHIFT_M)[0].shape[1]
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=SHIFT_N) + 1j * rng.normal(
        size=SHIFT_N)).astype(np.complex64)).to(device)
    xs = x[: SHIFT_N // SHIFT_M]
    radio, base = c4_inputs
    l, m = SHIFT_SC_L, SHIFT_M
    torch.cuda.synchronize()
    policy.reset_launches()
    outs = [shift.fir_shift(x, taps), shift.fir_shift(x, taps3),
            shift.polyphase_decim_shift(radio, m, taps),
            shift.polyphase_decim_shift(x, m, taps),
            shift.polyphase_interp_shift(base, m, taps),
            shift.polyphase_interp_shift(xs, m, taps),
            *shift.sc_correlate_shift(x, l)]
    torch.cuda.synchronize()
    launches = policy.launches()
    for k, c in launches.items():
        check((c > 0) == (k in SHIFT_PATH), f"shift: the run launched the "
              f"{k} kernel {c} times")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          "shift: an output is not finite")
    del outs
    nd = SHIFT_N - 2 * l + 1
    r, n_r = radio.shape
    b, n_b = base.shape
    cases = {   # key: (kernel, plain version, shape, work, library call)
        "shift_fir_193": (
            lambda: shift._fir_cuda(x, taps),
            lambda: fir.decim_plain(x, 1, taps), x.shape,
            work_filter(1, SHIFT_N, SHIFT_N, nt),
            library_fir(torch, x[None], taps, 1)),
        "shift_fir_3": (
            lambda: shift._fir_cuda(x, taps3),
            lambda: fir.decim_plain(x, 1, taps3), x.shape,
            work_filter(1, SHIFT_N, SHIFT_N, 3),
            library_fir(torch, x[None], taps3, 1)),
        "shift_decim_c4": (
            lambda: shift._decim_cuda(radio, m, taps),
            lambda: fir.decim_plain(radio, m, taps), radio.shape,
            work_filter(r, n_r, n_r // m, nt),
            library_fir(torch, radio, taps, m)),
        "shift_decim": (
            lambda: shift._decim_cuda(x, m, taps),
            lambda: fir.decim_plain(x, m, taps), x.shape,
            work_filter(1, SHIFT_N, SHIFT_N // m, nt),
            library_fir(torch, x[None], taps, m)),
        "shift_interp_c4": (
            lambda: shift._interp_cuda(base, m, taps),
            lambda: fir.interp_plain(base, m, taps), base.shape,
            work_filter(b, n_b, n_b * m, branch),
            library_interp(torch, base, m, taps)),
        "shift_interp": (
            lambda: shift._interp_cuda(xs, m, taps),
            lambda: fir.interp_plain(xs, m, taps), xs.shape,
            work_filter(1, xs.shape[0], xs.shape[0] * m, branch),
            library_interp(torch, xs[None], m, taps)),
        "shift_sc": (
            lambda: shift._sc_cuda(x, l),
            lambda: sync.sc_correlate_plain(x, l), x.shape,
            work_sc(1, SHIFT_N, l, metric=False), None),
    }
    public = {   # key: the public wrapper's call, for its host time
        "shift_fir_193": lambda: shift.fir_shift(x, taps),
        "shift_fir_3": lambda: shift.fir_shift(x, taps3),
        "shift_decim_c4": lambda: shift.polyphase_decim_shift(radio, m, taps),
        "shift_decim": lambda: shift.polyphase_decim_shift(x, m, taps),
        "shift_interp_c4": lambda: shift.polyphase_interp_shift(base, m,
                                                                taps),
        "shift_interp": lambda: shift.polyphase_interp_shift(xs, m, taps),
        "shift_sc": lambda: shift.sc_correlate_shift(x, l),
    }
    res = {}
    for key, (run_k, run_p, shape, work, library) in cases.items():
        close = sc_close if key == "shift_sc" else rel_close
        res[key] = held(torch, key, run_k, run_p, close, shape, work,
                        library)
        if library is None:
            res[key]["device_ms"] = device_ms(torch, run_k)
        else:
            library_in_turns(torch, res[key], run_k, library)
        res[key]["host_us"] = host_us(torch, public[key])
    log_kernels("shift", res)
    # the A/B at C4: the exact K7 kernel on the same input, in turns
    for key, k7 in (("shift_decim_c4",
                     lambda: fir._strided_cuda(radio, taps, m)),
                    ("shift_interp_c4",
                     lambda: fir._interp_cuda(base, m, taps))):
        k11 = cases[key][0]
        turns = [device_ms(torch, f) for f in (k7, k11, k11, k7)]
        res[key].update({"k7_ms": cuda_ms(torch, k7),
                         "k7_device_ms": [turns[0], turns[3]],
                         "device_ms_turns": [turns[1], turns[2]]})
        log(f"shift a/b: {key} in-kernel K7 / K11 / K11 / K7 " + " / ".join(
            "none" if t is None else f"{t:.4f}" for t in turns)
            + f" ms; events K7 {res[key]['k7_ms']:.3f}, K11 "
            f"{res[key]['ms']:.3f} ms")
    _, r9 = shift._sc_cuda(x, l)
    e = x.real * x.real + x.imag * x.imag
    r11 = 0.5 * sync._moving_sum(e, 2 * l)
    energy = float(((r11 - r9).abs() / r9.abs().clamp_min(1e-30)).max())
    check(r9.shape == (nd,) and energy <= R_TOL,
          f"shift: R from re*re + im*im differs from K9's by {energy}")
    log(f"shift: ok  every shift_* kernel within tolerance of its plain "
        f"version; R with the energy as re*re + im*im within {energy:.3g} "
        f"(relative) of K9's |r|^2 form; launches {launches}")
    return {"kernels": res, "launches": launches,
            "energy_form_max_rel": energy}


def exact_close(k, p) -> tuple[bool, float]:
    """Equal complex frames, component by component."""
    same = (k.shape == p.shape and k.real.equal(p.real)
            and k.imag.equal(p.imag))
    return same, float((k - p).abs().max()) if k.numel() else 0.0


def in_turns(torch, fns: dict, order: tuple) -> dict:
    """In-kernel ms of each named run, taken in the given order (each name
    twice, mirrored): {name: [first, second]}."""
    out = {k: [] for k in fns}
    for name in order + order[::-1]:
        out[name].append(device_ms(torch, fns[name]))
    return out


def fmt_turns(turns: dict) -> str:
    return ", ".join(f"{k} " + " / ".join(
        "none" if t is None else f"{t:.4f}" for t in v)
        for k, v in turns.items())


def run_tiers(torch, device, c4_inputs, c3_inputs) -> dict:
    """The last three TPU kernels' counterparts, which no user path runs:
    the banded tier K8 (kernels/banded.py) and the interleaved tier K13
    (research/fir_ilv.py) on csrc/banded.cu, K13 at the reference's
    DEFAULT precision on csrc/fir_bf16.cu (against the bf16 plain
    versions, its bound at the bf16 peak, conv1d on bf16 planes its
    library call), and the bulk-copy deframer K12 (research/deframe.py).
    Inputs: scripts/tpu_session.py's FIR rows
    (seed-0 complex64 TIERS_SESSION, the 193-tap FIR, 8x interpolation and
    decimation); C4's decimation input [8, 4,138,472] and TX frames [32,
    16128] (c4_inputs); K8's S&C at l = 128 on the shift phase's 2^20
    signal and on C3's AGC'd captures [8, 4,436,068], the input K6 reads;
    K12 on C3's extraction input (the captures and the 8208 detected
    offsets, c3_inputs) and on offsets that are negative, odd, in range and
    past n. One counted run of the eleven functions (this phase's main path:
    every tiers kernel launches, no other kernel does), then each kernel
    held against its plain version with its bound, plain, library and
    in-kernel times (where there is a library call, its in-kernel time
    too, in turns with the kernel); at C4 the four exact float32 designs in
    turns (K7, K11, K8, K13, and back); K8's S&C beside K9, and K12 beside
    K2 (equal on offsets in [0, n]). A kernel outside its tolerance fails
    the run (held)."""
    import numpy as np
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.kernels import banded, extract, fir, policy, sync
    from ofdm_uhd_tpu_torch.phy import tables
    from ofdm_uhd_tpu_torch.research import deframe, fir_ilv, shift
    m, l = SHIFT_M, SHIFT_SC_L
    taps = tables.resample_filter(m, 1)
    nt, branch = len(taps), fir.branch_matrix(taps, m)[0].shape[1]
    rng = np.random.default_rng(0)
    xs = torch.from_numpy((rng.standard_normal(TIERS_SESSION) + 1j
                           * rng.standard_normal(TIERS_SESSION)).astype(
                               np.complex64)).to(device)
    rng = np.random.default_rng(0)
    x1 = torch.from_numpy((rng.normal(size=SHIFT_N) + 1j * rng.normal(
        size=SHIFT_N)).astype(np.complex64)).to(device)
    radio, base = c4_inputs
    cap, ds = c3_inputs
    fl = config("c3").frame_len
    caps, n3 = cap.shape
    mixed = torch.tensor([-5000, -4225, -4224, -1, 0, 1, 2, 3, 1001, 4031,
                          n3 - fl, n3 - fl + 1, n3 - 7, n3 - 1, n3, n3 + 1,
                          2**31 - 1], dtype=torch.int32).repeat(caps, 1).to(
                              device)
    torch.cuda.synchronize()
    policy.reset_launches()
    outs = [banded.fir_banded(xs, taps),
            banded.polyphase_interp_banded(xs, m, taps),
            banded.polyphase_decim_banded(xs, m, taps),
            banded.polyphase_decim_banded(radio, m, taps),
            banded.polyphase_interp_banded(base, m, taps),
            *banded.sc_correlate_banded(x1, l),
            *banded.sc_correlate_banded(cap, l),
            fir_ilv.fir_ilv(xs, taps),
            fir_ilv.polyphase_interp_ilv(xs, m, taps),
            fir_ilv.polyphase_decim_ilv(xs, m, taps),
            fir_ilv.polyphase_decim_ilv(radio, m, taps),
            fir_ilv.polyphase_interp_ilv(base, m, taps),
            fir_ilv.fir_ilv(xs, taps, precision="default"),
            fir_ilv.polyphase_interp_ilv(xs, m, taps, precision="default"),
            fir_ilv.polyphase_decim_ilv(xs, m, taps, precision="default"),
            fir_ilv.polyphase_decim_ilv(radio, m, taps, precision="default"),
            fir_ilv.polyphase_interp_ilv(base, m, taps, precision="default"),
            deframe.extract_frames_dma(cap, ds, fl),
            deframe.extract_frames_dma(cap, mixed, fl)]
    torch.cuda.synchronize()
    launches = policy.launches()
    for k, c in launches.items():
        check((c > 0) == (k in TIERS_PATH), f"tiers: the run launched the "
              f"{k} kernel {c} times")
    check(all(bool(torch.isfinite(torch.view_as_real(o) if o.is_complex()
                                  else o).all()) for o in outs),
          "tiers: an output is not finite")
    del outs
    r, n_r = radio.shape
    b, n_b = base.shape
    rs, ns = xs.shape
    n_dec = -(-n_r // m)
    cases = {   # key: (kernel, plain version, shape, work, library call)
        "banded_fir": (
            lambda: banded._fir_cuda(xs, taps),
            lambda: fir.decim_plain(xs, 1, taps), xs.shape,
            work_tf32(rs, ns, ns, nt), library_fir(torch, xs, taps, 1)),
        "banded_decim_c4": (
            lambda: banded._decim_cuda(radio, m, taps),
            lambda: banded.decim_banded_plain(radio, m, taps), radio.shape,
            work_tf32(r, n_r, n_dec, nt), library_fir(torch, radio, taps, m)),
        "banded_decim": (
            lambda: banded._decim_cuda(xs, m, taps),
            lambda: banded.decim_banded_plain(xs, m, taps), xs.shape,
            work_tf32(rs, ns, -(-ns // m), nt),
            library_fir(torch, xs, taps, m)),
        "banded_interp_c4": (
            lambda: banded._interp_cuda(base, m, taps),
            lambda: fir.interp_plain(base, m, taps), base.shape,
            work_tf32(b, n_b, n_b * m, branch),
            library_interp(torch, base, m, taps)),
        "banded_interp": (
            lambda: banded._interp_cuda(xs, m, taps),
            lambda: fir.interp_plain(xs, m, taps), xs.shape,
            work_tf32(rs, ns, ns * m, branch),
            library_interp(torch, xs, m, taps)),
        "banded_sc_c3": (
            lambda: banded._sc_cuda(cap, l),
            lambda: banded.sc_correlate_banded_plain(cap, l), cap.shape,
            work_sc_banded(caps, n3, l), None),
        "banded_sc": (
            lambda: banded._sc_cuda(x1, l),
            lambda: banded.sc_correlate_banded_plain(x1, l), x1.shape,
            work_sc_banded(1, SHIFT_N, l), None),
        "ilv_fir": (
            lambda: fir_ilv._fir_cuda(xs, taps),
            lambda: fir.decim_plain(xs, 1, taps), xs.shape,
            work_tf32(rs, ns, ns, nt), library_fir(torch, xs, taps, 1)),
        "ilv_decim_c4": (
            lambda: fir_ilv._decim_cuda(radio, m, taps),
            lambda: fir.decim_plain(radio, m, taps), radio.shape,
            work_tf32(r, n_r, n_r // m, nt),
            library_fir(torch, radio, taps, m)),
        "ilv_decim": (
            lambda: fir_ilv._decim_cuda(xs, m, taps),
            lambda: fir.decim_plain(xs, m, taps), xs.shape,
            work_tf32(rs, ns, ns // m, nt), library_fir(torch, xs, taps, m)),
        "ilv_interp_c4": (
            lambda: fir_ilv._interp_cuda(base, m, taps),
            lambda: fir.interp_plain(base, m, taps), base.shape,
            work_tf32(b, n_b, n_b * m, branch),
            library_interp(torch, base, m, taps)),
        "ilv_interp": (
            lambda: fir_ilv._interp_cuda(xs, m, taps),
            lambda: fir.interp_plain(xs, m, taps), xs.shape,
            work_tf32(rs, ns, ns * m, branch),
            library_interp(torch, xs, m, taps)),
        "ilv_fir_bf16": (
            lambda: fir_ilv._fir_bf16_cuda(xs, taps),
            lambda: fir.decim_plain_bf16(xs, 1, taps), xs.shape,
            work_filter(rs, ns, ns, nt, BF16_OPS),
            library_fir(torch, xs, taps, 1, torch.bfloat16)),
        "ilv_decim_bf16_c4": (
            lambda: fir_ilv._decim_bf16_cuda(radio, m, taps),
            lambda: fir.decim_plain_bf16(radio, m, taps), radio.shape,
            work_filter(r, n_r, n_r // m, nt, BF16_OPS),
            library_fir(torch, radio, taps, m, torch.bfloat16)),
        "ilv_decim_bf16": (
            lambda: fir_ilv._decim_bf16_cuda(xs, m, taps),
            lambda: fir.decim_plain_bf16(xs, m, taps), xs.shape,
            work_filter(rs, ns, ns // m, nt, BF16_OPS),
            library_fir(torch, xs, taps, m, torch.bfloat16)),
        "ilv_interp_bf16_c4": (
            lambda: fir_ilv._interp_bf16_cuda(base, m, taps),
            lambda: fir.interp_plain_bf16(base, m, taps), base.shape,
            work_filter(b, n_b, n_b * m, branch, BF16_OPS),
            library_interp(torch, base, m, taps, torch.bfloat16)),
        "ilv_interp_bf16": (
            lambda: fir_ilv._interp_bf16_cuda(xs, m, taps),
            lambda: fir.interp_plain_bf16(xs, m, taps), xs.shape,
            work_filter(rs, ns, ns * m, branch, BF16_OPS),
            library_interp(torch, xs, m, taps, torch.bfloat16)),
        "deframe_c3": (
            lambda: deframe._deframe_cuda(cap, ds, fl),
            lambda: deframe.deframe_plain(cap, ds, fl), (ds.numel(), fl),
            work_extract(n3, ds, fl), None),
        "deframe_offsets": (
            lambda: deframe._deframe_cuda(cap, mixed, fl),
            lambda: deframe.deframe_plain(cap, mixed, fl),
            (mixed.numel(), fl), work_extract(n3, mixed, fl), None),
    }
    res = {}
    for key, (run_k, run_p, shape, work, library) in cases.items():
        close = (sc_close if key.startswith("banded_sc") else exact_close
                 if key.startswith("deframe") else rel_close)
        res[key] = held(torch, key, run_k, run_p, close, shape, work,
                        library)
        if library is None:
            res[key]["device_ms"] = device_ms(torch, run_k)
        else:
            library_in_turns(torch, res[key], run_k, library)
    log_kernels("tiers", res)
    # K12 against K2: equal wherever K2's clamp does not apply (d >= 0)
    check(int(ds.min()) >= 0, "tiers: detection gave a negative offset")
    for offs in (ds, mixed):
        k12 = deframe._deframe_cuda(cap, offs, fl)
        k2 = extract._extract_cuda(cap, offs, fl)
        inside = offs >= 0
        check(exact_close(k12[inside], k2[inside])[0]
              and not bool(k12[~inside].abs().any()),
              "tiers: K12 differs from K2 on offsets in [0, n], or gave "
              "samples at a negative offset")
    # the A/B of the exact float32 filter designs at C4, in turns
    ab = {
        "decim_c4": in_turns(torch, {
            "K7": lambda: fir._strided_cuda(radio, taps, m),
            "K11": lambda: shift._decim_cuda(radio, m, taps),
            "K8": lambda: banded._decim_cuda(radio, m, taps),
            "K13": lambda: fir_ilv._decim_cuda(radio, m, taps)},
            ("K7", "K11", "K8", "K13")),
        "interp_c4": in_turns(torch, {
            "K7": lambda: fir._interp_cuda(base, m, taps),
            "K11": lambda: shift._interp_cuda(base, m, taps),
            "K8": lambda: banded._interp_cuda(base, m, taps),
            "K13": lambda: fir_ilv._interp_cuda(base, m, taps)},
            ("K7", "K11", "K8", "K13")),
        "sc_c3": in_turns(torch, {
            "K9": lambda: sync._sccorr_cuda(cap, l),
            "K8": lambda: banded._sc_cuda(cap, l)}, ("K9", "K8")),
        "sc_2e20": in_turns(torch, {
            "K9": lambda: sync._sccorr_cuda(x1, l),
            "K8": lambda: banded._sc_cuda(x1, l)}, ("K9", "K8")),
        "extract_c3": in_turns(torch, {
            "K2": lambda: extract._extract_cuda(cap, ds, fl),
            "K12": lambda: deframe._deframe_cuda(cap, ds, fl)},
            ("K2", "K12")),
    }
    for key, turns in ab.items():
        log(f"tiers a/b: {key} in-kernel ms, in turns: {fmt_turns(turns)}")
    log(f"tiers: ok  every banded_*, ilv_* kernel within tolerance of its "
        f"plain version (ilv_*_bf16 of the bf16 one), deframe bit-exact and "
        f"equal to K2 on offsets in "
        f"[0, n]; launches {launches}")
    return {"kernels": res, "launches": launches, "ab": ab}


def make_input_c5(torch, spec, device):
    """The reference bench's stream capture: 4096 frames from the port's
    TxPipeline on the card, gap 300, SNR 28 dB, CFO 0.8, timing offset
    100, no phase noise, seed 0 (payloads and noise); fc32 [n] and its sc16
    planes [2, n] scaled by 32767 / max."""
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    t0 = time.perf_counter()
    cap, pays = build_capture(spec, C5_FRAMES, GAP, seed=0, snr_db=28.0,
                              cfo=0.8, phase_noise_std=0.0,
                              timing_offset=C5_OFFSET, device=device)
    iq = to_sc16(cap[None])[:, 0]
    log(f"c5 input: {cap.shape[0]} samples, {C5_FRAMES} frames, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return cap, pays, iq


def first_window(torch, spec, x, chunk, device):
    """The first stream step's processing window, before its AGC: the
    initial zero tail, then the first chunk ([1, H + chunk] complex64, or
    [2, 1, H + chunk] int16 planes for sc16)."""
    import numpy as np
    from ofdm_uhd_tpu_torch.core.state import StreamState
    h = StreamState.halo_len(spec)
    if x.dtype == np.int16:
        w = np.concatenate([np.zeros((2, h), np.int16), x[:, :chunk]], 1)
        return torch.from_numpy(w[:, None]).to(device)
    w = np.concatenate([np.zeros(h, np.complex64), x[:chunk]])
    return torch.from_numpy(w[None]).to(device)


def check_stream(label, frames, pays, spec, block) -> list:
    """Every sent frame decoded once with its CRC passing, bit-exact, in
    order, its start within the CP of the sent start. The only other slots
    allowed are the reference's boundary duplicates (tests/test_torch_
    stream.py): a frame starting a few samples before a shard's extended
    block is detected again at its first sample, start = k*block - H
    (block: the chunk, or a shard's Cb on a mesh). Returns those
    duplicates."""
    import numpy as np
    from ofdm_uhd_tpu_torch.core.state import StreamState
    h = StreamState.halo_len(spec)
    dups = [f for i, f in enumerate(frames)
            if i and (f.start + h) % block == 0
            and f.start - frames[i - 1].start <= spec.cp]
    kept = [f for f in frames if all(f is not d for d in dups)]
    n = pays.shape[0]
    check(len(kept) == n, f"{label}: {len(kept)} frames (and {len(dups)} "
          f"boundary duplicates), sent {n}")
    starts = np.array([f.start for f in kept])
    true = C5_OFFSET + np.arange(n) * (spec.frame_len + GAP)
    check(bool(np.all(np.diff(starts) > 0)), f"{label}: frames out of order")
    err = int(np.abs(starts - true).max())
    check(err <= spec.cp, f"{label}: a start is {err} samples off")
    check(all(f.crc_ok for f in kept), f"{label}: a frame failed its CRC")
    bad = sum(not np.array_equal(f.payload, p) for f, p in zip(kept, pays))
    check(bad == 0, f"{label}: {bad} payloads differ from the sent ones")
    return dups


def same_frames(label, a, b) -> None:
    import numpy as np
    check([f.start for f in a] == [f.start for f in b]
          and all(np.array_equal(x.payload, y.payload) for x, y in zip(a, b)),
          f"{label}: the plain-forced run's starts or payloads differ")


def phase_stream_run(torch, spec, label, make_rx, feed, run, pays,
                     samples, dispatches, path=C5_PATH
                     ) -> tuple[dict, list]:
    """One operating point of the stream: the main-path run (checked, its
    launches counted: every kernel of `path` launched, no other), `REPS_STREAM`
    timed runs on a second, perturbed feed, each by a fresh receiver, then
    `REPS_STREAM` by the last of them carried on, a plain-forced run that must
    give the same frames, and the busy share over one
    run. run(rx, feed) -> frames; feed = (first, second); samples and
    dispatches: radio samples and K-step dispatches per run. Returns the
    results and the main run's frames."""
    from ofdm_uhd_tpu_torch.kernels import policy
    rx = make_rx()
    torch.cuda.synchronize()
    policy.reset_launches()
    t0 = time.perf_counter()
    frames = run(rx, feed[0])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = policy.launches()
    for k, n in launches.items():
        check((n > 0) == (k in path), f"{label}: the main path launched the "
              f"{k} kernel {n} times")
    dups = check_stream(label, frames, pays, spec, rx.cb)
    edge = [d for d in dups if (d.start + rx.h) % rx.chunk_len == 0]
    inner = [d for d in dups if (d.start + rx.h) % rx.chunk_len]
    st = rx.state
    n_ok = pays.shape[0] + sum(d.crc_ok for d in dups)
    check(int(st.frames) == pays.shape[0] + len(dups)
          and int(st.crc_ok) == n_ok,
          f"{label}: state counts {int(st.frames)} frames, "
          f"{int(st.crc_ok)} crc_ok")

    walls, devs = [], []
    for _ in range(REPS_STREAM):
        rx_t = make_rx()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        got = run(rx_t, feed[1])
        end.record()
        end.synchronize()
        walls.append(time.perf_counter() - t0)
        devs.append(start.elapsed_time(end) / 1e3)
        check(sum(f.crc_ok for f in got) >= pays.shape[0],
              f"{label}: a timed run lost frames")
    wall = statistics.median(walls)
    # the last receiver carried on for REPS_STREAM more runs, the feeds in
    # turn, as cli.bench times its passes: beside the fresh runs above,
    # what a fresh receiver's run costs over the stream's steady state
    carried = []
    for i in range(REPS_STREAM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run(rx_t, feed[i % 2])
        torch.cuda.synchronize()
        carried.append(time.perf_counter() - t0)
        check(sum(f.crc_ok for f in got) >= pays.shape[0],
              f"{label}: a carried run lost frames")
    rx_p = make_rx()
    t0 = time.perf_counter()
    with policy.plain_versions():
        plain_frames = run(rx_p, feed[0])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same_frames(label, frames, plain_frames)
    busy = device_busy_share(torch, lambda: run(make_rx(), feed[0]))
    res = {"frames_ok": pays.shape[0],
           "boundary_duplicates": [(d.start, d.crc_ok) for d in edge],
           "inner_duplicates": [(d.start, d.crc_ok) for d in inner],
           "shards": rx.mesh.shape["time"], "dispatches": dispatches,
           "steps": rx._steps, "ms_per_dispatch": wall * 1e3 / dispatches,
           "ms_per_step": wall * 1e3 / rx._steps,
           "msps": samples / wall / 1e6, "run_s": walls,
           "device_s": devs, "carried_run_s": carried,
           "carried_msps": samples / statistics.median(carried) / 1e6,
           "first_run_s": first_s,
           "plain_run_s": plain_s, "plain_msps": samples / plain_s / 1e6,
           "launches": launches, "profile": busy}
    share = busy["busy_share"]
    log(f"{label}: ok  {pays.shape[0]}/{pays.shape[0]} frames crc_ok, "
        f"bit-exact, in order, and {len(edge)} chunk-boundary "
        f"duplicates (start, crc_ok) {res['boundary_duplicates']}, "
        f"{len(inner)} at inner shard boundaries {res['inner_duplicates']}"
        f"; state frames "
        f"{int(st.frames)}, crc_ok {int(st.crc_ok)}; "
        f"{res['ms_per_dispatch']:.2f} ms/dispatch over {dispatches} "
        f"dispatches ({rx._steps} steps, {res['ms_per_step']:.3f} ms/step), "
        f"{res['msps']:.1f} "
        f"Msamples/s (runs {', '.join(f'{w:.3f}' for w in walls)} s, "
        f"device {', '.join(f'{d:.3f}' for d in devs)} s); carried on "
        f"{res['carried_msps']:.1f} Msamples/s (runs "
        f"{', '.join(f'{w:.3f}' for w in carried)} s); plain-forced "
        f"{plain_s:.2f} s, same starts and payloads"
        "; busy share " + (
            "not measured" if share is None else
            f"{share:.3f} of {busy['traced_wall_ms']:.1f} ms") +
        f"; launches {launches}")
    return res, frames


def phase_track_c5(torch, config, device) -> dict:
    """The TRACK retry at full C5 width on the card: a noise burst over
    the last frame's channel-estimation symbol (the burst case of
    tests/property/test_fault_injection.py) fails its first decode; the
    retry with the tracked channel and CFO rescues it."""
    import numpy as np
    from ofdm_uhd_tpu_torch.channel import make_capture
    from ofdm_uhd_tpu_torch.core.spec import ChannelSpec
    from ofdm_uhd_tpu_torch.pipeline import StreamRx, TxPipeline
    spec = config("c5").with_(sfo_track=True)
    n_fr, gap, offset = 10, 500, 700
    rng = np.random.default_rng(7)
    pays = rng.integers(0, 2, (n_fr, spec.payload_bits_per_frame)).astype(
        np.uint8)
    frames = TxPipeline(spec)(torch.from_numpy(pays).to(device)).cpu()
    ch = ChannelSpec(snr_db=24.0, cfo=0.7, phase_noise_std=1e-4,
                     multipath_taps=(1.0, 0.0, 0.25j, 0.1),
                     timing_offset=offset)
    cap = make_capture(frames.numpy(), ch, spec.n_sc, gap=gap,
                       seed=7).astype(np.complex64)
    s = offset + (n_fr - 1) * (spec.frame_len + gap) + spec.sym_len
    rms = float(np.sqrt(np.mean(np.abs(cap) ** 2)))
    cap[s:s + spec.sym_len] += (4.0 * rms * (
        rng.standard_normal(spec.sym_len)
        + 1j * rng.standard_normal(spec.sym_len))).astype(np.complex64)
    chunk = 4 * 2 * (spec.frame_len + spec.n_sc)
    ok = {}
    for track in (False, True):
        rx = StreamRx(spec, chunk_len=chunk, track_mode=track, device=device)
        got = rx.process(cap) + rx.flush()
        ok[track] = sum(g.crc_ok for g in got)
    rescued = [g for g in got if abs(g.start - (s - spec.sym_len)) <= spec.cp]
    check(ok[False] == n_fr - 1 and ok[True] == n_fr and rx.rescued >= 1
          and len(rescued) == 1 and rescued[0].crc_ok
          and np.array_equal(rescued[0].payload, pays[n_fr - 1]),
          f"c5 track: {ok[False]} frames without the retry, {ok[True]} with "
          f"it, {rx.rescued} rescued")
    log(f"c5 track: ok  burst frame lost without the retry ({ok[False]}/"
        f"{n_fr}), rescued with it ({ok[True]}/{n_fr}, rescued "
        f"{rx.rescued}), payload equal to the sent one")
    return {"frames_ok_without": ok[False], "frames_ok_with": ok[True],
            "rescued": rx.rescued}


def phase_kernels_c5(torch, spec, llr_res, llr_host) -> dict:
    """K4w against its plain version on the LLRs of the stream's first
    step at both operating points (every bit of every slot, the empty
    ones included), and K4 timed on the same LLRs."""
    from ofdm_uhd_tpu_torch.kernels import viterbi
    res = {}
    for key, llr, geometry in (("512", llr_res, viterbi.XLA_WINDOW),
                               ("256", llr_host, viterbi.FUSED_WINDOW)):
        for k, v in hold_windowed(torch, llr, geometry, "c5").items():
            res[f"{k}_{key}"] = v
        res[f"viterbi_windowed_{key}"]["k4_ms"] = cuda_ms(
            torch, lambda: viterbi._viterbi_cuda(llr))
    log_kernels("c5", res)
    for k, v in res.items():
        if "k4_ms" in v:
            log(f"c5 kernels: {k} K4 on the same LLRs {v['k4_ms']:.3f} ms")
    return res


def run_c5(torch, config, device) -> tuple[dict, dict, dict, dict]:
    """C5, the stream, at its two operating points: resident fc32 (chunk
    4,128,768, K = 4, chunk stacks staged on the card) and host-fed sc16
    (chunk 129,024, K = 16, through process + flush); then c5_sharded, the
    distributed phase and the distributed axes phase on the resident
    point's stacks, c5_sharded's result carrying the frame and stage axes
    in one process (phase_axes). Returns (c5, c5_sharded, distributed,
    axes_distributed)."""
    import numpy as np
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    spec = config("c5").with_(kernel_backend="auto")
    cap, pays, iq = make_input_c5(torch, spec, device)

    # stages and kernels on the first step's window of each point
    mf_res = C5_RESIDENT[0] // spec.frame_len + 2
    mf_host = C5_HOSTFED[0] // spec.frame_len + 2
    ins, stages_res = phase_stages(
        torch, spec, "c5 resident", first_window(torch, spec, cap,
                                                 C5_RESIDENT[0], device),
        mf_res)
    kernels = phase_kernels(torch, spec, "c5", ins)
    llr_res = ins["llr"]
    del ins
    ins, stages_host = phase_stages(
        torch, spec, "c5 host-fed", first_window(torch, spec, iq,
                                                 C5_HOSTFED[0], device),
        mf_host)
    kernels.update(phase_kernels_c5(torch, spec, llr_res, ins["llr"]))
    del ins, llr_res

    # resident fc32: the padded capture as K-step stacks on the card
    chunk, k = C5_RESIDENT
    per = chunk * k
    stacks = resident_stacks(torch, cap, device)
    n_disp = len(stacks[0])
    resident, one_shard = phase_stream_run(
        torch, spec, "c5 resident fc32",
        lambda: StreamRx(spec, chunk_len=chunk, steps_per_dispatch=k,
                         device=device),
        stacks, lambda rx, st: rx.process_device(st), pays, n_disp * per,
        n_disp)
    sharded = run_c5_sharded(torch, spec, device, stacks, pays, one_shard,
                             n_disp * per, n_disp)
    distributed = run_distributed(torch, spec, device, cap, pays, stacks,
                                  sharded.pop("frames"))
    sharded["axes"], batch, outs = phase_axes(torch, device)
    axes_distributed = run_axes_distributed(torch, device, batch, outs,
                                            stacks)
    del batch, outs
    del stacks

    # host-fed sc16 from host memory, padded to whole K-step dispatches
    chunk, k = C5_HOSTFED
    per = chunk * k
    feed = np.zeros((2, -(-iq.shape[1] // per) * per), np.int16)
    feed[:, :iq.shape[1]] = iq
    hostfed, _ = phase_stream_run(
        torch, spec, "c5 host-fed sc16",
        lambda: StreamRx(spec, chunk_len=chunk, steps_per_dispatch=k,
                         input_format="sc16", device=device),
        (feed, feed ^ 1), lambda rx, f: rx.process(f) + rx.flush(), pays,
        feed.shape[1] + chunk, feed.shape[1] // per + 1)   # + the flush
    track = phase_track_c5(torch, config, device)
    return {"stages_ms": {"resident": stages_res, "hostfed": stages_host},
            "kernels": kernels, "resident": resident, "hostfed": hostfed,
            "track": track,
            "launches": {n: resident["launches"][n] + hostfed["launches"][n]
                         for n in resident["launches"]}}, sharded, \
        distributed, axes_distributed


def resident_stacks(torch, cap, device) -> list:
    """The capture zero-padded to whole K-step dispatches of the resident
    point, as [K, chunk] stacks on the card: [first feed, second feed],
    the second scaled by 1 + 1e-6 (distinct buffers for timed runs)."""
    import numpy as np
    chunk, k = C5_RESIDENT
    per = chunk * k
    n_disp = -(-cap.shape[0] // per)
    padded = np.zeros(n_disp * per, np.complex64)
    padded[:cap.shape[0]] = cap
    return [[torch.from_numpy(padded[d * per:(d + 1) * per].reshape(
        k, chunk)).to(device) * torch.tensor(1 + 1e-6 * v, device=device)
        for d in range(n_disp)] for v in range(2)]


def run_c5_sharded(torch, spec, device, stacks, pays, one_shard, samples,
                   dispatches) -> dict:
    """The time-sharded stream on a virtual mesh of C5_SHARDS entries of
    the one card, at the resident point, three ways: the halos moved as
    the reference's ppermute, by the halo kernel, and with the slot
    reshard. Each run decodes every frame (duplicates at the inner shard
    boundaries counted apart) and, less those, gives the one-shard run's
    starts and payloads; the halo-kernel run gives the ppermute run's
    frames exactly (eps and EVM included), the reshard run its frames
    (eps and EVM within 1e-5 and 0.01 dB). Before them, the steps and
    kernels of the path on the first step's window, cut into the shards'
    rows [4, Cb + H] by the halo exchange, each kernel held against its
    plain version there (the Viterbi on the 1032 rows' LLRs at 512/96, the
    geometry the algorithm takes at one shard's 258 slots). Then the
    receivers' times in interleaved rounds, K10 against its plain version,
    and a two-card mesh where there are two cards."""
    import numpy as np
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import make_mesh
    chunk, k = C5_RESIDENT
    mesh = make_mesh(1, C5_SHARDS, [device] * C5_SHARDS)
    step, window = first_sharded_window(torch, spec, mesh, stacks[0][0][0])
    check(len(step.groups) == 1, "c5_sharded: the virtual mesh's shards "
          "are not one batch of rows")
    ins, stages = phase_stages(
        torch, spec, "c5_sharded", None, step.mf, front=(
            "agc+halo", lambda: step.extend(agc_window(window))[0]),
        algo_batch=step.mf)
    kernels = phase_kernels(torch, spec, "c5_sharded", ins, C5_PATH[:-1])
    # the windows the algorithm chosen at one shard's slots decodes with
    # (C5 trellis: 'windowed' 512/96 at 258 slots, 'fused' 256/64 at <= 96)
    geometry = window_geometry(spec, step.mf)
    vit = {f"{k}_{geometry[0]}": v for k, v in hold_windowed(
        torch, ins["llr"], geometry, "c5_sharded").items()}
    log_kernels("c5_sharded", vit)
    kernels.update(vit)
    del ins
    variants = {"ppermute": {}, "pallas_halo": {"pallas_halo": True},
                "reshard": {"reshard": True}}
    makers = {name: (lambda kw=kw: StreamRx(
        spec, mesh=mesh, chunk_len=chunk, steps_per_dispatch=k, **kw))
        for name, kw in variants.items()}
    runs, frames = {}, {}
    for name, kw in variants.items():
        runs[name], frames[name] = phase_stream_run(
            torch, spec, f"c5_sharded {name}", makers[name],
            stacks, lambda rx, st: rx.process_device(st), pays, samples,
            dispatches, path=C5_PATH + (("halo",) if kw.get("pallas_halo")
                                        else ()))
        inner = {s for s, _ in runs[name]["inner_duplicates"]}
        same_frames(f"c5_sharded {name} against one shard",
                    [f for f in frames[name] if f.start not in inner],
                    one_shard)
    base = frames["ppermute"]
    for name, exact in (("pallas_halo", True), ("reshard", False)):
        got = frames[name]
        check(len(got) == len(base) and all(
            a.start == b.start and a.crc_ok == b.crc_ok
            and np.array_equal(a.payload, b.payload)
            and (((a.eps, a.evm_db) == (b.eps, b.evm_db)) if exact else
                 (abs(a.eps - b.eps) <= 1e-5
                  and abs(a.evm_db - b.evm_db) <= 0.01))
            for a, b in zip(got, base)),
            f"c5_sharded: the {name} run's slots differ from the ppermute "
            "run's")
    log(f"c5_sharded: ok  the halo-kernel run equals the ppermute run on "
        f"all {len(base)} slots (starts, crc_ok, payloads, eps, EVM), the "
        "reshard run on starts, crc_ok and payloads; all three equal the "
        "one-shard run less the inner-boundary duplicates")
    # per_block: one shard at chunk Cb, T steps a chunk, so the chain is
    # issued once per block as a loop over the shards would issue it
    cb, kb = chunk // C5_SHARDS, k * C5_SHARDS
    blocks = [st.view(kb, cb) for st in stacks[1]]
    rounds = interleaved_rounds(torch, {
        "one_shard": (lambda: StreamRx(spec, chunk_len=chunk,
                                       steps_per_dispatch=k, device=device),
                      stacks[1]),
        **{name: (make, stacks[1]) for name, make in makers.items()},
        "per_block": (lambda: StreamRx(spec, chunk_len=cb,
                                       steps_per_dispatch=kb, device=device),
                      blocks)}, dispatches)
    kernels["halo"] = hold_halo(torch, spec, mesh, stacks[0][0][0])
    log_kernels("c5_sharded", {"halo": kernels["halo"]})
    two = phase_two_cards(torch, spec, stacks, pays)
    if two is not None:
        kernels.update(two["kernels"])
    return {"stages_ms": stages, "runs": runs,
            "rounds_ms_per_dispatch": rounds, "kernels": kernels,
            "launches": runs["pallas_halo"]["launches"],
            "two_cards": two, "frames": frames["reshard"]}


def interleaved_rounds(torch, makers, dispatches) -> dict:
    """ms per dispatch of each receiver, makers = {name: (make_rx, its
    chunk stacks)}, all over the same samples, the receivers taking turns
    over ROUNDS_SHARDED rounds (host clock around process_device,
    synchronized): {name: [ms, ...]}."""
    out = {name: [] for name in makers}
    for _ in range(ROUNDS_SHARDED):
        for name, (make, stacks) in makers.items():
            rx = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rx.process_device(stacks)
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) * 1e3 / dispatches)
    log("c5_sharded rounds: ms per dispatch, median of "
        f"{ROUNDS_SHARDED} rounds taken in turn: " + ", ".join(
            f"{n} {statistics.median(v):.2f} (spread {min(v):.2f}-"
            f"{max(v):.2f})" for n, v in out.items()))
    return out


def first_sharded_window(torch, spec, mesh, chunk):
    """The stream step of `mesh` at the chunk length of `chunk` (halos
    moved as the reference's ppermute), and its first window before the
    AGC: the initial zero tail, then the chunk ([H + chunk] complex64)."""
    from ofdm_uhd_tpu_torch.shard.time_parallel import StreamStep
    step = StreamStep(spec, mesh, chunk.shape[0], None, 0.5, 0.25,
                      pallas_halo=False, reshard=False, track_mode=True,
                      agc=True, input_format="fc32")
    return step, torch.cat([chunk.new_zeros(step.h), chunk])


def agc_window(window):
    """The window's one AGC gain applied, as the stream step applies it."""
    from ofdm_uhd_tpu_torch.phy import agc
    return agc.agc_normalize(window)[0]


def hold_halo(torch, spec, mesh, chunk) -> dict:
    """K10 against its plain version (shard-to-shard copies) on the first
    window's blocks of `mesh`'s shards, exactly, launched as the stream
    step launches it (its setup built once over fixed buffers); library_ms:
    one Tensor.copy_ of the heads into the halos where that is one call
    (the shards share a card, or one pair across two cards), else None;
    then K10 and that call timed in turns (kernel, copy_, copy_, kernel),
    by events (turns_ms) and in-kernel."""
    from ofdm_uhd_tpu_torch.kernels import halo
    step, window = first_sharded_window(torch, spec, mesh, chunk)
    cb, h = step.cb, step.h
    exts = step.blocks(agc_window(window))
    for e in exts:
        e[:, cb:].zero_()
    ext_k, ext_p, lib = ([e.clone() for e in exts] for _ in range(3))

    def close(k, p):
        same = all(torch.equal(torch.view_as_real(a), torch.view_as_real(b))
                   for a, b in zip(k, p))
        return same, max(float((a - b).abs().max()) for a, b in zip(k, p))
    pair = len(lib) == 2 and lib[0].shape[0] == lib[1].shape[0] == 1
    library = ((lambda: lib[0][:-1, cb:].copy_(lib[0][1:, :h]))
               if len(lib) == 1 else
               (lambda: lib[0][0, cb:].copy_(lib[1][0, :h])) if pair else None)
    exchange = halo.HaloExchange(ext_k, cb, h)
    res = held(torch, "halo", lambda: (exchange(), ext_k)[1],
               lambda: (halo.halo_plain(ext_p, cb, h), ext_p)[1], close,
               (step.t, cb + h), (16.0 * h * (step.t - 1), 0.0), library)
    if library is not None:
        order = ("kernel", "library")
        res["turns_ms"] = {name: [] for name in order}
        for name in order + order[::-1]:
            res["turns_ms"][name].append(cuda_ms(
                torch, exchange if name == "kernel" else library))
        library_in_turns(torch, res, exchange, library)
        in_kernel = {"kernel": res["device_ms_turns"],
                     "library": res["library_device_ms_turns"]}
        log(f"halo in turns on {[str(e.device) for e in ext_k]}: events "
            f"ms {fmt_turns(res['turns_ms'])}; in-kernel "
            f"{fmt_turns(in_kernel)}")
    return res


def axes_batch(torch, spec, device):
    """The frame and stage axes' batch: AXES_FRAMES frames of `spec` from
    the port's TX (payloads seed 0) with AWGN at AXES_SNR dB (torch
    generator seed 0) -> (payloads, frames) on `device`."""
    import numpy as np
    from ofdm_uhd_tpu_torch.pipeline import TxPipeline
    rng = np.random.default_rng(0)
    pays = torch.from_numpy(rng.integers(
        0, 2, (AXES_FRAMES, spec.payload_bits_per_frame)).astype(
            np.uint8)).to(device)
    frames = TxPipeline(spec)(pays)
    g = torch.Generator(device=device).manual_seed(0)
    sigma = torch.sqrt((frames.abs() ** 2).mean() / 10 ** (AXES_SNR / 10)
                       / 2)
    return pays, frames + sigma * torch.complex(
        torch.randn(frames.shape, generator=g, device=device),
        torch.randn(frames.shape, generator=g, device=device))


def phase_axes(torch, device) -> tuple[dict, object, dict]:
    """The frame and stage axes on the card: axes_batch's C3 frames
    through rx_frames_sharded over a (4, 1) mesh and rx_aligned_pipelined
    over 2 stages (AXES_MICRO microbatches), each against
    RxPipeline.rx_aligned on the same batch: payloads and crc_ok equal,
    EVM within 0.01 dB, every frame bit-exact; ms of each (CUDA events,
    median of REPS). -> (the results, the batch, both outputs by axis
    name: what the distributed axes phase is held against)."""
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline
    from ofdm_uhd_tpu_torch.shard import make_mesh, rx_frames_sharded
    from ofdm_uhd_tpu_torch.shard.mesh import make_stage_mesh
    from ofdm_uhd_tpu_torch.shard.stage_pipeline import rx_aligned_pipelined
    spec = config("c3")
    pays, noisy = axes_batch(torch, spec, device)
    fused = RxPipeline(spec).rx_aligned
    want = fused(noisy)
    check(torch.equal(want["payload"], pays), "axes: rx_aligned missed a "
          "frame of the batch")
    res = {"frames": AXES_FRAMES, "rx_aligned_ms": cuda_ms(
        torch, lambda: fused(noisy))}
    outs = {}
    for name, fn in (
            ("frame", rx_frames_sharded(spec, make_mesh(4, 1, [device] * 4))),
            ("stage", rx_aligned_pipelined(
                spec, make_stage_mesh(2, [device] * 2), AXES_MICRO))):
        got = fn(noisy)
        torch.cuda.synchronize()
        evm = float((got["evm_db"] - want["evm_db"]).abs().max())
        check(torch.equal(got["payload"], want["payload"])
              and torch.equal(got["crc_ok"], want["crc_ok"]) and evm <= 0.01,
              f"axes: the {name} axis differs from rx_aligned (EVM by {evm})")
        if name == "frame":
            check(int(got["n_ok_global"]) == AXES_FRAMES,
                  f"axes: n_ok_global {int(got['n_ok_global'])}")
        outs[name] = got
        res[name] = {"ms": cuda_ms(torch, lambda: fn(noisy)),
                     "max_evm_diff_db": evm}
    log(f"c5_sharded axes: ok  {AXES_FRAMES} C3 frames at {AXES_SNR} dB, "
        f"bit-exact; rx_aligned {res['rx_aligned_ms']:.2f} ms, frame axis "
        f"(4, 1) {res['frame']['ms']:.2f} ms, stage axis (2 stages, "
        f"{AXES_MICRO} microbatches) {res['stage']['ms']:.2f} ms, equal to "
        "rx_aligned (payloads, crc_ok; EVM within "
        f"{max(res['frame']['max_evm_diff_db'], res['stage']['max_evm_diff_db']):.2g} dB)")
    return res, noisy, outs


def phase_two_cards(torch, spec, stacks, pays) -> dict | None:
    """With two cards or more: the resident point over a (1, 2) mesh of
    cuda:0 and cuda:1 (Cb = chunk / 2 per card, 2K steps a dispatch) with
    the halo kernel, whose last shard on cuda:0 reads cuda:1's head by
    peer access; every frame decoded. None on a one-card machine."""
    from ofdm_uhd_tpu_torch.kernels import policy
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import make_mesh
    if torch.cuda.device_count() < 2:
        log("c5_sharded two cards: not run (this machine has one card)")
        return None
    chunk, k = C5_RESIDENT[0] // 2, 2 * C5_RESIDENT[1]
    mesh = make_mesh(1, 2, [torch.device("cuda", i) for i in range(2)])
    rx = StreamRx(spec, mesh=mesh, chunk_len=chunk, steps_per_dispatch=k,
                  pallas_halo=True)
    policy.reset_launches()
    t0 = time.perf_counter()
    got = rx.process_device([s.view(k, chunk) for s in stacks[0]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = policy.launches()
    check(launches["halo"] > 0, "two cards: the halo kernel never ran")
    dups = check_stream("c5_sharded two cards", got, pays, spec, rx.cb)
    peer = {"halo_peer": hold_halo(torch, spec, mesh, stacks[0][0][0][:chunk])}
    log_kernels("c5_sharded two cards", peer)
    log(f"c5_sharded two cards: ok  {pays.shape[0]} frames bit-exact over "
        f"(1, 2) on two cards ({len(dups)} boundary duplicates), first "
        f"run {wall:.2f} s, halo launches {launches['halo']}")
    return {"frames_ok": pays.shape[0], "first_run_s": wall,
            "launches": launches, "kernels": peer}


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def hosted_store():
    """A TCPStore this process serves for one spawn's workers (clients
    under worker_env()), held until the last reference goes, after they
    have exited."""
    from ofdm_uhd_tpu_torch.shard import spawn
    return spawn.hosted_store(DIST_TIMEOUT_S)


def worker_env(agent_store: bool = True, **extra) -> dict:
    """A worker's environment (shard/spawn.py): under agent_store a client
    of a hosted store, else rank 0 serves the store at MASTER_PORT."""
    from ofdm_uhd_tpu_torch.shard import spawn
    return spawn.worker_env(ROOT, agent_store, threads=None, **extra)


def wait_all(procs, label) -> list[str]:
    """Wait for processes started together, each within DIST_TIMEOUT_S of
    the first wait; a hung one kills them all and fails the phase, as
    does a non-zero exit. Returns their stderr."""
    errs = []
    deadline = time.perf_counter() + DIST_TIMEOUT_S
    for p in procs:
        try:
            _, err = p.communicate(
                timeout=max(deadline - time.perf_counter(), 1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise SmokeFailure(f"{label}: a process hung past "
                               f"{DIST_TIMEOUT_S} s; all killed")
        errs.append(err)
    for p, err in zip(procs, errs):
        check(p.returncode == 0, f"{label}: a process exited "
              f"{p.returncode}: {err[-3000:]}")
    return errs


def run_workers(label, devices, backend, feed, tmp, rounds) -> list:
    """The distributed phase's workers (chip_smoke.py --worker), rank r on
    devices[r], each with C5_SHARDS / world shards; -> each rank's
    (frames .npz contents, report)."""
    import numpy as np
    world, store = len(devices), hosted_store()
    chunk, k = C5_RESIDENT
    procs = []
    for r, dev in enumerate(devices):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--worker",
             "--rank", str(r), "--world", str(world), "--port",
             str(store.port), "--device", str(dev), "--backend", backend,
             "--chunk", str(chunk), "--k", str(k), "--shards",
             str(C5_SHARDS), "--feed", feed, "--out",
             os.path.join(tmp, f"{label}_{r}"), "--rounds", str(rounds)],
            cwd=ROOT, env=worker_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    wait_all(procs, label)
    del store
    out = []
    for r in range(world):
        base = os.path.join(tmp, f"{label}_{r}")
        with np.load(base + ".npz") as z:
            frames = {key: z[key] for key in z.files}
        with open(base + ".json") as f:
            out.append((frames, json.load(f)))
    return out


def check_workers(label, workers, want, path) -> None:
    """Every rank's frames equal `want` (starts, crc_ok, payloads), the
    carried state is one replica on every rank, and each rank launched
    every kernel of `path` and no other."""
    import numpy as np
    for r, (fr, rep) in enumerate(workers):
        check(fr["starts"].tolist() == [f.start for f in want]
              and fr["crc_ok"].tolist() == [f.crc_ok for f in want]
              and np.array_equal(fr["payloads"], np.array(
                  [f.payload for f in want])),
              f"{label}: rank {r}'s frames differ from the in-process "
              "c5_sharded run's")
        for key in fr:
            if key.startswith("state_"):
                check(np.array_equal(fr[key], workers[0][0][key]),
                      f"{label}: rank {r}'s {key} differs from rank 0's")
        for name, n in rep["launches"].items():
            check((n > 0) == (name in path), f"{label}: rank {r} launched "
                  f"the {name} kernel {n} times")


def run_pod_rx(device, cap, want, tmp) -> dict:
    """cli.pod_rx --distributed as two processes under torchrun's
    environment set by hand, rank 0 serving the store at MASTER_PORT as
    README.md's launch by hand does (gloo: both on `device`), on C5's
    capture in a
    .npy file, at the resident point's chunk over C5_SHARDS entries:
    rank 0's bits must be the in-process run's payloads, and both ranks'
    summary lines agree up to their throughputs."""
    import numpy as np
    path, bits = os.path.join(tmp, "c5.npy"), os.path.join(tmp, "bits.npy")
    np.save(path, cap)
    from ofdm_uhd_tpu_torch.shard.spawn import rank0_port
    port = rank0_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ofdm_uhd_tpu_torch.cli.pod_rx", "--config",
         "c5", "--capture", path, "--chunk", str(C5_RESIDENT[0]),
         "--devices", str(C5_SHARDS), "--device", str(device),
         "--distributed", "--dist-backend", "gloo", "--bits-out", bits],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, env=worker_env(False, MASTER_ADDR="127.0.0.1",
                                  MASTER_PORT=str(port), RANK=str(r),
                                  WORLD_SIZE=str(DIST_WORLD),
                                  LOCAL_RANK=str(r)))
        for r in range(DIST_WORLD)]
    errs = wait_all(procs, "distributed pod_rx")
    wall = time.perf_counter() - t0
    lines = [e.strip().splitlines()[-1] for e in errs]
    check(len({line.split(" dB;")[0] for line in lines}) == 1,
          f"distributed pod_rx: the ranks' summaries differ: {lines}")
    got = np.load(bits)
    check(np.array_equal(got, np.array([f.payload for f in want])),
          "distributed pod_rx: the bits differ from the in-process run's")
    log(f"distributed pod_rx: ok  2 processes (gloo, {device}), "
        f"{got.shape[0]} frames bit-exact, {wall:.1f} s; " + " | ".join(
            lines))
    return {"frames": int(got.shape[0]), "wall_s": wall, "summaries": lines}


def window_geometry(spec, batch) -> tuple:
    """The windows K4w decodes with at a decode batch of `batch`, as the
    algorithm is chosen there: XLA_WINDOW for 'windowed', FUSED_WINDOW
    for 'fused' (C5 trellis: 'windowed' 512/96 above 96 slots)."""
    from ofdm_uhd_tpu_torch.kernels import policy, viterbi
    return (viterbi.XLA_WINDOW if policy.viterbi_impl(
        0, batch, spec.kernel_backend, spec.viterbi_mode) == "windowed"
        else viterbi.FUSED_WINDOW)


def hold_distributed(torch, spec, device, chunk, shards=C5_SHARDS,
                     per=C5_SHARDS // DIST_WORLD, label="distributed"
                     ) -> dict:
    """A distributed stream's kernels against their plain versions at one
    worker's shapes, on the first step's window of a (1, shards) time
    axis (a frame row) at the chunk length of `chunk`: rank 0's rows
    [per, Cb + H] of it (a worker cuts its shards' rows from the window
    it builds whole, and exchanges halos between them), their slots
    zero-padded from mf to the reshard's f2 a shard (the demodulation's
    batch: per * f2 slots), K4w at the windows the algorithm takes at f2,
    and, where a worker holds more than one shard, K10 over a mesh of
    `per` shards at the same Cb (one process's exchange)."""
    from ofdm_uhd_tpu_torch.shard import make_mesh
    step, window = first_sharded_window(
        torch, spec, make_mesh(1, shards, [device] * shards), chunk)
    f2 = -(-step.mf // step.t) * step.t
    ins, stages = phase_stages(
        torch, spec, f"{label} rank 0", None, step.mf, front=(
            f"agc+halo ({shards} rows, {per} kept)",
            lambda: step.extend(agc_window(window))[0][:per]),
        algo_batch=f2, slots=f2)
    kernels = phase_kernels(torch, spec, label, ins, C5_PATH[:-1])
    geometry = window_geometry(spec, f2)
    vit = {f"{k}_{geometry[0]}": v for k, v in hold_windowed(
        torch, ins["llr"], geometry, label).items()}
    del ins
    kernels.update(vit)
    if per > 1:
        kernels["halo"] = hold_halo(
            torch, spec, make_mesh(1, per, [device] * per),
            chunk[:chunk.shape[0] // shards * per])
    log_kernels(label, {k: v for k, v in kernels.items()
                        if k in vit or k == "halo"})
    return {"stages_ms": stages, "kernels": kernels}


def run_distributed(torch, spec, device, cap, pays, stacks, want) -> dict:
    """The stream over a mesh that spans processes: C5's resident point
    (the stacks of the first feed) over (1, C5_SHARDS) in DIST_WORLD
    worker processes on `device`, gloo between them (NCCL takes one
    process a card), with the halo kernel, the reshard and the TRACK
    retry, against the in-process c5_sharded run's frames `want`, its
    kernels first held at one worker's shapes (hold_distributed); then
    cli.pod_rx as two processes; then, with two cards or more, NCCL on 2
    and 4 cards (one process a card), each timed in interleaved rounds
    against the one-process, one-card receiver."""
    import tempfile
    import numpy as np
    per = C5_SHARDS // DIST_WORLD
    path = (C5_PATH + (("halo",) if per > 1 else ())
            if device.type == "cuda" else ())
    res = hold_distributed(torch, spec, device, stacks[0][0][0])
    with tempfile.TemporaryDirectory() as tmp:
        feed = os.path.join(tmp, "feed.npy")
        np.save(feed, torch.cat([s.reshape(-1) for s in stacks[0]]).cpu()
                .numpy())
        t0 = time.perf_counter()
        workers = run_workers("gloo", [device] * DIST_WORLD, "gloo", feed,
                              tmp, 0)
        check_workers("distributed gloo", workers, want, path)
        res["gloo"] = [rep for _, rep in workers]
        res["launches"] = {name: sum(rep["launches"][name]
                                     for _, rep in workers)
                           for name in workers[0][1]["launches"]}
        log(f"distributed gloo: ok  {DIST_WORLD} processes on {device}, "
            f"{per} shards each, halo kernel + reshard + TRACK: "
            f"{len(want)} slots, starts, crc_ok and payloads equal to the "
            "in-process c5_sharded run's on every rank, the state one "
            f"replica; {time.perf_counter() - t0:.1f} s with start-up; "
            f"first runs " + ", ".join(
                f"{rep['first_run_s']:.2f}" for _, rep in workers)
            + " s; launches " + "; ".join(
                f"rank {r} {nonzero(rep['launches'])}" for r, (_, rep)
                in enumerate(workers)))
        res["pod_rx"] = run_pod_rx(device, cap, want, tmp)
        res["nccl"] = {}
        for n in (2, 4):
            if device.type != "cuda" or torch.cuda.device_count() < n:
                log(f"distributed nccl on {n} cards: not run (this machine "
                    f"has {torch.cuda.device_count()} cards)")
                continue
            cards = [torch.device("cuda", i) for i in range(n)]
            workers = run_workers(f"nccl{n}", cards, "nccl", feed, tmp,
                                  ROUNDS_DIST)
            check_workers(f"distributed nccl {n} cards", workers, want,
                          C5_PATH + (("halo",) if C5_SHARDS // n > 1
                                     else ()))
            rounds = workers[0][1]["rounds_ms_per_step"]
            res["nccl"][n] = {"launches": [rep["launches"]
                                           for _, rep in workers],
                              "rounds_ms_per_step": rounds}
            log(f"distributed nccl on {n} cards: ok  frames equal on "
                f"every rank; ms per step in {ROUNDS_DIST} interleaved "
                "rounds: " + ", ".join(
                    f"{k} {statistics.median(v):.3f} ({' / '.join(f'{x:.3f}' for x in v)})"
                    for k, v in rounds.items()))
    return res


def dist_worker(args) -> int:
    """One rank of the distributed phase (chip_smoke.py --worker): C5's
    resident point (--feed, [dispatches * K * chunk] complex64) over a
    (1, --shards) mesh spanning --world processes, --shards / world
    entries of --device each, with the halo kernel, the reshard and the
    TRACK retry, under the launch counters; its frames and state to
    --out.npz, its counts and times to --out.json. With --rounds, the
    receiver is timed again in that many rounds, each followed by a
    one-process receiver (one shard, --device) on rank 0 alone."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.kernels import policy
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard.mesh import init_distributed, make_mesh
    device = init_distributed(f"127.0.0.1:{args.port}", args.world,
                              args.rank, backend=args.backend,
                              device=args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spec = config("c5").with_(kernel_backend="auto")
    chunk, k = args.chunk, args.k
    feed = np.load(args.feed)
    per = chunk * k
    stacks = [torch.from_numpy(feed[d * per:(d + 1) * per].reshape(
        k, chunk)).to(device) for d in range(feed.shape[0] // per)]
    mesh = make_mesh(1, args.shards, [device] * (args.shards // args.world))

    def make():
        return StreamRx(spec, mesh=mesh, chunk_len=chunk,
                        steps_per_dispatch=k, pallas_halo=True,
                        reshard=True, track_mode=True)
    rx = make()
    sync()
    policy.reset_launches()
    t0 = time.perf_counter()
    frames = rx.process_device(stacks)
    sync()
    first_s = time.perf_counter() - t0
    launches = policy.launches()
    steps = rx._steps
    rounds = {"distributed": [], "one_process": []}
    for _ in range(args.rounds):
        timed = make()
        dist.barrier()
        t0 = time.perf_counter()
        timed.process_device(stacks)
        sync()
        rounds["distributed"].append((time.perf_counter() - t0) * 1e3
                                     / steps)
        dist.barrier()
        if args.rank == 0:
            one = StreamRx(spec, chunk_len=chunk, steps_per_dispatch=k,
                           device=device)
            t0 = time.perf_counter()
            one.process_device(stacks)
            sync()
            rounds["one_process"].append((time.perf_counter() - t0) * 1e3
                                         / steps)
        dist.barrier()
    np.savez(args.out + ".npz",
             starts=np.array([f.start for f in frames], np.int64),
             crc_ok=np.array([f.crc_ok for f in frames], bool),
             payloads=np.array([f.payload for f in frames], np.uint8),
             **{"state_" + key: v
                for key, v in rx.state.to_numpy().items()})
    with open(args.out + ".json", "w") as f:
        json.dump({"rank": args.rank, "backend": dist.get_backend(),
                   "device": str(device), "launches": launches,
                   "first_run_s": first_s, "steps": steps,
                   "rescued": rx.rescued, "rounds_ms_per_step": rounds}, f)
    dist.destroy_process_group()
    return 0


# the kernels each step of the distributed axes phase launches: config
# ("c3") routes 'xla' with viterbi_mode 'scan', so the frame axis (at the
# whole batch) and the stage axis (at a microbatch) both decode whole
# sequences (K4); the stream decodes as C5 does (and exchanges halos by
# K10 between the shards of one process: axes_path)
AXES_PATHS = {"frame": ("fft", "viterbi"), "stage": ("fft", "viterbi"),
              "stream": C5_PATH}
# the stream's meshes in the gloo run, (2, 2) and (2, 4): each frame row
# over two processes, with one shard each or two
AXES_STREAMS = ((2, 2), (2, 4))


def axes_steps(steps: str) -> list[tuple]:
    """'frame:4x1,stage,stream:2x2' -> [(name, (F, T) or None), ...]."""
    out = []
    for step in steps.split(","):
        name, _, shape = step.partition(":")
        out.append((name, tuple(int(v) for v in shape.split("x"))
                    if shape else None))
    return out


def axes_path(name: str, world: int) -> tuple:
    """The kernels step `name` ('stream:2x4') launches over `world`
    processes: AXES_PATHS's, and K10 for a stream whose processes hold
    more than one shard each."""
    (step, shape), = axes_steps(name)
    halo = step == "stream" and shape[0] * shape[1] > world
    return AXES_PATHS[step] + (("halo",) if halo else ())


def run_axes_workers(label, devices, backend, steps, files, tmp, rounds
                     ) -> list:
    """The distributed axes phase's workers (chip_smoke.py --worker
    --steps ...), rank r on devices[r]; files: (the C3 batch, the C5
    feed) .npy paths -> each rank's (arrays .npz contents, report)."""
    import numpy as np
    world, store = len(devices), hosted_store()
    chunk, k = C5_RESIDENT
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--worker",
         "--steps", steps, "--rank", str(r), "--world", str(world),
         "--port", str(store.port), "--device", str(dev), "--backend",
         backend, "--chunk", str(chunk), "--k", str(k), "--batch", files[0],
         "--feed", files[1], "--out", os.path.join(tmp, f"{label}_{r}"),
         "--rounds", str(rounds)],
        cwd=ROOT, env=worker_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r, dev in enumerate(devices)]
    wait_all(procs, label)
    del store
    out = []
    for r in range(world):
        base = os.path.join(tmp, f"{label}_{r}")
        with np.load(base + ".npz") as z:
            arrays = {key: z[key] for key in z.files}
        with open(base + ".json") as f:
            out.append((arrays, json.load(f)))
    return out


def batch_record(out: dict) -> dict:
    """A batch result's keys as (dtype, shape) and the digests of its
    payloads and crc_ok, by which a worker's result compares with this
    process's."""
    return {"like": {k: [str(v.dtype), list(v.shape)] for k, v in out.items()},
            "payload": bits_digest(out["payload"]),
            "crc_ok": bits_digest(out["crc_ok"])}


def check_axes(label, workers, want, on_card) -> None:
    """Every rank's every step equal to this process's run of it: `want`
    = {step: batch dict, or the stream's frames}: payloads and crc_ok bit
    for bit (digests), every key of the one-process dict with its dtype
    and shape, n_ok_global equal, EVM and mean_evm_global within 0.01 dB;
    the stream's starts, crc_ok and payloads equal, EVM within 0.01 dB,
    its state one replica. On a card each rank launched only its step's
    path's kernels, and the ranks together every one of them (on the CPU
    none: the plain versions run there)."""
    import numpy as np
    for name, got in want.items():
        step = name.split(":")[0]
        for r, (arr, rep) in enumerate(workers):
            if step == "stream":
                check(arr[f"{name}_starts"].tolist() == [f.start for f in got]
                      and arr[f"{name}_crc_ok"].tolist()
                      == [f.crc_ok for f in got]
                      and np.array_equal(arr[f"{name}_payloads"], np.array(
                          [f.payload for f in got])),
                      f"{label}: rank {r}'s {name} frames differ from the "
                      "in-process run's")
                evm = float(np.abs(arr[f"{name}_evm"] - np.array(
                    [f.evm_db for f in got])).max())
                for key in arr:
                    if key.startswith(f"{name}_state_"):
                        check(np.array_equal(arr[key], workers[0][0][key]),
                              f"{label}: rank {r}'s {key} differs from "
                              "rank 0's")
            else:
                rec, mine = batch_record(got), rep["steps"][name]
                check(all(mine[k] == rec[k] for k in rec),
                      f"{label}: rank {r}'s {name} result differs from the "
                      f"in-process run's: {mine} against {rec}")
                evm = float(np.abs(arr[f"{name}_evm_db"] - got["evm_db"].cpu()
                                   .numpy()).max())
                if "n_ok_global" in got:
                    check(mine["n_ok_global"] == int(got["n_ok_global"])
                          and abs(mine["mean_evm_global"]
                                  - float(got["mean_evm_global"])) <= 0.01,
                          f"{label}: rank {r}'s {name} metrics differ")
            check(evm <= 0.01, f"{label}: rank {r}'s {name} EVM differs by "
                  f"{evm} dB")
            rep["steps"][name]["max_evm_diff_db"] = evm
        path = axes_path(name, len(workers)) if on_card else ()
        launched = {k for _, rep in workers
                    for k, n in rep["steps"][name]["launches"].items() if n}
        check(launched == set(path), f"{label}: {name} launched {launched}, "
              f"its path is {path}")


def axes_worker(args) -> int:
    """One rank of the distributed axes phase (chip_smoke.py --worker
    --steps ...): each step over a mesh spanning --world processes on
    --device under --backend, under the launch counters: 'frame:FxT'
    rx_frames_sharded over an (F, T) mesh, 'stage' rx_aligned_pipelined
    over 2 stages (AXES_MICRO microbatches), both on the C3 batch
    (--batch), 'stream:FxT' C5's resident point (--feed, --chunk, --k)
    over an (F, T) mesh with the halo kernel, the reshard and the TRACK
    retry; each process owns F * T / world entries. Its results to
    --out.npz and --out.json. With --rounds, the steps are timed in that
    many rounds (host clock, every card synchronized), each followed, on
    rank 0 alone, by the one-process runs over the same cards (the same
    mesh, driven by one process) and on one card (rx_aligned, the
    one-shard stream)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.kernels import policy
    from ofdm_uhd_tpu_torch.pipeline import RxPipeline, StreamRx
    from ofdm_uhd_tpu_torch.shard import make_mesh, rx_frames_sharded
    from ofdm_uhd_tpu_torch.shard.mesh import (Mesh, init_distributed,
                                               make_stage_mesh)
    from ofdm_uhd_tpu_torch.shard.stage_pipeline import rx_aligned_pipelined
    device = init_distributed(f"127.0.0.1:{args.port}", args.world,
                              args.rank, backend=args.backend,
                              device=args.device)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
    c3 = config("c3")
    c5 = config("c5").with_(kernel_backend="auto")
    batch = torch.from_numpy(np.load(args.batch)).to(device)
    chunk, k = args.chunk, args.k
    feed = np.load(args.feed)
    per = chunk * k
    stacks = [torch.from_numpy(feed[d * per:(d + 1) * per].reshape(
        k, chunk)).to(device) for d in range(feed.shape[0] // per)]
    runs, one = {}, {}
    for name, shape in axes_steps(args.steps):
        key = name if shape is None else f"{name}:{shape[0]}x{shape[1]}"
        if name == "stage":
            mesh = make_stage_mesh(2, [device])
            runs[key] = (lambda m=mesh: rx_aligned_pipelined(
                c3, m, AXES_MICRO)(batch))
            single = Mesh(mesh.devices, mesh.axis_names)
            one[f"{key} one process"] = (
                lambda m=single: rx_aligned_pipelined(c3, m, AXES_MICRO)(
                    batch))
            continue
        mesh = make_mesh(*shape, [device] * (shape[0] * shape[1]
                                             // args.world))
        single = Mesh(mesh.devices, mesh.axis_names)
        if name == "frame":
            runs[key] = (lambda fn=rx_frames_sharded(c3, mesh): fn(batch))
            one[f"{key} one process"] = (
                lambda fn=rx_frames_sharded(c3, single): fn(batch))
        else:
            def stream(m, kw=dict(chunk_len=chunk, steps_per_dispatch=k,
                                  pallas_halo=True, reshard=True)):
                rx = StreamRx(c5, mesh=m, **kw)
                return rx.process_device(stacks), rx
            runs[key] = (lambda m=mesh: stream(m))
            one[f"{key} one process"] = (lambda m=single: stream(m))
    arrays, report = {}, {"rank": args.rank, "backend": dist.get_backend(),
                          "device": str(device), "steps": {},
                          "rounds_ms": {}}
    for key, fn in runs.items():
        sync()
        policy.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        rec = {"first_run_s": time.perf_counter() - t0,
               "launches": policy.launches()}
        if key.startswith("stream"):
            frames, rx = out
            arrays.update({
                f"{key}_starts": np.array([f.start for f in frames],
                                          np.int64),
                f"{key}_crc_ok": np.array([f.crc_ok for f in frames], bool),
                f"{key}_payloads": np.array([f.payload for f in frames],
                                            np.uint8),
                f"{key}_evm": np.array([f.evm_db for f in frames]),
                **{f"{key}_state_{n}": v
                   for n, v in rx.state.to_numpy().items()}})
            rec["steps"] = rx._steps
        else:
            rec.update(batch_record(out))
            arrays[f"{key}_evm_db"] = out["evm_db"].cpu().numpy()
            if "n_ok_global" in out:
                rec["n_ok_global"] = int(out["n_ok_global"])
                rec["mean_evm_global"] = float(out["mean_evm_global"])
        report["steps"][key] = rec
        del out
    if args.rounds:
        fused = RxPipeline(c3).rx_aligned
        one["rx_aligned one card"] = lambda: fused(batch)
        if any(key.startswith("stream") for key in runs):
            one["stream one card"] = lambda: StreamRx(
                c5, chunk_len=chunk, steps_per_dispatch=k,
                device=device).process_device(stacks)
        times = {key: [] for key in list(runs) + list(one)}
        for _ in range(args.rounds):
            for key, fn in runs.items():
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                sync()
                times[key].append((time.perf_counter() - t0) * 1e3)
            dist.barrier()
            if args.rank == 0:
                for key, fn in one.items():
                    t0 = time.perf_counter()
                    fn()
                    sync()
                    times[key].append((time.perf_counter() - t0) * 1e3)
            dist.barrier()
        report["rounds_ms"] = times
    np.savez(args.out + ".npz", **arrays)
    with open(args.out + ".json", "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def hold_axes(torch, spec, part, label) -> dict:
    """The frame and stage axes' kernels against their plain versions at
    one worker's shapes: `part`, the frames one process decodes at once
    (a part of the frame axis's batch, or one microbatch of the stage
    axis): K3 forward and inverse on its windows and grid, K4 on its
    LLRs (AXES_PATHS)."""
    return phase_kernels(torch, spec, label, demod_ins(torch, spec, part),
                         ("fft", "viterbi"))


def axes_inputs(torch, device, batch, outs, stacks, tmp
                ) -> tuple[dict, tuple]:
    """What the distributed axes' workers are held against and fed:
    phase_axes's in-process outputs `outs` ('frame', 'stage') and this
    process's runs of C5's resident stream (the stacks of the first feed)
    on the AXES_STREAMS virtual meshes ('stream:2x2', 'stream:2x4'); and
    the workers' input files under tmp (the C3 batch, the C5 feed)."""
    import numpy as np
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.pipeline import StreamRx
    from ofdm_uhd_tpu_torch.shard import make_mesh
    chunk, k = C5_RESIDENT
    outs = dict(outs)
    for f, t in AXES_STREAMS:
        rx = StreamRx(config("c5").with_(kernel_backend="auto"),
                      mesh=make_mesh(f, t, [device] * (f * t)),
                      chunk_len=chunk, steps_per_dispatch=k,
                      pallas_halo=True, reshard=True)
        outs[f"stream:{f}x{t}"] = rx.process_device(stacks[0])
    files = (os.path.join(tmp, "batch.npy"), os.path.join(tmp, "feed.npy"))
    np.save(files[0], batch.cpu().numpy())
    np.save(files[1], torch.cat([s.reshape(-1) for s in stacks[0]])
            .cpu().numpy())
    return outs, files


def wanted(outs, steps) -> dict:
    """Each step's in-process result, by the step's name: the stream's by
    its mesh ('stream:2x2'), the frame and stage axes' by the axis."""
    return {s: outs[s] if s in outs else outs[s.split(":")[0]]
            for s in steps}


def log_launches(label, workers) -> None:
    for r, (_, rep) in enumerate(workers):
        log(f"{label} rank {r} launches: " + "; ".join(
            f"{s} {nonzero(v['launches'])}"
            for s, v in rep["steps"].items()))


def run_axes_nccl(torch, batch, outs, files, tmp) -> tuple[dict, dict]:
    """With two cards or more, NCCL, one process a card: the frame axis
    (2, 1) and the stage axis on 2 cards, the frame batch and the stream
    on (2, 2) on 4 (the stream: one process a frame row's entry, two
    processes a row), each checked against the in-process runs `outs` as
    the gloo workers are, and timed in ROUNDS_DIST interleaved rounds
    against one process over the same cards and one process on one
    card. Where they run, K3 and K4 are first held at the frame part
    those ranks decode (half the batch; a stage microbatch and the
    stream's row are the gloo workers' shapes). -> ({cards: reports,
    rounds and the card's name and power limit}, the holds)."""
    from ofdm_uhd_tpu_torch.core.spec import config
    res, kernels = {}, {}
    for n, steps in ((2, ("frame:2x1", "stage")),
                     (4, ("frame:2x2", "stream:2x2"))):
        if not torch.cuda.is_available() or torch.cuda.device_count() < n:
            log(f"axes_distributed nccl on {n} cards: not run (this "
                f"machine has {torch.cuda.device_count()} cards)")
            continue
        if not kernels:
            kernels = {f"{k}_nccl": v for k, v in hold_axes(
                torch, config("c3"), batch[:AXES_FRAMES // 2],
                "axes_distributed nccl").items()}
        cards = [torch.device("cuda", i) for i in range(n)]
        workers = run_axes_workers(f"axes_nccl{n}", cards, "nccl",
                                   ",".join(steps), files, tmp, ROUNDS_DIST)
        check_axes(f"axes_distributed nccl {n} cards", workers,
                   wanted(outs, steps), True)
        rounds = workers[0][1]["rounds_ms"]
        res[n] = {"reports": [rep for _, rep in workers],
                  "rounds_ms": rounds, "card": card_line()}
        log(f"axes_distributed nccl on {n} cards ({res[n]['card']}): ok  "
            "every rank equal to the in-process runs; ms a run in "
            f"{ROUNDS_DIST} interleaved rounds: " + ", ".join(
                f"{key} {statistics.median(v):.3f} "
                f"({' / '.join(f'{x:.3f}' for x in v)})"
                for key, v in rounds.items()))
        log_launches(f"axes_distributed nccl {n} cards", workers)
    return res, kernels


def run_axes_distributed(torch, device, batch, outs, stacks) -> dict:
    """The frame and stage axes, and the stream on 2-D meshes, across
    processes. First their kernels held at one worker's shapes
    (hold_axes; hold_distributed on a frame row of 2 shards, one a
    worker, and of 4, two a worker with K10 between them). Then
    AXES_WORLD worker processes sharing `device` under gloo (NCCL takes
    one process a card), one spawn for every step: phase_axes's C3
    `batch` over a (4, 1) frame axis and over the stage axis (ranks 0
    and 1; ranks 2 and 3 own no entry), each equal to phase_axes's
    in-process run (`outs`); C5's resident point (the stacks of the first
    feed) over each of AXES_STREAMS (two frame rows, each a replica over
    two processes), equal to this process's run on the same virtual
    mesh; their launches per rank. Then, with two cards or more,
    run_axes_nccl. The path's launches sum every rank of every run."""
    import tempfile
    from ofdm_uhd_tpu_torch.core.spec import config
    from ofdm_uhd_tpu_torch.kernels import policy
    c5 = config("c5").with_(kernel_backend="auto")
    kernels = hold_axes(torch, config("c3"),
                        batch[:AXES_FRAMES // AXES_WORLD], "axes_distributed")
    stages = {}
    for f, t in AXES_STREAMS:
        per = f * t // AXES_WORLD
        held = hold_distributed(
            torch, c5, device, stacks[0][0][0], shards=t, per=per,
            label=f"axes_distributed stream {f}x{t}")
        kernels.update({f"{k}_stream{f}x{t}": v
                        for k, v in held["kernels"].items()})
        stages[f"{f}x{t}"] = held["stages_ms"]
    res = {"kernels": kernels, "stream_stages_ms": stages}
    with tempfile.TemporaryDirectory() as tmp:
        outs, files = axes_inputs(torch, device, batch, outs, stacks, tmp)
        want = wanted(outs, ("frame:4x1", "stage") + tuple(
            f"stream:{f}x{t}" for f, t in AXES_STREAMS))
        t0 = time.perf_counter()
        workers = run_axes_workers("axes_gloo", [device] * AXES_WORLD,
                                   "gloo", ",".join(want), files, tmp, 0)
        check_axes("axes_distributed gloo", workers, want,
                   device.type == "cuda")
        res["gloo"] = [rep for _, rep in workers]
        log(f"axes_distributed gloo: ok  {AXES_WORLD} processes on {device}: "
            f"{AXES_FRAMES} C3 frames over the frame axis (4, 1) and the "
            f"stage axis (2 stages, {AXES_MICRO} microbatches; ranks 2, 3 "
            "own no entry), every rank's result equal to the in-process "
            "run's (payloads, crc_ok, every key's dtype and shape, "
            "n_ok_global; EVM within 0.01 dB); C5's resident stream over "
            + " and ".join(f"({f}, {t})" for f, t in AXES_STREAMS)
            + f": {len(outs['stream:2x2'])} slots equal to the in-process "
            "run's on the same mesh on every rank, the state one replica; "
            f"{time.perf_counter() - t0:.1f} s with start-up; first runs "
            + "; ".join(f"rank {r} " + ", ".join(
                f"{s} {v['first_run_s']:.2f} s"
                for s, v in rep["steps"].items())
                for r, (_, rep) in enumerate(workers)))
        log_launches("axes_distributed gloo", workers)
        res["nccl"], held = run_axes_nccl(torch, batch, outs, files, tmp)
        kernels.update(held)
    reports = res["gloo"] + [rep for row in res["nccl"].values()
                             for rep in row["reports"]]
    res["launches"] = {name: sum(v["launches"][name] for rep in reports
                                 for v in rep["steps"].values())
                       for name in policy.KERNELS}
    return res


def big_path(spec) -> tuple:
    """The kernels a big_nsc spec's RX launches: the S&C tile kernel or
    the split route's two passes (l = n_sc / 2), K1, K2, K3 (its two
    passes above ONE_LAUNCH_N) and the spec's Viterbi."""
    from ofdm_uhd_tpu_torch.kernels import fft, policy, sync
    sc = (("scfront",) if sync.route(spec.n_sc // 2)[0][0] == "tile"
          else ("sc_span", "sc_stride"))
    ff = (("fft",) if len(fft.route(spec.n_sc)) == 1
          else ("fft_columns", "fft_rows_t"))
    vit = ("viterbi" if policy.viterbi_impl(
        0, None, spec.kernel_backend, spec.viterbi_mode) == "scan"
        else "viterbi_windowed")
    return sc + ("localize", "extract") + ff + (vit,)


def make_input_big(torch, spec, label, device):
    """BIG_CAPS captures (seeds 0..) of BIG_FRAMES frames from the port's
    TxPipeline on the card (K3's inverse, by its two-pass route above
    ONE_LAUNCH_N): sc16 planes [2, C, n], the sent payloads, the TX's
    launch counts."""
    import numpy as np
    from ofdm_uhd_tpu_torch.bench_lib import build_capture, to_sc16
    from ofdm_uhd_tpu_torch.kernels import fft, policy
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    policy.reset_launches()
    built = [build_capture(spec, BIG_FRAMES, GAP, seed=s, device=device)
             for s in range(BIG_CAPS)]
    torch.cuda.synchronize()
    launches = policy.launches()
    passes = ("fft_columns", "fft_rows_t")
    ran = (passes if len(fft.route(spec.n_sc)) > 1 else ("fft",))
    check(all(launches[k] > 0 for k in ran)
          and not any(launches[k] for k in {"fft", *passes} - set(ran)),
          f"{label} input: the TX launched {launches}")
    caps = np.stack([c for c, _ in built])
    pays = torch.from_numpy(np.stack([p for _, p in built])).to(device)
    iq = torch.from_numpy(to_sc16(caps)).to(device)
    log(f"{label} input: {BIG_CAPS} captures x {caps.shape[1]} samples, "
        f"{BIG_FRAMES} frames each, sc16, built in "
        f"{time.perf_counter() - t0:.1f} s; TX launches {launches}")
    return iq, pays, launches


def planes_close(valid_p, valid_e):
    """Plane sets [3, B, n] of the split route's span pass, over their
    valid parts (P's planes [:valid_p], the energy [:valid_e]): within
    REL_TOL of each plane's max."""
    def close(k, p):
        errs = [rel_close(k[i, :, :v], p[i, :, :v])
                for i, v in ((0, valid_p), (1, valid_p), (2, valid_e))]
        return all(ok for ok, _ in errs), max(e for _, e in errs)
    return close


def hold_sc_split(torch, label, cap, l) -> dict:
    """The S&C split route's passes on the main path's AGC'd captures [C,
    n] at lag l and the route's width w: the span pass and the stride pass
    (on the span kernel's set), each against its plain step, then the
    whole route against sc_frontend_plain (under sc_stride_route); each
    timed in-kernel. Where the tile kernel takes the lag, the route's P
    and M are checked bit for bit against it; their digest is logged."""
    from ofdm_uhd_tpu_torch.kernels import scfront, sync
    rows, n = cap.shape
    nd = n - 2 * l + 1
    w = sync.split_width(l)
    lg, lgw = l.bit_length() - 1, w.bit_length() - 1
    len_e, len_p = n - w + 1, n - l - w + 1
    set_bytes = 4.0 * rows * (len_e + 2 * len_p)
    a = sync._span_cuda(cap, l, w)
    runs = {
        "sc_span": (lambda: sync._span_cuda(cap, l, w),
                    lambda: sync.span_plain(cap, l, w),
                    planes_close(len_p, len_e), cap.shape,
                    (8.0 * rows * n + set_bytes,
                     rows * (10.0 * len_e + lgw * (len_e + 2.0 * len_p)))),
        "sc_stride": (lambda: sync._stride_cuda(a, l, w, True),
                      lambda: sync.stride_plain(a, l, w, True),
                      scfront_close, a.shape,
                      (set_bytes + 12.0 * rows * nd,
                       rows * nd * (3.0 * (lg - lgw) + 10))),
        "sc_stride_route": (lambda: sync.sc_kernels("scfront", cap, l, True),
                            lambda: scfront.sc_frontend_plain(cap, l),
                            scfront_close, cap.shape,
                            work_sc(rows, n, l, metric=True))}
    res = {}
    for key, (run_k, run_p, tol, shape, work) in runs.items():
        res[key] = held(torch, key, run_k, run_p, tol, shape, work)
        res[key]["device_ms"] = device_ms(torch, run_k)
    route = sync.sc_kernels("scfront", cap, l, True)
    res["sc_stride_route"]["bits"] = bits_digest(*route)
    res["sc_stride_route"]["width"] = w
    tile = "none (l above the tile kernel's lags)"
    if l <= sync.TILE_KERNEL_MAX_L:
        t = sync._tile_cuda("scfront", cap, nd, l, True)
        check(all(bool(torch.equal(x, y)) for x, y in zip(route, t)),
              f"{label}: the split route's bits differ from the tile "
              "kernel's")
        tile = "equal to the tile kernel's"
        del t
    del route, a
    log(f"{label} split route (W = {w}): P and M {tile}, digest "
        f"{res['sc_stride_route']['bits']}")
    log_kernels(label, res)
    return res


def hold_passes(torch, label, x) -> dict:
    """The two-pass route's passes on the inputs the route gives them from
    the main path's FFT windows x [..., n]: the column pass (its twiddles
    included) and the row pass, each within REL_TOL of max|y| of its plain
    step, in-kernel. No one PyTorch call computes either pass."""
    from ofdm_uhd_tpu_torch.kernels import fft
    n = x.shape[-1]
    xin = x.reshape(-1, n).contiguous()
    (_, n1, n2), _ = fft.route(n)
    tw = fft._route_twiddles(n1, n2, xin.device)
    rows = xin.shape[0]
    mid = fft._columns_cuda(xin, n1, n2, tw, False)
    fb, fo = work_fft(rows * n2, n1, n1, n1)
    runs = {
        f"fft_columns_{n1}x{n2}": (
            lambda: fft._columns_cuda(xin, n1, n2, tw, False),
            lambda: fft.columns_plain(xin, n1, n2, tw, False),
            (fb + 8.0 * n, fo + 6.0 * rows * n)),
        f"fft_rows_t_{n1}x{n2}": (
            lambda: fft._rows_t_cuda(mid, n1, n2, False),
            lambda: fft.rows_t_plain(mid, n1, n2, False),
            work_fft(rows * n1, n2, n2, n2))}
    res = {}
    for key, (run_k, run_p, work) in runs.items():
        res[key] = held(torch, key, run_k, run_p, rel_close, xin.shape, work)
        res[key]["device_ms"] = device_ms(torch, run_k)
    log_kernels(label, res)
    return res


def route_splits(torch, x) -> dict:
    """K3's two passes on x [rows, n] at every split n1 x n2 with n2 from
    PASS_MAX_N / 8 to PASS_MAX_N (512 .. 4096), and one launch where n <=
    ONE_LAUNCH_N, each within REL_TOL of max|y| of fft_plain: in-kernel
    ms in turns, {split: [first, second]}. route() takes the fastest."""
    from ofdm_uhd_tpu_torch.kernels import fft
    n = x.shape[-1]
    want = fft.fft_plain(x)
    runs = {}
    for n2 in (fft.PASS_MAX_N >> k for k in (3, 2, 1, 0)):
        n1 = n // n2
        if n1 < 2 or n1 > fft.PASS_MAX_N:
            continue
        tw = fft._route_twiddles(n1, n2, x.device)
        runs[f"{n1}x{n2}"] = (lambda n1=n1, n2=n2, tw=tw: fft._rows_t_cuda(
            fft._columns_cuda(x, n1, n2, tw, False), n1, n2, False))
    if n <= fft.ONE_LAUNCH_N:
        runs["one_launch"] = lambda: fft._fft_launch(x, False)
    for key, run in runs.items():
        ok, err = rel_close(run(), want)
        check(ok, f"fft {n} split {key}: differs from fft_plain by {err}")
    return in_turns(torch, runs, tuple(runs))


def hold_fft_sizes(torch, device) -> dict:
    """K3 at N = BIG_FFT_NS on seed-0 rows of BIG_FFT_SAMPLES samples in
    all: within REL_TOL of max|y| of fft_plain, in-kernel in turns with
    torch.fft.fft (ortho), its unscaled call beside; above PASS_MAX_N
    every split of the route in turns (route_splits)."""
    from ofdm_uhd_tpu_torch.kernels import fft
    g = torch.Generator(device=device).manual_seed(0)
    res = {}
    for n in BIG_FFT_NS:
        x = torch.randn((BIG_FFT_SAMPLES // n, n), dtype=torch.complex64,
                        generator=g, device=device)
        res[f"fft_n{n}"] = held(
            torch, f"fft {n}", lambda: fft._fft_cuda(x, False),
            lambda: fft.fft_plain(x), rel_close, x.shape,
            work_fft(x.shape[0], n, n, n),
            lambda: torch.fft.fft(x, norm="ortho"))
        fft_in_turns(torch, res[f"fft_n{n}"], lambda: fft._fft_cuda(x, False),
                     lambda: torch.fft.fft(x, norm="ortho"),
                     lambda: torch.fft.fft(x, norm="backward"))
        if n > fft.PASS_MAX_N:
            res[f"fft_n{n}"]["splits"] = route_splits(torch, x)
            log(f"big_nsc fft {n} splits, in-kernel ms: "
                + fmt_turns(res[f"fft_n{n}"]["splits"]))
        del x
    log_kernels("big_nsc fft", res)
    return res


def run_big_nsc(torch, device) -> dict:
    """RxPipeline.rx_capture_sc16 at n_sc = BIG_NSC (QPSK, CP n/8, 2 data
    symbols): the TX builds the captures on the card, the stages and
    kernels on the whole batch (the S&C split route's passes and K3's
    two passes each against its plain step), then the
    slice: every frame bit-exact, equal to the plain-forced run, every
    kernel of big_path launched and none of the other route's. Last, K3
    alone at N = 4096 .. 65536."""
    from ofdm_uhd_tpu_torch.core.spec import WaveformSpec
    from ofdm_uhd_tpu_torch.kernels import policy
    routes = {"scfront", "sc_span", "sc_stride", "fft", "fft_columns",
              "fft_rows_t"}
    out = {"kernels": {}, "slices": {}, "stages_ms": {},
           "launches": dict.fromkeys(policy.KERNELS, 0),
           "tx_launches": dict.fromkeys(policy.KERNELS, 0)}
    for n in BIG_NSC:
        spec = WaveformSpec(n_sc=n, cp=n // 8, modulation="qpsk",
                            n_data_syms=2)
        label = f"big_nsc {n}"
        path = big_path(spec)
        iq, pays, tx = make_input_big(torch, spec, label, device)
        max_frames = BIG_FRAMES + 2
        ins, out["stages_ms"][n] = phase_stages(torch, spec, label, iq,
                                                max_frames)
        kernels = phase_kernels(torch, spec, label, ins, tuple(
            k for k in path if k in ("scfront", "localize", "extract", "fft",
                                     "viterbi", "viterbi_windowed"))
            + (("fft",) if "fft_columns" in path else ()))
        if "sc_span" in path:
            kernels.update(hold_sc_split(torch, label, ins["cap"], n // 2))
        if "fft_columns" in path:
            syms, st = ins["syms"], ins["start"]
            kernels.update(hold_passes(torch, label, syms[..., st:st + n]))
        del ins
        sl = phase_slice(torch, spec, label, iq, iq ^ 1, pays, max_frames,
                         path, sc16=True, absent=tuple(routes - set(path)))
        out["slices"][n] = sl
        out["kernels"].update({f"{k}_{n}": v for k, v in kernels.items()})
        for k in policy.KERNELS:
            out["launches"][k] += sl["launches"][k]
            out["tx_launches"][k] += tx[k]
    out["kernels"].update(hold_fft_sizes(torch, device))
    return out


def path_launches(paths) -> dict:
    """Launches per kernel of every counted main-path run: each path's RX
    slice (C5: its two operating points; c5_sharded: its halo-kernel run;
    files: its in-process cli.rx; bench: its in-process cli.bench runs,
    their TX included; shift, tiers, k4w_ab, variants: their counted
    runs) and the
    TX input builds of C4, c4_bf16, the 'pallas' paths and big_nsc."""
    out = {}
    for p, r in paths.items():
        out[p] = r["launches"] if "launches" in r else r["slice"]["launches"]
        if "tx_launches" in r:
            out[p + "_tx"] = r["tx_launches"]
    return out


def held_kernel(key: str) -> str:
    """The kernel a check's key names ('fir_stride1' -> 'fir',
    'viterbi_windowed_256' -> 'viterbi_windowed')."""
    return max((n for n in KERNEL_INFO
                if key == n or key.startswith(n + "_")), key=len)


def kernel_entry(name, paths, by_path) -> dict:
    """One kernel's entry of the kernels line. Each kernel was held against
    its plain version on every path that runs it (fir also at stride 1,
    viterbi_windowed at both C5 geometries): max_abs_err is the worst over
    those checks, `paths` gives each check's numbers, and ms / plain_ms are
    those of the first path's check (C3's for the kernels C3 runs, C5
    resident's for viterbi_windowed, c3_pallas's for cpfft and ifftcp,
    c2_pallas's for sccorr, c5_sharded's for halo, c4_bf16's for fir_bf16
    and interp_bf16, the shift and tiers phases' for their kernels: the
    first check, C4's shape for the decimation and interpolation, C3's for
    banded_sc and deframe; the files and bench phases' checks come last),
    as are bound_ms, bound_by and library_ms.
    launches sums the counted main-path runs (every path's RX, the files
    phase's in-process cli.rx, the bench phase's in-process cli.bench
    runs, the TX input builds of C4, c4_bf16 and the 'pallas' paths, and
    the shift and tiers phases' counted runs), and
    launches_by_path splits them."""
    src, rep = KERNEL_INFO[name]
    held_on = {p + k[len(name):]: v for p, r in paths.items()
               for k, v in r["kernels"].items() if held_kernel(k) == name}
    first = next(iter(held_on.values()))
    counts = {p: c[name] for p, c in by_path.items()}
    return {"name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(counts.values()),
            "max_abs_err": max(v["max_abs_err"] for v in held_on.values()),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"],
            "launches_by_path": counts,
            "paths": {p: {k: v[k] for k in ("shape", "max_abs_err", "ms",
                                             "plain_ms", "bound_ms",
                                             "library_ms", "device_ms")
                          if k in v}
                      for p, v in held_on.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    ap.add_argument("--worker", action="store_true",
                    help="run as one rank of the distributed phase")
    for name in ("rank", "world", "port", "chunk", "k", "shards",
                 "rounds"):
        ap.add_argument(f"--{name}", type=int, help="(--worker)")
    for name in ("device", "backend", "feed", "batch", "steps"):
        ap.add_argument(f"--{name}", help="(--worker)")
    args = ap.parse_args()
    try:
        import torch
        from ofdm_uhd_tpu_torch.core.spec import config
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "repository's root", file=sys.stderr)
        return 2
    if args.worker:
        rc = axes_worker(args) if args.steps else dist_worker(args)
        from ofdm_uhd_tpu_torch.shard.spawn import exit_worker
        exit_worker(rc)
    try:
        dev_info = phase_device(torch)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        build_info = phase_build()
        c3 = run_c3(torch, config, device)
        files = run_files(torch, config, device)
        bench = run_bench(torch, device)
        harness = run_harness(torch, device)
        c4 = run_c4(torch, config, device)
        c4_bf16 = run_c4_bf16(torch, config, device, c4)
        c5, c5_sharded, distributed, axes_distributed = run_c5(
            torch, config, device)
        c3_pallas = run_c3_pallas(torch, config, device)
        k4w_ab = run_k4w_ab(torch, c3_pallas.pop("llr"))
        c2_pallas = run_c2_pallas(torch, config, device)
        variants = run_variants(torch, device)
        fir_inputs = c4.pop("fir_inputs")
        shift = run_shift(torch, device, fir_inputs)
        tiers = run_tiers(torch, device, fir_inputs, c3.pop("tier_inputs"))
        del fir_inputs
        big_nsc = run_big_nsc(torch, device)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # files and bench last: their checks join each kernel's `paths`, and
    # the first path's check stays the one kernel_entry names
    paths = {"c3": c3, "c4": c4, "c5": c5, "c5_sharded": c5_sharded,
             "distributed": distributed,
             "axes_distributed": axes_distributed, "c3_pallas": c3_pallas,
             "c2_pallas": c2_pallas,
             "c4_bf16": c4_bf16, "shift": shift, "tiers": tiers,
             "big_nsc": big_nsc, "k4w_ab": k4w_ab, "variants": variants,
             "files": files,
             "bench": bench, "harness": harness}
    by_path = path_launches(paths)
    line = {"kernels": [kernel_entry(k, paths, by_path)
                        for k in KERNEL_INFO]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": dev_info, "build": build_info, **paths},
                      f, indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
