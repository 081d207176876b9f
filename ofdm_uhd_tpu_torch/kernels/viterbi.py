"""K=7 rate-1/2 soft Viterbi decoders: two hand kernels + plain versions,
and the reference's choice among its three decoding algorithms.

Kernels (CUDA source: csrc/viterbi.cu), each tier picked by the tensor's
device (policy.py):

  * `viterbi` (K4): whole sequence, trellis pinned to state 0 at both
    ends; replaces ofdm_uhd_tpu/kernels/pallas_viterbi.py:viterbi_pallas
    with one window (`_run_windows`), bit-exact with the reference scan
    phy/bits.py:viterbi_decode. One group of G lanes decodes a sequence
    (csrc/viterbi_group.cuh), 64 / G states a lane: at G = 4, 8, 16
    regrouped through shared memory every log2(64 / G) steps, at G = 32
    (one warp) exchanged by a shuffle butterfly every step; survivors in
    records of 24 (20) steps; G from `k4_group` (the batch against the
    card's SMs);
  * `viterbi_windowed` (K4w): the sliding-window decode of
    pallas_viterbi.py:viterbi_pallas_windowed and phy/bits.py:
    viterbi_decode_windowed, with the window and overlap as arguments;
    one thread decodes one window (csrc/viterbi_window.cuh), its
    decisions in a scratch of e x windows x 8 bytes.

Both use the reference's arithmetic: branch metrics without the 0.5
factor, strict '>' (a tie keeps predecessor 0), and the window boundary
conditions of the reference (first window pinned to state 0, interior
windows uniform, the tail window terminated in state 0, the others traced
back from the first state that reaches the maximum).

The algorithm is the spec's and the batch's choice, as in the reference
(`decode`, after policy.viterbi_impl): the windowed decoders can differ
from the whole-sequence one on frames whose survivors do not merge, so
the port follows the reference's choice to give its bits on every slot.
"""

from __future__ import annotations

import numpy as np
import torch

from ..phy import tables as T
from . import build, policy

# window geometries (window, overlap) of the reference's two windowed
# decoders: pallas_viterbi.py:285 and phy/bits.py:201
FUSED_WINDOW = (256, 64)
XLA_WINDOW = (512, 96)
# viterbi_pallas's whole-sequence gate (pallas_viterbi.py:338-345): a
# trellis of e steps (n rounded up to a multiple of 8) decodes whole while
# e * bytes-per-step stays within 6 MiB, else in FUSED_WINDOW windows
_WHOLE_GATE_BYTES = 6 * 1024 * 1024
_STEP_BYTES = {"shuffle": 2 * 128 * 4 + 3 * 128 * 4,
               "mm": 32 * 64 * 4 + 3 * 128 * 4}
_BIG = 2048.0          # certainty-of-zero LLR of the padding steps
_NEG = -1e30
# K4's group sizes (lanes a sequence; csrc/viterbi.cu ofdm_viterbi) and the
# steps a survivor record covers at each (csrc/viterbi_group.cuh
# kRecordSteps, kButterflyRecord)
K4_GROUPS = (4, 8, 16, 32)
K4_RECORD_STEPS = {4: 24, 8: 24, 16: 24, 32: 20}
# k4_group's rule: (sequences an SM at least, group size), the first that
# holds; else 32. Timed in turns on an NVIDIA H100 80GB HBM3 (chip_smoke.py
# hold_k4): 4 lanes fastest at C3 (62 sequences an SM), 16 at c2_pallas
# (31.5), 32 at C4 (2.1) and big_nsc (0.2); each threshold lies between two
# of them. 8 lanes was never the fastest and is only taken when asked for.
K4_PER_SM = ((48, 4), (8, 16))


def _signs(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """+1/-1 code-bit signs of the p=0 branch into each state [64]; the p=1
    branch is their negation (both polys tap the oldest register bit)."""
    br_a = T.on_device(T.viterbi_tables, (), "br_a", device)
    br_b = T.on_device(T.viterbi_tables, (), "br_b", device)
    return (1.0 - 2.0 * br_a)[0], (1.0 - 2.0 * br_b)[0]


def _acs_plain(la: torch.Tensor, lb: torch.Tensor, pm: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ACS loop of phy/bits.py:viterbi_decode over rows: la, lb [R, n],
    pm [R, 64] initial metrics -> (final metrics [R, 64], decisions [n, R]
    int64, each step's 64 choices packed in one word: bit s = state s; bit
    63 rides the sign, which disjoint-bit sums and `>>` leave exact)."""
    rows, n = la.shape
    dev = la.device
    sa0, sb0 = _signs(dev)
    states = torch.arange(64, device=dev)
    pred_even = (states & 31) << 1
    pred_odd = pred_even | 1
    weights = torch.from_numpy(
        (np.uint64(1) << np.arange(64, dtype=np.uint64)).view(np.int64)
    ).to(dev)
    packed = torch.empty((n, rows), dtype=torch.int64, device=dev)
    for t in range(n):
        bm0 = sa0 * la[:, t, None] + sb0 * lb[:, t, None]      # [R, 64]
        c0 = pm[:, pred_even] + bm0
        c1 = pm[:, pred_odd] - bm0
        choice = c1 > c0                                      # tie -> pred 0
        pm = torch.where(choice, c1, c0)
        packed[t] = (choice * weights).sum(-1)
    return pm, packed


def _traceback_plain(packed: torch.Tensor, state: torch.Tensor
                     ) -> torch.Tensor:
    """Decisions [n, R] and the state after the last step [R] -> bits
    [R, n] u8."""
    n, rows = packed.shape
    bits = torch.empty((n, rows), dtype=torch.uint8, device=packed.device)
    state = state.to(torch.int64)
    for t in range(n - 1, -1, -1):
        bits[t] = (state >> 5) & 1
        state = ((state & 31) << 1) | ((packed[t] >> state) & 1)
    return bits.T.contiguous()


def viterbi_plain(llr: torch.Tensor) -> torch.Tensor:
    """llr [B, 2n] f32 (a/b interleaved, log P(0)/P(1)) -> bits [B, n] u8,
    whole sequence: starts and ends in state 0."""
    bsz = llr.shape[0]
    pm = torch.full((bsz, 64), _NEG, dtype=torch.float32, device=llr.device)
    pm[:, 0] = 0.0
    _, packed = _acs_plain(llr[:, 0::2].float(), llr[:, 1::2].float(), pm)
    return _traceback_plain(
        packed, torch.zeros(bsz, dtype=torch.int64, device=llr.device))


def window_geometry(n: int, window: int, overlap: int
                    ) -> tuple[int, int, np.ndarray]:
    """(owned length l, extended length e, window starts [W]) of an n-step
    trellis: starts clip(w*l - overlap, 0, n - e) as the reference's. A
    trellis of n <= e steps is one window, the whole sequence (l = e = n)."""
    e = window + 2 * overlap
    if n <= e:
        return n, n, np.zeros(1, dtype=np.int64)
    w = -(-n // window)
    return window, e, np.clip(np.arange(w) * window - overlap, 0, n - e)


def viterbi_windowed_plain(llr: torch.Tensor, window: int, overlap: int
                           ) -> torch.Tensor:
    """llr [B, 2n] -> bits [B, n] u8 by the sliding-window decode: the ACS
    loop of viterbi_plain over [B*W, 64] window metrics, each window
    traced back from its entry state, and only its owned span kept."""
    bsz, n = llr.shape[0], llr.shape[1] // 2
    dev = llr.device
    l, e, starts = window_geometry(n, window, overlap)
    w = len(starts)
    span = torch.from_numpy(starts[:, None] + np.arange(e)).to(dev)  # [W, e]
    la = llr[:, 0::2].float()[:, span].reshape(bsz * w, e)
    lb = llr[:, 1::2].float()[:, span].reshape(bsz * w, e)
    first = torch.from_numpy(np.tile(starts == 0, bsz)).to(dev)[:, None]
    tail = torch.from_numpy(np.tile(starts + e == n, bsz)).to(dev)[:, None]
    nonzero = torch.arange(64, device=dev) != 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    pm, packed = _acs_plain(la, lb, torch.where(first & nonzero, neg, zero))
    pm = pm + torch.where(tail & nonzero, neg, zero)
    # first state reaching the maximum (argmax's tie-break)
    mx = pm.max(dim=-1, keepdim=True).values
    entry = torch.where(pm >= mx, torch.arange(64, device=dev), 64).min(
        dim=-1).values
    bits = _traceback_plain(packed, entry).reshape(bsz, w * e)
    # global position p is owned by window p // l at offset p - start
    p = np.arange(n)
    wi = p // l
    own = torch.from_numpy(wi * e + p - starts[wi]).to(dev)
    return bits[:, own].contiguous()


def _check_llr(kernel: str, llr: torch.Tensor) -> None:
    if llr.dtype != torch.float32 or llr.dim() != 2 or llr.shape[1] % 2:
        raise ValueError(f"{kernel}: need float32 [B, 2n], got "
                         f"{llr.dtype} {tuple(llr.shape)}")
    build.check_inputs(kernel, llr)


def k4_group(batch: int, sms: int) -> int:
    """Lanes a sequence for K4 on a card of `sms` SMs. Many sequences an SM
    take few lanes (more states a lane, fewer instructions a state-step;
    the other warps hide each one's latency); few take 32, one warp a
    sequence, whose step waits on one shuffle (K4_PER_SM)."""
    for per_sm, g in K4_PER_SM:
        if batch >= per_sm * sms:
            return g
    return 32


def _viterbi_cuda(llr: torch.Tensor, group: int | None = None,
                  traceback: bool = True) -> torch.Tensor:
    """K4 on a CUDA tensor, one group of `group` lanes a sequence (default
    k4_group's choice for this batch and card). traceback=False runs the
    forward alone and leaves the bits unset: chip_smoke.py times it for
    the traceback's share; no path asks for it."""
    _check_llr("viterbi", llr)
    bsz, n = llr.shape[0], llr.shape[1] // 2
    if group is None:
        group = k4_group(bsz, torch.cuda.get_device_properties(
            llr.device).multi_processor_count)
    if group not in K4_GROUPS:
        raise ValueError(f"viterbi: group must be one of {K4_GROUPS}, got "
                         f"{group}")
    lib = build.library()
    # the survivor records of a row, made odd (csrc/viterbi_group.cuh
    # record_stride)
    records = -(-n // K4_RECORD_STEPS[group]) | 1
    rec = torch.empty((bsz, records, 64), dtype=torch.int32,
                      device=llr.device)
    bits = torch.empty((bsz, n), dtype=torch.uint8, device=llr.device)
    err = lib.ofdm_viterbi(llr.data_ptr(), rec.data_ptr(), bits.data_ptr(),
                           bsz, n, group, int(traceback),
                           build.stream_ptr(llr.device))
    build.check(err, "viterbi")
    policy.count_launch("viterbi")
    return bits


def _viterbi_windowed_cuda(llr: torch.Tensor, window: int, overlap: int
                           ) -> torch.Tensor:
    _check_llr("viterbi_windowed", llr)
    if window < 1 or overlap < 0:
        raise ValueError(f"viterbi_windowed: need window >= 1 and overlap "
                         f">= 0, got {window}, {overlap}")
    bsz, n = llr.shape[0], llr.shape[1] // 2
    l, e, starts = window_geometry(n, window, overlap)
    bits = torch.empty((bsz, n), dtype=torch.uint8, device=llr.device)
    # each step's two decision words of every window, [e, B * W]
    dec = torch.empty((e, bsz * len(starts), 2), dtype=torch.int32,
                      device=llr.device)
    lib = build.library()
    err = lib.ofdm_viterbi_windowed(llr.data_ptr(), dec.data_ptr(),
                                    bits.data_ptr(), bsz, n, len(starts), l,
                                    overlap, e, build.stream_ptr(llr.device))
    build.check(err, "viterbi_windowed")
    policy.count_launch("viterbi_windowed")
    return bits


def _viterbi_windowed_warp_cuda(llr: torch.Tensor, window: int,
                                overlap: int) -> torch.Tensor:
    """K4w's previous body (one warp a window, decisions in shared memory):
    the same bits; the A/B baseline of chip_smoke.py, which no path
    runs."""
    _check_llr("viterbi_windowed_warp", llr)
    bsz, n = llr.shape[0], llr.shape[1] // 2
    l, e, starts = window_geometry(n, window, overlap)
    bits = torch.empty((bsz, n), dtype=torch.uint8, device=llr.device)
    lib = build.library()
    err = lib.ofdm_viterbi_windowed_warp(llr.data_ptr(), bits.data_ptr(),
                                         bsz, n, len(starts), l, overlap, e,
                                         build.stream_ptr(llr.device))
    build.check(err, "viterbi_windowed_warp")
    policy.count_launch("viterbi_windowed_warp")
    return bits


def viterbi(llr: torch.Tensor) -> torch.Tensor:
    """Whole sequence: llr [B, 2n] -> bits [B, n] uint8 (kernel on CUDA,
    plain on CPU)."""
    if policy.use_kernel(llr):
        return _viterbi_cuda(llr)
    return viterbi_plain(llr)


def viterbi_windowed(llr: torch.Tensor, window: int, overlap: int
                     ) -> torch.Tensor:
    """Sliding windows of `window` owned steps, extended by `overlap` on
    both sides: llr [B, 2n] -> bits [B, n] uint8 (kernel on CUDA, plain on
    CPU). n <= window + 2*overlap decodes the whole sequence."""
    if policy.use_kernel(llr):
        return _viterbi_windowed_cuda(llr, window, overlap)
    return viterbi_windowed_plain(llr, window, overlap)


def viterbi_fused(llr: torch.Tensor, layout: str = "shuffle") -> torch.Tensor:
    """The reference's viterbi_pallas: whole sequence below its VMEM gate,
    the trellis padded to a multiple of 8 steps with certainty-of-zero LLRs
    (the pad bits are dropped); above it, windows of FUSED_WINDOW.
    `layout` is the spec's viterbi_impl, which sets the gate."""
    bsz, n = llr.shape[0], llr.shape[1] // 2
    e = -(-n // 8) * 8
    if e * _STEP_BYTES[layout] > _WHOLE_GATE_BYTES:
        return viterbi_windowed(llr, *FUSED_WINDOW)
    if e != n:
        llr = torch.cat([llr, llr.new_full((bsz, 2 * (e - n)), _BIG)], 1)
    return viterbi(llr)[:, :n]


def decode(llr: torch.Tensor, algorithm: str, layout: str = "shuffle"
           ) -> torch.Tensor:
    """llr [B, 2n] -> bits [B, n] by the algorithm policy.viterbi_impl
    chose: 'fused' (viterbi_pallas), 'windowed' (the XLA windowed decoder,
    XLA_WINDOW) or 'scan' (whole sequence)."""
    llr = llr.contiguous()
    if algorithm == "fused":
        return viterbi_fused(llr, layout)
    if algorithm == "windowed":
        return viterbi_windowed(llr, *XLA_WINDOW)
    if algorithm == "scan":
        return viterbi(llr)
    raise ValueError(f"unknown Viterbi algorithm {algorithm!r}")
