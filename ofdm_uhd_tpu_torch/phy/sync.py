"""Schmidl-Cox synchronization with fixed-capacity frame detection.

The counterpart of ofdm_uhd_tpu/phy/sync.py, with the capture batch
written out: every function takes [C, ...] captures where the reference
vmapped over them. Detection is the reference's parallel formulation:

  0. the S&C correlation P and metric M (`sc_front`): in one pass
     (kernels/scfront.py, K6), or, where the reference routes its boxcar
     correlator, P and R (kernels/sync.py, K9) and then M;
  1. candidates: rising edges of (M >= threshold), the first `max_cand`
     kept with the reference's per-512-block capacity of 8 edges
     (`_first_k_indices`; overflow shows only in `det_sat`);
  2. plateau localization of every candidate: kernels/localize.py;
  3. greedy spacing selection (`_select`): the reference's sequential
     rule, computed by integer pointer jumping;
  4. order-preserving compaction into the max_frames slots.

Integer cumsums, searchsorted and gathers replace the reference's exact
float32 triangular matmuls and one-hot products, with identical output
(tests/test_torch_sync.py holds each step to the reference).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.spec import WaveformSpec
from ..kernels.extract import extract_frames as _extract
from ..kernels.localize import localize
from ..kernels.policy import choose
from ..kernels.scfront import sc_frontend
from ..kernels.sync import sc_correlate, sc_metric
from . import tables as T

_EXTRACT_BS = 512      # block size of the hierarchical index extraction
_EXTRACT_S = 8         # rising-edge capacity per block


def sc_front(spec: WaveformSpec, capture: torch.Tensor,
             backend: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """capture [C, n] c64 -> (P [C, nd] c64, M [C, nd] f32) at l = n_sc/2,
    in the reference's formulation for `backend` (default the spec's
    kernel_backend; ofdm_uhd_tpu/phy/sync.py:61-75): the fused front end
    when l % 128 == 0 and it is chosen; else the boxcar correlator K9 and
    the metric where 'sc_corr' is chosen; else the XLA compose, which K6
    computes in the same summation order."""
    l = spec.n_sc // 2
    if boxcar(spec, backend):
        p, rr = sc_correlate(capture, l)
        return p, sc_metric(p, rr)
    return sc_frontend(capture, l)


def boxcar(spec: WaveformSpec, backend: str | None = None) -> bool:
    """True where `sc_front` takes the boxcar correlator K9 and the
    metric, False where it takes the fused front end K6."""
    l = spec.n_sc // 2
    be = backend or spec.kernel_backend
    fused = l % 128 == 0 and choose("sc_front", l, be) == "pallas"
    return not fused and choose("sc_corr", l, be) == "pallas"


def detect_frames(spec: WaveformSpec, capture: torch.Tensor, max_frames: int,
                  threshold: float = 0.5, rel: float = 0.9,
                  backend: str | None = None,
                  threshold_mode: str = "fixed", cfar_k: float = 16.0):
    """capture [C, n] c64 -> (d [C, mf] i32, eps [C, mf] f32,
    valid [C, mf] bool, det_sat [C] bool).

    d = first sample of each frame (plateau midpoint - cp/2); eps =
    fractional CFO in subcarrier spacings, angle(P)/pi; det_sat is TRUE
    where a 512-sample block held more rising edges than the extractor's
    capacity, so a frame MAY have been missed. `backend` picks the S&C
    formulation (`sc_front`), default the spec's kernel_backend.
    threshold_mode 'fixed' detects at `threshold`; 'cfar' at each row's
    noise-floor-adaptive threshold (`cfar_threshold`).
    """
    n = capture.shape[-1]
    p, m = sc_front(spec, capture, backend)
    nd = m.shape[-1]
    span = spec.sym_len
    if threshold_mode == "cfar":
        thr = cfar_threshold(m, threshold, cfar_k)
    elif threshold_mode == "fixed":
        thr = T.f32_scalar(threshold, m.device)
    else:
        raise ValueError(f"unknown threshold_mode {threshold_mode!r}")
    max_cand = min(4 * max_frames + 16, nd)
    cand, sat = _first_k_indices(_rising_edges(m, thr), max_cand,
                                 sentinel=nd)                   # [C, mc]
    found_c = cand < nd
    ds_c, eps_c = localize(m, p, cand, span, spec.cp, rel=rel)
    valid_c = found_c & (ds_c + spec.frame_len <= n)
    keeps = _select(spec, cand, ds_c, valid_c, found_c, slack=span)
    ds, eps, valid = _compact(ds_c, eps_c, keeps, max_frames)
    return ds, eps, valid, sat


def cfar_threshold(m: torch.Tensor, threshold: float, cfar_k: float
                   ) -> torch.Tensor:
    """The reference's noise-floor-adaptive threshold of each row of the
    metric [C, nd] -> [C, 1] float32: clip(cfar_k * median(M), 0.05,
    threshold) (ofdm_uhd_tpu/phy/sync.py:93-94). jnp.median is the
    midpoint quantile, (low + high) * 0.5 in float32 of the two middle
    values of the sorted row (one value where nd is odd); torch.median
    would return `low` alone. One sort of every row, indexed at positions
    known from the shape, so the card is not waited on."""
    nd = m.shape[-1]
    s = torch.sort(m, dim=-1).values
    low, high = s[:, (nd - 1) // 2], s[:, nd // 2]
    med = (low + high) * T.f32_scalar(0.5, m.device)
    thr = med * T.f32_scalar(cfar_k, m.device)
    return thr.clamp(T.f32_scalar(0.05, m.device),
                     T.f32_scalar(threshold, m.device))[:, None]


def _rising_edges(m: torch.Tensor, threshold) -> torch.Tensor:
    """[C, nd] metric -> bool [C, nd]: where M crosses up to >= threshold
    (a float, or a float32 tensor [C, 1] or 0-d)."""
    if not isinstance(threshold, torch.Tensor):
        threshold = T.f32_scalar(threshold, m.device)
    above = m >= threshold
    rise = above.clone()
    rise[:, 1:] &= ~above[:, :-1]
    return rise


def _first_k_indices(rise: torch.Tensor, k: int, sentinel: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """rise [C, n] bool -> (first k TRUE indices [C, k] i32 ascending,
    empty slots = sentinel; sat [C] bool).

    Same result as the reference's hierarchical form: each 512-sample
    block contributes at most its first _EXTRACT_S rising edges, so the
    output differs from a plain nonzero exactly when a block overflows,
    which `sat` reports.
    """
    caps, n = rise.shape
    bs, cap = _EXTRACT_BS, _EXTRACT_S
    nb = -(-n // bs)
    r = torch.nn.functional.pad(rise, (0, nb * bs - n)).reshape(caps, nb, bs)
    rank = torch.cumsum(r, dim=-1, dtype=torch.int32)        # inclusive
    pos = (torch.arange(nb, device=rise.device, dtype=torch.int32)[:, None]
           * bs + torch.arange(bs, device=rise.device, dtype=torch.int32))
    slot = torch.where(r & (rank <= cap), rank - 1, cap).long()
    slots = torch.full((caps, nb, cap + 1), sentinel, dtype=torch.int32,
                       device=rise.device)
    # unselected samples all land in the spare column `cap`, dropped below
    slots.scatter_(2, slot, pos.expand(caps, nb, bs).contiguous())
    flat = slots[..., :cap].reshape(caps, nb * cap)          # ascending
    if flat.shape[1] < k:
        flat = torch.nn.functional.pad(flat, (0, k - flat.shape[1]),
                                       value=sentinel)
    idx = torch.sort(flat, dim=-1).values[:, :k].contiguous()
    return idx, (rank[..., -1] > cap).any(dim=-1)


def _select(spec: WaveformSpec, cand: torch.Tensor, ds_c: torch.Tensor,
            valid_c: torch.Tensor, found_c: torch.Tensor, slack: int
            ) -> torch.Tensor:
    """Greedy spacing selection [C, m] -> keeps [C, m] bool; bit-identical
    to the reference's sequential _select_scan:

        elig = found & (cand >= pos - slack) & ~dead
        keep = elig & valid;  dead |= elig & ~valid
        pos  = d + frame_len where kept

    Candidates ascend with the not-found ones (sentinels) last, as
    detect_frames produces them. The kept set is then a path: it starts
    at the first found candidate, and after keeping i the next eligible
    candidate is the first j > i with cand[j] >= d[i] + frame_len - slack
    (searchsorted); it ends at a not-found candidate, or at an invalid one
    (eligible, so the scan dies there, but not kept). Pointer jumping
    lists the path's nodes in log2(m) rounds of gathers.
    """
    caps, m = cand.shape
    dev = cand.device
    term = m                                                 # absorbing node
    ar = torch.arange(m, device=dev)
    xi = (ds_c.long() + spec.frame_len - slack).contiguous()
    nxt = torch.searchsorted(cand.long().contiguous(), xi)   # first c >= xi
    nxt = torch.maximum(nxt, ar + 1)
    tgt_found = found_c.gather(1, nxt.clamp_max(m - 1)) & (nxt < m)
    nxt = torch.where(tgt_found & valid_c & found_c, nxt, term)
    jump = torch.cat([nxt, torch.full((caps, 1), term, device=dev,
                                      dtype=nxt.dtype)], dim=1)   # [C, m+1]
    start = torch.where(found_c[:, :1], 0, term)             # [C, 1]
    node = start.expand(caps, m).contiguous()                # k-th path node
    k = ar
    for bit in range(max(1, (m - 1).bit_length())):
        take = ((k >> bit) & 1).bool()
        node = torch.where(take, jump.gather(1, node), node)
        jump = jump.gather(1, jump)
    on_path = torch.zeros((caps, m + 1), dtype=torch.bool, device=dev)
    on_path.scatter_(1, node, True)
    return on_path[:, :m] & valid_c & found_c


def _compact(ds_c: torch.Tensor, eps_c: torch.Tensor, keeps: torch.Tensor,
             max_frames: int):
    """Order-preserving compaction: slot j <- the j-th kept candidate;
    empty slots hold d = 0, eps = 0, valid = False."""
    caps = keeps.shape[0]
    rank = torch.cumsum(keeps, dim=-1) - 1
    slot = torch.where(keeps & (rank < max_frames), rank, max_frames)
    ds = ds_c.new_zeros((caps, max_frames + 1))
    eps = eps_c.new_zeros((caps, max_frames + 1))
    valid = keeps.new_zeros((caps, max_frames + 1))
    ds.scatter_(1, slot, ds_c)
    eps.scatter_(1, slot, eps_c)
    valid.scatter_(1, slot, keeps)
    return (ds[:, :max_frames].contiguous(), eps[:, :max_frames].contiguous(),
            valid[:, :max_frames].contiguous())


def extract_frames(spec: WaveformSpec, capture: torch.Tensor,
                   ds: torch.Tensor) -> torch.Tensor:
    """capture [C, n], ds [C, mf] -> frames [C, mf, frame_len]."""
    return _extract(capture, ds, spec.frame_len)


def cfo_correct(frames: torch.Tensor, eps: torch.Tensor, n_sc: int
                ) -> torch.Tensor:
    """frames [..., n] * exp(-j 2 pi eps n / n_sc), eps [...] per frame."""
    n = torch.arange(frames.shape[-1], dtype=torch.float32,
                     device=frames.device)
    two_pi = T.f32_scalar(2.0 * np.pi, frames.device)
    phase = two_pi * eps[..., None] * n / n_sc
    return frames * torch.polar(torch.ones_like(phase), -phase)


@functools.lru_cache(maxsize=32)
def _int_cfo_tables(spec: WaveformSpec, search: int):
    """Shifted occupied bins [n_s, n_occ] of the integer-CFO search."""
    occ = np.asarray(T.frame_tables(spec)["occupied_bins"], dtype=np.int64)
    shifts = np.arange(-search, search + 1)
    return (occ[None, :] + shifts[:, None]) % spec.n_sc, shifts.astype(
        np.float32)


def integer_cfo(spec: WaveformSpec, frames: torch.Tensor, search: int = 4
                ) -> torch.Tensor:
    """Integer CFO per frame [...] (float32) from preamble sym B by the
    differential correlation over +-search bin shifts."""
    dev = frames.device
    bins = T.on_device(_int_cfo_tables, (spec, search), 0, dev)
    shifts = T.on_device(_int_cfo_tables, (spec, search), 1, dev)
    start = spec.sym_len + spec.cp
    win = frames[..., start:start + spec.n_sc]
    y = torch.fft.fft(win, norm="ortho").to(torch.complex64)   # not a kernel
    ys = y[..., bins]                                         # [..., S, n_occ]
    d = ys * T.on_device(T.frame_tables, (spec,), "sym_b_occ_conj", dev)
    val = (d[..., 1:] * torch.conj(d[..., :-1])).sum(-1).abs()   # [..., S]
    best = torch.argmax(val, dim=-1)
    return shifts[best]
