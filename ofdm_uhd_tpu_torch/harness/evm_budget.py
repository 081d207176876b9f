"""Per-stage EVM budget on the port: the port of bench/evm_budget.py.

Stage timing lives in harness.stages; this is its numerics twin: where do
the EVM decibels go? The harness demodulates the same noisy frames
repeatedly, replacing one estimated quantity at a time with its genie
value (known channel, no CPE correction), so each row isolates one
stage's contribution:

  genie-all      known H, no CPE correction (a phase-coherent channel):
                 the channel + noise floor itself
  est-H          the chain's LS estimate in place of the genie H: the
                 channel-estimation penalty (one preamble symbol: ~3 dB
                 at chanest_smooth=0)
  est-H+CPE      + the chain's pilot CPE / slope tracking (its estimation
                 noise: ~1/n_pilots of a symbol SNR unit)
  chain-aligned  the aligned chain (est H + CPE): should match est-H+CPE
  chain-capture  the capture chain (adds S&C timing and CFO estimation
                 residuals). It reads ~1 dB better than chain-aligned,
                 not worse: make_capture defines SNR against the mean
                 power of the whole capture, inter-frame gaps included,
                 so the per-frame noise is lower by the duty cycle (a
                 harness definition, not a chain property).

    python -m ofdm_uhd_tpu_torch.harness.evm_budget [--config c2] \\
        [--snr 22] [--frames 256] [--multipath c2] [--device cuda] \\
        [--jsonl out.jsonl]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from . import add_device_arg, open_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="c2")
    p.add_argument("--snr", type=float, default=22.0)
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--multipath", default=None, choices=[None, "c2"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jsonl", default=None)
    add_device_arg(p)
    args = p.parse_args(argv)

    import torch
    from ..channel import apply_channel, make_capture
    from ..cli import config as C
    from ..core.spec import ChannelSpec
    from ..phy import frame as PF
    from ..phy import qam as PQ
    from ..phy import tables as T
    from ..pipeline import RxPipeline, TxPipeline
    from .sweeps import MULTIPATH

    device = open_device(args.device)
    spec = C.load_spec(args.config)
    taps = MULTIPATH.get(args.multipath)
    rng = np.random.default_rng(args.seed)
    payloads = rng.integers(
        0, 2, (args.frames, spec.payload_bits_per_frame)).astype(np.uint8)
    frames = TxPipeline(spec)(torch.from_numpy(payloads).to(device)
                              ).cpu().numpy()
    ch = (ChannelSpec(snr_db=args.snr, multipath_taps=taps)
          if taps else ChannelSpec(snr_db=args.snr))
    rx_in = torch.from_numpy(np.stack([
        apply_channel(frames[i], ch, spec.n_sc, seed=5000 + i)
        for i in range(args.frames)]).astype(np.complex64)).to(device)

    # the genie channel on occupied bins (the exact DFT of the taps)
    t = np.zeros(spec.n_sc, np.complex128)
    tv = np.asarray(taps if taps else (1.0,), np.complex128)
    t[: len(tv)] = tv
    occ = np.asarray(T.frame_tables(spec)["occupied_bins"])
    h_genie = np.fft.fft(t)[occ].astype(np.complex64)

    shift = min(4, spec.cp // 4)
    # the FFT window's intentional advance (s samples into the CP) rotates
    # every bin by exp(-j 2 pi k s / N): the genie H includes it, as the
    # estimated H absorbs it
    rot = np.exp(-1j * 2 * np.pi * occ * shift / spec.n_sc)
    h_rot = torch.from_numpy((h_genie * rot).astype(np.complex64)).to(device)
    data_pos = torch.from_numpy(np.asarray(
        T.frame_tables(spec)["data_positions"])).long().to(device)

    def evm_of(data):
        hard = PQ.qam_demap_hard(data, spec.modulation)
        ideal = PQ.qam_map(hard, spec.modulation).cpu().numpy()
        d = data.cpu().numpy()
        err = np.mean(np.abs(d - ideal) ** 2)
        ref = np.mean(np.abs(ideal) ** 2)
        return float(10 * np.log10(err / ref + 1e-30))

    grid = PF.ofdm_demodulate(spec, rx_in, shift=shift)
    h_est = PF.estimate_channel(spec, grid)
    hb = h_rot[None, :].expand(h_est.shape)

    rows = {}
    # genie H, no CPE (a static channel, no CFO on aligned frames: any
    # residual CPE the tracker sees is its own estimation noise)
    rows["genie-all"] = evm_of(PF.equalize(spec, grid, hb)[..., data_pos])
    # estimated H, no CPE
    eq_e = PF.equalize(spec, grid, h_est)
    rows["est-H"] = evm_of(eq_e[..., data_pos])
    # estimated H + the chain's CPE tracking
    rows["est-H+CPE"] = evm_of(PF.track_phase(spec, eq_e)[0])
    # the whole aligned chain (cross-check: must equal est-H+CPE)
    rx = RxPipeline(spec, shift=shift)
    out_a = rx.rx_aligned(rx_in)
    rows["chain-aligned"] = float(np.mean(out_a["evm_db"].cpu().numpy()))
    # the whole capture chain: adds S&C timing and CFO residuals
    cap = make_capture(frames, ChannelSpec(
        snr_db=args.snr, cfo=0.4 / spec.resample_l,
        **({"multipath_taps": taps} if taps else {})),
        spec.n_sc, gap=300, seed=77).astype(np.complex64)
    out_c = rx.rx_capture(torch.from_numpy(cap).to(device),
                          max_frames=args.frames + 2)
    v = out_c["valid"].cpu().numpy()
    rows["chain-capture"] = float(np.mean(out_c["evm_db"].cpu().numpy()[v]))

    print(f"# config={args.config} snr={args.snr} "
          f"multipath={args.multipath or 'flat'} frames={args.frames}")
    print(f"{'stage':<16}{'EVM dB':>9}{'delta':>9}")
    for k, v_ in rows.items():
        print(f"{k:<16}{v_:>9.2f}{v_ - rows['genie-all']:>+9.2f}"
              if k != "genie-all" else f"{k:<16}{v_:>9.2f}{'':>9}")
    if args.jsonl:
        with open(args.jsonl, "a") as f:
            f.write(json.dumps({"config": args.config, "snr_db": args.snr,
                                "multipath": args.multipath,
                                "frames": args.frames,
                                "evm_db": rows}) + "\n")


if __name__ == "__main__":
    main()
