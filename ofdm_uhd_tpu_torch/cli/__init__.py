"""Command-line tools on the port, as python -m modules (the counterparts
of ofdm_uhd_tpu/cli/tx, rx, loopback, pod_rx and bench):

    python -m ofdm_uhd_tpu_torch.cli.tx       --config c2 --out tx.npy --frames 10
    python -m ofdm_uhd_tpu_torch.cli.rx       --config c3 --capture rx.iq
    python -m ofdm_uhd_tpu_torch.cli.loopback --config c1 --frames 100 --snr 12
    python -m ofdm_uhd_tpu_torch.cli.pod_rx   --config c5 --capture rx.npy
    python -m ofdm_uhd_tpu_torch.cli.bench    --config c3 --caps 8 --frames 1024 --input sc16

Each runs the pipelines on --device, the CUDA card unless asked otherwise
(`--device cpu` takes every kernel's plain version); without a card they
fail rather than run on the CPU.
"""
