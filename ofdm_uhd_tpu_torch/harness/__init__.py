"""The repository's analysis harnesses (bench/*.py) as tools of the port,
one module each under bench/'s file names, each run as
`python -m ofdm_uhd_tpu_torch.harness.<name>`:

  stages        per-stage timing of the capture chain, and its steps
  roofline      the analytic cost model against the card's peaks, and its
                cross-check against a stages record
  sweeps        pre-FEC BER, post-FEC FER and EVM against SNR
  detect_sweep  detection rate and false alarms against SNR, the fixed
                threshold against CFAR, and the stream's TRACK rescue
  evm_budget    per-stage EVM by genie substitution
  pod           stream throughput against the time axis's size
  pp_ab         the 2-stage pipeline against the frame axis

Each takes the reference harness's flags and writes its --jsonl records
with the reference's keys, plus --device: the CUDA card by default (a
missing card raises), 'cpu' to run every kernel's plain version. None is
a benchmark: none prints a metric line.
"""

from __future__ import annotations

import json
import statistics
import time

import torch


def add_device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")


def open_device(name: str) -> torch.device:
    """The device `name` names; a CUDA device that is missing raises,
    never falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA card here (pass "
                               "--device cpu to run on the CPU)")
        if (device.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"--device {name}: {torch.cuda.device_count()}"
                               " CUDA card(s) here")
        if device.index is not None:
            torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"--device {name}: only cuda and cpu run the port")
    return device


def read_jsonl(path) -> list:
    """The records of a --jsonl file, in order."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def device_name(device: torch.device) -> str:
    """The card's name, or 'cpu'."""
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def median_ms(fn, device: torch.device, iters: int) -> float:
    """fn() once (the warm-up), then `iters` runs, each timed alone: a
    CUDA event pair on the device's stream on a card, the host clock
    around a synchronized run on the CPU. The median, in milliseconds."""
    fn()
    synchronize(device)
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
