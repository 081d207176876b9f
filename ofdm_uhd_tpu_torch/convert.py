"""Carry the reference's parameters across.

The modem has no weights: its parameters are the WaveformSpec and the host
tables (frame and selection tables, interleaver permutation, Viterbi
branch tables, QAM constellations). Both converters take plain data
(`dataclasses.asdict` of a reference spec, numpy arrays of reference
tables), so neither imports the reference package.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.spec import WaveformSpec


def spec_from_reference(fields: dict) -> WaveformSpec:
    """The port's spec from `dataclasses.asdict(reference_spec)`."""
    return WaveformSpec(**fields)


def tables_from_reference(np_tables: dict, device: str | torch.device = "cpu"
                          ) -> dict:
    """Nested dict / tuple of numpy arrays -> the same structure of tensors
    on `device` (numpy scalars become 0-d tensors)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        a = np.asarray(v)
        if a.ndim == 0:
            return torch.tensor(a.item(), dtype=torch.from_numpy(
                a.reshape(1)).dtype, device=device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return conv(np_tables)

