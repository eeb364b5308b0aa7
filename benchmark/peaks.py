"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates without sparsity, at the full 700 W power limit).

`bf16_flops`: the tensor-core rate of the fastest precision the measured
steps use (bfloat16 operands in the 3D convolutions).  `hbm_bytes`: the
device memory's rate.
"""
from __future__ import annotations

PEAKS = {'H100': {'bf16_flops': 989e12, 'hbm_bytes': 3.35e12}}


def peaks_of(device_name):
    """The row whose key the card's name contains, or None."""
    for key, row in PEAKS.items():
        if key in device_name:
            return row
    return None
