"""Learned lattice coefficient banks, read-only (counterpart of
convopeq_tpu/models/learner.py:70 `coefficient_bank_index` and :124-163
`AdaptiveCoefficientBanks`).

180 banks: 10 sample rates x 3 bit depths x 6 learning modes, each nine
reflection coefficients of the adaptive lattice shaper
(src/DeviceSettings.cpp adaptiveCoeff_{sr}_{bit}_{i}).  The factory banks
ship as convopeq_tpu_torch/data/learned_banks.json, a copy of the JAX
package's file, so the port reads nothing of that package.  The learner
itself (the CMA-ES fit) is not ported: the banks are read, not trained.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .dither import NS_ORDER_LATTICE

BANK_SAMPLE_RATES = [44100.0, 48000.0, 88200.0, 96000.0, 176400.0,
                     192000.0, 352800.0, 384000.0, 705600.0, 768000.0]
BANK_BIT_DEPTHS = [16, 24, 32]
BANK_MODES = 6
NUM_BANKS = len(BANK_SAMPLE_RATES) * len(BANK_BIT_DEPTHS) * BANK_MODES
FACTORY_BANKS = Path(__file__).resolve().parent.parent / "data" / \
    "learned_banks.json"


def coefficient_bank_index(sample_rate: float, bit_depth: int,
                           mode: int) -> int:
    sr_idx = int(np.argmin([abs(sample_rate - r) for r in BANK_SAMPLE_RATES]))
    bd_idx = 0 if bit_depth <= 16 else 1 if bit_depth <= 24 else 2
    mode = int(np.clip(mode, 0, BANK_MODES - 1))
    return (sr_idx * len(BANK_BIT_DEPTHS) + bd_idx) * BANK_MODES + mode


class AdaptiveCoefficientBanks:
    """The bank store: set / get by (sample rate, bit depth, mode), and
    the JSON dict form {str(index): [9 floats]}."""

    def __init__(self):
        self._banks: dict = {}

    @staticmethod
    def _key(sample_rate: float, bit_depth: int, mode: int) -> int:
        return coefficient_bank_index(sample_rate, bit_depth, mode)

    def set(self, sample_rate: float, bit_depth: int, mode: int, coeffs):
        c = np.asarray(coeffs, np.float64)
        if c.shape != (NS_ORDER_LATTICE,):
            raise ValueError(f"expected ({NS_ORDER_LATTICE},) coefficients")
        self._banks[self._key(sample_rate, bit_depth, mode)] = c.copy()
        return self

    def get(self, sample_rate: float, bit_depth: int, mode: int):
        """Learned coefficients for the bank, or None if never trained."""
        return self._banks.get(self._key(sample_rate, bit_depth, mode))

    def to_dict(self) -> dict:
        return {str(k): v.tolist() for k, v in sorted(self._banks.items())}

    @classmethod
    def from_dict(cls, d: dict) -> "AdaptiveCoefficientBanks":
        b = cls()
        for k, v in (d or {}).items():
            c = np.asarray(v, np.float64)
            if c.shape != (NS_ORDER_LATTICE,):
                raise ValueError(f"bank {k}: expected ({NS_ORDER_LATTICE},) "
                                 f"coefficients, got {c.shape}")
            b._banks[int(k)] = c.copy()
        return b

    def __len__(self):
        return len(self._banks)


def factory_banks() -> AdaptiveCoefficientBanks:
    """The factory banks shipped with the package."""
    with open(FACTORY_BANKS) as f:
        return AdaptiveCoefficientBanks.from_dict(json.load(f)["banks"])
