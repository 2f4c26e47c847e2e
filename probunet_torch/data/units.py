"""Unit and time converters — ``probunet_tpu/data/units.py``."""

from __future__ import annotations

import numpy as np
import torch


def date_to_float(dates: np.ndarray) -> np.ndarray:
    """datetime64[ns] -> float nanoseconds."""
    return np.asarray(dates, dtype="datetime64[ns]").astype(float)


def float_to_date(floats) -> np.ndarray:
    """float nanoseconds -> datetime64[ns]."""
    return np.array(floats, dtype="datetime64[ns]")


def kgm2s_to_mmday(data):
    """Precipitation kg/m^2/s -> mm/day."""
    return data * (24 * 60 * 60)


def log_inv(data):
    """Inverse of the log1p-style transform."""
    return torch.exp(data) - 1


def k_to_c(data):
    """Kelvin -> Celsius."""
    return data - 273.15
