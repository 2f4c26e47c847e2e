"""ClimEx dataset: host ingest + device-resident tensors —
``probunet_tpu/data/dataset.py``.

Ingest (h5py thread pool) materializes the HR tensor once, channels-last; it
is copied to the device once and the split's standardization statistics are
computed there eagerly. Pair synthesis happens per batch in the sampler
(:func:`probunet_torch.data.transforms.make_pair`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from probunet_torch.data import transforms
from probunet_torch.data.netcdf import load_window
from probunet_torch.utils.device import resolve_device


class ClimexDataset:
    def __init__(
        self,
        datadir: Optional[str] = None,
        years: Sequence[int] = range(1960, 2020),
        variables: Sequence[str] = ("pr", "tasmin", "tasmax"),
        coords: Sequence[int] = (120, 184, 120, 184),
        lowres_scale: int = 4,
        time_transform: Optional[str] = None,
        standardization: str = "perpixel",
        *,
        hr: Optional[np.ndarray] = None,          # (T, H, W, C) bypasses file ingest
        timestamps: Optional[np.ndarray] = None,  # (T,) float ns
        lat: Optional[np.ndarray] = None,
        lon: Optional[np.ndarray] = None,
        reader_workers: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        self.variables = tuple(variables)
        self.nvars = len(self.variables)
        self.coords = tuple(coords)
        self.lowres_scale = int(lowres_scale)
        self.time_transform = time_transform
        self.standardization = standardization
        self.epsilon = transforms.EPSILON

        if hr is None:
            loaded = load_window(datadir, list(years), self.variables, self.coords,
                                 max_workers=reader_workers)
            hr = loaded["hr"]
            timestamps = loaded["timestamps"]
            lat, lon = loaded["lat"], loaded["lon"]
        self.hr_np = np.ascontiguousarray(hr, dtype=np.float32)
        self.timestamps_np = (np.asarray(timestamps, dtype=np.float64)
                              if timestamps is not None
                              else np.arange(len(hr), dtype=np.float64) * 86400e9)
        self.lat, self.lon = lat, lon
        self.years = list(years)

        self._hr_dev: Optional[torch.Tensor] = None
        self._stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._stats_done = False

    def __len__(self) -> int:
        return self.hr_np.shape[0]

    @property
    def spatial_shape(self) -> Tuple[int, int]:
        return self.hr_np.shape[1], self.hr_np.shape[2]

    def hr_device(self) -> torch.Tensor:
        """The HR tensor on the dataset's device, copied once."""
        if self._hr_dev is None:
            self._hr_dev = torch.from_numpy(self.hr_np).to(self.device)
        return self._hr_dev

    @property
    def stats(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The split's LR statistics, computed once on the device."""
        if not self._stats_done:
            self._stats = transforms.compute_lr_stats(self.hr_device(), self.lowres_scale,
                                                      self.standardization)
            self._stats_done = True
        return self._stats

    def batch(self, idx) -> Dict[str, torch.Tensor]:
        """Batched equivalent of the reference ``__getitem__``."""
        idx = torch.as_tensor(idx, device=self.device)
        hr = self.hr_device()[idx]
        stats = transforms.slice_stats(self.stats, self.standardization, idx)
        out = transforms.make_pair(hr, self.lowres_scale, self.standardization, stats)
        out["timestamps"] = torch.from_numpy(self.timestamps_np).to(self.device)[idx]
        return out

    def epoch_indices(self, epoch_seed: int, batch_size: int, shuffle: bool = True,
                      drop_remainder: bool = True) -> np.ndarray:
        """(num_batches, batch_size) int array of sample indices for one epoch."""
        n = len(self)
        order = np.random.default_rng(epoch_seed).permutation(n) if shuffle else np.arange(n)
        if drop_remainder:
            nb = n // batch_size
            return order[: nb * batch_size].reshape(nb, batch_size)
        pad = (-n) % batch_size
        if pad:
            order = np.concatenate([order, order[:pad]])
        return order.reshape(-1, batch_size)
