"""Multi-process data parallelism: per-process data and the lockstep batch
plan — ``probunet_tpu/parallel/multihost.py``.

One process per card: each reads only its contiguous slice of the train
years, holds its rows of every global batch, and the gradient all-reduce of
:class:`~probunet_torch.parallel.mesh.DataParallel` does the rest. The
guarantee, as in the JAX package: N processes compute what one process
computes with ``--data_shards N``: the same global batches, the same GLOBAL
standardization statistics, the same random draws (rows of the global
draw), the same gradient. Everything here is the identity, or the
single-process plan, when no process group is up.

- :func:`maybe_initialize_distributed`: the process group from the
  environment (``mesh.launch_env``), before any device work;
- :func:`shard_years`, :func:`local_batch_slice`, :func:`shard_sizes_for`;
- :func:`allreduce_sum`, :func:`allreduce_moments`, :func:`allgather_counts`:
  float64 host values through an ordered all-gather (torch moves float64
  natively, where the JAX package moves its bits as uint32), summed on the
  host in process order, so every rank holds the identical value;
- :func:`merge_moment_stats`, :func:`global_perpixel_stats`;
- :func:`stratified_epoch_batches` and :class:`MultihostPlan`.

The JAX package's ``make_global_batch`` has no counterpart: a rank never
assembles a global array, it holds its own rows (``device_batch``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from probunet_torch.parallel import mesh


def maybe_initialize_distributed(device=None, backend: Optional[str] = None) -> bool:
    """Join the process group when the environment describes a
    multi-process launch (``mesh.launch_env``); a no-op otherwise, or when
    the group is already up. ``device``: this rank's device (default its
    card, ``cuda:<LOCAL_RANK>``); ``backend``: default NCCL on a card, gloo
    on the CPU. Returns whether more than one process runs."""
    if not mesh.is_initialized():
        launch = mesh.launch_env()
        if launch is None:
            return False
        mesh.init_process_group(launch, device, backend)
    return process_info()[1] > 1


def process_info() -> tuple:
    """(rank, world size); (0, 1) without a process group."""
    if mesh.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def shard_years(years: Sequence[int], process_index: int, process_count: int) -> List[int]:
    """Balanced contiguous partition of ``years`` across processes: every
    year goes to exactly one process, sizes differ by at most 1 (the first
    ``len(years) % process_count`` processes get the extra year)."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in [0, {process_count})")
    years = list(years)
    base, rem = divmod(len(years), process_count)
    start = process_index * base + min(process_index, rem)
    size = base + (1 if process_index < rem else 0)
    return years[start:start + size]


def local_batch_slice(global_batch_size: int, process_index: int,
                      process_count: int) -> slice:
    """Rows of a global batch owned by this process (contiguous blocks)."""
    if global_batch_size % process_count:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {process_count} processes")
    per = global_batch_size // process_count
    return slice(process_index * per, (process_index + 1) * per)


def merge_moment_stats(parts):
    """Merge per-process (sum, sum_of_squares, count) accumulators into the
    global (mean, unbiased std), float32: the mergeable-moments identity
    that keeps year-sharded statistics those of one pass over all years."""
    s1 = sum(np.asarray(p[0], np.float64) for p in parts)
    s2 = sum(np.asarray(p[1], np.float64) for p in parts)
    n = sum(int(p[2]) for p in parts)
    mean = s1 / n
    var = (s2 - n * mean * mean) / (n - 1)
    return mean.astype(np.float32), np.sqrt(np.maximum(var, 0.0)).astype(np.float32)


def allreduce_sum(*arrays, group=None):
    """Element-wise float64 sum of host arrays across the processes of
    ``group`` (default all), summed on the host in process order from an
    all-gather of every process's values (:func:`mesh.allgather_f64_rows`),
    so the result is bit-equal on every process. The arrays, of any shapes,
    travel as one payload. Without a process group: the arrays as they are."""
    if not mesh.is_initialized():
        return arrays
    shapes = [np.asarray(a).shape for a in arrays]
    payload = np.concatenate([np.asarray(a, np.float64).ravel() for a in arrays])
    total = mesh.allgather_f64_rows(payload, group).sum(axis=0, dtype=np.float64)
    out, lo = [], 0
    for shp in shapes:
        n = int(np.prod(shp)) if shp else 1
        out.append(total[lo:lo + n].reshape(shp))
        lo += n
    return tuple(out)


def allreduce_moments(s1: np.ndarray, s2: np.ndarray, count: int, group=None):
    """(s1, s2, count) summed across the processes of ``group``
    (:func:`allreduce_sum`)."""
    if not mesh.is_initialized():
        return s1, s2, count
    s1, s2, cnt = allreduce_sum(s1, s2, np.float64(count), group=group)
    return s1, s2, int(round(float(cnt)))


def allgather_counts(local_n: int, group=None) -> np.ndarray:
    """Every process's ``local_n`` (of ``group``, default all), in process
    order, on every process (float64 transport: exact below 2**53). Without
    a process group: ``[local_n]``."""
    if not mesh.is_initialized():
        return np.asarray([int(local_n)], np.int64)
    rows = mesh.allgather_f64_rows(np.asarray([np.float64(local_n)]), group)
    return np.asarray(np.round(rows[:, 0]), np.int64)


def global_perpixel_stats(hr_np: np.ndarray, lowres_scale: int, device=None, group=None):
    """Per-pixel standardization statistics over the GLOBAL train split:
    local float64 LR moments (pooled on ``device``) -> sum across the
    processes of ``group`` (default all; each must hold another shard) ->
    (mean, std) repeated to the HR grid. Without a process group: the
    streaming statistics of ``hr_np``."""
    from probunet_torch.data.pipeline import lr_moments_streaming

    s1, s2, n = lr_moments_streaming(hr_np, lowres_scale, device=device)
    s1, s2, n = allreduce_moments(s1, s2, n, group)
    mean, std = merge_moment_stats([(s1, s2, n)])
    mean_hr = np.repeat(np.repeat(mean, lowres_scale, axis=0), lowres_scale, axis=1)
    std_hr = np.repeat(np.repeat(std, lowres_scale, axis=0), lowres_scale, axis=1)
    return mean_hr, std_hr


def stratified_epoch_batches(shard_sizes: Sequence[int], batch: int, seed: int,
                             shuffle: bool = True) -> np.ndarray:
    """Lockstep epoch batch plan over year-sharded data: an (nb, batch)
    array of GLOBAL sample ids in which every batch takes ``batch //
    num_shards`` rows from each contiguous shard, grouped in shard order
    (process p's rows are ``local_batch_slice(batch, p, num_shards)``).
    A function of its arguments only: every process computes it with no
    communication. Shard p is shuffled by ``default_rng([seed, p])``;
    ``nb`` is the minimum over the shards (tails dropped)."""
    shard_sizes = [int(s) for s in shard_sizes]
    k = len(shard_sizes)
    if batch % k:
        raise ValueError(f"batch {batch} not divisible by {k} shards")
    per = batch // k
    nb = min(s // per for s in shard_sizes)
    if nb == 0:
        raise ValueError(f"some shard ({shard_sizes}) has fewer than {per} samples")
    cols = []
    offset = 0
    for p, size in enumerate(shard_sizes):
        order = (np.random.default_rng([seed, p]).permutation(size) if shuffle
                 else np.arange(size))
        cols.append(offset + order[: nb * per].reshape(nb, per))
        offset += size
    return np.concatenate(cols, axis=1)


def shard_sizes_for(n_samples: int, years: Sequence[int], num_shards: int):
    """Per-shard sample counts of a dataset of ``n_samples`` over ``years``,
    partitioned by :func:`shard_years`; the calendar must give every year
    the same number of samples (ClimEx is noleap)."""
    years = list(years)
    if n_samples % len(years):
        raise ValueError(f"{n_samples} samples over {len(years)} years is not uniform; "
                         "cannot derive shard sizes")
    spy = n_samples // len(years)
    return [len(shard_years(years, p, num_shards)) * spy for p in range(num_shards)]


class MultihostPlan:
    """Per-step batches that keep every process in lockstep.

    Built whenever more than one process runs (each ingested only its
    :func:`shard_years` slice of the train years) or ``--data_shards`` > 1 on
    one process, which then holds every shard and computes the global
    batches of the multi-process run: the run a multi-process run is held
    against. The plan gives the lockstep epoch plans (from the gathered
    shard sizes), the GLOBAL perpixel statistics, and each step's rows of
    this process on its device (:meth:`device_batch`).

    ``shard`` = (index, count) and ``group`` key the plan by a data shard
    other than the process (default: this process of all): the spatial 2d
    mode's data index of ``dp``, whose ranks in the data ``group`` hold
    distinct shards while the ranks of one space group hold the same."""

    def __init__(self, cfg, ds_train, device, shard: Optional[tuple] = None, group=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.pi, self.pc = shard or process_info()
        self.group = group
        self.num_shards = int(cfg.data_shards) or self.pc
        if self.pc > 1 and self.num_shards != self.pc:
            raise ValueError(f"data_shards={self.num_shards} must equal the process count "
                             f"{self.pc} when running multi-process")
        if cfg.batch_size % self.num_shards:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                             f"{self.num_shards} shards")
        if self.pc > 1:
            self.shard_sizes = [int(s) for s in allgather_counts(len(ds_train), group)]
            self.offset = int(sum(self.shard_sizes[:self.pi]))
        else:
            # one process holds every shard: global ids are its ids
            self.shard_sizes = shard_sizes_for(len(ds_train), ds_train.years, self.num_shards)
            self.offset = 0
        self.global_train_n = int(sum(self.shard_sizes))
        self.stats_np = self.split_stats(ds_train, merged=True)
        self._global_stats = {}   # id(stats_np) -> (stats_np, device tensors)

    # ---- statistics ----
    def split_stats(self, ds, merged: bool = False):
        """Host standardization statistics of a split. ``merged``: the
        perpixel moments are summed across processes (the year-sharded
        train split); a replicated split (val, test) keeps its own."""
        from probunet_torch.data.pipeline import compute_lr_stats_streaming

        std = self.cfg.standardization
        if std == "none":
            return None
        if std == "perpixel" and merged:
            return global_perpixel_stats(ds.hr_np, self.cfg.lowres_scale, self.device,
                                         self.group)
        return compute_lr_stats_streaming(ds.hr_np, self.cfg.lowres_scale, std,
                                          device=self.device)

    # ---- epoch plans ----
    @property
    def steps_per_epoch(self) -> int:
        per = self.cfg.batch_size // self.num_shards
        return min(s // per for s in self.shard_sizes)

    def epoch_batches(self, epoch_seed: int, shuffle: bool = True) -> np.ndarray:
        """(nb, batch_size) GLOBAL train sample ids, the same on every process."""
        return stratified_epoch_batches(self.shard_sizes, self.cfg.batch_size, epoch_seed,
                                        shuffle=shuffle)

    def replicated_batches(self, n: int, batch: Optional[int] = None) -> np.ndarray:
        """Sequential (nb, batch) ids over a replicated split (val, test):
        the order of the single-process eval."""
        batch = batch or self.cfg.batch_size
        nb = n // batch
        return np.arange(nb * batch, dtype=np.int64).reshape(nb, batch)

    # ---- per-step batches ----
    def _host_rows(self, hr_np, batch_gids, stats_np, timestamps_np, replicated_source):
        """This process's rows of one global batch, as host arrays."""
        lids = np.asarray(batch_gids)[local_batch_slice(len(batch_gids), self.pi, self.pc)]
        if not replicated_source:
            lids = lids - self.offset
        item = {"hr": hr_np[lids]}
        if stats_np is not None and self.cfg.standardization in ("pertimestep", "minmax"):
            item["stats"] = tuple(s[lids] for s in stats_np)
        if timestamps_np is not None:
            item["timestamps"] = timestamps_np[lids].astype(np.float32)
        return item

    def _finish(self, item, stats_np):
        """Per-split statistics go to the device once; ``idx`` indexes the rows."""
        if "stats" not in item:
            item["stats"] = None
            if stats_np is not None:
                hit = self._global_stats.get(id(stats_np))
                if hit is None or hit[0] is not stats_np:
                    hit = self._global_stats[id(stats_np)] = (stats_np, tuple(
                        torch.from_numpy(np.asarray(s, np.float32)).to(self.device)
                        for s in stats_np))
                item["stats"] = hit[1]
        item["idx"] = torch.arange(item["hr"].shape[0], device=self.device)
        return item

    def device_batch(self, hr_np: np.ndarray, batch_gids: np.ndarray, stats_np=None,
                     timestamps_np: Optional[np.ndarray] = None,
                     replicated_source: bool = False) -> dict:
        """One step's item of this process: {hr, stats, idx[, timestamps]}
        with its rows of the global batch ``batch_gids`` on its device
        (``idx`` indexes ``hr``). ``replicated_source``: every process holds
        the whole split (val, test), so global ids index it directly."""
        item = self._host_rows(hr_np, batch_gids, stats_np, timestamps_np, replicated_source)
        item = {k: (tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in v)
                    if isinstance(v, tuple)
                    else torch.from_numpy(np.ascontiguousarray(v)).to(self.device))
                for k, v in item.items()}
        return self._finish(item, stats_np)

    def batch_iter(self, hr_np: np.ndarray, batches: np.ndarray, stats_np=None,
                   timestamps_np: Optional[np.ndarray] = None,
                   replicated_source: bool = False, buffer_size: Optional[int] = None):
        """The :meth:`device_batch` items of ``batches`` (nb, batch), their
        host slicing and copies run ``buffer_size`` steps ahead on a
        :class:`~probunet_torch.data.pipeline.DevicePrefetcher` (default
        ``cfg.prefetch_buffer``). Closing the generator stops the worker."""
        from probunet_torch.data.pipeline import DevicePrefetcher

        if buffer_size is None:
            buffer_size = int(getattr(self.cfg, "prefetch_buffer", 2) or 2)

        def host_iter():
            for gids in batches:
                yield self._host_rows(hr_np, gids, stats_np, timestamps_np, replicated_source)

        prefetcher = DevicePrefetcher(host_iter(), buffer_size=buffer_size, device=self.device)
        try:
            for item in prefetcher:
                yield self._finish(item, stats_np)
        finally:
            prefetcher.close()

    @property
    def is_primary(self) -> bool:
        return self.pi == 0


def make_plan(cfg, ds_train, device, shard: Optional[tuple] = None,
              group=None) -> Optional[MultihostPlan]:
    """A :class:`MultihostPlan` when several processes (or data shards
    ``shard`` = (index, count), with their ``group``) run or
    ``--data_shards`` > 1, else None (the single-process path)."""
    _, pc = shard or process_info()
    if pc > 1 or int(cfg.data_shards) > 1:
        return MultihostPlan(cfg, ds_train, device, shard, group)
    return None


def require_single_process(what: str, cfg=None) -> None:
    """Fail fast, before any expensive init, in a path that has no
    multi-process form."""
    _, pc = process_info()
    if pc > 1:
        raise NotImplementedError(f"{what} has no multi-process support yet; run it as one "
                                  "process")
    if cfg is not None and int(getattr(cfg, "data_shards", 0)) > 1:
        raise ValueError(f"--data_shards applies to the multi-process batch plan, which "
                         f"{what} does not use")
