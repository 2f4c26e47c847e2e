"""Host->device streaming pipeline — ``probunet_tpu/data/pipeline.py``.

The default training mode keeps the whole HR tensor on the device. For
datasets that do not fit, this module streams batches: a background thread
slices the host array, stages each batch in pinned host memory and copies it
to the card on a side CUDA stream while the card computes the current step,
so the step never waits on the host link.

Also the streaming computation of the standardization statistics: pooling
on the device chunk by chunk, accumulation in float64 on the host, so the
statistics never need the full tensor on the device either.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from probunet_torch.data import transforms
from probunet_torch.ops.resample import avg_pool
from probunet_torch.utils.device import resolve_device


def _tree_map(fn, obj):
    """``fn`` over the arrays/tensors of nested dicts, tuples and lists."""
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_tree_map(fn, v) for v in obj)
    return fn(obj)


class ThreadPrefetcher:
    """Drain any item-producing iterator in a background thread through a
    bounded queue, so producing item k+1 overlaps the consumer's work on
    item k. Items pass through ``transform`` (if given) inside the worker
    thread; an exception there reaches the consumer. :meth:`close` stops the
    worker of a consumer that leaves early."""

    def __init__(self, it: Iterator, buffer_size: int = 2, transform=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._transform = transform
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, args=(it,), daemon=True)
        self._thread.start()

    def _worker(self, it):
        try:
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(self._transform(item) if self._transform else item)
        except Exception as e:  # surface worker errors to the consumer
            self._q.put(e)
        self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self) -> None:
        """Stop the worker: drain what it queues until it has exited."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.01)


class DevicePrefetcher(ThreadPrefetcher):
    """Wrap a host iterator of numpy items; keep ``buffer_size`` items
    copied to ``device`` ahead of the consumer.

    On a CUDA device the worker thread stages each array in one of two
    pinned host buffers and copies it on a side stream. A buffer is refilled
    only after the event of its last copy has completed. The consumer's
    stream waits on the event of each item's copies before its tensors are
    used, and each tensor is ``record_stream``-ed on the consumer's stream,
    so the caching allocator cannot hand its memory to a later copy while
    the consumer's kernels still read it. On the CPU items become tensors
    that share the host arrays."""

    def __init__(self, host_iter: Iterator, buffer_size: int = 2, device=None):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            if self.device.index is None:   # the worker's set_device needs an index
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
            self._slots = [{}, {}]             # pinned staging buffers by item key path
            self._slot_done = [None, None]     # the event of each slot's last copy
            self._next = 0
        super().__init__(host_iter, buffer_size, transform=self._put_item)

    def _put_item(self, item):
        if not self._cuda:
            return _tree_map(torch.as_tensor, item)
        torch.cuda.set_device(self.device)  # this runs in the worker thread
        slot = self._next
        self._next ^= 1
        if self._slot_done[slot] is not None:
            self._slot_done[slot].synchronize()   # its last copy has left the buffer
        bufs = self._slots[slot]
        keys = itertools.count()

        def put(a):
            src = torch.from_numpy(np.ascontiguousarray(a))
            key = next(keys)
            buf = bufs.get(key)
            if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                buf = bufs[key] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            buf.copy_(src)
            return torch.empty(src.shape, dtype=src.dtype, device=self.device).copy_(
                buf, non_blocking=True)

        with torch.cuda.stream(self._stream):
            out = _tree_map(put, item)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._slot_done[slot] = done
        return out, done

    def __iter__(self):
        for item in super().__iter__():
            if not self._cuda:
                yield item
                continue
            item, done = item
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            _tree_map(lambda t: t.record_stream(stream), item)
            yield item


def stream_batches(
    hr_np: np.ndarray,
    batch_size: int,
    epoch_seed: int,
    stats_np: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    standardization: str = "perpixel",
    device=None,
    start_batch: int = 0,
    timestamps_np: Optional[np.ndarray] = None,
) -> Iterator[Dict]:
    """Yield {hr, stats[, timestamps]} batches on ``device`` (default the
    CUDA card), double-buffered, in the order of
    ``ClimexDataset.epoch_indices`` (``epoch_seed``'s permutation, the
    remainder dropped) from batch ``start_batch`` on. For
    pertimestep/minmax, per-sample stats slices ride along with the batch;
    perpixel (global) stats are copied to the device once and passed with
    every batch. With ``timestamps_np`` (the models that condition on time)
    each batch's timestamps ride along too, as float32, on the same copy
    stream as ``hr``. The returned generator's ``close()`` stops the worker
    thread."""
    dev = resolve_device(device)
    n = hr_np.shape[0]
    order = np.random.default_rng(epoch_seed).permutation(n)
    nb = n // batch_size
    per_sample = stats_np is not None and standardization in ("pertimestep", "minmax")
    global_stats = None
    if stats_np is not None and not per_sample:
        global_stats = tuple(torch.from_numpy(np.asarray(s, np.float32)).to(dev)
                             for s in stats_np)

    def host_iter():
        # start_batch: resume an interrupted epoch mid-way (identical order —
        # the permutation is a pure function of epoch_seed)
        for b in range(start_batch, nb):
            idx = order[b * batch_size:(b + 1) * batch_size]
            item = {"hr": hr_np[idx]}
            if per_sample:
                item["stats"] = (stats_np[0][idx], stats_np[1][idx])
            if timestamps_np is not None:
                item["timestamps"] = timestamps_np[idx].astype(np.float32)
            yield item

    prefetcher = DevicePrefetcher(host_iter(), device=dev)
    try:
        for item in prefetcher:
            item.setdefault("stats", global_stats)
            yield item
    finally:
        prefetcher.close()


def lr_moments_streaming(hr_np: np.ndarray, lowres_scale: int, chunk: int = 512,
                         device=None):
    """Raw per-pixel LR moments of a host-resident HR tensor: float64
    (sum, sum_of_squares, count) on the LR grid, accumulated chunk by chunk.
    Pooling runs on ``device`` (default the CUDA card); accumulation is
    float64 on the host, since fp32 sums of squares of Kelvin-scale fields
    over a century lose all precision in ``s2 - n*mean^2``."""
    dev = resolve_device(device)
    t = hr_np.shape[0]
    s1 = s2 = None
    for lo in range(0, t, chunk):
        lr = avg_pool(torch.from_numpy(np.ascontiguousarray(hr_np[lo:lo + chunk])).to(dev),
                      lowres_scale)
        lr64 = lr.cpu().numpy().astype(np.float64)
        c1 = lr64.sum(axis=0)
        c2 = (lr64 * lr64).sum(axis=0)
        s1 = c1 if s1 is None else s1 + c1
        s2 = c2 if s2 is None else s2 + c2
    return s1, s2, t


def compute_lr_stats_streaming(
    hr_np: np.ndarray,
    lowres_scale: int,
    standardization: str,
    chunk: int = 512,
    device=None,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Chunked equivalent of ``transforms.compute_lr_stats`` for
    host-resident datasets, as host arrays. Matches the non-streaming result
    (unbiased std)."""
    if standardization == "none":
        return None
    dev = resolve_device(device)

    if standardization == "perpixel":
        s1, s2, n = lr_moments_streaming(hr_np, lowres_scale, chunk, dev)
        mean = s1 / n
        # unbiased variance (torch std default, climex_utils.py:174)
        var = (s2 - n * mean * mean) / (n - 1)
        std = np.sqrt(np.maximum(var, 0.0)).astype(np.float32)
        mean = mean.astype(np.float32)
        s = lowres_scale
        mean_hr = np.repeat(np.repeat(mean, s, axis=0), s, axis=1)
        std_hr = np.repeat(np.repeat(std, s, axis=0), s, axis=1)
        return mean_hr, std_hr

    # per-sample modes reduce within each sample — chunked trivially
    parts0, parts1 = [], []
    for lo in range(0, hr_np.shape[0], chunk):
        hr = torch.from_numpy(np.ascontiguousarray(hr_np[lo:lo + chunk])).to(dev)
        a, b = transforms.compute_lr_stats(hr, lowres_scale, standardization)
        parts0.append(a.cpu().numpy())
        parts1.append(b.cpu().numpy())
    return np.concatenate(parts0, axis=0), np.concatenate(parts1, axis=0)
