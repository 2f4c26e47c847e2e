"""The process group of data-parallel training — ``probunet_tpu/parallel/mesh.py``.

The JAX package lays a device mesh over every chip and lets XLA insert the
gradient all-reduce. Here each process drives one card (its rank's device)
and holds its rows of every global batch; this module brings the process
group up and gives the steps what XLA's collectives gave the JAX step:

- :func:`init_process_group`: ``torch.distributed`` from ``torchrun``'s
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) or the JAX package's names (``COORDINATOR_ADDRESS``,
  ``PROBUNET_NUM_PROCESSES``, ``PROBUNET_PROCESS_ID``). The backend follows
  the device (NCCL on a CUDA card, gloo on the CPU) unless the caller names
  one; gloo also moves CUDA tensors, which lets two ranks share one card,
  where NCCL refuses two ranks on one device. A failed init raises: no rank
  carries on alone or on another backend;
- :class:`DataParallel`: this rank's place in the group. Random draws are
  rows of the global draw (``randn``; dropout through the models'
  ``shard=(rank, world)``), so N ranks draw what one process draws
  for the whole global batch; gradients are all-reduced as one flat buffer
  per dtype (``allreduce_grads``) and metrics on the device
  (``reduce_metrics``); ``check_same_params`` is the JAX ``put_state``'s
  guarantee that every rank starts from the same parameters;
- :func:`allgather_f64_rows`: the bit-exact, ordered all-gather under
  ``multihost.allreduce_sum``;
- :class:`SpatialMesh`: the (data, space) grid of ranks of the spatial
  modes (``parallel/spatial*.py``), one process group per row and column.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from probunet_torch.utils import device as _device
from probunet_torch.utils.logging import span


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def launch_env() -> Optional[dict]:
    """(init_method, world_size, rank) of a multi-process launch found in the
    environment, or None. A half-set launch raises rather than running as a
    single process."""
    env = os.environ
    if env.get("PROBUNET_NUM_PROCESSES") or env.get("COORDINATOR_ADDRESS"):
        need = ("COORDINATOR_ADDRESS", "PROBUNET_NUM_PROCESSES", "PROBUNET_PROCESS_ID")
        missing = [n for n in need if not env.get(n)]
        if missing:
            raise ValueError("a multi-process launch by the JAX package's names needs "
                             + ", ".join(need) + "; missing " + ", ".join(missing))
        return {"init_method": f"tcp://{env['COORDINATOR_ADDRESS']}",
                "world_size": int(env["PROBUNET_NUM_PROCESSES"]),
                "rank": int(env["PROBUNET_PROCESS_ID"])}
    if env.get("WORLD_SIZE"):
        need = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
        missing = [n for n in need if not env.get(n)]
        if missing:
            raise ValueError("a torchrun launch needs " + ", ".join(need) + "; missing "
                             + ", ".join(missing))
        return {"init_method": "env://", "world_size": int(env["WORLD_SIZE"]),
                "rank": int(env["RANK"])}
    return None


def local_rank(rank: Optional[int] = None) -> int:
    """``LOCAL_RANK`` (torchrun sets it), else the global rank (``rank``, or
    the process group's): the index of this rank's card on its host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank if rank is not None else dist.get_rank() if is_initialized() else 0


def rank_device(rank: Optional[int] = None) -> torch.device:
    """This rank's card, ``cuda:<LOCAL_RANK>``; raises when the host has no
    such card."""
    idx = local_rank(rank)
    if not torch.cuda.is_available() or idx >= torch.cuda.device_count():
        raise RuntimeError(f"a rank needs CUDA device {idx} (LOCAL_RANK), and this host has "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; "
                           "pass the device to run on")
    return torch.device("cuda", idx)


def resolve_device(device=None) -> torch.device:
    """``utils.device.resolve_device``, except that ``None`` under a process
    group means this rank's card, ``cuda:<LOCAL_RANK>``: the entry points
    that run under a group (the trainer, serving, BCSD) resolve through it."""
    if device is None and is_initialized():
        return rank_device()
    return _device.resolve_device(device)


def init_process_group(launch: dict, device=None, backend: Optional[str] = None) -> torch.device:
    """Join the process group ``launch`` describes (:func:`launch_env`) from
    ``device`` (default this rank's card); returns the device. ``backend``
    defaults to NCCL for a CUDA device and gloo for the CPU."""
    dev = torch.device(device) if device is not None else rank_device(launch["rank"])
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank(launch["rank"]))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev.index} on this host")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend moves CUDA tensors only; use gloo on the CPU")
    dist.init_process_group(backend, init_method=launch["init_method"],
                            world_size=launch["world_size"], rank=launch["rank"])
    return dev


def collective_device() -> torch.device:
    """Where host values go for a collective: the rank's card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def allgather_f64_rows(row, group=None) -> np.ndarray:
    """Every rank's float64 vector ``row``, stacked in rank order:
    (ranks, k), bit for bit on every rank of ``group`` (default all). Any
    reduction of the rows then runs on the host in an order the caller
    fixes; ``all_reduce(SUM)`` would leave the order to the backend."""
    t = torch.from_numpy(np.ascontiguousarray(row, np.float64).ravel()).to(collective_device())
    rows = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, t, group=group)
    return torch.stack(rows).cpu().numpy()


def randn_rows(shape: Sequence[int], generator: Optional[torch.Generator], device,
               dtype: Optional[torch.dtype], axis: int, index: int, count: int) -> torch.Tensor:
    """Shard ``index`` of ``count`` (rows along ``axis``) of the standard
    normals that ``generator`` gives for the global shape, ``shape[axis] *
    count`` rows: every shard draws the global numbers and keeps its own."""
    full = list(shape)
    full[axis] *= count
    out = torch.randn(full, generator=generator, device=device, dtype=dtype)
    return out.narrow(axis, index * shape[axis], shape[axis])


class DataParallel:
    """This process's rank in the initialized default process group, which
    trains on its ``b`` rows of each global batch of ``world * b`` rows
    (``multihost.local_batch_slice``)."""

    def __init__(self):
        if not is_initialized():
            raise RuntimeError("DataParallel needs an initialized process group")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()

    def randn(self, shape: Sequence[int], generator: Optional[torch.Generator] = None,
              device=None, dtype: Optional[torch.dtype] = None, axis: int = 0) -> torch.Tensor:
        """This rank's rows (along ``axis``) of the standard normals that
        ``generator`` gives for the global shape, ``shape[axis] * world``
        rows: one process drawing the global batch draws the same numbers."""
        return randn_rows(shape, generator, device, dtype, axis, self.rank, self.world)

    def allreduce_grads(self, params: Iterable[torch.nn.Parameter], mean: bool) -> None:
        """Replace every ``p.grad`` by the global gradient: summed over the
        ranks, as one flat buffer per dtype, and divided by the world size
        when the loss is a mean over the batch (a loss summed over the batch
        sums its gradients, as the JAX step's global loss does). One
        ``probunet.allreduce`` span."""
        with span("probunet.allreduce"):
            by_dtype: Dict[torch.dtype, list] = {}
            for p in params:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
            for grads in by_dtype.values():
                flat = torch.cat([g.reshape(-1) for g in grads])
                dist.all_reduce(flat)
                if mean:
                    flat.div_(self.world)
                parts = flat.split([g.numel() for g in grads])
                torch._foreach_copy_(grads, [c.view(g.shape) for c, g in zip(parts, grads)])

    def reduce_metrics(self, metrics: Dict, sums: Sequence[str] = (),
                       means: Sequence[str] = ()) -> Dict:
        """``metrics`` with the device scalars named in ``sums`` summed over
        the ranks and those in ``means`` averaged, in one all-reduce on the
        device: no host sync."""
        summed = [k for k in sums if k in metrics]
        names = summed + [k for k in means if k in metrics]
        if not names:
            return metrics
        vec = torch.stack([metrics[k].float() for k in names])
        dist.all_reduce(vec)
        vec[len(summed):].div_(self.world)
        return {**metrics, **dict(zip(names, vec.unbind()))}

    def check_same_params(self, model: torch.nn.Module) -> None:
        """Raise unless every rank holds bit-equal parameters (each
        tensor's float64 sum and sum of squares, gathered and compared)."""
        with torch.no_grad():
            sig = torch.stack([s for p in model.parameters()
                               for s in (p.double().sum(), p.double().square().sum())])
        rows = allgather_f64_rows(sig.cpu().numpy())
        bad = [r for r in range(self.world) if not np.array_equal(rows[r], rows[0])]
        if bad:
            raise RuntimeError(f"ranks {bad} start from other parameters than rank 0 "
                               "(another seed, or another checkpoint)")


def data_parallel() -> Optional[DataParallel]:
    """A :class:`DataParallel` of the default process group when one is
    initialized, else None (a single process: every step as without one)."""
    return DataParallel() if is_initialized() else None


class SpatialMesh:
    """The ranks of the spatial modes as a (data, space) grid — the JAX
    package's ``make_mesh((dp, -1), ("data", "space"))`` with one rank in
    place of each device: rank r has data index ``r // sp`` and space index
    ``r % sp``. The ``sp`` ranks of a data index form its space group (they
    hold the rows of one batch shard, H split in rank order); the ``dp``
    ranks of a space index form a data group. ``dp=1`` is the pure spatial
    mode: one space group of every rank. Without a process group the mesh is
    one rank (``sp = dp = 1``, no groups), and the spatial collectives are
    the identity.

    Every rank creates every group, in the same order, including the groups
    it is not in (``torch.distributed.new_group`` is collective)."""

    def __init__(self, dp: int = 1):
        rank, world = (dist.get_rank(), dist.get_world_size()) if is_initialized() else (0, 1)
        if dp < 1 or world % dp:
            raise ValueError(f"{world} ranks do not split into {dp} data shards")
        self.dp, self.sp = dp, world // dp
        self.data_index, self.space_index = divmod(rank, self.sp)
        #: global ranks of this rank's space group, in space order
        self.space_ranks = [self.data_index * self.sp + s for s in range(self.sp)]
        self.space_group = self.data_group = None
        if is_initialized():
            spaces = [dist.new_group([d * self.sp + s for s in range(self.sp)])
                      for d in range(dp)]
            datas = [dist.new_group([d * self.sp + s for d in range(dp)])
                     for s in range(self.sp)]
            self.space_group = spaces[self.data_index]
            self.data_group = datas[self.space_index]

    def randn(self, shape: Sequence[int], generator: Optional[torch.Generator] = None,
              device=None, dtype: Optional[torch.dtype] = None, axis: int = 0) -> torch.Tensor:
        """This data index's rows (along ``axis``) of the standard normals of
        the global batch: the same numbers on every rank of a space group,
        and what one process draws for the whole batch."""
        return randn_rows(shape, generator, device, dtype, axis, self.data_index, self.dp)
