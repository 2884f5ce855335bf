"""Process groups and collectives on ``torch.distributed``: the twin of
``valle_tpu/parallel/dist.py``.

JAX runs one process per host and GSPMD places the collectives; the port
runs one process per card (rank r on ``cuda:{r % device_count}``) and calls
its collectives by hand.  Only ``all_reduce`` (SUM, MAX), ``all_gather``,
``broadcast`` and ``barrier`` are used, so NCCL and gloo both serve.  Gloo
takes CPU tensors here: a CUDA tensor goes through a host copy, so gloo on
the card is for correctness runs (two ranks sharing one card, where NCCL
refuses), not for speed.

Every helper is the identity where ``group`` is None: a run without a
process group, which is the single-process run.
"""

from __future__ import annotations

import datetime
import logging
import socket
from typing import Optional

import torch
import torch.distributed as tdist

DEFAULT_TIMEOUT_S = 1800


def default_backend(device: str) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device: str = "cuda", rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}`` on the card (raises
    without CUDA), the CPU otherwise."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    rank = process_index() if rank is None else rank
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device: str = "cuda",
               backend: Optional[str] = None, force: bool = False,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group of ``num_processes`` ranks at
    ``tcp://<coordinator_address>`` as rank ``process_id``; a no-op at one
    process unless ``force`` (a group of one, which runs every collective).
    Sets this rank's card as the current device.  Returns whether a group
    was made."""
    if not num_processes or (num_processes <= 1 and not force):
        return False
    if not coordinator_address:
        raise ValueError("a process group needs a coordinator address (host:port)")
    if process_id is None and num_processes > 1:
        raise ValueError(f"each of the {num_processes} processes needs its process id")
    rank = process_id or 0
    backend = backend or default_backend(device)
    dev = local_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                             world_size=num_processes, rank=rank,
                             timeout=datetime.timedelta(seconds=timeout_s))
    logging.info(f"process group: rank {rank} of {num_processes} over {backend} on {dev}")
    return True


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def world_group():
    """The group of every rank, or None without one."""
    return tdist.group.WORLD if tdist.is_initialized() else None


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a coordinator address."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _staged(t: torch.Tensor, group):
    """(the tensor the collective takes, whether it is a host copy): gloo
    gets CUDA tensors as host copies."""
    if t.is_cuda and tdist.get_backend(group) == "gloo":
        return t.cpu(), True
    return t, False


_OPS = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}


def all_reduce_(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` with SUM or MAX; returns it."""
    if group is None:
        return t
    buf, staged = _staged(t, group)
    tdist.all_reduce(buf, op=_OPS[op], group=group)
    if staged:
        t.copy_(buf)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along dim 0, in group
    rank order."""
    if group is None:
        return t
    buf, staged = _staged(t.contiguous(), group)
    parts = [torch.empty_like(buf) for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(parts, buf, group=group)
    out = torch.cat(parts)
    return out.to(t.device) if staged else out


def broadcast_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` of the group's first rank, in place on every rank; returns it."""
    if group is None:
        return t
    buf, staged = _staged(t, group)
    tdist.broadcast(buf, src=tdist.get_global_rank(group, 0), group=group)
    if staged:
        t.copy_(buf)
    return t


def _comm_device(group) -> torch.device:
    if tdist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_int(value: int, group=None) -> int:
    """The group's first rank's ``value`` on every rank."""
    if group is None:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=_comm_device(group))
    return int(broadcast_(t, group))


def reduce_ints(values, op: str = "sum", group=None) -> list:
    """Host ints reduced over ``group`` with SUM or MAX."""
    if group is None:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64, device=_comm_device(group))
    return all_reduce_(t, op, group).tolist()


def barrier(group=None) -> None:
    if group is not None:
        tdist.barrier(group=group)


BUCKET_BYTES = 25 * 2**20  # DistributedDataParallel's default bucket


def coalesced_(tensors, op: str = "sum", group=None) -> int:
    """``all_reduce_`` with SUM (op "sum") or ``broadcast_`` (op
    "broadcast") of many tensors, in place, through flattened buckets of at
    most ``BUCKET_BYTES`` (one tensor larger than that is a bucket of its
    own) of one dtype and device: a few calls instead of one per tensor.
    Returns the bytes that went through the collective."""
    if op not in ("sum", "broadcast"):
        raise ValueError(f"coalesced_ takes op 'sum' or 'broadcast', not {op!r}")
    if group is None:
        return 0
    buckets, sizes = {}, {}
    order = []
    for t in tensors:
        key = (t.dtype, t.device)
        if key not in buckets or sizes[key] + t.numel() * t.element_size() > BUCKET_BYTES:
            if key in buckets:
                order.append(buckets[key])
            buckets[key], sizes[key] = [], 0
        buckets[key].append(t)
        sizes[key] += t.numel() * t.element_size()
    order.extend(buckets.values())
    moved = 0
    for bucket in order:
        if not bucket:
            continue
        flat = torch.cat([t.reshape(-1) for t in bucket])
        if op == "broadcast":
            broadcast_(flat, group)
        else:
            all_reduce_(flat, "sum", group)
        moved += flat.numel() * flat.element_size()
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
    return moved
