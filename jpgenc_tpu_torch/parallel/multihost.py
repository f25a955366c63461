"""Multi-process control plane over `torch.distributed` with the gloo
backend (counterpart of jpgenc_tpu/parallel/multihost.py).

Every process runs the same program on its own devices; what crosses
between processes is host data only: the finished byte blobs of the
images or stripes a process owns, and the optimize mode's symbol counts.
So every collective here runs on CPU tensors through gloo, which serves
any number of processes on one card or on none (NCCL refuses two ranks on
one GPU and is never needed). A single-process run degenerates every
function to an identity, so the same code path runs everywhere.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group ("gloo", init_method "tcp://ADDRESS:PORT").

    With explicit arguments (all three) this connects to, or as process 0
    hosts, the given coordinator. With none it reads the usual MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK variables; when they are absent the
    process stays single-process and this returns quietly. A configuration
    that is given, explicitly or by the variables, and fails raises.
    Re-entry is a no-op."""
    if dist.is_initialized():
        return
    args = (coordinator_address, num_processes, process_id)
    if all(a is None for a in args):
        if not all(k in os.environ for k in _ENV):
            return                      # no cluster configured
        args = (f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
                int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"]))
    elif any(a is None for a in args):
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id together")
    address, n, rank = args
    dist.init_process_group("gloo", init_method=f"tcp://{address}",
                            world_size=int(n), rank=int(rank))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def owned_indices(n_items: int) -> range:
    """Contiguous shard of item indices owned by this process (batch driver:
    each process encodes its own shard; the manifest keyed by index keeps
    relaunches idempotent)."""
    p, np_ = process_index(), process_count()
    per = -(-n_items // np_)
    return range(min(p * per, n_items), min((p + 1) * per, n_items))


def gather_bytes(local: bytes) -> list[bytes]:
    """All-gather one byte blob per process; every process receives all
    blobs in process order. Fixed-shape exchange: the lengths first, then
    each blob padded to the longest. Single-process runs return [local]."""
    n = process_count()
    if n == 1:
        return [local]
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([len(local)], dtype=torch.int64))
    lens = [int(t) for t in lens]
    buf = torch.zeros(max(max(lens), 1), dtype=torch.uint8)
    if local:
        buf[:len(local)] = torch.frombuffer(bytearray(local),
                                            dtype=torch.uint8)
    blobs = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(blobs, buf)
    return [b[:k].numpy().tobytes() for b, k in zip(blobs, lens)]


def sum_array(local: np.ndarray) -> np.ndarray:
    """Element-wise sum of an integer array over processes (the optimize
    mode's symbol counts; the reference's allgather + sum). Single-process
    runs return the array as it is."""
    if process_count() == 1:
        return local
    t = torch.tensor(np.asarray(local), dtype=torch.int64)    # a copy
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy().astype(local.dtype)
