"""Data parallelism over ``torch.distributed``: one process a GPU, the
batch split over the ranks; counterpart of ``stego_tpu/parallel/mesh.py``
and ``parallel/multihost.py``.

The JAX package runs one SPMD program over a data mesh, and XLA inserts the
collectives. Here each rank runs the one-process code on its rows of the
global batch, and the few places where the ranks meet call the functions
below: the gradient average, the global counts and means of the losses, the
gathers of the negatives, the feature-pyramid head's BatchNorm
statistics, the confusion matrices, the row-sharded feature cache and the
KNN table. Without a group every function is the identity
and no collective runs; in a group of one (the card's NCCL check) the
collectives run and change nothing.

Every collective is built on ``all_reduce`` and ``broadcast`` alone: gloo
has only those two for CUDA tensors, and the card's two-rank check runs two
ranks on one GPU over gloo, because NCCL refuses two ranks on one device.
A gather is a sum of zero buffers into which each rank wrote its own rows,
taken over the bytes (``uint8``), so that it copies every value bit for
bit (a float sum would turn -0.0 into +0.0).

* :func:`maybe_initialize_distributed` joins the process group from
  ``torch.distributed.run``'s environment (``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from its arguments:
  NCCL on ``cuda:LOCAL_RANK`` by default, gloo when the caller asks for the
  CPU (the tests) or names it.
* :func:`launch` runs an entry point on the processes ``num_devices`` asks
  for, starting them itself when no launcher did.
* :func:`gather_rows` and :func:`all_reduce_sum` (autograd functions; the
  second sums the feature-pyramid head's BatchNorm statistics),
  :func:`row_take`
  (``mesh.py:sharded_row_take``), :func:`average_grads`,
  :func:`all_reduce_`, :func:`broadcast_module`, :func:`masked_mean` and
  :func:`local_rows` are the collectives and the batch split.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as tdist

# The device this process's collectives run on (its GPU, or the CPU under
# gloo), set when it joins a group.
_device: Optional[torch.device] = None
TIMEOUT_S = 600.0
# Collective calls in this process and the host seconds spent in them (a
# call returns when gloo's collective ends; NCCL's when it is queued). Read
# and reset by chip_smoke.py.
CALLS = 0
SECONDS = 0.0


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world() -> int:
    """The number of processes (1 without a group)."""
    return tdist.get_world_size() if initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return tdist.get_rank() if initialized() else 0


def is_primary() -> bool:
    """Rank 0 writes the logs, the checkpoints, the figures and the
    caches."""
    return rank() == 0


def device() -> torch.device:
    """The device of this process: the one it joined its group on, else
    ``cuda:LOCAL_RANK`` (``cuda:0`` without a launcher)."""
    if _device is not None:
        return _device
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def num_processes(num_devices: int) -> int:
    """The processes a run of ``num_devices`` takes (``make_mesh``'s
    count): 0 means every visible GPU, one on a machine without one."""
    if num_devices and num_devices > 0:
        return int(num_devices)
    return max(1, torch.cuda.device_count())


def maybe_initialize_distributed(
        backend: Optional[str] = None,
        device: Optional[torch.device | str] = None,
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        init_method: Optional[str] = None,
        timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group when this is one of several processes;
    returns True if it is. The rank and world size come from the arguments
    or from ``RANK``/``WORLD_SIZE`` (and the rendezvous from
    ``init_method`` or ``MASTER_ADDR``/``MASTER_PORT``, ``env://``). The
    device defaults to ``cuda:LOCAL_RANK``, made the current CUDA device
    before the group starts, and the backend to NCCL there; a CPU device
    takes gloo. A collective that waits past ``timeout_s`` raises, so a
    rank that died does not hang the others for ever. An explicit
    ``world_size`` of 1 starts a group of one."""
    global _device
    if initialized():
        return world() > 1
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        if world_size <= 1:
            return False
    rank = int(rank if rank is not None else os.environ["RANK"])
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} asked for {dev} and this "
                               f"machine has no CUDA device")
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    tdist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _device = dev
    return world_size > 1


def destroy() -> None:
    """Leave the process group (nothing without one)."""
    global _device
    if initialized():
        tdist.destroy_process_group()
    _device = None


def _on_group(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the collectives' device (NCCL takes CUDA tensors only)."""
    return t if _device is None or t.device == _device else t.to(_device)


def all_reduce_(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Sum (or ``op="max"``) ``t`` over the ranks, in place where ``t`` is
    on the collectives' device; returns the result. Every rank must call
    it. The identity without a group."""
    global CALLS, SECONDS
    if not initialized():
        return t
    t0 = time.perf_counter()
    buf = _on_group(t)
    tdist.all_reduce(buf, op=tdist.ReduceOp.MAX if op == "max"
                     else tdist.ReduceOp.SUM)
    if buf is not t:
        t.copy_(buf)
    CALLS += 1
    SECONDS += time.perf_counter() - t0
    return t


def barrier() -> None:
    """Wait until every rank arrives (one all_reduce)."""
    if initialized():
        all_reduce_(torch.zeros(1, device=_device))


def _byte_sum_(t: torch.Tensor) -> torch.Tensor:
    """All_reduce ``t``'s bytes, where every rank but one holds zeros in
    each place: a bit-exact gather."""
    all_reduce_(t.view(-1).view(torch.uint8))
    return t


def local_rows(n: int) -> slice:
    """This rank's rows of a global batch of ``n``: the ``n // world()``
    after ``rank() * n // world()``."""
    w = world()
    if n % w:
        raise ValueError(f"global batch {n} not divisible by {w} processes")
    b = n // w
    return slice(rank() * b, (rank() + 1) * b)


def _gather(x: torch.Tensor) -> torch.Tensor:
    b = x.shape[0]
    return gather_stripes(x, range(rank() * b, (rank() + 1) * b),
                          world() * b)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = slice(rank() * x.shape[0], (rank() + 1) * x.shape[0])
        return _gather(x)

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reaches this rank's rows: the sum of the
        # incoming gradients, then the rank's own slice
        return all_reduce_(g.contiguous().clone())[ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (b, ...) stacked in rank order, (world * b, ...),
    bit for bit. Differentiable: the gradient of rank r's rows is the sum
    over the ranks of the gradients that reached them. The identity without
    a group."""
    if not initialized():
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x.contiguous())
    return _gather(x.detach())


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        # every rank's loss reads the sum: each rank's input takes the sum
        # of the incoming gradients
        return all_reduce_(g.contiguous().clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``x`` (same shape on each), as a new tensor.
    Differentiable: the gradient of a rank's ``x`` is the sum over the
    ranks of the gradients that reached their sums (which
    :func:`average_grads` then divides by W). The identity without a
    group, and no collective runs."""
    if not initialized():
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x.contiguous())
    return all_reduce_(x.detach().clone())


def row_take(block: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """Rows ``ind`` (b,) of an (N, ...) table whose rows are
    block-distributed over the ranks (rank k holds rows [k N / W,
    (k + 1) N / W) as ``block``), for this rank's ``ind``
    (``mesh.py:sharded_row_take``): the ranks gather their index vectors,
    each serves the rows it owns with zeros elsewhere, and one all_reduce of
    the bytes gives every rank every row. An index outside [0, N) gives a
    zero row (the validation's ``-1`` pads)."""
    ind = ind.to(device=block.device, dtype=torch.long)
    rows = block.shape[0]
    idx_all = gather_rows(ind)
    local = idx_all - rank() * rows
    own = (local >= 0) & (local < rows)
    vals = block.index_select(0, torch.clamp(local, 0, rows - 1))
    vals = torch.where(own.view((-1,) + (1,) * (vals.dim() - 1)), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    b = ind.shape[0]
    return _byte_sum_(vals.contiguous())[rank() * b:(rank() + 1) * b]


def masked_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """This rank's share of a mean over the global batch's valid entries:
    ``total / max(count, 1)`` with one process; over W ranks ``W * total /
    max(global count, 1)`` (one all_reduce of the count, which carries no
    gradient), so that the ranks' mean of it, which :func:`average_grads`
    takes of the gradients, is the global mean."""
    if not initialized():
        return total / torch.clamp_min(count, 1)
    count = all_reduce_(count.detach().clone())
    return world() * total / torch.clamp_min(count, 1)


def average_grads(params: Iterable[torch.nn.Parameter],
                  metrics: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """Replace every gradient by its mean over the ranks, in one flat
    all_reduce; the scalar ``metrics``, each a rank's share of a global
    mean, ride in the same buffer and come back as their global values.
    Every parameter needs a gradient (zeros where the loss did not reach
    it), so that every rank's buffer has one layout."""
    params = list(params)
    if not initialized():
        return metrics
    names = list(metrics or {})
    parts = [p.grad.reshape(-1) for p in params]
    parts += [metrics[k].detach().float().reshape(1).to(parts[0].device)
              for k in names]
    flat = all_reduce_(torch.cat(parts)).div_(world())
    start = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[start:start + n].view_as(p.grad))
        start += n
    return {k: flat[start + i] for i, k in enumerate(names)}


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers into every rank's ``module``, in one
    broadcast of their bytes."""
    global CALLS, SECONDS
    if not initialized():
        return
    t0 = time.perf_counter()
    tensors = [t for t in list(module.parameters()) + list(module.buffers())
               if t.numel()]
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1).view(torch.uint8)
                          for t in tensors])
        buf = _on_group(flat)
        tdist.broadcast(buf, src=0)
        flat = buf.to(flat.device)
        start = 0
        for t in tensors:
            n = t.numel() * t.element_size()
            t.view(-1).view(torch.uint8).copy_(flat[start:start + n])
            start += n
    CALLS += 1
    SECONDS += time.perf_counter() - t0


def gather_stripes(rows: torch.Tensor, positions: Sequence[int],
                   n: int) -> torch.Tensor:
    """An (n, ...) table whose rows at ``positions`` are this rank's
    ``rows`` and the others every other rank's (each position written by
    one rank), bit for bit."""
    out = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    if len(positions):
        out[torch.as_tensor(list(positions), device=rows.device)] = rows
    return _byte_sum_(out)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(local_rank: int, fn: Callable, nprocs: int, port: int,
           args: tuple, group: dict) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(nprocs), RANK=str(local_rank),
                      LOCAL_RANK=str(local_rank))
    run_ranked(fn, *args, **group)


def run_ranked(fn: Callable, *args: Any, backend: Optional[str] = None,
               device: Optional[torch.device | str] = None) -> Any:
    """``fn(*args)`` in this process's group, joined from the environment
    (none for one process) with ``backend`` and ``device``
    (:func:`maybe_initialize_distributed`), and left when ``fn`` returns or
    raises."""
    maybe_initialize_distributed(backend, device)
    try:
        return fn(*args)
    finally:
        destroy()


def launch(fn: Callable, num_devices: int, *args: Any,
           prepare: Optional[Callable[[], Any]] = None,
           backend: Optional[str] = None,
           device: Optional[torch.device | str] = None) -> None:
    """Run ``fn(*args)`` on every process of the run. Under a launcher
    (``python -m torch.distributed.run``: ``WORLD_SIZE`` is set) this
    process joins its group and runs it; otherwise, when ``num_devices``
    (:func:`num_processes`) asks for more than one, ``prepare()`` runs here
    (the CUDA library's build, once for all ranks) and one spawned process
    a GPU runs it, and a rank that fails fails the launch; else it runs
    here, alone. ``backend`` and ``device`` are the group's (default NCCL
    on each rank's GPU; the tests ask for gloo on the CPU). ``fn`` must be
    importable (it is pickled)."""
    group = dict(backend=backend, device=device)
    n = num_processes(num_devices)
    if "WORLD_SIZE" in os.environ or n == 1:
        run_ranked(fn, *args, **group)
        return
    if prepare is not None:
        prepare()
    import torch.multiprocessing as mp

    mp.start_processes(_child, args=(fn, n, _free_port(), args, group),
                       nprocs=n, join=True, start_method="spawn")
