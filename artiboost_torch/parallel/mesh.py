"""Data parallelism across processes (counterpart of
``artiboost_tpu/parallel/mesh.py``: the mesh's ``data`` axis as a
``torch.distributed`` process group).

Every rank runs the same program on its own rows of the global batch.
The loader makes every draw of the global batch on every rank and each
rank keeps the rows ``rows(n)`` gives it, as ``put_global`` hands each
process its shard of a host array; parameters and buffers start equal
(``broadcast_module``), gradients are averaged over ranks before the
optimizer (``all_reduce_grads``), and BatchNorm and the metrics reduce
over the global batch. So a run over N ranks computes what one rank
computes on the same global batch, up to the order of float reductions.

With no process group every helper is the identity of one rank, so the
single-process path is unchanged."""
from __future__ import annotations

import datetime
import inspect
import json
import os
import socket
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from artiboost_torch.utils import profiling
from artiboost_torch.utils.misc import logger

TIMEOUT_S = 300  # a lost rank fails the run after this long instead of hanging it


def choose_backend(device_type: str, hosts: List[Tuple[str, int]], rank: int
                   ) -> Tuple[str, int, int]:
    """``hosts[r]`` = (host name, cards it sees) of rank r -> (backend, this
    rank's index among the ranks on its host, their number). NCCL when the
    run is on cards and every host has a card for each of its ranks; gloo on
    the CPU and when ranks share a card (NCCL refuses two ranks on one
    device). Every rank gets the same backend from the same table."""
    local = [r for r, (h, _) in enumerate(hosts) if h == hosts[rank][0]]
    per_host: Dict[str, List[int]] = {}
    for h, n in hosts:
        per_host.setdefault(h, [0, n])[0] += 1
    nccl = device_type == "cuda" and all(n and k <= n for k, n in per_host.values())
    return ("nccl" if nccl else "gloo"), local.index(rank), len(local)


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device_type: str = "cuda",
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Join a process group (``--multihost``) -> whether one is joined.

    ``coordinator`` is ``host:port`` of rank 0's rendezvous, with the world
    size and this process's rank; the ranks then tell each other their host
    and its cards through the rendezvous store, which gives each its local
    rank (its card) and the backend (``choose_backend``), on one host or
    many. Without it the ranks come from torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` (as JAX reads
    ``COORDINATOR_ADDRESS``); with neither, a single-process run joins
    nothing. A repeated call does nothing."""
    if dist.is_initialized():
        return True
    n_cards = torch.cuda.device_count() if device_type == "cuda" else 0
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is not None:
        world, rank = int(num_processes), int(process_id)
        host, port = coordinator.rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout)
        store.set(f"artiboost/host/{rank}", json.dumps([socket.gethostname(), n_cards]))
        hosts = [tuple(json.loads(store.get(f"artiboost/host/{r}"))) for r in range(world)]
        backend, local_rank, local_world = choose_backend(device_type, hosts, rank)
        kw = {"store": store}
    elif "RANK" in os.environ and "MASTER_ADDR" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        backend, _, _ = choose_backend(device_type, [("", n_cards)] * local_world, 0)
        kw = {"init_method": "env://"}
    else:
        return False
    if device_type == "cuda" and n_cards:
        torch.cuda.set_device(local_rank % n_cards)
        if backend == "nccl" and "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            # bind the communicator to the card now, not at the first collective
            kw["device_id"] = torch.device("cuda", local_rank % n_cards)
    dist.init_process_group(backend, world_size=world, rank=rank, timeout=timeout, **kw)
    logger.info(f"process group: rank {rank} of {world}, backend {backend} "
                f"({local_world} ranks on this host, {n_cards} cards)")
    return True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned_rank(rank: int, entry: Callable, argv: List[str], world: int, port: int,
                  results) -> None:
    out = entry(list(argv) + ["--multihost", "--coordinator", f"localhost:{port}",
                              "--num_processes", str(world), "--process_id", str(rank)])
    if rank == 0 and results is not None:
        results.put(out)


def spawn_ranks(entry: Callable, argv: List[str], world: int, keep_result: bool = False):
    """``--n_devices``: ``world`` local processes, each ``entry(argv + the
    rank flags)`` joined through a rendezvous on a free localhost port, one
    a card where there are enough (``init_distributed``). Returns once all
    have finished; with ``keep_result``, rank 0's return value (it must
    pickle), else None."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue() if keep_result else None
    ranks = mp.spawn(_spawned_rank, args=(entry, list(argv), world, _free_port(), results),
                     nprocs=world, join=False)
    out, done = None, False
    while not done:
        # rank 0 blocks in put() until its result is read: drain before the join
        done = ranks.join(timeout=1)
        if results is not None and not results.empty():
            out = results.get()
    return out


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def backend() -> Optional[str]:
    return dist.get_backend() if active() else None


def rank_device(device: torch.device) -> torch.device:
    """This rank's card for a CUDA run (the one ``init_distributed`` set),
    else ``device``."""
    if device.type == "cuda" and device.index is None and active():
        return torch.device("cuda", torch.cuda.current_device())
    return device


def close() -> None:
    if active():
        dist.destroy_process_group()


def rows(n: int) -> Tuple[int, int]:
    """(lo, hi): the rows of an n-row global batch this rank owns, a
    contiguous 1/world of them (``batch_sharding``'s P("data"))."""
    w = world()
    if n % w:
        raise ValueError(f"a global batch of {n} rows does not tile {w} ranks")
    k = n // w
    return rank() * k, (rank() + 1) * k


def shard_rows(tree, n: int):
    """Every tensor of a nested dict of draws or a batch, each with n
    leading rows, cut to this rank's rows."""
    if world() == 1:
        return tree
    lo, hi = rows(n)
    if isinstance(tree, dict):
        return {k: shard_rows(v, n) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        if tree.shape[0] != n:
            raise ValueError(f"a tensor of {tuple(tree.shape)} has no {n} leading rows")
        return tree[lo:hi]
    return tree


def _on_backend(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend reduces it: gloo on the host (it reduces CUDA
    tensors only in some collectives), NCCL on this rank's card."""
    if backend() == "gloo":
        return t.cpu()
    return t.cuda() if not t.is_cuda else t


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over ranks (the same bits on every rank)."""
    if not active():
        return t
    with profiling.trace("mesh/all_reduce", bytes=_nbytes(t)):
        staged = _on_backend(t)
        dist.all_reduce(staged)
        if staged is not t:
            t.copy_(staged)
        return t


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """A new tensor: the mean of ``t`` over ranks."""
    if not active():
        return t
    out = all_reduce_sum_(t.detach().clone())
    return out / world()


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Concatenate every rank's ``t`` along dim 0, in rank order (every
    rank's ``t`` has the same shape)."""
    if world() == 1:
        return t
    with profiling.trace("mesh/all_gather", bytes=_nbytes(t)):
        src = _on_backend(t.detach().contiguous())
        parts = [torch.empty_like(src) for _ in range(world())]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(t.device)


def gather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order, on every rank."""
    if not active():
        return [obj]
    with profiling.trace("mesh/all_gather_object"):
        out = [None] * world()
        dist.all_gather_object(out, obj)
        return out


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    if not active():
        return t
    with profiling.trace("mesh/broadcast", bytes=_nbytes(t)):
        staged = _on_backend(t)
        dist.broadcast(staged, src)
        if staged is not t:
            t.copy_(staged)
        return t


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t`` this rank puts into a collective (a span's count)."""
    return t.numel() * t.element_size()


def _flat_groups(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers onto every rank, one flat
    broadcast per dtype."""
    if not active():
        return
    state = [t for t in list(module.parameters()) + list(module.buffers()) if t.numel()]
    for ts in _flat_groups(state).values():
        flat = broadcast_(torch.cat([t.reshape(-1) for t in ts]), src)
        for t, piece in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(piece.view_as(t))


@torch.no_grad()
def all_reduce_grads(params: List[torch.Tensor]) -> None:
    """Each ``.grad`` becomes its mean over ranks, one flat all-reduce per
    dtype (every rank holds gradients for the same parameters)."""
    if not active():
        return
    grads = [p.grad for p in params if p.grad is not None]
    with profiling.trace("mesh/all_reduce_grads"):
        for gs in _flat_groups(grads).values():
            flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in gs]))
            flat /= world()
            for g, piece in zip(gs, flat.split([g.numel() for g in gs])):
                g.copy_(piece.view_as(g))


def shard_normaliser(count: torch.Tensor) -> torch.Tensor:
    """The global count of a masked mean over this rank's share: a rank
    dividing its local sum by this gives a loss whose mean over ranks is
    the global masked mean (the count is data, so it carries no gradient)."""
    if world() == 1:
        return count
    return all_reduce_mean(count.detach())
