"""Multi-process runtime: ``torch.distributed`` init, the shard group, and
the collectives the row-sharded solve makes.

Port of the reference package's ``parallel/runtime.py`` (``jax.distributed``
and a 1-D device mesh).  Here each rank is one process that owns one shard
and one device:

* :func:`init_distributed` brings up the process group from an explicit
  ``init_method`` (a ``file://`` rendezvous, as the tests and the dry run
  use, or ``tcp://host:port``) or from torchrun's environment
  (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``).  In a
  single process without either it is a no-op returning False, and a
  second call is safe.
* The backend follows the topology, never an error: NCCL where each rank
  has a card of its own, gloo on the CPU, and gloo with every collective's
  tensors staged through pinned host buffers where several ranks share one
  card (NCCL refuses two ranks on one GPU, and gloo takes no point-to-point
  transfer of CUDA tensors).  :func:`choose_backend` is the rule; the
  choice is in :func:`topology_summary` and every record.
* :func:`solver_mesh` (the reference's name) makes the shard group over
  the first ``n_shards`` ranks in place of a device mesh.  Its collectives
  (``all_reduce``, ``all_gather``, ``exchange``) are the only communication
  of ``parallel.sharded``, counted in ``ShardGroup.stats``; a failed
  collective raises, nothing retries another way.

Contiguous row shards go to consecutive ranks, so the frontier exchange is
between neighbouring ranks only, and the reductions are all-reduces.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT_S = 120  # a collective that waits longer raises: a lost rank fails the run

# set by init_distributed: backend, staged, device of this rank
_STATE: dict = {}


def choose_backend(device_type: str, world_size: int, cards: int) -> tuple[str, bool]:
    """(backend, staged) for ``world_size`` ranks on ``device_type`` with
    ``cards`` CUDA devices on the host: NCCL when every rank has a card of
    its own, gloo on the CPU, gloo staged through host memory when ranks
    share a card."""
    if device_type == "cpu":
        return "gloo", False
    if device_type != "cuda":
        raise ValueError(f"device type {device_type!r}: cpu or cuda")
    if cards < 1:
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return ("nccl", False) if world_size <= cards else ("gloo", True)


def rank_device(device_type: str, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank % cards``."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, device: str = "cuda") -> bool:
    """Initialize the process group for a multi-process solve.

    Each argument: the explicit value, else torchrun's environment
    (``WORLD_SIZE``, ``RANK``; ``MASTER_ADDR`` / ``MASTER_PORT`` give the
    ``env://`` rendezvous when ``init_method`` is None).  ``device`` is the
    ranks' device type ("cuda": card ``rank % cards``; "cpu").  Returns
    True when a world of more than one process is up, False for the
    single-process no-op (no ``init_method`` and no environment) and for a
    world of one.  Idempotent: a second call returns the same answer.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None:
        if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT") and world_size):
            return False
        init_method = "env://"
    if world_size is None or rank is None:
        raise ValueError(f"init_method {init_method!r} needs world_size and rank "
                         "(arguments or WORLD_SIZE / RANK)")
    cards = torch.cuda.device_count() if device == "cuda" else 0
    backend, staged = choose_backend(device, world_size, cards)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _STATE.update(backend=backend, staged=staged, device=dev)
    return world_size > 1


def barrier() -> None:
    """Wait for every rank (a no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()


def shutdown() -> None:
    """Destroy the process group (after every rank's last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.clear()


@dataclasses.dataclass
class ShardGroup:
    """The ranks ``[0, size)``, each owning one shard on its ``device``.

    Without a process group (one process, no init) it is a group of one
    whose collectives return their input.  Collectives take tensors on
    ``device``; where ``staged`` they pass through pinned host buffers.
    """

    size: int
    rank: int
    device: torch.device
    backend: str  # "nccl", "gloo" or "none" (a group of one, no process group)
    staged: bool = False
    group: object = None  # the ProcessGroup (None: the default group)
    # this rank's collectives since reset_stats(): calls by kind, the
    # point-to-point messages it sent and the bytes it sent in all
    stats: dict = dataclasses.field(default_factory=dict)
    _pins: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.reset_stats()

    @property
    def distributed(self) -> bool:
        return self.backend != "none"

    def reset_stats(self) -> None:
        self.stats.update(all_reduce=0, all_gather=0, exchange=0, messages=0, bytes=0)

    def _count(self, kind: str, *tensors) -> None:
        self.stats[kind] += 1
        self.stats["bytes"] += sum(t.numel() * t.element_size() for t in tensors)

    def _host(self, t: torch.Tensor, slot) -> torch.Tensor:
        """A pinned host buffer of ``t``'s shape and dtype, one per slot."""
        key = (slot, t.dtype, tuple(t.shape))
        h = self._pins.get(key)
        if h is None:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pins[key] = h
        return h

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of ``t`` over the group, in place; returns ``t``."""
        if not self.distributed:
            return t
        self._count("all_reduce", t)
        if self.staged:
            h = self._host(t, "ar")
            h.copy_(t)
            dist.all_reduce(h, group=self.group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` (equal shapes) concatenated in rank order, by
        ``dist.all_gather``, a collective both backends take."""
        if not self.distributed:
            return t
        self._count("all_gather", t)
        src = self._host(t, "ag") if self.staged else t
        if self.staged:
            src.copy_(t)
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts)
        return out.to(self.device) if self.staged else out

    def exchange(self, sends, recvs) -> None:
        """Point-to-point: each (tensor, peer) of ``sends`` to its peer,
        each (buffer, peer) of ``recvs`` filled from its peer; returns when
        every transfer is done.  NCCL batches them
        (``dist.batch_isend_irecv``); gloo posts ``isend`` / ``irecv`` on
        host tensors (staged through pinned buffers from a card)."""
        if not sends and not recvs:
            return
        if not self.distributed:
            raise RuntimeError("a group of one has no peers to exchange with")
        self._count("exchange", *(t for t, _ in sends))
        self.stats["messages"] += len(sends)
        if self.backend == "nccl":
            ops = ([dist.P2POp(dist.isend, t, p, self.group) for t, p in sends]
                   + [dist.P2POp(dist.irecv, t, p, self.group) for t, p in recvs])
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            return
        hs = [(self._host(t, ("s", i)) if self.staged else t, p)
              for i, (t, p) in enumerate(sends)]
        hr = [(self._host(t, ("r", i)) if self.staged else t, p)
              for i, (t, p) in enumerate(recvs)]
        if self.staged:
            for (h, _), (t, _) in zip(hs, sends):
                h.copy_(t)
        works = ([dist.isend(h, p, group=self.group) for h, p in hs]
                 + [dist.irecv(h, p, group=self.group) for h, p in hr])
        for w in works:
            w.wait()
        if self.staged:
            for (h, _), (t, _) in zip(hr, recvs):
                t.copy_(h)


def solver_mesh(n_shards: int | None = None, device: str = "cuda") -> ShardGroup | None:
    """The shard group over the first ``n_shards`` ranks (all by default),
    with this rank's device.  Every rank of the world calls it (a subgroup
    is made collectively); a rank outside the group gets None.  Raises past
    the world size.  Without a process group: a group of one on
    ``device`` (card 0, or the CPU)."""
    if not dist.is_initialized():
        if n_shards not in (None, 1):
            raise ValueError(f"n_shards={n_shards} exceeds 1 process (init_distributed "
                             "first)")
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        return ShardGroup(size=1, rank=0, device=rank_device(device, 0), backend="none")
    world = dist.get_world_size()
    n = world if n_shards is None else n_shards
    if not 1 <= n <= world:
        raise ValueError(f"n_shards={n_shards} exceeds {world} ranks")
    rank = dist.get_rank()
    group = None if n == world else dist.new_group(ranks=list(range(n)))
    if rank >= n:
        return None
    return ShardGroup(size=n, rank=rank, device=_STATE["device"], backend=_STATE["backend"],
                      staged=_STATE["staged"], group=group)


def topology_summary() -> dict:
    """Processes, devices and the backend as a JSON-ready dict."""
    up = dist.is_initialized()
    dev = _STATE.get("device")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    on_card = cards > 0 if dev is None else dev.type == "cuda"
    return dict(
        num_processes=dist.get_world_size() if up else 1,
        process_id=dist.get_rank() if up else 0,
        num_devices=cards,
        platform="gpu" if on_card else "cpu",
        device_kind=torch.cuda.get_device_name(dev or 0) if on_card else "cpu",
        backend=_STATE.get("backend", "none"),
        staged=_STATE.get("staged", False),
    )
