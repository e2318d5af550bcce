"""Multi-process training on ``torch.distributed``: process start and the
exchange route.

Port of ``mg_gcn_tpu/parallel/multihost.py``. The JAX package forms one
program over the devices of every process (``jax.distributed``); the port
runs one process each with its own partitions and exchanges blocks between
processes through the helpers here, which ``parallel/dist.py``'s
:class:`~.dist.Ring` calls where a neighbour is remote:

* :func:`initialize` starts the process group from the ``MG_GCN_*``
  variables (or keywords) and decides once how card tensors travel:
  over NCCL when no two processes share a card, else staged through host
  memory over gloo (two processes on one card: NCCL refuses a second rank
  on a card). CPU tensors always go over gloo. The products stay where the
  partitions lie; only the transfer changes path. One line on stderr names
  the route.
* :func:`all_gather_parts` and :func:`exchange` are the two transfers the
  ring needs: every partition's tensor on every process (``psum`` and
  ``pmax``, folded in partition order by the caller) and one batch of
  point-to-point messages (``ppermute``, and the column path's
  ``all_to_all``), posted together so that a ring of sends and receives
  cannot deadlock.

The JAX package's put helpers (``replicate_put``, ``shard_put``,
``tree_shard_put``, ``load_row_sharded``) are ``dist.replicate`` and
``dist.shard`` here: each places only this process's partitions, and
``dist.shard`` reads a ``np.memmap`` (``formats.read_dense(mmap=True)``)
one partition's rows at a time.

A process that has not called :func:`initialize` is a world of one, and
every helper reduces to the one-process form.
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
from dataclasses import dataclass

import torch

DEFAULT_TIMEOUT_S = 600  # a lost peer raises after this long instead of hanging


@dataclass(frozen=True)
class World:
    """This process's place in the run, and the route card tensors take."""

    rank: int
    size: int
    local_device_ids: tuple[int, ...] | None
    route: str  # "nccl", "staged" (through host over gloo) or "gloo" (no card)
    nccl_group: object | None = None


_WORLD: World | None = None  # the process group is the process's, as torch.distributed's is


def process_index() -> int:
    return 0 if _WORLD is None else _WORLD.rank


def process_count() -> int:
    return 1 if _WORLD is None else _WORLD.size


def local_device_ids() -> tuple[int, ...] | None:
    """The card ids ``MG_GCN_LOCAL_DEVICE_IDS`` (or ``local_device_ids=``)
    gave this process, or None."""
    return None if _WORLD is None else _WORLD.local_device_ids


def route() -> str | None:
    return None if _WORLD is None else _WORLD.route


def choose_route(cards: list) -> str:
    """The route for card tensors given every process's cards (a tuple of
    its distinct cards' (host, card id), or None for a process without a
    card): "nccl" when every process has a card and no card is any two
    processes', "staged" when some process has a card otherwise, "gloo"
    when none has. NCCL here takes one card a process (one rank each, its
    ``set_device``): several raise ValueError."""
    if all(c is None for c in cards):
        return "gloo"
    every = [card for c in cards if c is not None for card in c]
    if all(c is not None for c in cards) and len(set(every)) == len(every):
        if any(len(c) > 1 for c in cards):
            raise ValueError(f"the NCCL route takes one card a process; cards {cards}: give each process one "
                             "card id in MG_GCN_LOCAL_DEVICE_IDS")
        return "nccl"
    return "staged"


def _card_identity(ids) -> tuple[tuple[str, str], ...] | None:
    """This process's distinct cards as (host, card uuid) pairs, or None
    without a card."""
    if not torch.cuda.is_available():
        return None
    host = socket.gethostname()
    out = []
    for index in dict.fromkeys(ids or (torch.cuda.current_device(),)):
        uuid = getattr(torch.cuda.get_device_properties(index), "uuid", None)
        out.append((host, str(uuid if uuid is not None else index)))
    return tuple(out)


def initialize(coordinator_address: str | None = None, **kw) -> None:
    """Join the run's process group (a no-op once joined).

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    process 0; keywords ``num_processes``, ``process_id``,
    ``local_device_ids`` and ``timeout`` (seconds, default
    DEFAULT_TIMEOUT_S). Without a coordinator argument,
    ``MG_GCN_COORDINATOR`` gives it, and then ``MG_GCN_NUM_PROCESSES`` and
    ``MG_GCN_PROCESS_ID`` must give each keyword the caller left out (a
    default world of one would let a mis-launched process train a part of
    the model alone); ``MG_GCN_LOCAL_DEVICE_IDS`` (comma list) names this
    process's cards. Every process then prints its route line on stderr."""
    global _WORLD
    if _WORLD is not None:
        return
    if coordinator_address is None and "MG_GCN_COORDINATOR" in os.environ:
        coordinator_address = os.environ["MG_GCN_COORDINATOR"]
        for key, var in (("num_processes", "MG_GCN_NUM_PROCESSES"), ("process_id", "MG_GCN_PROCESS_ID")):
            if key not in kw:  # read only what the caller left out
                if var not in os.environ:
                    raise ValueError(
                        "MG_GCN_COORDINATOR is set but the companion env var "
                        f"{var} is missing — set MG_GCN_NUM_PROCESSES and a "
                        "per-host MG_GCN_PROCESS_ID"
                    )
                kw[key] = int(os.environ[var])
        ldi = os.environ.get("MG_GCN_LOCAL_DEVICE_IDS")
        if ldi and "local_device_ids" not in kw:
            kw["local_device_ids"] = [int(v) for v in ldi.split(",")]
    if coordinator_address is None:
        raise ValueError("no coordinator: set MG_GCN_COORDINATOR=host:port (with MG_GCN_NUM_PROCESSES and"
                         " MG_GCN_PROCESS_ID) or pass coordinator_address")
    if "num_processes" not in kw or "process_id" not in kw:
        raise ValueError("a coordinator needs num_processes and process_id")
    size, rank = int(kw.pop("num_processes")), int(kw.pop("process_id"))
    ids = kw.pop("local_device_ids", None)
    ids = tuple(int(i) for i in ids) if ids else None
    timeout = datetime.timedelta(seconds=float(kw.pop("timeout", DEFAULT_TIMEOUT_S)))
    if kw:
        raise TypeError(f"unknown initialize keywords {sorted(kw)}")
    import torch.distributed as tdist

    address = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    tdist.init_process_group("gloo", init_method=address, world_size=size, rank=rank, timeout=timeout)
    cards = [None] * size
    tdist.all_gather_object(cards, _card_identity(ids))
    try:
        how = choose_route(cards)
    except ValueError:  # every process saw the same cards: all leave
        tdist.destroy_process_group()
        raise
    group = None
    if how == "nccl":
        torch.cuda.set_device(ids[0] if ids else torch.cuda.current_device())
        group = tdist.new_group(backend="nccl", timeout=timeout)
    _WORLD = World(rank=rank, size=size, local_device_ids=ids, route=how, nccl_group=group)
    said = {
        "nccl": "card tensors over NCCL (each process on its own card)",
        "staged": "card tensors staged through host over gloo (processes share a card)",
        "gloo": "gloo (no card)",
    }[how]
    print(f"multihost: process {rank} of {size} ({address}); exchange route: {said}; CPU tensors over gloo",
          file=sys.stderr, flush=True)


def shutdown() -> None:
    """Leave the process group; the process is a world of one again."""
    global _WORLD
    if _WORLD is None:
        return
    import torch.distributed as tdist

    tdist.destroy_process_group()
    _WORLD = None


def broadcast_object(obj, src: int = 0):
    """``obj`` of process ``src`` on every process (a small host object)."""
    if process_count() == 1:
        return obj
    import torch.distributed as tdist

    box = [obj]
    tdist.broadcast_object_list(box, src=src)
    return box[0]


def _on_nccl(t: torch.Tensor) -> bool:
    return t.is_cuda and _WORLD.route == "nccl"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of card tensor ``t`` in pinned memory; the copy waits for
    the card's stream, so the bytes are final before they are sent."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every process's ``t`` (same shape and dtype on each), in process
    order, on ``t``'s device."""
    if process_count() == 1:
        return [t]
    import torch.distributed as tdist

    t = t.contiguous()
    if t.is_cuda and not _on_nccl(t):
        host = _to_host(t)
        out = [torch.empty_like(host) for _ in range(_WORLD.size)]
        tdist.all_gather(out, host)
        return [o.to(t.device) for o in out]
    out = [torch.empty_like(t) for _ in range(_WORLD.size)]
    tdist.all_gather(out, t, group=_WORLD.nccl_group if _on_nccl(t) else None)
    return out


def all_gather_parts(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Every partition's tensor, in partition order, on ``xs[0]``'s device:
    ``xs`` are this process's partitions' tensors (the same count and shape
    on every process; processes own contiguous partitions in rank order)."""
    local = torch.stack([x.to(xs[0].device) for x in xs])
    return [p for block in all_gather(local) for p in block]


def exchange(sends: list, recvs: list) -> list[torch.Tensor]:
    """One batch of messages between processes: ``sends`` are (tensor,
    destination process, tag), ``recvs`` (buffer, source process, tag);
    every message is posted before any is waited for. Sends and receives
    are posted in (peer, tag) order: NCCL ignores tags and pairs a peer's
    messages in the order they were posted, so a sender's order and its
    receiver's must agree. Returns the received tensors in ``recvs``'
    order, each on its buffer's device."""
    if not sends and not recvs:
        return []
    import torch.distributed as tdist

    def by_peer_and_tag(message):
        return message[1], message[2]

    ops, staged = [], []
    for t, dst, tag in sorted(sends, key=by_peer_and_tag):
        t = t.contiguous()
        if t.is_cuda and not _on_nccl(t):
            t = _to_host(t)
        ops.append(tdist.P2POp(tdist.isend, t, dst, group=_WORLD.nccl_group if _on_nccl(t) else None, tag=tag))
    for buf, _, _ in recvs:
        target = buf
        if buf.is_cuda and not _on_nccl(buf):
            target = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        staged.append((target, buf))
    for (target, buf), (_, src, tag) in sorted(zip(staged, recvs), key=lambda e: by_peer_and_tag(e[1])):
        ops.append(tdist.P2POp(tdist.irecv, target, src, group=_WORLD.nccl_group if _on_nccl(buf) else None,
                               tag=tag))
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    return [buf.copy_(target) if target is not buf else buf for target, buf in staged]
