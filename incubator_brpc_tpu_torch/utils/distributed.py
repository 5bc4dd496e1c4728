"""The process's place in a job of several processes: the port's counterpart
of what ``jax.distributed`` gives the JAX package's multi-controller plane.

A job is ``world_size`` processes, each told its ``rank`` and its own
device explicitly (nothing on the machine tells a process of a cluster).
Process 0 holds the job's ``TCPStore``; the others connect to it. The
store is the rendezvous of every group the port builds, each over
``PrefixStore(key, store)`` by its members and by no one else:

- a link group (``link_group``): the two processes of one multi-controller
  link (``transport/mc_link.py``);
- a session group (``session_group``): the N ranks of one run of a
  collective session (``parallel/mc_dispatch.py``), in party order.

Links and sessions are made on demand by an RPC between some of the
processes, so no collective ``new_group`` over the whole job could build
them.

The backend of a group is the caller's choice: ``gloo`` (CPU tensors, and
on a card the rows stay CUDA tensors that gloo moves through the host) or
``nccl`` (CUDA tensors across cards). A backend that fails to build fails
the link or the session; nothing picks another.

Process 0 must outlive the others: its store is the rendezvous.

Per-run state stays bounded in a long-lived job: a process remembers the
group prefixes it claimed (``Job.claim_key``: the highest epoch of each
of its newest ``KEYS_KEPT`` prefixes, so a reused prefix, or a session run
at an equal or lower epoch, refuses), and a session run's gloo rendezvous
entries leave the store once every party has passed the group's first
collective (``forget_session_rendezvous``).
"""

from __future__ import annotations

import datetime
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from incubator_brpc_tpu_torch.utils.device import DeviceLike, resolve_device

BACKENDS = ("gloo", "nccl")
# group prefixes a process remembers for the reuse guard (the newest ones)
KEYS_KEPT = 64


class Job:
    """One process's membership: its rank, the job's size, its device, the
    backend its links use and the job's store."""

    def __init__(
        self,
        rank: int,
        world_size: int,
        device: torch.device,
        backend: str,
        store: "dist.Store",
    ) -> None:
        self.rank = rank
        self.world_size = world_size
        self.device = device
        self.backend = backend
        self.store = store
        # group prefix -> the highest epoch this process claimed under it,
        # the newest KEYS_KEPT prefixes only
        self._keys: "OrderedDict[str, int]" = OrderedDict()
        self._lock = threading.Lock()

    def claim_key(self, key: str, epoch: int = 0) -> None:
        """A group's store prefix at ``epoch``, once per process: a prefix
        claimed again at an equal or lower epoch would rendezvous with a
        stale group's entries, and refuses. The guard covers the newest
        ``KEYS_KEPT`` prefixes (an older one's run has long left the
        store)."""
        with self._lock:
            last = self._keys.get(key)
            if last is not None and epoch <= last:
                raise ValueError(
                    f"group key {key!r} already used by this process at epoch {last}"
                )
            self._keys[key] = epoch
            self._keys.move_to_end(key)
            while len(self._keys) > KEYS_KEPT:
                self._keys.popitem(last=False)


_job: Optional[Job] = None
_job_lock = threading.Lock()


def init_job(
    rank: int,
    world_size: int,
    store_port: int,
    device: DeviceLike,
    backend: str = "gloo",
    host: str = "127.0.0.1",
    timeout: float = 60.0,
) -> Job:
    """Start (rank 0: hold the ``TCPStore`` on ``host:store_port``) or join
    (every other rank: connect to it, waiting up to ``timeout`` s) the
    job, as this process's one job. ``device`` is this process's own
    device (``"cpu"`` or ``"cuda:N"``; ``None`` is the card)."""
    global _job
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a job of {world_size}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    with _job_lock:
        if _job is not None:
            raise RuntimeError("this process already belongs to a job")
        store = dist.TCPStore(
            host,
            store_port,
            world_size,
            rank == 0,
            timeout=datetime.timedelta(seconds=timeout),
            wait_for_workers=False,
        )
        _job = Job(rank, world_size, resolve_device(device), backend, store)
        return _job


def current_job() -> Optional[Job]:
    """The job this process joined, or None."""
    return _job


def shutdown_job() -> None:
    """Leave the job (the store of rank 0 closes with its last reference)."""
    global _job
    with _job_lock:
        _job = None


def link_group(
    key: str,
    ranks: Sequence[int],
    backend: str,
    timeout: float,
    job: Optional[Job] = None,
) -> "dist.ProcessGroup":
    """The two-rank process group of one link: ``ranks`` are the job ranks
    of side 0 and side 1, and this process's place among them is its rank
    in the group. Both parties call it with the same ``key``; it returns
    once both joined (or raises after ``timeout`` s, which also bounds
    every collective on the group)."""
    job = job or _job
    if job is None:
        raise RuntimeError("link_group needs a job (utils.distributed.init_job)")
    if len(ranks) != 2 or ranks[0] == ranks[1]:
        raise ValueError(f"a link group is two distinct ranks, got {list(ranks)}")
    if job.rank not in ranks:
        raise ValueError(f"rank {job.rank} is not a party of the link {list(ranks)}")
    job.claim_key(key)
    return make_pair_group(
        dist.PrefixStore(key, job.store), list(ranks).index(job.rank), backend, timeout
    )


def session_group(
    session_id: str,
    epoch: int,
    ranks: Sequence[int],
    backend: str,
    timeout: float,
    job: Optional[Job] = None,
) -> "dist.ProcessGroup":
    """The process group of one run of a collective session: ``ranks`` are
    the session's parties in party order, and this process's place among
    them is its rank in the group. Every party calls it with the same
    ``session_id`` and ``epoch`` (a resumed run is a new epoch, so a new
    group); it returns once all joined (or raises after ``timeout`` s,
    which also bounds every collective on the group). One group a run:
    two sessions over the same ranks must not interleave their
    collectives on one group."""
    job = job or _job
    if job is None:
        raise RuntimeError("session_group needs a job (utils.distributed.init_job)")
    ranks = [int(r) for r in ranks]
    if len(set(ranks)) != len(ranks) or len(ranks) < 2:
        raise ValueError(f"a session group is two or more distinct ranks, got {ranks}")
    if job.rank not in ranks:
        raise ValueError(f"rank {job.rank} is not a party of the session {ranks}")
    job.claim_key(f"session/{session_id}", int(epoch))
    return make_group(
        dist.PrefixStore(_session_prefix(session_id, epoch), job.store),
        ranks.index(job.rank), len(ranks), backend, timeout,
    )


def _session_prefix(session_id: str, epoch: int) -> str:
    return f"session/{session_id}/{int(epoch)}"


def forget_session_rendezvous(
    session_id: str, epoch: int, group_rank: int, backend: str, job: Optional[Job] = None
) -> None:
    """Delete this party's rendezvous entry of a session run from the
    job's store. Call it once this party's first collective on the group
    completed: every party then has joined the group (each had to, to send
    to this one), so nobody reads the entry again; when every party has
    called it, the run has left nothing in the store. gloo's rendezvous is
    one entry a rank, ``<prefix>/<device index>/<rank>`` with the one
    device 0; an nccl group's entries are left as they are."""
    job = job or _job
    if job is None or backend != "gloo":
        return
    job.store.delete_key(f"{_session_prefix(session_id, epoch)}/0/{int(group_rank)}")


def make_pair_group(store: "dist.Store", group_rank: int, backend: str, timeout: float):
    """A two-process group of ``backend`` over ``store``, this process at
    ``group_rank``. Raises if the backend is not built into this torch."""
    return make_group(store, group_rank, 2, backend, timeout)


def make_group(store: "dist.Store", group_rank: int, size: int, backend: str, timeout: float):
    """A ``size``-process group of ``backend`` over ``store``, this process
    at ``group_rank``. Raises if the backend is not built into this torch."""
    td = datetime.timedelta(seconds=timeout)
    if backend == "gloo":
        return dist.ProcessGroupGloo(store, group_rank, size, td)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        return dist.ProcessGroupNCCL(store, group_rank, size, opts)
    raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
