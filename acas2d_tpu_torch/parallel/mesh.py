"""Device mesh over torch.distributed: the port's counterpart of
`acas2d_tpu/parallel/mesh.py`.

JAX runs one process that sees every device and shards arrays over a 1-D
('env',) mesh.  The port runs one process a card, launched by PyTorch's
own launcher:

    python -m torch.distributed.run --nproc-per-node W \\
        -m acas2d_tpu_torch.train --preset tpu --fused-rollout --fused-update

The launcher sets RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT; `multihost_init` reads them and joins the process group
(NCCL for a CUDA device, gloo on the CPU).  Without them it does nothing,
and the one process trains alone, as JAX's `multihost_init` does without a
coordinator.  A launch of one process (`--nproc-per-node 1`) does join a
group of one: the collectives then run, over NCCL on the card, and change
no bit.

A `Mesh` is this process's place in the group: its rank, the group's size,
the group, and its device (`cuda:LOCAL_RANK` unless the caller names
another).  As in JAX, the env batch (solo) or the member axis (population)
is split over the mesh in contiguous rows (`env_rows`), and the small policy
is replicated: every rank builds the whole initial state from the seed and
keeps its rows (`shard_env_state`), and `gather_env_state` puts the rows
back together (checkpoints hold the whole state).  The collectives the
learner needs are three: `all_reduce_mean` / `all_reduce_sum` of one flat
buffer, `all_gather_rows` and `broadcast`.  Each is one collective a call,
and on a mesh of one process (no group) none runs.

Each collective that runs is a span (`collective.all_reduce`,
`collective.all_gather`, `collective.broadcast`; the join is `mesh.join`)
and adds to the counters `collective.all_reduce`, `collective.all_gather`
and their bytes (`.bytes`: the all-reduced buffer, the gathered output),
while a profiler records, and to `TALLY` always (`utils.profiling.tally`:
one tally for the program's work; a CUDA graph's capture is counted by
its replays, `learner.ReplayedLoop`).
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import pickle
import warnings
from typing import Any, Optional

import torch
import torch.distributed as dist

from acas2d_tpu_torch import resolve_device
from acas2d_tpu_torch.utils import profiling

# JAX folds the shard's index times this prime into a shard's rollout seed,
# since the kernel's program ids restart at 0 on every device
# (learner.py:190-193, population.py:160-164)
SEED_STRIDE = 7919
# how long a collective (and the join) may wait for the other ranks
TIMEOUT_S = 600
# the program's tally, which holds the collectives this process has run
# and their bytes by counter name
TALLY = profiling.TALLY


def _tally(kind: str, x: torch.Tensor) -> None:
    """Tally one collective `kind` over `x` (the all-reduced buffer, the
    gathered output)."""
    name = f"collective.{kind}"
    profiling.tally(name, 1, x.device)
    profiling.tally(name + ".bytes", x.numel() * x.element_size(), x.device)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D mesh of `size` processes: `rank`,
    the process group (None for a process that trains alone) and its
    device."""
    rank: int
    size: int
    group: Any
    device: torch.device

    @property
    def distributed(self) -> bool:
        return self.group is not None


def launched() -> bool:
    """Whether a launcher (torch.distributed.run) started this process."""
    return "WORLD_SIZE" in os.environ


def local_device(device=None) -> torch.device:
    """The process's device: `device`, where under a launcher a CUDA
    device without an index is `cuda:LOCAL_RANK`; None means CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and launched():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(dev)


def multihost_init(device=None, backend: Optional[str] = None,
                   timeout_s: float = TIMEOUT_S) -> Mesh:
    """Join the launcher's process group and return this process's mesh.

    A no-op without a launcher (no WORLD_SIZE): the mesh of one process,
    with no group.  The backend is NCCL for a CUDA device and gloo on the
    CPU; `backend` names another (gloo for two processes that share one
    card, which NCCL refuses).  Every collective, and the join, waits at
    most `timeout_s`.  Safe to call again: a process already in a group
    gets its mesh."""
    dev = local_device(device)
    if not dist.is_initialized():
        if not launched():
            return Mesh(0, 1, None, dev)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        kw = {}
        if backend == "nccl":
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        with profiling.span("mesh.join"):
            dist.init_process_group(
                backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)
        atexit.register(_leave)
    return make_mesh(dev)


def _leave() -> None:
    """Leave the process group as the process exits."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of `group` (default the whole process group) on this
    process's device; the mesh of one process when no group was joined."""
    dev = local_device(device)
    if not dist.is_initialized():
        return Mesh(0, 1, None, dev)
    group = group if group is not None else dist.group.WORLD
    return Mesh(dist.get_rank(group), dist.get_world_size(group), group, dev)


def backend_of(mesh: Optional[Mesh]) -> Optional[str]:
    """The mesh's backend ('nccl', 'gloo'), None without a group (or
    without a mesh)."""
    if mesh is None or not mesh.distributed:
        return None
    return dist.get_backend(mesh.group)


def env_rows(n: int, mesh: Mesh) -> slice:
    """The contiguous rows of `n` that are this rank's."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    k = n // mesh.size
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def map_tensors(tree, fn):
    """`tree` (a tensor, or dicts, lists, tuples and dataclasses of them)
    with `fn` applied to every tensor."""
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    return tree


def shard_env_state(tree, mesh: Mesh):
    """This rank's rows of every tensor of `tree` (an EnvState, a tensor,
    or dicts, lists and dataclasses of them), split along the leading
    axis: the counterpart of JAX's `shard_env_pytree`.  Every rank builds
    the whole tree from the seed and keeps its rows, as copies."""
    if not mesh.distributed:
        return tree
    return map_tensors(tree, lambda x: x[env_rows(x.shape[0], mesh)].clone())


def gather_env_state(tree, mesh: Mesh):
    """Every rank's rows of `tree` put back together on every rank, in
    rank order: the inverse of `shard_env_state`, one collective a tensor."""
    if not mesh.distributed:
        return tree
    return map_tensors(tree, lambda x: all_gather_rows(x, mesh))


def all_reduce_sum(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over ranks of `flat` (a new tensor), one collective."""
    if not mesh.distributed:
        return flat
    out = flat.clone()
    with profiling.span("collective.all_reduce"):
        dist.all_reduce(out, group=mesh.group)
    _tally("all_reduce", out)
    return out


def all_reduce_mean(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over ranks of `flat`, one collective: the ranks' sum
    divided by their number (a mesh of one divides by nothing, so its mean
    is `flat` bit for bit).  Ranks of equal shards make it the global mean
    of their means, as JAX's `pmean`."""
    out = all_reduce_sum(flat, mesh)
    return out / mesh.size if mesh.size > 1 else out


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `x` stacked along the leading axis in rank order (a
    (size * n, ...) tensor on every rank), one collective."""
    if not mesh.distributed:
        return x
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with warnings.catch_warnings(), \
            profiling.span("collective.all_gather"):
        warnings.filterwarnings("ignore", category=FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    _tally("all_gather", out)
    return out


def sync(mesh: Mesh) -> None:
    """Wait, on the host, until every rank of the mesh has come here (a
    collective that the host reads back)."""
    if mesh.distributed:
        float(all_reduce_sum(torch.zeros(1, device=comm_device(mesh)),
                             mesh)[0])


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `x` on every rank (written into `x`), one collective."""
    if mesh.distributed:
        with profiling.span("collective.broadcast"):
            dist.broadcast(x, dist.get_global_rank(mesh.group, src)
                           if mesh.group is not dist.group.WORLD else src,
                           group=mesh.group)
    return x


def broadcast_object(obj: Any, mesh: Mesh, src: int = 0) -> Any:
    """Rank `src`'s picklable `obj` on every rank: the host's values that
    rank 0 alone computes (an eval's metrics, a checkpoint read from its
    disk)."""
    if not mesh.distributed:
        return obj
    data = pickle.dumps(obj) if mesh.rank == src else b""
    n = torch.tensor([len(data)], dtype=torch.int64, device=comm_device(mesh))
    broadcast(n, mesh, src)
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(n.device)
           if mesh.rank == src else
           torch.empty(int(n), dtype=torch.uint8, device=n.device))
    broadcast(buf, mesh, src)
    return obj if mesh.rank == src else pickle.loads(buf.cpu().numpy()
                                                     .tobytes())


def comm_device(mesh: Mesh) -> torch.device:
    """Where the host's bytes go to cross the group: the card under NCCL,
    else the CPU."""
    return mesh.device if backend_of(mesh) == "nccl" else torch.device("cpu")


def fold_seed(seed, mesh: Mesh):
    """The rank's rollout seed: `seed` + rank * SEED_STRIDE, wrapped to
    int32 as JAX's int32 add wraps.  `seed` is an int or a (1,) int32
    tensor; a tensor's fold is made on its device (inside a captured CUDA
    graph, where the seed is read anew at each replay).  Rank 0, and a
    process that trains alone, keep the seed."""
    if not mesh.distributed or mesh.rank == 0:
        return seed
    off = mesh.rank * SEED_STRIDE
    if torch.is_tensor(seed):
        return ((seed.to(torch.int64) + (off + (1 << 31))) % (1 << 32)
                - (1 << 31)).to(torch.int32)
    return ((int(seed) + off + (1 << 31)) % (1 << 32)) - (1 << 31)
