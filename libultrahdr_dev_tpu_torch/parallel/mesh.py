"""The device mesh: a batch cut into contiguous shards, one per device.

The port of libultrahdr_dev_tpu/parallel/sharding.py:31-44
(``default_mesh``, ``single_device_mesh``, ``_batch_sharding``). JAX
shards a batch's leading axis over a 1-D "batch" mesh of every local
device and runs one program over it; here each shard runs the kernels
on its own card, and a batched output is a ``ShardedBatch`` of
per-device tensors, the counterpart of a batch-sharded ``jax.Array``.
Frames are independent, so no collective runs between shards.

A mesh may name one device several times (two shards on one card, as
the tests and chip_smoke.py's mesh window use), and may be a CPU mesh
(``default_mesh(["cpu"] * k)``), where every kernel runs its plain
version.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from ..device import resolve_device
from ..utils.workers import worker_count


class DeviceMesh:
    """A 1-D mesh: the devices of a batch's shards, in batch order."""

    def __init__(self, devices):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"

    def shards(self, n: int) -> list[slice]:
        """The contiguous spans of a batch of n, one per device. A batch
        the mesh size does not divide raises, as JAX's batch-sharded
        device_put does."""
        k = len(self.devices)
        if n % k:
            raise ValueError(f"a batch of {n} does not divide over a mesh "
                             f"of {k} devices")
        m = n // k
        return [slice(i * m, (i + 1) * m) for i in range(k)]


def default_mesh(devices=None) -> DeviceMesh:
    """The mesh over every visible CUDA device, cuda:0 .. cuda:n-1 (it
    raises without a GPU, as resolve_device does), or over `devices`."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return DeviceMesh(devices)


def mesh_for(mesh, device) -> DeviceMesh:
    """The mesh a batched entry point runs on: `mesh`, or, where the
    caller gives none, the one-device mesh of `device`. Such a call
    runs the same shard loop over its one shard and hands back that
    shard's own output (a tensor, not a ShardedBatch)."""
    return DeviceMesh([device]) if mesh is None else mesh


def single_device_mesh() -> DeviceMesh:
    """The mesh of the current CUDA device alone."""
    return DeviceMesh([resolve_device("cuda")])


class ShardedBatch:
    """A batch laid over a mesh: one tensor per shard, each on its own
    device, the frames in batch order."""

    def __init__(self, shards):
        self.shards = tuple(shards)
        s0 = self.shards[0]
        if any(s.shape[1:] != s0.shape[1:] or s.dtype != s0.dtype
               for s in self.shards):
            raise ValueError("the shards of a batch differ in frame shape "
                             "or dtype")

    @property
    def shape(self) -> tuple:
        return (sum(s.shape[0] for s in self.shards),
                *self.shards[0].shape[1:])

    @property
    def devices(self) -> tuple:
        return tuple(s.device for s in self.shards)

    def cpu(self) -> torch.Tensor:
        """The whole batch on the host, one shard's copy after another."""
        return torch.cat([s.cpu() for s in self.shards])


def check_placed(mesh: DeviceMesh, batch) -> None:
    """Raise unless `batch` (a ShardedBatch) lies shard for shard on the
    mesh's devices."""
    if not isinstance(batch, ShardedBatch):
        raise TypeError(f"expected a ShardedBatch over {mesh}, got "
                        f"{type(batch).__name__}")
    if len(batch.shards) != len(mesh) or any(
            s.device != d for s, d in zip(batch.shards, mesh.devices)):
        raise ValueError(f"a batch on {[str(d) for d in batch.devices]} "
                         f"is not laid over {mesh}")


def map_shards(fn, items) -> list:
    """fn over each shard's item, one worker per shard (at most the
    utils/workers.py count; in the calling thread for one shard), the
    results in shard order."""
    items = list(items)
    workers = min(len(items), worker_count())
    if workers <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, items))


def merge_stats(stats: dict | None, parts: list[dict]) -> None:
    """Fold the stats dicts of a call's shards into the caller's:
    numbers add up (bytes, ms), a string keeps each shard's distinct
    value joined by "+" (a pack mode), and a dict (a fetch's stages)
    becomes the list of the shards' dicts, or stays the one shard's dict
    where there is one shard."""
    if stats is None:
        return
    for k in dict.fromkeys(k for p in parts for k in p):
        vals = [p[k] for p in parts if k in p]
        if isinstance(vals[0], dict):
            stats[k] = vals if len(parts) > 1 else vals[0]
        elif isinstance(vals[0], str):
            stats[k] = "+".join(dict.fromkeys(vals))
        else:
            stats[k] = stats.get(k, 0) + sum(vals)
