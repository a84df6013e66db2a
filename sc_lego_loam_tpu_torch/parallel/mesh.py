"""Process meshes and the explicit collectives of the sharded engine (port of
``sc_lego_loam_tpu/parallel/mesh.py``).

The JAX package shards the keyframe / descriptor banks over a
``jax.sharding.Mesh`` and lets GSPMD insert the collectives.  Here a mesh
is a ``torch.distributed`` ``DeviceMesh`` of one process per card, with the
same axes:

  kf    keyframe / descriptor bank shards (sharded retrieval);
  seq   data-parallel sequences (``parallel.batch.BatchEngine``).

A bank sharded over ``kf`` is held in contiguous row blocks, as JAX's
``P("kf")``: the rank at place r of the ``kf`` group holds rows
``[r K/n, (r+1) K/n)``.  Indexing a sharded ``DTensor`` with an index
tensor would replicate the whole bank, so data moves by a few explicit
collectives, built on ``all_reduce`` and ``broadcast`` alone (the two that
gloo also runs on CUDA tensors, which lets two processes share one card):

- ``gather_rows``: each rank gathers the rows it owns, writes zeros for the
  rest, and one ``all_reduce(SUM)`` assembles them; adding zeros is exact,
  so the result is bit-equal to an unsharded gather (bool fields travel as
  0 / 1 in the same float buffer);
- ``owner_write``: a row goes only into the shard that owns its slot;
- ``exchange``: each rank's value in its own slot of a zero vector, one
  ``all_reduce(SUM)``: the winners of sharded retrieval, the gathered
  trajectories of a sequence-sharded batch;
- ``share``: the first rank's values on every rank, one ``broadcast``;
- ``gather_full``: the whole bank on every rank (checkpoint, export), one
  ``broadcast`` per shard.

``stats`` counts the collectives and the bytes they carry.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import NamedTuple

import torch
import torch.distributed as dist

# Collectives issued by this module: "calls" and "bytes" (the buffer each
# rank hands to the collective).
stats: Counter = Counter()


def reset_stats():
    stats.clear()


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> int:
    """Join the process group, so that a mesh spans every process.

    ``coordinator`` is an ``init_method`` URL (``tcp://host:port`` or
    ``file:///path``); without one, ``MASTER_ADDR`` in the environment
    selects ``env://`` (``WORLD_SIZE`` / ``RANK`` there too).  With neither
    it is a no-op, as the JAX package's is on one host.  ``backend``
    defaults to ``nccl`` with a card and ``gloo`` without.  Returns the
    number of processes (one card each)."""
    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = "env://"
    if coordinator is None and num_processes is None:
        return 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if num_processes is not None:
        kw.update(world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, init_method=coordinator, **kw)
    return dist.get_world_size()


def make_mesh(n_kf: int | None = None, n_seq: int = 1,
              device_type: str = "cuda"):
    """A ``(seq, kf)`` ``DeviceMesh`` over every process of the group (one
    card each; ``device_type="cpu"`` for CPU processes).  Without a process
    group, a group of this process alone is made first."""
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if n_kf is None:
        n_kf = world // n_seq
    if n_kf * n_seq != world:
        raise ValueError(f"a ({n_seq}, {n_kf}) mesh needs {n_seq * n_kf} "
                         f"processes, the group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (n_seq, n_kf),
                            mesh_dim_names=("seq", "kf"))


class Shard(NamedTuple):
    """This rank's place on one mesh axis: a bank's leading axis is split
    into ``size`` contiguous blocks and the rank holds block ``index``.
    ``group`` is None for a bank held whole (no collective)."""

    group: object
    index: int
    size: int

    def block(self, n: int) -> tuple[int, int]:
        """(first row, rows) of this rank's block of an ``n``-row bank."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        rows = n // self.size
        return self.index * rows, rows


def axis_shard(mesh, axis: str) -> Shard:
    dm = mesh[axis]
    return Shard(dm.get_group(), dm.get_local_rank(), dm.size())


def bank_sharding(mesh) -> Shard | None:
    """Banks split over 'kf' on their leading axis (JAX's ``P("kf")``).
    Takes a ``DeviceMesh``, a ``Shard`` (returned as it is) or None."""
    if mesh is None or isinstance(mesh, Shard):
        return mesh
    return axis_shard(mesh, "kf")


def replicated(mesh=None) -> Shard:
    """A bank held whole by every rank (JAX's ``P()``)."""
    return Shard(None, 0, 1)


def _count(t: torch.Tensor):
    stats["calls"] += 1
    stats["bytes"] += t.numel() * t.element_size()


def all_reduce_sum(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """In-place SUM over the shard's group (nothing without a group)."""
    if shard.group is not None:
        _count(t)
        dist.all_reduce(t, group=shard.group)
    return t


def _pack_dtype(dtype) -> bool:
    return dtype in (torch.float32, torch.bool)


def gather_rows(local, idx: torch.Tensor, mesh):
    """``bank[idx]`` of a bank sharded over 'kf', on every rank.

    ``local`` is this rank's block of the bank, or a tuple of blocks of
    several banks with one leading axis (gathered in ONE collective);
    ``idx`` a device index tensor of global rows (never read on the host).
    Each rank gathers the rows it owns and zeros for the others, and an
    ``all_reduce(SUM)`` assembles them: adding zeros is exact, so the rows
    are bit-equal to an unsharded gather.  Float32 and bool blocks travel
    in one float32 buffer; others in one collective each."""
    shard = bank_sharding(mesh)
    many = isinstance(local, (tuple, list))
    blocks = list(local) if many else [local]
    if shard is None:
        out = [b[idx] for b in blocks]
        return out if many else out[0]
    lo, rows = shard.block(blocks[0].shape[0] * shard.size)
    li = idx.to(torch.int64) - lo
    own = (li >= 0) & (li < rows)
    li = torch.clamp(li, 0, rows - 1)

    def mine(b):
        g = b[li]
        keep = own.reshape(own.shape + (1,) * (g.dim() - own.dim()))
        return torch.where(keep, g, torch.zeros((), dtype=g.dtype,
                                                device=g.device))

    parts = [mine(b) for b in blocks]
    out: list = [None] * len(parts)
    packed = [i for i, p in enumerate(parts) if _pack_dtype(p.dtype)]
    lead = idx.numel()
    if packed:
        flat = [parts[i].reshape(lead, -1).to(torch.float32) for i in packed]
        buf = all_reduce_sum(torch.cat(flat, 1), shard)
        at = 0
        for i, f in zip(packed, flat):
            chunk = buf[:, at:at + f.shape[1]].reshape(parts[i].shape)
            at += f.shape[1]
            out[i] = chunk > 0.5 if parts[i].dtype == torch.bool \
                else chunk.contiguous()
    for i, p in enumerate(parts):
        if out[i] is None:
            out[i] = all_reduce_sum(p.contiguous(), shard)
    return out if many else out[0]


def local_row(local: torch.Tensor, i: torch.Tensor, mesh) -> torch.Tensor:
    """Row ``i`` (a (1,) global slot) of this rank's block, clamped into
    the block: the slot's own contents on its owner, a row of no meaning
    elsewhere."""
    shard = bank_sharding(mesh)
    if shard is None:
        return local[i][0]
    lo, rows = shard.block(local.shape[0] * shard.size)
    return local[torch.clamp(i.to(torch.int64) - lo, 0, rows - 1)][0]


def owner_write(local: torch.Tensor, i: torch.Tensor, row: torch.Tensor,
                mesh) -> None:
    """``bank[i] = row`` IN PLACE on the rank that owns slot ``i`` ((1,)
    device index); the other ranks rewrite a row of their own with its own
    contents.  ``row`` must be the same on every rank; no collective."""
    shard = bank_sharding(mesh)
    if shard is None:
        local.index_copy_(0, i, row[None])
        return
    lo, rows = shard.block(local.shape[0] * shard.size)
    li = i.to(torch.int64) - lo
    own = (li >= 0) & (li < rows)
    li = torch.clamp(li, 0, rows - 1)
    local.index_copy_(0, li, torch.where(own, row, local[li][0])[None])


def exchange(value: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``value`` on every rank, stacked by the rank's place in
    the group: (size, *value.shape).  Each rank writes its own slot of a
    zero buffer and one ``all_reduce(SUM)`` fills the rest."""
    shard = bank_sharding(mesh)
    buf = torch.zeros((shard.size,) + tuple(value.shape), dtype=value.dtype,
                      device=value.device)
    buf[shard.index] = value
    return all_reduce_sum(buf, shard)


def share(tensors, mesh):
    """The first rank's values of float32 / bool ``tensors`` on every rank
    of the 'kf' group, in one ``broadcast``.  For state that every rank
    computes alike but a float atomic can round differently on the card
    (the voxel filter's sums, the pose graph's scatter-add): all ranks then
    go on from one value and take the same branches."""
    shard = bank_sharding(mesh)
    if shard is None or shard.group is None:
        return tensors
    flat = [t.reshape(-1).to(torch.float32) for t in tensors]
    buf = torch.cat(flat)
    _count(buf)
    dist.broadcast(buf, src=dist.get_global_rank(shard.group, 0),
                   group=shard.group)
    out, at = [], 0
    for t, f in zip(tensors, flat):
        chunk = buf[at:at + f.numel()].reshape(t.shape)
        at += f.numel()
        out.append(chunk > 0.5 if t.dtype == torch.bool else chunk)
    return type(tensors)(out) if isinstance(tensors, tuple) else out


def agree(flags: torch.Tensor, mesh):
    """Read ``flags`` (a small device tensor) on the host, after checking
    that every rank of the 'kf' group holds the same values: each rank's
    next collective depends on them, and ranks that disagree would wait
    on each other forever."""
    shard = bank_sharding(mesh)
    if shard is None or shard.group is None:
        return flags.tolist()
    every = exchange(flags.to(torch.float64), shard).tolist()
    if any(row != every[0] for row in every[1:]):
        raise RuntimeError(f"ranks of the 'kf' group disagree: {every}")
    return [type(v)(x) for v, x in zip(flags.tolist(), every[0])] \
        if flags.dim() else type(flags.item())(every[0])


def gather_full(local: torch.Tensor, mesh) -> torch.Tensor:
    """The whole bank on every rank: one ``broadcast`` of each rank's block
    (bool blocks as uint8)."""
    shard = bank_sharding(mesh)
    if shard is None or shard.group is None:
        return local
    rows = local.shape[0]
    as_u8 = local.dtype == torch.bool
    src = local.to(torch.uint8) if as_u8 else local
    full = torch.empty((rows * shard.size,) + tuple(local.shape[1:]),
                       dtype=src.dtype, device=local.device)
    for r in range(shard.size):
        block = full[r * rows:(r + 1) * rows]
        if r == shard.index:
            block.copy_(src)
        _count(block)
        dist.broadcast(block, src=dist.get_global_rank(shard.group, r),
                       group=shard.group)
    return full.bool() if as_u8 else full


def bring(value: torch.Tensor, owner: int, shard: Shard) -> torch.Tensor:
    """The tensor that the rank at place ``owner`` of the shard's group
    holds, on every rank (one ``broadcast``; ``value`` gives the shape and
    dtype elsewhere, bool as uint8)."""
    if shard.group is None:
        return value
    as_u8 = value.dtype == torch.bool
    buf = value.to(torch.uint8) if as_u8 else value
    buf = buf.clone() if shard.index == owner else torch.empty_like(buf)
    _count(buf)
    dist.broadcast(buf, src=dist.get_global_rank(shard.group, owner),
                   group=shard.group)
    return buf.bool() if as_u8 else buf
