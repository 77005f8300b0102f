"""The (data, model) mesh over a ``torch.distributed`` process group, and
the slices of the batch and the catalog each rank owns (port of what the
distributed SCE, evaluation and serving paths need of
``repro/dist/sharding.py`` and of ``repro.dist.make_mesh``).

Mesh axes, as in the reference:

* ``data`` — rows of ``X`` (model outputs, positions): rank coordinate
  ``i`` owns rows ``[i·N/D, (i+1)·N/D)`` of the global batch
  (``batch_spec``);
* ``model`` — rows of the catalog ``Y``: coordinate ``j`` owns rows
  ``[j·C/M, (j+1)·C/M)`` (``catalog_spec``).

Rank ``r < D·M`` sits at ``(r // M, r % M)``, row-major as a JAX mesh
lays out its devices. Each axis of size > 1 has one process group per
line of the grid, built with ``new_group`` (every rank enters every
``new_group`` call, as ``torch.distributed`` requires). An axis of size 1
has no group and its collectives (``dist/collectives.py``) are the
identity — what ``psum``/``all_gather`` over a size-1 axis compute in
JAX. With no process group the world is this one process and the mesh
is (1, 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")  # outer-to-inner data-parallel axes
AXIS_NAMES = ("data", MODEL_AXIS)


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the default process group, or ``(0, 1)``
    when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its ``size``, this rank's
    ``index`` along it, and the group of the ranks on its line (None
    when the size is 1)."""

    name: str
    size: int
    index: int
    group: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of ranks. ``shape`` maps each axis name
    to its size; ``coords`` is this rank's place, None for a rank left
    out of the grid (a world larger than ``D·M``)."""

    shape: Dict[str, int]
    coords: Optional[Dict[str, int]]
    groups: Dict[str, Optional[object]]
    axis_names = AXIS_NAMES

    @property
    def member(self) -> bool:
        return self.coords is not None

    def axis(self, name: str) -> Axis:
        if not self.member:
            raise ValueError(f"this rank is outside the {self.shape} mesh")
        return Axis(name, self.shape[name], self.coords[name],
                    self.groups[name])


def make_mesh(shape: Tuple[int, int]) -> Mesh:
    """The ``(data, model)`` mesh of ``shape`` over ranks ``0 … D·M − 1``
    of the default group (see the module docstring). Every rank of the
    world must call it, in the same order as any other group it builds."""
    n_data, n_model = shape
    rank, size = world()
    if n_data * n_model > size:
        raise ValueError(f"a {shape} mesh needs {n_data * n_model} ranks; "
                         f"the world has {size}")
    lines = {
        "data": [[i * n_model + j for i in range(n_data)]
                 for j in range(n_model)],
        MODEL_AXIS: [[i * n_model + j for j in range(n_model)]
                     for i in range(n_data)],
    }
    groups: Dict[str, Optional[object]] = {"data": None, MODEL_AXIS: None}
    for name in AXIS_NAMES:
        if len(lines[name][0]) == 1:
            continue  # a size-1 axis: no group, identity collectives
        for ranks in lines[name]:
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    coords = None
    if rank < n_data * n_model:
        coords = {"data": rank // n_model, MODEL_AXIS: rank % n_model}
    return Mesh({"data": n_data, MODEL_AXIS: n_model}, coords, groups)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The data-parallel axes present on ``mesh``, outermost first."""
    return tuple(ax for ax in DATA_AXES if ax in mesh.axis_names)


def dp_size(mesh: Mesh) -> int:
    """The number of data shards: the product of the data axes' sizes."""
    size = 1
    for ax in data_axes(mesh):
        size *= mesh.shape[ax]
    return size


def data_shard_index(mesh: Mesh) -> int:
    """Flattened index of this rank's data shard across the data axes
    (``_data_shard_index`` of ``repro/core/distributed_sce.py``)."""
    idx = 0
    for ax in data_axes(mesh):
        idx = idx * mesh.shape[ax] + mesh.coords[ax]
    return idx


def host_batch_slice(global_rows: int, host_id: int, n_hosts: int) -> slice:
    """Axis-0 slice of the GLOBAL batch owned by ``host_id``: the
    contiguous block ``[host_id·per, (host_id+1)·per)``,
    ``per = global_rows / n_hosts``. Raises ``ValueError`` when the rows
    do not divide or ``host_id`` is out of range."""
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} not in [0, {n_hosts})")
    if global_rows % n_hosts:
        raise ValueError(
            f"global batch rows {global_rows} not divisible by "
            f"n_hosts {n_hosts}"
        )
    per = global_rows // n_hosts
    return slice(host_id * per, (host_id + 1) * per)


def batch_slice(mesh: Mesh, global_rows: int) -> slice:
    """The rows of a batch-leading tensor this rank holds: its data
    shard's block, data-major (``batch_spec``), the same on every model
    rank of the shard."""
    return host_batch_slice(global_rows, data_shard_index(mesh),
                            dp_size(mesh))


def batch_rows(mesh: Mesh, global_rows: int,
               n_micro: int = 1) -> Union[slice, np.ndarray]:
    """The rows of a global batch this rank holds when a step splits it
    into ``n_micro`` microbatches and shards each GLOBAL microbatch over
    the data axes, as the reference does: its data shard's block of every
    microbatch, microbatch-major (cut into ``n_micro`` equal parts, part
    ``i`` is this rank's block of microbatch ``i``). One microbatch, or
    one data shard: the contiguous :func:`batch_slice`. Raises
    ``ValueError`` when the rows do not divide."""
    if n_micro == 1 or dp_size(mesh) == 1:
        return batch_slice(mesh, global_rows)
    if global_rows % n_micro:
        raise ValueError(f"global batch rows {global_rows} not divisible "
                         f"by {n_micro} microbatches")
    per = global_rows // n_micro
    block = batch_slice(mesh, per)
    return np.concatenate([np.arange(i * per + block.start,
                                     i * per + block.stop)
                           for i in range(n_micro)])


def pad_rows(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """``t`` with its last row repeated until the rows divide
    ``multiple`` (the data-axis product: the sharded evaluation's rows);
    the padded rows' results are dropped."""
    pad = (-t.shape[0]) % multiple
    if pad:
        t = torch.cat([t, t[-1:].expand((pad,) + tuple(t.shape[1:]))])
    return t


def local_catalog(y: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, int]:
    """The serving layout of the reference's ``seqrec_serve_shardings``
    as this rank sees it: the catalog rows over ``model`` — this rank's
    block of the (shard-even) table ``y`` and the global id of its first
    row — and everything else replicated (every rank holds the whole
    parameter tree; the encoder reads the full item table)."""
    rows = catalog_slice(mesh, y.shape[0])
    return y[rows], rows.start


def catalog_slice(mesh: Mesh, catalog_rows: int) -> slice:
    """The catalog rows this rank's model coordinate owns,
    ``[j·C/M, (j+1)·C/M)`` (``catalog_spec``); ``C`` must divide."""
    m = mesh.shape[MODEL_AXIS]
    if catalog_rows % m:
        raise ValueError(f"catalog rows {catalog_rows} not divisible by "
                         f"the model axis {m}")
    per = catalog_rows // m
    j = mesh.coords[MODEL_AXIS]
    return slice(j * per, (j + 1) * per)
