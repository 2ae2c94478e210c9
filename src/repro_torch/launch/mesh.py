"""Mesh factories over ``torch.distributed``'s ``DeviceMesh`` (the
reference's ``launch/mesh.py``).

Every factory is a function, so importing this module touches no process
group.  A mesh needs a world of its size: the dry-run's fake world
(``dist.collectives.fake_world``), a real one started by
``torch.distributed.init_process_group``, or the one-card NCCL world of
``repro_torch.launch.dryrun``'s ``--mesh card``.

Dim roles:
  pod    outer data-parallel dim, gradient all-reduce crosses hosts
  data   inner data-parallel / FSDP dim
  model  tensor/expert/kv-seq parallel dim

``dp_extent`` and ``batch_axes_for`` read only ``mesh_dim_names`` and the
dim sizes, so they take a ``DeviceMesh`` or any stand-in with
``axis_names`` and a ``shape`` dict.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.dist.sharding import mesh_axis_names, mesh_shape

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current
    world (its size must be the product of ``shape``), on the card by
    default; ``device_type="cpu"`` for a gloo or fake world."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) data x model, or (2, 16, 16) pod x data x model."""
    shape, axes = PRODUCTION[multi_pod]
    return make_mesh(shape, axes, device_type)


def dp_extent(mesh) -> int:
    """Total data-parallel ways (pod x data when pod exists)."""
    shape = mesh_shape(mesh)
    e = shape["data"]
    if "pod" in shape:
        e *= shape["pod"]
    return e


def batch_axes_for(mesh, global_batch: int) -> Optional[Tuple[str, ...]]:
    """Largest data-parallel dim tuple that evenly divides the batch.

    A size-1 batch (``long_500k``) cannot be sharded 32 ways, so it
    degrades to replication and the work lives on the 'model' dim
    (kv_seq sharding)."""
    shape = mesh_shape(mesh)
    has_pod = "pod" in mesh_axis_names(mesh)
    if has_pod and global_batch % (shape["pod"] * shape["data"]) == 0:
        return ("pod", "data")
    if global_batch % shape["data"] == 0:
        return ("data",)
    if has_pod and global_batch % shape["pod"] == 0:
        return ("pod",)
    return None
