"""Device meshes over the ranks of the process group: the port of
``tpu_sandbox/runtime/mesh.py`` (:34-97) as a
``torch.distributed.device_mesh.DeviceMesh``.

Ranks are laid out row-major over the axes, as JAX reshapes its device
list: with ``{"data": 2, "model": 2}`` rank ``2 * d + m`` sits at
``(d, m)``. Each axis's sub-groups are created once, with the mesh; every
rank must build the same mesh.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from collections.abc import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpu_sandbox_torch.runtime import bootstrap

DEFAULT_AXIS = "data"


def make_mesh(axes: dict[str, int] | None = None, *,
              device_type: str | None = None) -> DeviceMesh:
    """A mesh over every rank of the initialised group. ``axes`` maps axis
    name to size; one entry may be -1 to absorb the remaining ranks.
    Default: a 1-D ``('data',)`` mesh, the reference's world group.
    ``device_type`` defaults to the device ``bootstrap.init`` chose."""
    n = dist.get_world_size()
    if axes is None:
        axes = {DEFAULT_AXIS: n}
    axes = OrderedDict(axes)
    wildcard = [k for k, v in axes.items() if v == -1]
    if len(wildcard) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if wildcard:
        fixed = math.prod(v for v in axes.values() if v != -1)
        if n % fixed:
            raise ValueError(
                f"{n} ranks not divisible by the non-wildcard axes of "
                f"{dict(axes)}")
        axes[wildcard[0]] = n // fixed
    total = math.prod(axes.values())
    if total != n:
        raise ValueError(f"mesh {dict(axes)} needs {total} ranks, have {n}")
    return init_device_mesh(device_type or bootstrap.device().type,
                            tuple(axes.values()),
                            mesh_dim_names=tuple(axes.keys()))


def submesh(mesh: DeviceMesh, axes: Sequence[str]) -> DeviceMesh:
    """The mesh over ``axes`` that holds this rank (the other axes fixed at
    this rank's coordinates): the once-created counterpart of
    ``dist.new_group(range(args.gpus))`` (reference
    mnist_distributed.py:100)."""
    names = mesh.mesh_dim_names or ()
    unknown = set(axes) - set(names)
    if unknown:
        raise ValueError(f"axes {sorted(unknown)} not in mesh axes {names}")
    kept = tuple(a for a in names if a in axes)
    return mesh[kept[0]] if len(kept) == 1 else mesh[kept]
