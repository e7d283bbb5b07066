"""The process-wide device mesh, over ``torch.distributed.device_mesh``.

The twin of ``repro.distributed.compat``.  Every mesh touch-point of the
port goes through here: :func:`make_auto_mesh` builds a ``DeviceMesh``
with named dims over the default process group, :func:`enter_mesh` makes
it the current mesh for the rest of the process, and
:func:`current_mesh_axis_names` / :func:`current_mesh` read it back
(``()`` and None off a mesh, as in the reference).  A mesh's device type
follows the process group: ``cuda`` under NCCL, ``cpu`` under any other
backend (gloo, or the fake group the shape-only dry run builds).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_auto_mesh", "enter_mesh", "current_mesh_axis_names",
           "current_mesh"]

# the mesh last made current through enter_mesh (None: off a mesh)
_CURRENT: DeviceMesh | None = None


def make_auto_mesh(shape, axes) -> DeviceMesh:
    """A mesh of ``shape`` with dims named ``axes`` over the default
    process group, which must already be initialized with
    ``prod(shape)`` ranks."""
    device_type = ("cuda" if dist.is_initialized()
                   and dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def enter_mesh(mesh: DeviceMesh | None) -> None:
    """Make ``mesh`` the current mesh for the rest of the process (None
    leaves the mesh: the model's constraints become identity again)."""
    global _CURRENT
    _CURRENT = mesh


def current_mesh_axis_names() -> tuple[str, ...]:
    """Dim names of the current mesh, ``()`` off a mesh."""
    if _CURRENT is None:
        return ()
    return tuple(_CURRENT.mesh_dim_names or ())


def current_mesh() -> DeviceMesh | None:
    """The current mesh, or None off a mesh."""
    return _CURRENT
