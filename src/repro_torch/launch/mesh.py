"""Production mesh construction.

Functions, not module-level constants: importing this module touches no
process group.  A mesh needs the default process group initialized with
as many ranks as it has devices (NCCL on the cards; the shape-only dry
run builds the production meshes over torch's fake process group, where
only their names and sizes are read).
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.compat import make_auto_mesh

__all__ = ["make_production_mesh", "make_test_mesh", "TP"]

TP = 16  # model-parallel extent of one pod row


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 single-pod (256 devices) or 2x16x16 multi-pod (512).

    Axes: ``data`` carries batch/FSDP, ``model`` carries TP/EP, ``pod``
    carries cross-pod data parallelism (batch and gradient reduction only,
    so per-device memory does not depend on the pod count).
    """
    if multi_pod:
        return make_auto_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_auto_mesh((16, 16), ("data", "model"))


def make_test_mesh(shape=(1, 1), axes=("data", "model")) -> DeviceMesh:
    """A small mesh over the ranks of the default process group."""
    return make_auto_mesh(shape, axes)
