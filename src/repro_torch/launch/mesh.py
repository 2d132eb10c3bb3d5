"""Mesh constructors: ``DeviceMesh``es over the default process group.

Port of ``repro.launch.mesh``.  They are functions, never module-level
constants, so importing this module touches no device and no process
group.  Each needs the default process group initialised
(``torch.distributed.init_process_group``, or ``torchrun``) with at least
the mesh's size of ranks; a larger world leaves its last ranks out of the
mesh (``distributed.elastic.make_mesh``).  The meshes are on the card
unless the caller asks for the CPU (``device_type="cpu"``).
"""

from __future__ import annotations

from ..distributed.elastic import make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16 x 16 = 256 ranks a pod, ``("data", "model")``; with ``multi_pod``
    2 pods = 512 ranks, ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A small ``(data, model)`` mesh named ``("data", "model")`` (tests,
    examples)."""
    return make_mesh((data, model), ("data", "model"), device_type)


def make_pod_mesh(pods: int, data: int = 1, model: int = 1,
                  device_type: str = "cuda"):
    """A ``(pods, data, model)`` mesh named ``("pod", "data", "model")``:
    the pipelined prefill's, one pipeline stage a pod
    (``launch.pipeline_prefill``)."""
    return make_mesh((pods, data, model), ("pod", "data", "model"),
                     device_type)
