"""Meshes, the port of ``repro.launch.mesh``. Importing this module touches
no distributed state: each function builds its mesh over the process group
that exists when it is called.

``make_production_mesh`` is the reference's shape on ``cuda``: one pod is
16 x 16 = 256 ranks, axes ``(data, model)``; two pods are 2 x 16 x 16 =
512, axes ``(pod, data, model)``, the pod axis pure data parallel. The
dry-run builds it over a ``fake`` process group of that many ranks
(``launch.dryrun``). ``make_host_mesh(model_axis)`` takes the world of the
current process group (``torchrun``: one GPU a rank; gloo on the CPU) as
``(world // model_axis, model_axis)``, axes ``(data, model)``.
"""

from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device_type="cuda"):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise ValueError(f"--model-axis {model_axis}: a host mesh needs a "
                         f"process group (torchrun, or init_process_group)")
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world of {n} ranks")
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
