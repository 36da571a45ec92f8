"""Device meshes and the device inventory (counterpart of
``repro.launch.mesh``).

Meshes are functions, not module constants, so importing this module
touches no process group.  They are ``torch.distributed`` DeviceMeshes
over the initialised world (``init_process_group`` first): the production
meshes are the reference's, (16, 16) = 256 devices on ("data", "model"),
or (2, 16, 16) = 512 on ("pod", "data", "model"), the leading "pod" axis
across the slower links between pods; the host mesh spans whatever world
there is.  ``device_type`` is "cuda" unless the caller names another
("cpu" for gloo ranks or a fake world).

The inventory enumerates CUDA devices through ``torch.cuda`` (the reference
enumerates ``jax.devices()``).  The device class is the record a
``CalibrationProfile`` carries, so a profile states the substrate it was
fitted on.
"""
from __future__ import annotations

import platform

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.models.partitioning import axis_sizes


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device_type: str = "cuda"):
    """(world / model_axis, model_axis) on ("data", "model") over the
    initialised world."""
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"make_host_mesh: model axis {model_axis} does not divide "
                         f"the world of {n}")
    return init_device_mesh(device_type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> dict:
    return axis_sizes(mesh)


def device_inventory() -> list:
    """One dict per visible CUDA device, sorted by device index.  Raises
    where there is none: a card-bound caller never gets a host stand-in."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_inventory: no CUDA device is visible")
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append({
            "id": i,
            "platform": "cuda",
            "device_kind": torch.cuda.get_device_name(i),
            "capability": f"{props.major}.{props.minor}",
            "total_memory": int(props.total_memory),
        })
    return out


def _on_card(backend: str, device) -> bool:
    return backend in ("torch", "cuda") and (
        device is None or torch.device(device).type == "cuda")


def device_class(backend: str = "cuda", device=None) -> str:
    """One-line device-class summary for profile metadata,
    ``f"{backend}:{platform} ({name}) x{count}"``, e.g.
    ``"cuda:cuda (NVIDIA H100 80GB HBM3) x1"``.  ``device`` is the
    ``ArrayContext``'s: None (every visible card, the default), "cuda",
    "cuda:<i>" or "cpu".  A torch/cuda backend on the card raises where
    there is no CUDA device; the numpy backend and ``device="cpu"`` name
    the host."""
    if _on_card(backend, device):
        inv = device_inventory()
        if device is not None and torch.device(device).index is not None:
            inv = [d for d in inv if d["id"] == torch.device(device).index]
            if not inv:
                raise RuntimeError(f"device_class: no CUDA device {device}")
        d = inv[0]
        return f"{backend}:{d['platform']} ({d['device_kind']}) x{len(inv)}"
    name = platform.processor() or platform.machine() or "host"
    return f"{backend}:cpu ({name}) x1"
