"""Device inventory of the card(s) a block runtime runs on.

Counterpart of the device half of ``repro.launch.mesh``: the reference
enumerates ``jax.devices()``; the port enumerates CUDA devices through
``torch.cuda``.  The device class is the record a ``CalibrationProfile``
carries, so a profile states the substrate it was fitted on.  The
reference's production meshes (``make_production_mesh``/``make_host_mesh``)
belong to SPMD sharding (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import platform

import torch


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
