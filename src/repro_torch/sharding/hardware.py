"""The device table the plan optimizer and the roofline read: one named
record per accelerator, in place of the reference's module constants
(``repro.sharding.estimator`` and ``repro.sharding.roofline`` hold a TPU's;
the port holds the card it runs on)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Hardware:
    name: str
    hbm_bytes: float     # device memory a plan must fit in
    hbm_bw: float        # device memory bytes/s
    link_bw: float       # bytes/s each way on one device-to-device link
    peak_bf16: float     # dense FLOP/s, bf16 tensor cores
    peak_fp32: float     # FLOP/s, f32 outside the tensor cores
    peak_fp64: float     # FLOP/s, f64 tensor cores


H100_SXM = Hardware(
    name="NVIDIA H100 80GB HBM3 (SXM)",
    # torch.cuda.get_device_properties(0).total_memory on the card
    # (NVIDIA H100 80GB HBM3, 700 W): 79.18 GiB
    hbm_bytes=85017493504,
    # NVIDIA's H100 SXM data sheet: HBM3 at 3.35 TB/s; dense (no sparsity)
    # 989 TFLOP/s bf16, 67 TFLOP/s f32 and 67 TFLOP/s f64 tensor core
    hbm_bw=3.35e12,
    peak_bf16=989e12,
    peak_fp32=67e12,
    peak_fp64=67e12,
    # the same data sheet: NVLink 4 at 900 GB/s per card, both directions
    # together, so 450 GB/s each way
    link_bw=450e9,
)
