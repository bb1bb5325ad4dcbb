"""Hardware constants of the port's card: one record per NVIDIA H100
variant, from NVIDIA's H100 data sheet (dense rates, no sparsity).

Counterpart of ``repro.configs.hw``, which holds TPU v5e figures; none of
those is used here.  Everything in the port that prices work against the
card (``repro_torch.obs.ledger``, ``repro_torch.obs.profiler`` and
``chip_smoke.py``'s kernel bounds) reads one :class:`Hardware` record, by
default :func:`current`, so there is one source.

Per card:

- ``peak_bf16``: dense bf16 tensor-core rate (FLOP/s).
- ``peak_fp4_gemm``: the rate the W4A4 expert FFN runs its products at.
  Hopper has no FP4 tensor cores: the kernel decodes the NVFP4 codes into
  bf16 ``wgmma`` operands, so this equals ``peak_bf16``.  (The reference
  prices FP4 experts at the TPU's int8 MXU rate, ``PEAK_INT8``.)
- ``peak_f32``: f32 rate of the CUDA cores, outside the tensor cores.
- ``hbm_bw``: HBM bandwidth (B/s).
- ``hbm_bytes``: the card's memory (bytes), what the dry run judges a
  cell's per-device peak against (``repro_torch.launch.dryrun``).  The
  SXM record holds what an H100 80GB HBM3 reports as
  ``torch.cuda.get_device_properties(0).total_memory`` (85017493504 B,
  79.18 GiB), not the data sheet's 80 GiB: a peak between the two does
  not run.  The PCIe and NVL records hold the data sheet's sizes, read
  from no card.

Inter-rank bandwidth is not a property of one card here: the serving
stack prices dispatch and migration bytes at
``repro_torch.configs.base.MIGRATION_BW_DEFAULT``, as the reference does.
"""
from __future__ import annotations

import dataclasses


# decimal units of the reports: giga and tera (GB, TB/s, TFLOP/s)
GIGA = 1e9
TERA = 1e12


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Peak rates of one accelerator, the ledger's and profiler's input."""
    name: str
    peak_bf16: float            # FLOP/s, dense bf16
    peak_fp4_gemm: float        # FLOP/s the FP4 expert GEMMs run at
    peak_f32: float             # FLOP/s, f32 off the tensor cores
    hbm_bw: float               # B/s
    hbm_bytes: int = 0          # bytes of device memory (0: unknown)


H100_SXM = Hardware("H100 SXM", peak_bf16=989e12, peak_fp4_gemm=989e12,
                    peak_f32=67e12, hbm_bw=3.35e12, hbm_bytes=85017493504)
H100_PCIE = Hardware("H100 PCIe", peak_bf16=756e12, peak_fp4_gemm=756e12,
                     peak_f32=51e12, hbm_bw=2.0e12, hbm_bytes=80 << 30)
H100_NVL = Hardware("H100 NVL", peak_bf16=835e12, peak_fp4_gemm=835e12,
                    peak_f32=60e12, hbm_bw=3.9e12, hbm_bytes=94 << 30)


def for_device_name(name: str) -> Hardware:
    """The record of the H100 variant named by
    ``torch.cuda.get_device_name()`` ("NVIDIA H100 80GB HBM3" is the SXM
    card, "NVIDIA H100 PCIe" and "NVIDIA H100 NVL" the others)."""
    if "PCIe" in name:
        return H100_PCIE
    if "NVL" in name:
        return H100_NVL
    if "H100" in name:
        return H100_SXM
    raise ValueError(f"no hardware record for {name!r}")


def current() -> Hardware:
    """The record of CUDA device 0, or of the H100 SXM (the port's target
    card) when there is none, as in the CPU tests."""
    import torch
    if torch.cuda.is_available():
        return for_device_name(torch.cuda.get_device_name(0))
    return H100_SXM


__all__ = ["Hardware", "H100_SXM", "H100_PCIE", "H100_NVL",
           "for_device_name", "current", "GIGA", "TERA"]
