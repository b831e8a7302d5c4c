"""Accelergy-style energy tables (paper Sec. V-C uses Accelergy [41]).

Per-access energies live on the Cluster records themselves; this module
adds technology presets and NoC hop energies used by the MAESTRO-like
model's multicast accounting.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EnergyTable:
    """pJ per byte / per MAC for one technology point."""

    name: str
    dram_pj_byte: float
    onchip_sram_pj_byte: float
    local_sram_pj_byte: float
    noc_hop_pj_byte: float
    package_link_pj_byte: float
    mac_pj: float


# 45nm-class numbers in the lineage of Eyeriss/Accelergy tables
ACCEL_45NM_UINT8 = EnergyTable(
    name="45nm_uint8",
    dram_pj_byte=64.0,
    onchip_sram_pj_byte=4.0,
    local_sram_pj_byte=0.5,
    noc_hop_pj_byte=0.35,
    package_link_pj_byte=10.0,
    mac_pj=0.2,
)

# 7nm-class bf16 numbers for the TPU-adapted studies
TPU_7NM_BF16 = EnergyTable(
    name="7nm_bf16",
    dram_pj_byte=7.0,  # HBM2e
    onchip_sram_pj_byte=0.6,  # CMEM/VMEM-class
    local_sram_pj_byte=0.15,
    noc_hop_pj_byte=0.08,
    package_link_pj_byte=2.0,  # ICI
    mac_pj=0.4,
)
