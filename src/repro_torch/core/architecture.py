"""Union architecture abstraction (paper Sec. IV-C).

A *logical cluster-target* hierarchical description: the architecture is a
chain of cluster levels ``C_n (outermost) ... C_1 (innermost)``.  Each level
has:

  * ``memory_bytes``     -- local memory capacity (None when ``virtual``),
  * ``virtual``          -- paper's Virtual attribute: no dedicated physical
                            memory at this level (an "imaginary" buffer used
                            only to express intermediate tiling),
  * ``fanout``           -- number of sub-cluster instances,
  * ``dimension``        -- paper's Dimension attribute: physical axis along
                            which the sub-clusters are laid out ('X', 'Y',
                            or a mesh-axis name like 'pod'/'data'/'model'),
  * ``fill_bandwidth``   -- bytes/s from the parent level into this level,
  * ``read_energy/write_energy`` -- pJ per byte (Accelergy-style),
  * leaf compute: ``macs_per_cycle`` + ``mac_energy``.

The same abstraction describes the paper's edge/cloud/chiplet accelerators
AND a multi-pod TPU system (pods -> chips -> Pallas grid -> VMEM/MXU); see
``tpu_v5e_pod`` below) and one NVIDIA H100 (``h100_sm``: HBM -> CTAs on 132
SMs -> shared memory + tensor cores), the hierarchy the port's kernels are
planned on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Cluster:
    """One cluster level. Levels are indexed outermost=highest."""

    name: str
    fanout: int = 1
    dimension: str = "X"  # physical layout axis of the sub-clusters
    memory_bytes: Optional[int] = None  # None => virtual level
    fill_bandwidth: float = float("inf")  # bytes/sec from parent into this level
    read_energy: float = 0.0  # pJ / byte
    write_energy: float = 0.0  # pJ / byte
    # leaf compute (only meaningful for the innermost cluster)
    macs_per_cycle: int = 0
    mac_energy: float = 0.0  # pJ / MAC

    @property
    def virtual(self) -> bool:
        return self.memory_bytes is None

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        mem = "virtual" if self.virtual else f"{self.memory_bytes}B"
        return f"Cluster({self.name}, fanout={self.fanout}@{self.dimension}, {mem})"


@dataclass
class Architecture:
    """A chain of cluster levels, outermost first.

    ``clusters[0]`` is C_n (e.g. DRAM/host), ``clusters[-1]`` is C_1 (the PE
    with its L1 + MAC). The physical PE count is the product of fanouts.
    """

    name: str
    clusters: List[Cluster]
    frequency_hz: float = 1e9
    attrs: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.clusters:
            raise ValueError("architecture needs at least one cluster level")
        if self.clusters[-1].macs_per_cycle <= 0:
            raise ValueError("innermost cluster must have compute (macs_per_cycle>0)")

    # ---------------------------------------------------------------- #
    @property
    def n_levels(self) -> int:
        return len(self.clusters)

    def level(self, i: int) -> Cluster:
        """Paper-style index: C_n ... C_1 with n = n_levels. level(1) is innermost."""
        return self.clusters[self.n_levels - i]

    @property
    def num_pes(self) -> int:
        return math.prod(c.fanout for c in self.clusters)

    @property
    def peak_macs_per_cycle(self) -> int:
        return self.num_pes * self.clusters[-1].macs_per_cycle

    def fanout_below(self, idx: int) -> int:
        """Product of fanouts strictly inside clusters[idx]."""
        return math.prod(c.fanout for c in self.clusters[idx + 1 :]) if idx + 1 < self.n_levels else 1

    def with_aspect_ratio(self, shape: Sequence[int], names: Optional[Sequence[str]] = None) -> "Architecture":
        """Re-cluster the spatial fanout into the given aspect ratio.

        Used by the paper's Fig. 10 case study: a flexible accelerator
        (MAERI/Eyeriss_v2-like) reconfigures its PE array into e.g. 1x2048,
        32x64, ... We rebuild the sub-PE cluster levels accordingly,
        inserting virtual levels for each spatial axis.
        """
        total = math.prod(shape)
        if total != self.num_pes:
            raise ValueError(f"aspect ratio {shape} != {self.num_pes} PEs")
        outer = [c for c in self.clusters if c.fanout == 1 and c.memory_bytes is not None]
        if not outer:
            raise ValueError("expected at least one non-spatial outer level")
        pe = self.clusters[-1]
        new: List[Cluster] = list(outer[:-1])
        shared = outer[-1]
        new.append(shared)
        names = names or [("Y" if i % 2 == 0 else "X") for i in range(len(shape))]
        for i, (f, ax) in enumerate(zip(shape[:-1], names[:-1])):
            new.append(Cluster(f"V{len(shape)-1-i}", fanout=int(f), dimension=ax, memory_bytes=None))
        new.append(replace(pe, fanout=int(shape[-1]), dimension=names[-1]))
        return Architecture(f"{self.name}_ar{'x'.join(map(str, shape))}", new, self.frequency_hz, dict(self.attrs))

    def describe(self) -> str:
        lines = [f"Architecture {self.name} ({self.num_pes} PEs @ {self.frequency_hz/1e9:g} GHz)"]
        for i, c in enumerate(self.clusters):
            lvl = self.n_levels - i
            mem = "virtual" if c.virtual else f"{c.memory_bytes:,} B"
            bw = "" if math.isinf(c.fill_bandwidth) else f", fill {c.fill_bandwidth/1e9:g} GB/s"
            comp = f", {c.macs_per_cycle} MAC/cyc" if c.macs_per_cycle else ""
            lines.append(f"  C{lvl} {c.name}: fanout {c.fanout} along {c.dimension}, {mem}{bw}{comp}")
        return "\n".join(lines)


# ---------------------------------------------------------------------- #
# Presets: the paper's accelerators (Table V) and the TPU target
# ---------------------------------------------------------------------- #

# Accelergy-style energy constants (pJ/byte; relative magnitudes follow the
# usual 45nm tables used by Timeloop+Accelergy and Eyeriss).
_E_DRAM = 64.0
_E_L2 = 4.0
_E_L1 = 0.5
_E_MAC_UINT8 = 0.2  # pJ per uint8 MAC (paper case studies use uint8 units)


def edge_accelerator(aspect: Tuple[int, int] = (16, 16), word_bytes: int = 1) -> Architecture:
    """Paper Table V 'Edge': 256 PEs, 0.5KB L1, 100KB L2, 32 GB/s NoC."""
    y, x = aspect
    assert y * x == 256, "edge accelerator has 256 PEs"
    return Architecture(
        "edge",
        [
            Cluster("DRAM", 1, "X", memory_bytes=1 << 40, fill_bandwidth=float("inf"),
                    read_energy=_E_DRAM, write_energy=_E_DRAM),
            Cluster("L2", 1, "X", memory_bytes=100 * 1024, fill_bandwidth=32e9,
                    read_energy=_E_L2, write_energy=_E_L2),
            Cluster("V2", y, "Y", memory_bytes=None),
            Cluster("PE", x, "X", memory_bytes=512, fill_bandwidth=32e9 / 256,
                    read_energy=_E_L1, write_energy=_E_L1,
                    macs_per_cycle=1, mac_energy=_E_MAC_UINT8),
        ],
        frequency_hz=1e9,
        attrs={"word_bytes": word_bytes},
    )


def cloud_accelerator(aspect: Tuple[int, int] = (32, 64), word_bytes: int = 1) -> Architecture:
    """Paper Table V 'Cloud': 2048 PEs, 0.5KB L1, 800KB L2, 256 GB/s NoC."""
    y, x = aspect
    assert y * x == 2048, "cloud accelerator has 2048 PEs"
    return Architecture(
        "cloud",
        [
            Cluster("DRAM", 1, "X", memory_bytes=1 << 40, fill_bandwidth=float("inf"),
                    read_energy=_E_DRAM, write_energy=_E_DRAM),
            Cluster("L2", 1, "X", memory_bytes=800 * 1024, fill_bandwidth=256e9,
                    read_energy=_E_L2, write_energy=_E_L2),
            Cluster("V2", y, "Y", memory_bytes=None),
            Cluster("PE", x, "X", memory_bytes=512, fill_bandwidth=256e9 / 2048,
                    read_energy=_E_L1, write_energy=_E_L1,
                    macs_per_cycle=1, mac_energy=_E_MAC_UINT8),
        ],
        frequency_hz=1e9,
        attrs={"word_bytes": word_bytes},
    )


def chiplet_accelerator(n_chiplets: int = 16, fill_bandwidth: float = 8e9) -> Architecture:
    """Paper Fig. 11 (Simba-like): 16 chiplets x edge config = 4096 PEs.

    ``fill_bandwidth`` is the DRAM -> per-chiplet global-buffer bandwidth;
    the case study sweeps it. Package-level traffic pays a higher energy.
    """
    return Architecture(
        f"chiplet{n_chiplets}",
        [
            Cluster("DRAM", 1, "X", memory_bytes=1 << 40,
                    read_energy=_E_DRAM, write_energy=_E_DRAM),
            Cluster("Package", n_chiplets, "Y", memory_bytes=None),
            Cluster("ChipletGB", 1, "X", memory_bytes=100 * 1024,
                    fill_bandwidth=fill_bandwidth,
                    read_energy=_E_L2 * 2.5, write_energy=_E_L2 * 2.5),
            Cluster("V2", 16, "Y", memory_bytes=None),
            Cluster("PE", 16, "X", memory_bytes=512, fill_bandwidth=32e9 / 256,
                    read_energy=_E_L1, write_energy=_E_L1,
                    macs_per_cycle=1, mac_energy=_E_MAC_UINT8),
        ],
        frequency_hz=1e9,
        attrs={"inter_chiplet": True},
    )


# TPU v5e constants (per chip)
TPU_V5E = {
    "peak_bf16_flops": 197e12,
    "hbm_bytes": 16 * (1 << 30),
    "hbm_bw": 819e9,
    "ici_link_bw": 50e9,  # ~50 GB/s per link
    "vmem_bytes": 64 * (1 << 20),  # budgeted usable VMEM for one kernel pipeline
    "mxu": 128,  # systolic array dim
}


def tpu_chip(vmem_tile_budget: int = 16 * (1 << 20)) -> Architecture:
    """A single TPU v5e chip as a 3-level Union cluster hierarchy:
    C3 HBM -> C2 virtual grid-step (the Pallas grid) -> C1 VMEM+MXU.

    This is the architecture the kernel tile-planner maps Problems onto;
    legality rule R3 at C1 guarantees the chosen temporal tile fits the
    VMEM budget, so every legal mapping is a valid BlockSpec.
    """
    mxu = TPU_V5E["mxu"]
    macs_per_cycle = mxu * mxu * 4  # 4 MXUs per chip
    freq = TPU_V5E["peak_bf16_flops"] / (2 * macs_per_cycle)
    return Architecture(
        "tpu_chip",
        [
            Cluster("HBM", 1, "X", memory_bytes=TPU_V5E["hbm_bytes"],
                    fill_bandwidth=TPU_V5E["ici_link_bw"],
                    read_energy=7.0, write_energy=7.0),
            Cluster("GridStep", 1, "X", memory_bytes=None),
            Cluster("VMEM", 1, "X", memory_bytes=vmem_tile_budget,
                    fill_bandwidth=TPU_V5E["hbm_bw"],
                    read_energy=0.15, write_energy=0.15,
                    macs_per_cycle=macs_per_cycle, mac_energy=0.4),
        ],
        frequency_hz=freq,
        attrs=dict(TPU_V5E),
    )


# NVIDIA H100 SXM constants (per card; NVIDIA's data sheet and the Hopper
# architecture white paper, dense rates at the 700 W power limit)
H100_SXM = {
    "sms": 132,
    "smem_optin_bytes": 232_448,  # 227 KB of shared memory a block may opt into
    "hbm_bytes": 80 * 10**9,
    "hbm_bw": 3.35e12,
    "peak_bf16_flops": 989e12,  # tensor cores, dense
    "peak_f32_flops": 67e12,  # CUDA cores, FMA
    "tc_macs_per_cycle": 4 * 512,  # bf16 FMA per SM per clock: 4 tensor cores
}

#: the shared-memory tile budget the H100 kernel spaces plan under: half of
#: the opt-in, so two stages of operand tiles fit (the rule the TPU spaces
#: used for VMEM: half of fast memory, leaving room for double buffering)
H100_SMEM_BUDGET = H100_SXM["smem_optin_bytes"] // 2


def h100_sm(smem_tile_budget: int = H100_SMEM_BUDGET) -> Architecture:
    """One NVIDIA H100 SXM as a 3-level Union cluster hierarchy, the twin of
    :func:`tpu_chip`: C3 HBM -> C2 virtual CTA level (one instance per SM,
    fanout 132) -> C1 shared memory + tensor cores.

    Unlike the TPU's grid, whose steps run one after another on one core,
    CTAs run in parallel on the 132 SMs: a spatial split at HBM spreads
    the CTA grid over the SMs, and the CTA level's temporal loop is the
    sequence of tiles one SM works through. Legality rule R3 at C1 keeps
    the block tile inside ``smem_tile_budget``. The constants are the data
    sheet's, not probes of the card at hand, so a plan does not depend on
    the machine that made it. The clock is derived so that 132 SMs at
    ``tc_macs_per_cycle`` reach the bf16 dense peak.
    """
    h = H100_SXM
    macs_per_cycle = h["tc_macs_per_cycle"]
    freq = h["peak_bf16_flops"] / (2 * macs_per_cycle * h["sms"])
    return Architecture(
        "h100_sm",
        [
            Cluster("HBM", 1, "X", memory_bytes=h["hbm_bytes"],
                    read_energy=7.0, write_energy=7.0),
            Cluster("CTA", h["sms"], "X", memory_bytes=None),
            Cluster("SMEM", 1, "X", memory_bytes=int(smem_tile_budget),
                    fill_bandwidth=h["hbm_bw"] / h["sms"],
                    read_energy=0.15, write_energy=0.15,
                    macs_per_cycle=macs_per_cycle, mac_energy=0.4),
        ],
        frequency_hz=freq,
        attrs=dict(h),
    )


def tpu_v5e_pod(
    pods: int = 1,
    data: int = 16,
    model: int = 16,
    vmem_tile_budget: int = 16 * (1 << 20),
) -> Architecture:
    """A multi-pod TPU v5e system in Union's cluster abstraction.

    C6 Host/DCN -> C5 pods (DCN links) -> C4 'data' chips -> C3 'model'
    chips (HBM lives here: a chip) -> C2 virtual Pallas grid step -> C1
    VMEM+MXU. Spatial tiling at C5/C4/C3 == GSPMD sharding over mesh axes
    (pod, data, model); tiling at C2/C1 == Pallas grid/BlockSpec.

    Energy numbers are pJ/byte estimates for 7nm-class HBM/SRAM, only used
    for relative EDP comparisons, exactly like the paper's case studies.
    """
    mxu = TPU_V5E["mxu"]
    macs_per_cycle = mxu * mxu  # one MXU pass per cycle (bf16)
    # derive clock so that peak FLOPs match 197 TF: 2*macs/cycle*f = 197e12
    freq = TPU_V5E["peak_bf16_flops"] / (2 * macs_per_cycle * 4)  # 4 MXUs/chip
    levels = [
        Cluster("DCN", 1, "X", memory_bytes=1 << 50, fill_bandwidth=25e9,
                read_energy=400.0, write_energy=400.0),
        Cluster("Pods", pods, "pod", memory_bytes=None),
        Cluster("DataRing", data, "data", memory_bytes=None),
        Cluster("HBM", model, "model", memory_bytes=TPU_V5E["hbm_bytes"],
                fill_bandwidth=TPU_V5E["ici_link_bw"],
                read_energy=7.0, write_energy=7.0),
        Cluster("GridStep", 1, "X", memory_bytes=None),
        Cluster("VMEM", 1, "X", memory_bytes=vmem_tile_budget,
                fill_bandwidth=TPU_V5E["hbm_bw"],
                read_energy=0.15, write_energy=0.15,
                macs_per_cycle=macs_per_cycle * 4, mac_energy=0.4),
    ]
    return Architecture(
        f"tpu_v5e_{pods}x{data}x{model}",
        levels,
        frequency_hz=freq,
        attrs={"chip_count": pods * data * model, **TPU_V5E},
    )
