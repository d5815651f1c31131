"""Hardware constants.

``TRIMOE_HW`` is the paper's Table 1 prototype (H100 PCIe + AMX Xeon 8470
+ 16 buffer-chip DIMM-NDPs + DIMM-Link). ``TPU_V5E`` is the dry-run /
roofline target. Derived quantities (per-DIMM host bandwidth, aggregate
NDP bandwidth) follow the paper's stated ratios: NDP internal bandwidth is
8x the host's view of a single DIMM, and a full-NDP system aggregates
16 x 153.6 GB/s = 2.46 TB/s — the physics that makes cold-expert
offloading win.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TriMoEHardware:
    # --- GPU (H100 PCIe 80GB, paper Table 1) ---
    gpu_flops: float = 819.6e12  # BF16 FLOP/s as listed
    gpu_hbm_bw: float = 2.04e12  # B/s
    gpu_hbm_bytes: float = 80e9
    pcie_bw: float = 64e9  # PCIe 5.0 unidirectional B/s

    # --- AMX CPU (Xeon Platinum 8470, 8ch DDR5-4800 x 2 DIMM) ---
    cpu_flops: float = 90.1e12  # BF16 theoretical
    host_bw: float = 307.2e9  # 8 x 38.4 GB/s channels
    n_channels: int = 8
    dimms_per_channel: int = 2
    host_mem_bytes: float = 2e12

    # --- DIMM-NDP (center-buffer GEMV+Act unit per DIMM) ---
    n_dimms: int = 16
    ndp_flops: float = 256e9  # per NDP BF16
    ndp_internal_bw: float = 153.6e9  # per DIMM internal
    ndp_buffer_bytes: float = 256e3
    ndp_area_mm2: float = 1.13

    # --- DIMM-Link (host-free inter-DIMM bus) ---
    dimm_link_bw: float = 25e9  # 8 lanes x 25 Gb/s per link
    # DIMM-Link is a point-to-point mesh: transfers between disjoint DIMM
    # pairs proceed concurrently, and a striped<->localized relayout
    # streams its per-DIMM shards over multiple links at once. §5.5's
    # "~0.63 ms for up to four experts" implies ~4 concurrent lanes.
    dimm_link_parallelism: int = 4

    @property
    def dimm_host_bw(self) -> float:
        """Host-side bandwidth when reading a single (localized) DIMM."""
        return self.host_bw / self.n_channels / self.dimms_per_channel  # 19.2 GB/s

    @property
    def ndp_aggregate_bw(self) -> float:
        return self.n_dimms * self.ndp_internal_bw  # 2.46 TB/s


@dataclass(frozen=True)
class TPUv5e:
    """Roofline constants for the dry-run target (per chip)."""

    flops: float = 197e12  # BF16 FLOP/s
    hbm_bw: float = 819e9  # B/s
    hbm_bytes: float = 16e9
    ici_link_bw: float = 50e9  # B/s per link (per direction)
    ici_links: int = 2  # usable links per chip on a 2D torus axis-pair
    dcn_bw: float = 25e9  # per-host cross-pod


TRIMOE_HW = TriMoEHardware()
TPU_V5E = TPUv5e()
