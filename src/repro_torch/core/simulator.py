"""CIM hardware simulator — system/application-level latency, dynamic
energy, area and EDAP for a mapped network (paper §IV-D/E).

This is an analytical model in the style of DNN+NeuroSim [13] (the actual
NeuroSim C++ core is not available offline): a chip of ``P`` SRAM CIM macros
(PE = macro + adder tree + local buffers, tiles + global buffer + H-tree
interconnect, Fig 2), 22 nm CMOS, 1 GHz, parallel read-out with flash ADCs
(Fig 3), bit-serial multi-bit inputs.

All constants live in :class:`TechConfig` with their provenance; the
paper's headline results are *relative* (normalized latency / energy /
EDAP between mapping algorithms under identical hardware), which this
model reproduces from the exact cycle/window/macro accounting of the
mapping layer — absolute joules/seconds are order-of-magnitude.

Component breakdown per inference:

latency  = window loads x input_bits x t_clk            (array compute)
         + input-buffer traffic / buffer bandwidth       (IFM staging)
         + H-tree traffic / interconnect bandwidth       (cross-tile)
         + accumulation pipeline drain per load
energy   = array read + ADC conversions + shift/add accumulation
         + buffer R/W + interconnect transfer
area     = P x (array + ADC + decoders + adder tree + local buffer)
         + global buffer + H-tree wiring
EDAP     = energy x latency x area  (§IV-E; idle macros are power-gated:
           they cost area but neither energy nor latency)
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .types import (ArrayConfig, LayerMapping, MacroGrid, NetworkMapping)


@dataclass(frozen=True)
class TechConfig:
    """22 nm CMOS @ 1 GHz, 300 K (paper §IV-D).  Energies in J, areas in
    m^2, bandwidths in bytes/s.  Values are NeuroSim-order constants:
    8T-SRAM CIM bitcell ~0.25 um^2 at 22 nm; 5b flash ADC ~2 pJ/conv,
    ~0.003 mm^2, shared by 8 columns (column-mux); SRAM buffer ~25 fJ/bit;
    on-chip H-tree ~0.2 pJ/bit/mm."""

    clock_hz: float = 1e9
    # --- array ---
    e_cell_read: float = 1.0e-15          # J per active bitcell per phase
    e_wl_driver: float = 2.0e-14          # J per row activation per phase
    a_cell: float = 0.25e-12              # m^2 per bitcell
    # --- ADC (5b flash, parallel read-out) ---
    e_adc: float = 2.0e-12                # J per conversion
    a_adc: float = 3.0e-9                 # m^2 per ADC
    adc_share: int = 8                    # columns per ADC (mux)
    # --- accumulation (shift&add + adder trees) ---
    e_acc: float = 5.0e-14                # J per partial-sum accumulate
    a_acc_per_col: float = 0.5e-9         # m^2 per column of adders
    # --- buffers ---
    e_buf_bit: float = 2.5e-14            # J per bit R/W (local SRAM buffer)
    buf_bw: float = 64e9                  # bytes/s per tile input buffer
    a_buf_per_kb: float = 2.0e-9          # m^2 per KiB of buffer
    local_buf_kb: float = 32.0
    global_buf_kb: float = 256.0
    # --- interconnect (H-tree) ---
    e_wire_bit_mm: float = 0.2e-12        # J per bit per mm
    htree_bw: float = 128e9               # bytes/s
    # --- misc digital (pooling/activation peripheries) ---
    a_misc: float = 0.05e-6               # m^2 flat
    act_bits: int = 8                     # activation precision
    weight_bits: int = 5                  # weight precision (Fig 4 example)


@dataclass
class LayerMetrics:
    name: str
    algorithm: str
    cycles: int
    latency_s: float
    energy_j: float
    breakdown: Dict[str, float] = field(default_factory=dict)


@dataclass
class SystemMetrics:
    name: str
    algorithm: str
    grid: MacroGrid
    active_macros: int
    latency_s: float
    energy_j: float
    area_m2: float
    layers: List[LayerMetrics] = field(default_factory=list)

    @property
    def edap(self) -> float:
        return self.energy_j * self.latency_s * self.area_m2

    @property
    def edp(self) -> float:
        return self.energy_j * self.latency_s

    def row(self) -> str:
        return (f"{self.name},{self.algorithm},{self.grid.r}x{self.grid.c},"
                f"{self.latency_s:.3e},{self.energy_j:.3e},"
                f"{self.area_m2 * 1e6:.3f},{self.edap:.3e}")


def macro_area(array: ArrayConfig, tech: TechConfig) -> float:
    """One PE: synaptic array + ADCs + adder tree + local buffer."""
    a_array = array.ar * array.ac * tech.a_cell
    a_adcs = math.ceil(array.ac / tech.adc_share) * tech.a_adc
    a_acc = array.ac * tech.a_acc_per_col
    a_buf = tech.local_buf_kb * tech.a_buf_per_kb
    return a_array + a_adcs + a_acc + a_buf


def chip_area(array: ArrayConfig, grid: MacroGrid, tech: TechConfig) -> float:
    """Full hardware budget (idle macros still occupy area, §IV-E)."""
    a = grid.p * macro_area(array, tech)
    a += tech.global_buf_kb * tech.a_buf_per_kb
    a *= 1.10          # H-tree + wiring overhead ~10 %
    return a + tech.a_misc


def simulate_layer(m: LayerMapping, tech: TechConfig) -> LayerMetrics:
    """Latency/energy for one mapped layer (one inference)."""
    arr = m.array
    layer = m.layer
    gr, gc = m.group_split
    g_par = min(m.group, gr * gc)
    seq_groups = math.ceil(m.group / g_par)
    t_clk = 1.0 / tech.clock_hz
    sub_r = max(1, m.grid.r // gr)      # one group's sub-grid: loop-
    sub_c = max(1, m.grid.c // gc)      # invariant across tiles

    lat_array = 0.0
    e_array = e_adc = e_acc = e_buf = e_wire = 0.0
    total_loads_time = 0            # sequential array loads (time axis)
    total_loads_energy = 0          # loads counted across parallel macros

    for t in m.tiles:
        seq_loads = (t.n_windows * math.ceil(t.ar_c / sub_r)
                     * math.ceil(t.ac_c / sub_c))
        all_loads = t.n_windows * t.ar_c * t.ac_c          # work, not time
        total_loads_time += seq_loads
        total_loads_energy += all_loads

        rows_used = t.window.rows(t.ic_t)
        cols_used = (t.window.positions(layer.k_w, layer.k_h, layer.stride)
                     * t.oc_t * arr.cols_per_weight)
        # cells that actually hold weights (null cells don't discharge)
        active_cells = t.mapped_cells(layer, arr)

        # --- energy per load (one parallel window, all input-bit phases) ---
        phases = tech.act_bits
        e_load = (rows_used * tech.e_wl_driver
                  + active_cells * tech.e_cell_read) * phases
        e_array += e_load * all_loads * m.group
        e_adc += (cols_used * phases * tech.e_adc) * all_loads * m.group
        e_acc += (cols_used * phases * tech.e_acc) * all_loads * m.group

        # --- buffer traffic: window inputs in, partial sums out ---
        in_bits = rows_used * tech.act_bits
        out_bits = cols_used * (tech.act_bits + tech.weight_bits
                                + math.ceil(math.log2(max(2, rows_used))))
        e_buf += (in_bits + out_bits) * tech.e_buf_bit * all_loads * m.group
        e_wire += ((in_bits + out_bits) * all_loads * m.group
                   * tech.e_wire_bit_mm * 1.0)   # ~1 mm mean H-tree hop

        # --- latency: bit-serial phases per sequential load + buffer/htree --
        lat_array += seq_loads * phases * t_clk
        lat_array += seq_loads * 4 * t_clk       # adder-tree pipeline drain
        # per-load input staging: every load re-streams its window pixels
        # through the WL switch matrix (img2col's "duplicated IFMs" cost);
        # the trailing *seq_groups on lat_array covers the group loop.
        lat_array += seq_loads * rows_used * (tech.act_bits / 8) / tech.buf_bw

    # buffer/interconnect latency: total IFM + OFM traffic at tile buffers
    ifm_bytes = layer.i_w * layer.i_h * layer.ic * tech.act_bits / 8
    ofm_bytes = layer.o_w * layer.o_h * layer.oc * tech.act_bits / 8
    lat_buf = (ifm_bytes + ofm_bytes) / tech.buf_bw
    lat_wire = (ifm_bytes + ofm_bytes) / tech.htree_bw

    lat = lat_array * seq_groups + lat_buf + lat_wire
    energy = e_array + e_adc + e_acc + e_buf + e_wire
    return LayerMetrics(
        name=layer.name, algorithm=m.algorithm, cycles=m.cycles,
        latency_s=lat, energy_j=energy,
        breakdown={"array": e_array, "adc": e_adc, "accum": e_acc,
                   "buffer": e_buf, "interconnect": e_wire,
                   "lat_array": lat_array * seq_groups,
                   "lat_buffer": lat_buf + lat_wire})


def simulate(net: NetworkMapping,
             tech: Optional[TechConfig] = None) -> SystemMetrics:
    tech = tech or TechConfig()
    layers = [simulate_layer(m, tech) for m in net.layers]
    active = max(m.active_macros for m in net.layers)
    return SystemMetrics(
        name=net.name, algorithm=net.algorithm, grid=net.grid,
        active_macros=active,
        latency_s=sum(m.latency_s for m in layers),
        energy_j=sum(m.energy_j for m in layers),
        area_m2=chip_area(net.array, net.grid, tech),
        layers=layers)
