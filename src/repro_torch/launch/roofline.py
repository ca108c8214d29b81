"""Roofline terms of a dry-run cell on NVIDIA H100 terms (port of
``repro/launch/roofline.py``).

Per (arch x shape x mesh) cell, from the per-rank counts of
``launch.op_analysis``:

    t_compute = FLOPs_per_rank / PEAK_FLOPS[compute dtype]
    t_memory  = bytes_per_rank / HBM_BW
    t_coll    = sum over links of collective_bytes_per_rank[link]
                / LINK_BW[link]

The constants are the card's, NVIDIA H100 SXM5 80GB (the "NVIDIA H100
80GB HBM3" at 700 W), from NVIDIA's H100 Tensor Core GPU data sheet:

* ``PEAK_FLOPS["bf16"]`` 989e12 FLOP/s: dense BF16 on the tensor cores
  (the sheet's 1,979 TFLOPS is with 2:4 sparsity);
* ``PEAK_FLOPS["f32"]`` 67e12 FLOP/s: FP32 on the CUDA cores (the port
  switches TF32 off);
* ``HBM_BW`` 3.35e12 B/s: the SXM5's HBM3;
* ``LINK_BW["nvlink"]`` 450e9 B/s: fourth-generation NVLink, 900 GB/s a
  GPU in both directions together, so 450 GB/s a direction, between the
  ``GPUS_PER_NODE`` = 8 GPUs of an HGX H100 node;
* ``LINK_BW["network"]`` 50e9 B/s: one NDR InfiniBand adapter (400 Gb/s)
  a GPU between nodes (the DGX H100's eight ConnectX-7 ports).

A collective is charged at the slowest link its group spans: NVLink only
where every rank of its group sits in one node of ``GPUS_PER_NODE``
consecutive ranks.  The compute peak follows the cell's compute dtype.
These are analytic bounds, not measurements.

The JAX module's ``collective_stats`` parsed HLO text; the port has no
HLO and counts collectives as they are issued (``op_analysis``).

MODEL_FLOPS uses 6*N*D (train, dense), 6*N_active*D (MoE), 2*N*D
(prefill) and 2*N_active*B (decode, per step) with N from the analytic
param count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable

#: dense peak FLOP/s of one H100 SXM5 by compute dtype
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
#: HBM3 bytes/s of one H100 SXM5
HBM_BW = 3.35e12
#: bytes/s a GPU, a direction: NVLink 4 within a node, NDR between nodes
LINK_BW = {"nvlink": 450e9, "network": 50e9}
GPUS_PER_NODE = 8

_DTYPE_NAMES = {"bfloat16": "bf16", "float32": "f32"}


def dtype_name(dtype) -> str:
    """``"bf16"`` or ``"f32"`` of a torch dtype (or its name)."""
    name = str(dtype).replace("torch.", "")
    if name in PEAK_FLOPS:
        return name
    if name not in _DTYPE_NAMES:
        raise ValueError(f"no H100 peak for compute dtype {dtype}")
    return _DTYPE_NAMES[name]


def link_of(ranks: Iterable[int]) -> str:
    """The slowest link a group of global ranks spans: ``"nvlink"`` if
    they all sit in one node, else ``"network"``."""
    return ("nvlink" if len({int(r) // GPUS_PER_NODE for r in ranks}) <= 1
            else "network")


@dataclass
class RooflineTerms:
    flops_per_chip: float
    bytes_per_chip: float
    #: the collective bytes of a rank by link (``LINK_BW``'s keys), where
    #: the JAX module has one figure, ``coll_bytes_per_chip``
    coll_link_bytes: Dict[str, float]
    chips: int
    model_flops_total: float = 0.0
    compute_dtype: str = "bf16"

    @property
    def coll_bytes_per_chip(self) -> float:
        return float(sum(self.coll_link_bytes.values()))

    @property
    def peak_flops(self) -> float:
        return PEAK_FLOPS[dtype_name(self.compute_dtype)]

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_coll(self) -> float:
        return sum(b / LINK_BW[link]
                   for link, b in self.coll_link_bytes.items())

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_coll}
        return max(terms, key=terms.get)

    @property
    def bound(self) -> float:
        """Step-time lower bound (no overlap assumption: max of terms)."""
        return max(self.t_compute, self.t_memory, self.t_coll)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (total) — remat/redundancy waste."""
        counted = self.flops_per_chip * self.chips
        return self.model_flops_total / counted if counted else 0.0

    @property
    def t_useful(self) -> float:
        """The useful FLOPs of a rank at the peak."""
        return self.model_flops_total / self.chips / self.peak_flops

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound:
        (useful flops / chips / peak) / bound."""
        if self.bound == 0:
            return 0.0
        return self.t_useful / self.bound

    def fraction_at(self, seconds: float) -> float:
        """The roofline fraction of a measured step: (useful flops / chips
        / peak) / the step's ``seconds``."""
        return self.t_useful / seconds


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """Analytic 'useful' FLOPs for the cell (whole step)."""
    tokens = shape.batch * shape.seq
    if shape.mode == "train":
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.batch      # decode: one token / seq
