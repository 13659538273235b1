"""Three-term roofline model for the NVIDIA H100 SXM (the port's card).

    compute term    = Σ_dtype matmul_FLOPs_per_rank[dtype] / peak[dtype]
    memory term     = bytes_per_rank / HBM_BW
    collective term = Σ_link collective_bytes_per_rank[link] / link_bw

The counts are per rank already (``roofline.dispatch`` traces one rank's
step).  ``model_flops`` is the analytic useful work, 6·N_active·D for
training, 2·N_active·D for prefill, 2·N_active·B for one decode step, and
the usefulness ratio ``model_flops / (counted FLOPs · ranks)`` flags
recompute and redundancy (per-block recompute puts it near 0.75, a full
recompute near 1/3).

Two deviations from ``repro.roofline.analysis`` (one bf16 peak, one link):

1. the compute term sums each matmul's FLOPs over the peak of the dtype it
   runs in (``flops_by_dtype``): the port's attention scores are float32,
   and float32 matmuls run outside the bf16 tensor-core rate;
2. the collective term charges a collective whose process group fits in
   one node of ``NODE_RANKS`` ranks at NVLink and any other at the node's
   network card (``collective_link_bytes``): the production meshes span
   32 or 64 nodes of 8 cards.

A ``parsed`` dict without ``flops_by_dtype`` counts every FLOP at the bf16
peak, and one without ``collective_link_bytes`` every collective byte at
the network card, which is the reference's arithmetic with these peaks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


from repro_torch.configs.base import InputShape, ModelConfig

# NVIDIA H100 SXM5 data sheet
HBM_BW = 3.35e12             # HBM3, bytes/s
PEAK_FLOPS = 989e12          # dense bf16 / fp16 tensor cores, FLOP/s
PEAK_F32_FLOPS = 67e12       # float32 outside the tensor cores (TF32 off)
NVLINK_BW = 450e9            # NVLink 4, bytes/s each way per card
NIC_BW = 50e9                # one 400 Gb/s NDR NIC per card, bytes/s
NODE_RANKS = 8               # cards joined by NVLink in one node

# the peak each matmul dtype runs at (data sheet; float64 on the FP64
# tensor cores, integers at the bf16 rate as a floor)
PEAK_BY_DTYPE = {
    "bfloat16": PEAK_FLOPS, "float16": PEAK_FLOPS,
    "float32": PEAK_F32_FLOPS, "float64": PEAK_F32_FLOPS,
}


def peak_of(dtype) -> float:
    """FLOP/s for matmuls in ``dtype`` (a ``torch.dtype`` or its name)."""
    name = str(dtype).replace("torch.", "")
    return PEAK_BY_DTYPE.get(name, PEAK_FLOPS)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float
    usefulness: float
    dominant: str
    step_time_s: float

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Analytic useful FLOPs per step (global, all ranks)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def compute_seconds(parsed: Dict) -> float:
    """The compute term: each dtype's FLOPs over its peak."""
    by_dtype = parsed.get("flops_by_dtype")
    if not by_dtype:
        return parsed["flops_per_device"] / PEAK_FLOPS
    return sum(f / peak_of(dt) for dt, f in by_dtype.items())


def collective_seconds(parsed: Dict) -> float:
    """The collective term: NVLink bytes over its rate, the rest over the
    network card's."""
    links = parsed.get("collective_link_bytes")
    if not links:
        return parsed["collective_bytes_per_device"] / NIC_BW
    return (links.get("nvlink", 0.0) / NVLINK_BW
            + links.get("nic", 0.0) / NIC_BW)


def build_report(cfg: ModelConfig, shape: InputShape, mesh_name: str,
                 chips: int, parsed: Dict[str, float]) -> RooflineReport:
    compute_s = compute_seconds(parsed)
    memory_s = parsed["bytes_per_device"] / HBM_BW
    collective_s = collective_seconds(parsed)
    mf = model_flops(cfg, shape)
    hlo_global = parsed["flops_per_device"] * chips
    useful = mf / hlo_global if hlo_global > 0 else float("nan")
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        model_flops=mf, hlo_flops_global=hlo_global, usefulness=useful,
        dominant=dominant, step_time_s=max(terms.values()),
    )


def suggestion(report: RooflineReport) -> str:
    if report.dominant == "compute":
        if report.usefulness < 0.5:
            return ("compute-bound with low usefulness: reduce remat "
                    "recompute (save residuals) or cut redundant/causal "
                    "over-compute")
        return ("compute-bound near peak usefulness: only larger meshes or "
                "lower-precision matmuls move this")
    if report.dominant == "memory":
        return ("memory-bound: raise arithmetic intensity — larger "
                "microbatch, fused elementwise chains, weight-stationary "
                "layouts, or quantized (bf16/int8) state")
    return ("collective-bound: reshard to cut cross-device volume — "
            "bigger per-shard blocks, overlap collectives with compute, or "
            "compress the synchronized payload (FAIR-k rho)")


__all__ = ["HBM_BW", "PEAK_FLOPS", "PEAK_F32_FLOPS", "NVLINK_BW", "NIC_BW",
           "NODE_RANKS", "PEAK_BY_DTYPE", "peak_of", "RooflineReport",
           "model_flops", "compute_seconds", "collective_seconds",
           "build_report", "suggestion"]
