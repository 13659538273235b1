"""The roofline of a step traced under fake tensors (``repro.roofline``
for the port): ``dispatch`` counts what one rank's step computes, moves
and holds; ``analysis`` turns the counts into the H100's three terms;
``report`` prints the tables of the dry-run artifacts."""

from repro_torch.roofline import analysis, dispatch
from repro_torch.roofline.analysis import (HBM_BW, NIC_BW, NVLINK_BW,
                                           PEAK_F32_FLOPS, PEAK_FLOPS,
                                           RooflineReport, build_report,
                                           model_flops, suggestion)
from repro_torch.roofline.dispatch import StepCounter, count

__all__ = ["analysis", "dispatch", "HBM_BW", "NIC_BW", "NVLINK_BW",
           "PEAK_F32_FLOPS", "PEAK_FLOPS", "RooflineReport", "build_report",
           "model_flops", "suggestion", "StepCounter", "count"]
