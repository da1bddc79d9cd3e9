"""Roofline model of the card, the measured-vs-modeled attribution of
the packed kernels, the per-device cost analysis of a traced step
(``step_costs``, where the reference parses HLO) and the dry-run report
(``report``) (mirrors ``repro/roofline``)."""

from repro_torch.roofline.attribution import (
    attribute,
    model_packed_costs,
    profile_packed_tree,
    read_report,
    render_report,
    write_report,
)
from repro_torch.roofline.costs import COLLECTIVES, Costs
from repro_torch.roofline.step_costs import (
    StepCostMode,
    rank_step_hotspots,
    record_step,
)
from repro_torch.roofline.hw import (
    HBM_BW,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    PEAK_FLOPS_FP32,
    RooflineTerms,
    model_flops_infer,
    model_flops_train,
    roofline_terms,
)

__all__ = [
    "COLLECTIVES", "Costs", "HBM_BW", "NVLINK_BW", "PEAK_FLOPS_BF16",
    "PEAK_FLOPS_FP32", "RooflineTerms", "StepCostMode", "attribute",
    "model_flops_infer", "model_flops_train", "model_packed_costs",
    "profile_packed_tree", "rank_step_hotspots", "read_report",
    "record_step", "render_report", "roofline_terms", "write_report",
]
