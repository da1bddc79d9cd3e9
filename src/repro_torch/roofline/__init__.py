"""Roofline model of the card and the measured-vs-modeled attribution of
the packed kernels (mirrors ``repro/roofline``; the HLO cost parser and
the dry-run report have no counterpart yet)."""

from repro_torch.roofline.attribution import (
    attribute,
    model_packed_costs,
    profile_packed_tree,
    read_report,
    render_report,
    write_report,
)
from repro_torch.roofline.costs import COLLECTIVES, Costs
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
    "PEAK_FLOPS_FP32", "RooflineTerms", "attribute", "model_flops_infer",
    "model_flops_train", "model_packed_costs", "profile_packed_tree",
    "read_report", "render_report", "roofline_terms", "write_report",
]
