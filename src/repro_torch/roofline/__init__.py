from repro_torch.roofline.analysis import (  # noqa: F401
    RooflineReport,
    model_flops_estimate,
    roofline_terms,
)
