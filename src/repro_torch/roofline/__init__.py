"""Analytic FLOPs, bytes and the roofline on one card (port of
``repro.roofline``)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    HW,
    Hardware,
    collective_bytes_from_hlo,
    roofline_terms,
)
from repro_torch.roofline.flops import (  # noqa: F401
    cell_flops,
    cell_hbm_bytes,
    forward_flops_per_token,
)
