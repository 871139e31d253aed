"""Three-term roofline of one step (port of ``repro.roofline.analysis``,
re-based on the NVIDIA H100 SXM).

    compute term    = FLOPs / (cards x peak FLOP/s)
    memory term     = bytes per card / HBM rate
    collective term = collective bytes per card / link rate

``Hardware`` holds the H100 SXM data sheet's dense bf16 rate, its HBM3
rate and NVLink's all-to-all rate in place of the TPU's ICI link.  The
reference's parser of collectives in compiled HLO waits for the dry-run
slice (ROADMAP queue 1, item 8b).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_flops: float = 989e12       # bf16 dense, per card
    hbm_bw: float = 3.35e12          # bytes/s per card (HBM3)
    link_bw: float = 900e9           # bytes/s per card (NVLink, all to all)


HW = Hardware()


def roofline_terms(
    *,
    n_chips: int,
    hlo_flops_global: float,
    model_flops: float,
    hbm_bytes_per_chip: float,
    collective_bytes_per_chip: float,
    hw: Hardware = HW,
) -> Dict[str, Any]:
    """The three roofline terms and the bottleneck of one cell, in the
    reference's keys.  ``hlo_flops_global``: the implementation's FLOPs
    (``flops.cell_flops``); ``hbm_bytes_per_chip``: the analytic traffic
    per card; ``collective_bytes_per_chip``: bytes each card sends."""
    compute_s = hlo_flops_global / (n_chips * hw.peak_flops)
    memory_s = hbm_bytes_per_chip / hw.hbm_bw
    collective_s = collective_bytes_per_chip / hw.link_bw

    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = (max(terms, key=terms.get)
                if any(v > 0 for v in terms.values()) else "n/a")
    bound = max(terms.values()) if any(terms.values()) else 0.0
    ideal = model_flops / (n_chips * hw.peak_flops) if n_chips else 0.0
    return {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "model_flops": model_flops,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": ((model_flops / hlo_flops_global)
                               if hlo_flops_global else 0.0),
        "roofline_fraction": (ideal / bound) if bound else 0.0,
        "step_time_lower_bound_s": bound,
    }
