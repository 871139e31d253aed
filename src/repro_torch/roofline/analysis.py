"""Three-term roofline of one step (port of ``repro.roofline.analysis``,
re-based on the NVIDIA H100 SXM).

    compute term    = FLOPs / (cards x peak FLOP/s)
    memory term     = bytes per card / HBM rate
    collective term = collective bytes per card / link rate

``Hardware`` holds the H100 SXM data sheet's dense bf16 rate, its HBM3
rate and NVLink's all-to-all rate in place of the TPU's ICI link.

``collective_bytes_from_hlo`` is the reference's parser of collectives in
(per-device) HLO text, copied: pure text code, for HLO such as the
reference's dry-run dumps.  PyTorch produces no HLO, so the port's own
dry run (``launch.dryrun``) has no collective bytes to parse: 0 on one
card, unknown for a planned mesh of more.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s4": 1, "u4": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_flops: float = 989e12       # bf16 dense, per card
    hbm_bw: float = 3.35e12          # bytes/s per card (HBM3)
    link_bw: float = 900e9           # bytes/s per card (NVLink, all to all)


HW = Hardware()

_COLLECTIVE_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([0-9,]*)\][^=]*?\s"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)

_TUPLE_COLLECTIVE_RE = re.compile(
    r"=\s*\(([^)]+)\)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\("
)

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


# computation defs may have nested parens in tuple signatures — only anchor
# on the leading name and the trailing "{"
_COMP_DEF_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")
_WHILE_RE = re.compile(
    r"while\(.*?\)"
    r".*?condition=%?([\w.\-]+)"
    r".*?body=%?([\w.\-]+)"
)
_CONST_RE = re.compile(r"=\s*[su]\d+\[\]\s+constant\((\d+)\)")


def _parse_line_collective(line: str):
    """Returns (op, bytes) if the line is a collective, else None."""
    if "-done(" in line:
        return None  # the matching -start already counted this transfer
    m = _TUPLE_COLLECTIVE_RE.search(line)
    if m:
        total = sum(_shape_bytes(dt, dims) for dt, dims in _SHAPE_RE.findall(m.group(1)))
        return m.group(2), total
    m = _COLLECTIVE_RE.search(line)
    if m and m.group(1) in _DTYPE_BYTES:
        return m.group(3), _shape_bytes(m.group(1), m.group(2))
    return None


def collective_bytes_from_hlo(hlo_text: str) -> Dict[str, Any]:
    """Sum result sizes of every collective op in (per-device) HLO text,
    multiplied by the trip counts of enclosing while loops.

    ``lax.scan`` lowers to ``while`` whose condition compares the induction
    variable against a constant — collectives inside scan-over-layers /
    microbatch-accumulation bodies execute ``trip`` times per step, so the
    per-computation totals are scaled by the (possibly nested) trip counts.
    ``-start`` ops are counted; matching ``-done`` ops are not.
    """
    # 1. split into computations
    comps: Dict[str, list] = {}
    current = "__top__"
    comps[current] = []
    for line in hlo_text.splitlines():
        stripped = line.rstrip()
        if not line.startswith(" ") and stripped.endswith("{"):
            m = _COMP_DEF_RE.match(stripped)
            if m:
                current = m.group(1)
                comps[current] = []
                continue
        comps.setdefault(current, []).append(line)

    # 2. per-computation: own collective bytes, outgoing edges, cond constants
    own: Dict[str, Dict[str, int]] = {}
    whiles: Dict[str, list] = {}
    plain_refs: Dict[str, set] = {}
    cond_consts: Dict[str, int] = {}
    ref_re = re.compile(r"(?:to_apply|calls)=%?([\w.\-]+)")
    for name, lines in comps.items():
        own[name] = {}
        whiles[name] = []
        plain_refs[name] = set()
        max_const = 0
        for line in lines:
            got = _parse_line_collective(line)
            if got:
                op, nbytes = got
                own[name][op] = own[name].get(op, 0) + nbytes
            wm = _WHILE_RE.search(line)
            if wm:
                whiles[name].append((wm.group(1), wm.group(2)))
            elif "to_apply=" in line or "calls=" in line:
                # follow call/fusion edges (closed_call bodies hold the scans);
                # reducer to_apply regions are harmless (no collectives inside)
                for rm in ref_re.finditer(line):
                    plain_refs[name].add(rm.group(1))
            cm = _CONST_RE.search(line)
            if cm:
                max_const = max(max_const, int(cm.group(1)))
        cond_consts[name] = max_const

    # 3. recursively accumulate:
    #    bytes(comp) = own + sum(trip * bytes(while body)) + sum(bytes(callees))
    memo: Dict[str, Dict[str, int]] = {}
    in_progress: set = set()

    def total(name: str, depth: int = 0) -> Dict[str, int]:
        if name in memo:
            return memo[name]
        if name in in_progress or depth > 16:
            return {}
        in_progress.add(name)
        acc = dict(own.get(name, {}))
        for cond, body in whiles.get(name, []):
            trip = max(cond_consts.get(cond, 1), 1)
            for op, nbytes in total(body, depth + 1).items():
                acc[op] = acc.get(op, 0) + trip * nbytes
            for op, nbytes in total(cond, depth + 1).items():
                acc[op] = acc.get(op, 0) + nbytes
        for callee in plain_refs.get(name, ()):
            for op, nbytes in total(callee, depth + 1).items():
                acc[op] = acc.get(op, 0) + nbytes
        in_progress.discard(name)
        memo[name] = acc
        return acc

    entry = None
    for name in comps:
        if name.startswith("main") or "entry" in name.lower():
            entry = name
            break
    per_op: Dict[str, int] = {}
    roots = [entry] if entry else [n for n in comps if whiles.get(n) or own.get(n)]
    if entry:
        per_op = dict(total(entry))
    else:
        # fallback: flat sum without trip adjustment
        for name in comps:
            for op, nbytes in own.get(name, {}).items():
                per_op[op] = per_op.get(op, 0) + nbytes

    flat_counts: Dict[str, int] = {}
    for name, lines in comps.items():
        for line in lines:
            got = _parse_line_collective(line)
            if got:
                flat_counts[got[0]] = flat_counts.get(got[0], 0) + 1
    return {
        "per_op_bytes": per_op,
        "per_op_counts": flat_counts,
        "total_bytes": int(sum(per_op.values())),
        "entry": entry or "flat",
    }


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
