"""What kernel 7b's fixed dQ order costs, and what its launch order saves.

    python3 scripts/dq_order_variants.py [--parent-src DIR]

Copies this checkout's ``src`` under the ignored ``build/dq_order/`` three
times more, each with one change to ``csrc/flash_attention_bwd.cu``:

* ``no wait``: the dQ writer's wait on each tile's counter cut to a wait
  for 0, every other step kept (the walk from the last query tile, the
  counters zeroed and raised, each add waited for to complete): the adds
  then land in the order the blocks finish, so this copy times the wait
  alone.  It is built only here and is no path of the port.
* ``group 1``: ``GROUP`` 1, a (batch, KV head)'s key blocks launched one
  after another, as before the groups.
* ``group 128``: ``GROUP`` 128, every row's first key block first (at the
  rows below, 128 (batch, KV head) rows or 16).

Then times kernel 7b at every ``scripts/bwd_timings.py`` backward row for
the design and each copy (and ``--parent-src``'s, where given) in turns,
forward then back, each in a process of its own (``bwd_timings.py --only
flash_attention_bwd``).  Prints one JSON object a row: each variant's ms
a call and main-pass microseconds a call, their means, and each mean over
the design's.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "dq_order"
KERNEL = pathlib.Path("repro_torch", "kernels", "csrc",
                      "flash_attention_bwd.cu")
WAIT = "dq_wait(dq_sem + tile, kb);"
GROUP = "GROUP = 32;"
PATCHES = {
    "no wait": [(WAIT, "dq_wait(dq_sem + tile, 0);", 1)],
    "group 1": [(GROUP, "GROUP = 1;", 1), ("GROUP == 32", "GROUP == 1", 2)],
    "group 128": [(GROUP, "GROUP = 128;", 1),
                  ("GROUP == 32", "GROUP == 128", 2)],
}


def copy(name: str, patches) -> pathlib.Path:
    dst = OUT / name.replace(" ", "_") / "src"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst, ignore=shutil.ignore_patterns(
        "build", "__pycache__"))
    path = dst / KERNEL
    text = path.read_text()
    for old, new, count in patches:
        if text.count(old) != count:
            raise SystemExit(f"dq_order_variants: {old!r} not found {count} "
                             f"time(s) in {path}: edit it with the kernel")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src", default="")
    args = ap.parse_args()
    srcs = {"design": ROOT / "src"}
    srcs.update((name, copy(name, patches))
                for name, patches in PATCHES.items())
    if args.parent_src:
        srcs["parent"] = pathlib.Path(args.parent_src)
    turns = list(srcs) + list(srcs)[::-1]
    rows = {}
    for label in turns:
        out = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "bwd_timings.py"),
             "--src", str(srcs[label]), "--label", label,
             "--only", "flash_attention_bwd"],
            capture_output=True, text=True, check=True).stdout
        for r in (json.loads(line) for line in out.splitlines()
                  if line.startswith("{")):
            main_us = sum(us for key, us in r["kernels_us"].items()
                          if "main" in key)
            rows.setdefault(r["row"], {"card": r["card"]}).setdefault(
                label, []).append({"ms": r["ms"], "main_us": main_us})
    for row, by in rows.items():
        mean = {label: statistics.mean(t["ms"] for t in by[label])
                for label in srcs}
        print(json.dumps(dict(
            row=row, card=by["card"], turns={k: by[k] for k in srcs},
            mean_ms=mean, over_design={k: v / mean["design"]
                                       for k, v in mean.items()})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
