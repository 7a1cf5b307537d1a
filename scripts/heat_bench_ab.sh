#!/bin/bash
# The heat bench of two checkouts in turns on one card, for an A/B of a
# change against its parent: parent, change, change, parent.
#
#     bash scripts/heat_bench_ab.sh PARENT_DIR [SLABS]
#
# PARENT_DIR holds the parent's tree (e.g. `git archive <commit>` unpacked
# into the git-ignored build/parent); the change is this checkout.  Each
# run is `python -m stfem_tpu_torch.bench_heat --slabs SLABS` (default 4)
# at the bench's defaults with the estimate cache off; per run it prints
# the V-cycles and walls of every slab, the setup and the metric value.
set -euo pipefail
parent=$1
slabs=${2:-4}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
export STFEM_EIG_CACHE=0
for d in "$parent" . . "$parent"; do
  echo "== $d"
  (cd "$d" && python -m stfem_tpu_torch.bench_heat --slabs "$slabs" 2>&1 |
    python -c '
import json, sys
for line in sys.stdin:
    if not line.startswith("{"):
        continue
    d = json.loads(line)
    if "metric" in d:
        print("metric", d["value"])
    else:
        print("iters", d["iters"], "slab_s",
              [round(t, 4) for t in d["slab_s"]], "setup",
              round(d["setup_s"], 2))
')
done
