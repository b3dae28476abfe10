"""The readings that the check's limits are set from: for each seed, one
short run of a cell with the numbers the check compares, read for the
program and for the control (the reference in float32 with TF32 matmuls in
the program's place), all seeds in one process:

    python3 -m vio_bench.readings --workload <cell> --seconds 3 --seeds 11 12 13

``--fault <name>`` plants one of ``faults.FAULTS`` in the program first and
reads the program's numbers alone. One JSON line a seed on standard output.
Needs a CUDA card."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import cell as C
from . import faults
from .run import log


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("needs a CUDA card")
        return 2
    cell = C.Cell(Path.cwd(), args.workload)
    if args.fault:
        faults.plant(args.fault)
    for seed in args.seeds:
        res = C.run(cell, seed, args.seconds, False, device="cuda", log=log,
                    control=not args.fault)
        gaps, seen = res.get("control", (None, None))
        print(json.dumps(dict(workload=args.workload, seed=seed, fault=args.fault,
                              program={k: v["value"] for k, v in res["check"]["numbers"].items()},
                              control=gaps, seen=res["check"]["seen"], control_seen=seen,
                              calls=res["calls"], ate_m=res["ate_m"],
                              frames_per_s=res["window"]["frames"] / res["window"]["wall_s"])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
