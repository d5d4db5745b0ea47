"""Readings for the limits: sound runs of a cell on many seeds, each judged
also as the control, in one process (one kernel load, one set-up per seed).

    python portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 5

prints one JSON line per seed with `checks` (the program's readings) and
`control_checks` (the same answers held with one bit less). With `--fault
<name>` (`faults.py`) the program runs with that fault planted, and `checks`
are the fault's readings. The benchmark's own runs never run it. It needs
the card, as run.py does.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch

    from contextlib import nullcontext

    from portbench.faults import FAULTS
    from portbench.harness import forbidden_loaded, run_cell
    from portbench.spec import Spec

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    spec = Spec(ROOT / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        with FAULTS[args.fault]() if args.fault else nullcontext():
            r = run_cell(spec, args.workload, seed, args.seconds, False, control=True)
        if forbidden_loaded():
            print(f"portbench: JAX or the JAX package loaded: {forbidden_loaded()}",
                  file=sys.stderr)
            return 3
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": r["correct"],
                          "control_correct": r["control_correct"], "attempted": r["attempted"],
                          "metrics": r["metrics"], "checks": r["checks"],
                          "control_checks": r["control_checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
