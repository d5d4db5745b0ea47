"""Run one cell of the benchmark of `mxx_tpu_torch` once.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`. With `--trace 0` the
last line of standard output is the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics; each is one JSON object with `correct`,
`attempted`, `failed`, `metrics`, `device` and, last, `checks`: every number
the reference compared beside its limit, which are also the last lines of
standard error. Exits with 2, printing no result, where CUDA is missing or
has fewer cards than the cell asks for, and with 3 where JAX or the JAX
package was loaded in this process by the time the run has ended (the
window, the reference's judgement and the readers all done).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the run at a fixed place inside the
    # checkout (the program builds its kernels into build/mxx_tpu_torch/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "extensions")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    sys.path[0] = str(ROOT)  # the checkout's root, not portbench/
    import torch

    from portbench.spec import Spec

    spec = Spec(ROOT / "BENCHMARK.json")
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return report(spec, args.workload, args.seed, args.seconds, bool(args.trace))


def report(spec, workload: str, seed: int, seconds: float, trace: bool,
           device_type: str = "cuda") -> int:
    """Run the cell once, look for JAX and the JAX package last, and print
    the result; 3, and no result, where they were loaded."""
    from portbench.harness import forbidden_loaded, run_cell

    result = run_cell(spec, workload, seed, seconds, trace, device_type)
    found = forbidden_loaded()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (pass if {c['pass_if']} {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
