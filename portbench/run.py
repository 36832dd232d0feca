"""Run one cell of the benchmark of ``slr_torch`` once:

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's checks (each number compared beside its limit) as the last
lines of standard error, and as the last line of standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics), ``device``,
with ``--trace 1`` ``breakdown``, and ``checks``. Exits non-zero with no
result without a CUDA device, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the program's host work on one thread of its own and two fixed cores, so
# that a run loads the host alike whichever cores are free
os.sched_setaffinity(0, set(sorted(os.sched_getaffinity(0))[-2:]))
os.environ["OMP_NUM_THREADS"] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    bench = harness.manifest()
    cell = harness.cell_of(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           T_START, device="cuda", bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
