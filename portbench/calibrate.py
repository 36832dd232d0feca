"""The readings a correctness limit is set from, on the card, in one
process: the program's numbers on many seeds (sound runs, each a short
window at the cell's own load, checked as a run checks them), the
control's (the plain reference in TF32 put in the program's place) on the
first few, and, where the traffic kind plants them, the faults' on the
first few, at the cell's own size:

    python portbench/calibrate.py --workload <cell> --seeds <n> --controls <k> \
        [--faults <k>] [--first-seed <s>] [--seconds <s>] [--out <file.jsonl>]

One JSON line per seed. Not run by the benchmark's runs.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    _, cfg, mix, gen = harness.load_cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        traffic = gen.Traffic(cfg, mix["params"], seed, "cuda")
        try:
            traffic.setup()
            e2e, attempted, failed = traffic.window(args.seconds, sync_spans=False)
            faults = None
            if i < args.faults and hasattr(traffic, "fault_readings"):
                faults = traffic.fault_readings()
            traffic.release()
            got = traffic.readings()
            checks = harness.limits_check(got, cfg["checks"]["limits"])
            line = {"workload": args.workload, "seed": seed, "attempted": attempted,
                    "failed": failed, "program": got,
                    "correct": failed == 0 and attempted > 0 and all(c[3] for c in checks),
                    **e2e}
            if faults is not None:
                line["faults"] = faults
            if i < args.controls:
                line["control"] = traffic.control_readings()
        finally:
            traffic.close()
        line["s"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()
        del traffic
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
