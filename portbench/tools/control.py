"""Read the controls of a cell at its own size on the card: the program's
float32 path and, for the sweeps, the reference run in float32 in the
program's place, each judged by the float64 reference, on several seeds.

    python portbench/tools/control.py --workload <cell> --seeds 1 2 3

Prints one JSON line per seed and control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from pbench import control, harness, requests  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    _, config, traffic, limits = harness.cell_files(args.workload)
    for seed in args.seeds:
        inputs = requests.build_inputs(config, seed)
        t0 = time.perf_counter()
        numbers, record = control.program_f32(config, traffic, inputs, args.device)
        print(json.dumps({"cell": args.workload, "seed": seed, "control": "program_f32",
                          "numbers": numbers, "failed": record.get("failed"),
                          "error": record.get("error"),
                          "seconds": time.perf_counter() - t0, "limits": limits}), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers = control.reference_f32(config, traffic, inputs, args.device)
        if numbers is not None:
            print(json.dumps({"cell": args.workload, "seed": seed, "control": "reference_f32",
                              "numbers": numbers, "seconds": time.perf_counter() - t0}),
                  flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
