"""Run one cell of the port's benchmark once and print its result line.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA GPU.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared with its limit); the last lines of
standard error repeat the checks.  Exits non-zero and prints no result
without a card, when the program cannot be imported, or when JAX or the
JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Build and kernel caches at fixed paths inside the checkout.
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from pbench import harness

    try:
        work, _, _, _ = harness.cell_files(args.workload)
    except (OSError, KeyError, ValueError) as e:
        fail(2, f"cannot load the cell: {e}")
    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        fail(3, f"needs {work['chips']} CUDA device(s), found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import differentialriccatiequations_jl_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(4, f"the program cannot be imported: {e}")

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)

    found = harness.forbidden_modules()
    if found:
        fail(5, f"forbidden modules loaded: {', '.join(found)}")
    for name, c in result["checks"].items():
        if not math.isfinite(c["value"]):
            c["value"] = 1e300  # JSON has no infinity; any limit fails it
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
