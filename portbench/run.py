"""Run one cell of BENCHMARK.json once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout, on a host with the cards the cell asks for.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, which are also the last lines of standard error). With
``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones, read from spans around the program's
methods and a ``torch.profiler`` trace of the window.

Exits with 1 and prints no result when CUDA is missing or has fewer
cards than the cell asks for, and when a module of JAX or of the JAX
package is loaded once the window has closed. The program's kernel
builds go to ``build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    cell = harness.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("portbench: CUDA is not available\n")
        return 1
    if torch.cuda.device_count() < cell.chips:
        sys.stderr.write(f"portbench: {args.workload} needs {cell.chips} "
                         f"cards, {torch.cuda.device_count()} visible\n")
        return 1

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    bad = harness.banned_modules()
    if bad:
        sys.stderr.write("portbench: loaded after the window: "
                         + ", ".join(bad) + "\n")
        return 1
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name}: {c['value']} {c['op']} "
                         f"{c['limit']}\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
