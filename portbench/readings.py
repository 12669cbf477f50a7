"""The readings that the limits of ``correct`` are set from, for one
cell, in one process (the kernels built once):

    python3 portbench/readings.py --workload <cell> --seconds <s>
        --seeds <n,n,...> [--controls <k>] [--bf16 <n,n,...>]

For each seed, one run of the cell as ``run.py`` makes it (the same
window, entry and check) and its ``max_gap_lsb``. For the first ``k``
seeds also the control: the reference in TF32 put in the program's
place at the same written frames (``check.control_writes``), judged
by ``check.compare`` as the program's writes are: it has to come out not
correct, and the script exits with 1 where one does not. For each
``--bf16`` seed, a run of the program under its own lower-precision
path, the bf16 bank and ring (``BRUTEFIR_TPU_BANK_DTYPE`` /
``_RING_DTYPE``). Prints a line a run and a JSON summary last.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--bf16", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import check, harness

    seeds = [int(s) for s in args.seeds.split(",") if s]
    out = {"workload": args.workload, "program": [], "tf32": [],
           "bf16": []}
    for i, seed in enumerate(seeds):
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             time.perf_counter(),
                             keep_reference=i < args.controls)
        gap = r["checks"]["max_gap_lsb"]["value"]
        out["program"].append([seed, gap])
        line = (f"program seed {seed}: max_gap_lsb {gap}, correct "
                f"{r['correct']}, xrt {r['metrics']['xrt']['value']:.4f}, "
                f"setup_s {r['metrics']['setup_s']['value']:.3f}")
        if "_reference" in r:
            reference, kept = r.pop("_reference")
            limits = {k: c["limit"] for k, c in r["checks"].items()}
            numbers, _ = check.compare(
                check.control_writes(kept, reference, "tf32"), reference,
                limits)
            tf = numbers["max_gap_lsb"][0]
            tf_ok = all(ok for *_, ok in numbers.values())
            out["tf32"].append([seed, tf, tf_ok])
            line += f"; tf32 control {tf}, correct {tf_ok}"
            del reference, kept
        print(line, flush=True)
    bf16 = {k: "bf16" for k in harness.PRECISION_KNOBS}
    for seed in [int(s) for s in args.bf16.split(",") if s]:
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             time.perf_counter(), knobs=bf16)
        gap = r["checks"]["max_gap_lsb"]["value"]
        out["bf16"].append([seed, gap])
        print(f"bf16 program seed {seed}: max_gap_lsb {gap}, correct "
              f"{r['correct']}", flush=True)
    print(json.dumps(out), flush=True)
    if any(ok for *_, ok in out["tf32"]):
        sys.stderr.write("readings: a control came out correct\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
