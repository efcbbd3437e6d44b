"""The precision control of a cell, read beside the program's own numbers.

    python3 ralm_bench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

Runs the cell once a seed in one process (set-up, warm-up, the window at
the cell's own load), then reads the compared numbers of the engine's
served tokens and, on the same sample, of the reference computed a
precision lower (the comparison's ``control_outputs``), and judges the
control's against the cell's limits (``control_correct``, which has to
be false). One JSON line a seed. The limits in ``limits/<cell>.json``
are set between the two: above the largest sound reading, below the
smallest control reading.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from ralm_bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run(cell, seed, args.seconds, False, "cuda", t0,
                          control=True)
        checks = res["checks"]
        print(json.dumps(dict(
            workload=cell.name, seed=seed, correct=checks["correct"],
            sound={n: c["value"] for n, c in checks["numbers"].items()},
            control_correct=checks.get("control_correct"),
            control=checks.get("control_numbers"),
            compared_tokens=checks.get("compared_tokens"),
            seconds=time.perf_counter() - t0)), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
