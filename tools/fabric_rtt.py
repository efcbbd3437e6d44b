"""Round trips of the disaggregated pools' fabric at the serve's message
sizes, with two memory-node processes on the card.

    python3 tools/fabric_rtt.py [--src DIR] [--iters N] [--device cuda]

Times, per op, the coordinator's host wall time of a round trip to both
nodes (median, 10th and 90th percentile) and the slowest node's own
handling time, for the messages ``serve.disaggregated`` sends a wave:
``stats`` (no tensors: the fabric's floor), a ``place`` of one wave's
queries (32 x 512 float32, 64 KiB out, nothing back) and a ``gather``
of one wave's ids (32 x 100 int32, 12.8 KB each way). ``--src`` imports
``repro_torch`` from another source tree (an earlier commit unpacked
with ``git archive``), so two versions of the fabric can be timed in
one call. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.retrieval.fabric import Fabric

    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("fabric_rtt: no CUDA device")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    dev = torch.device(args.device)
    fabric = Fabric(make_mesh_for(data=2, device=args.device).devices)
    try:
        q = torch.randn(32, 512, device=dev)
        table = torch.arange(4096, dtype=torch.int32)
        fabric.call("place", {i: ({"name": "table"}, [table[i * 2048:
                                                            (i + 1) * 2048]])
                              for i in range(2)})
        ids = torch.randint(0, 4096, (32, 100), dtype=torch.int32,
                            device=dev)
        ops = {
            "stats": lambda: fabric.broadcast("stats"),
            "place_64KiB": lambda: fabric.broadcast(
                "place", {"name": "queries"}, [q]),
            "gather_12.8KB": lambda: fabric.call(
                "gather", {i: ({"table": "table", "lo": i * 2048},
                               [ids.cpu()]) for i in range(2)}),
        }
        out = {}
        for name, fn in ops.items():
            for _ in range(10):
                fn()
            fabric.reset_counters()
            times = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            times.sort()
            op = name.split("_")[0]
            c = fabric.counters[op]
            out[name] = dict(
                p50_ms=round(times[len(times) // 2] * 1e3, 4),
                p10_ms=round(times[len(times) // 10] * 1e3, 4),
                p90_ms=round(times[len(times) * 9 // 10] * 1e3, 4),
                node_ms=round(c.node_seconds / c.round_trips * 1e3, 4),
                kb_out=round(c.bytes_out / c.round_trips / 1e3, 2),
                kb_in=round(c.bytes_in / c.round_trips / 1e3, 2))
        print(json.dumps({"src": args.src, "iters": args.iters, **out}),
              flush=True)
    finally:
        fabric.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
