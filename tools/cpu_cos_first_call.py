"""Why the port's index build is not bit-stable between processes on the
CPU: float32 ``torch.cos``'s first call in a process.

    python3 tools/cpu_cos_first_call.py [--processes 24]

Each fresh process does one bfloat16 matmul (as the model's forward
does before the first layer's rotary tables), then computes
``torch.cos`` twice over the same float32 angles of the rotary tables
of a [64, 32] position grid at d_head 16 (16 384 values: 8 intra-op
threads' chunks of 2048), and once in float64. It prints, per process,
how many values of the first call differ from the second, the first
call's largest error against float64, and the same for ``torch.sin``
and for float64 ``torch.cos``. A first call that goes wrong does so in
whole thread chunks, with errors near 1.5e-4 where the second call's
are near 3e-8. No GPU is used.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

CHILD = r"""
import torch
g = torch.Generator().manual_seed(0)
a = torch.randn(2048, 64, generator=g).bfloat16()
w = torch.randn(64, 64, generator=g).bfloat16()
(a @ w)
pos = torch.arange(32)[None].expand(64, 32)
inv = 1.0 / (1e4 ** (torch.arange(0, 16, 2, dtype=torch.float32) / 16))
ang = pos[..., None].float() * inv
c1, c2 = torch.cos(ang), torch.cos(ang)
s1, s2 = torch.sin(ang), torch.sin(ang)
d1, d2 = torch.cos(ang.double()), torch.cos(ang.double())
ref = torch.cos(ang.double())
print(int((c1 != c2).sum()), float((c1.double() - ref).abs().max()),
      float((c2.double() - ref).abs().max()), int((s1 != s2).sum()),
      int((d1 != d2).sum()), torch.get_num_threads())
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=24)
    args = ap.parse_args(argv)
    bad = 0
    print("process cos_first_differs cos_first_err cos_second_err "
          "sin_first_differs cos_f64_first_differs threads")
    for i in range(args.processes):
        out = subprocess.run([sys.executable, "-c", CHILD], check=True,
                             capture_output=True, text=True).stdout.split()
        bad += int(out[0]) > 0
        print(i, *out)
    print(f"processes whose first float32 cos differs from the second: "
          f"{bad} of {args.processes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
