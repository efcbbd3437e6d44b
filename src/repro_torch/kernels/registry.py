"""Tile heuristics for the port's kernels (twin of ``repro.kernels.registry``).

The reference's ``KernelSpec`` also chose a backend (Pallas, ref,
einsum) and counted Pallas-to-ref fallbacks. The port has neither: the
device of the input decides — a CPU tensor runs the plain PyTorch
version, a CUDA tensor launches the hand-written kernel or raises — so
what remains is the tile arithmetic, kept identical so that host-side
replicas (``decode_attn.ops.count_skipped_blocks``) agree with the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Tile overrides for one kernel call (``None`` = heuristic)."""

    tile_q: Optional[int] = None   # query-tile rows
    tile_n: Optional[int] = None   # scan-axis tile / decode KV split length
    tile_c: Optional[int] = None   # centroid-tile columns

    @staticmethod
    def _divisor_at_most(n: int, want: int) -> int:
        """Largest divisor of ``n`` that is <= ``want`` (>= 1)."""
        t = max(1, min(want, n))
        while n % t:
            t -= 1
        return t

    def pick_tile_q(self, nq: int) -> int:
        """Query-tile rows: largest of 8/4/1 dividing the batch."""
        if self.tile_q is not None:
            return self._divisor_at_most(nq, self.tile_q)
        return 8 if nq % 8 == 0 else (4 if nq % 4 == 0 else 1)

    def pick_tile_c(self, nlist: int) -> int:
        """Centroid-tile columns for the IVF scan."""
        if self.tile_c is not None:
            return self._divisor_at_most(nlist, self.tile_c)
        return 512 if nlist % 512 == 0 else (128 if nlist % 128 == 0
                                             else nlist)

    def pick_tile_n(self, n: int) -> int:
        """Scan-axis tile for the streaming ADC kernels."""
        tile = self.tile_n if self.tile_n is not None else 512
        return min(tile, max(128, n))

    def pick_block_seq(self, s: int) -> int:
        """KV-block length over a cache seq axis of ``s`` slots: the
        largest divisor of ``s`` that is <= ``tile_n`` (default 128). It
        is the reference kernel's skip granularity and the port's
        split-KV chunk length."""
        want = self.tile_n if self.tile_n is not None else 128
        return self._divisor_at_most(s, want)


DEFAULT = KernelSpec()
