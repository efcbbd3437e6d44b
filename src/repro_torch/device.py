"""Device selection for the port's entry points.

Entry points (``RalmEngine.from_config``, ``DatastoreBuilder``) run on
the card unless the caller names another device: ``None`` means
``"cuda"``, and asking for the card on a host without one raises rather
than quietly running on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None
            ) -> torch.device:
    """``None`` -> the first CUDA device; raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on the GPU by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev
