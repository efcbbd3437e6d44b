"""``repro_torch`` — the PyTorch + CUDA port of the Chameleon RALM system.

The JAX package ``repro`` is the reference; this package mirrors its
module paths (``repro_torch.models.transformer`` is the twin of
``repro.models.transformer``) and imports nothing of it, nor JAX.

Every TPU Pallas kernel on the served path has a hand-written CUDA
counterpart under ``csrc/``. A kernel wrapper decides by the device of
the tensor it is handed: a CPU tensor runs the kernel's plain PyTorch
version, a CUDA tensor launches the kernel (or raises) — there is no
silent fallback on the card.

Float32 products decide IVF probe ids and PQ codes, so TF32 is switched
off once, here, for every matmul and convolution of the process.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
