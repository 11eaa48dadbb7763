"""repro_torch: the PyTorch/CUDA port of the MindTheStep-AsyncPSGD system.

The JAX package ``repro`` is the reference; this package mirrors its layout
module for module (``repro_torch.optim.fuse`` is the port of
``repro.optim.fuse`` and so on) and imports nothing of it.  Entry points run
on the card (``device="cuda"``) unless the caller asks for the CPU; on a CPU
tensor every kernel wrapper runs its plain PyTorch version.

TF32 is switched off explicitly for matmuls and cuDNN, so an f32 product is a
full-precision f32 product on the card as it is on the CPU.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
