"""news_recsys_tpu_torch — the PyTorch + CUDA port of ``news_recsys_tpu``.

The port runs on one NVIDIA H100 (Hopper, ``sm_90a``). Its layout mirrors
the JAX package's, which stays as the reference: ``zoo``, ``ops/``
(hand-written CUDA kernels in ``csrc/``, each beside its plain PyTorch
version), ``models/``, ``training/``, ``serving``, ``convert`` and
``cli``. It imports no JAX. The JAX package's backend-free modules
(``config``, ``zoo``, ``data.packed_dataset``, ``utils.logging``) import no
JAX either, and the port uses them as they are, so configs and feature
schemas have one source.

Float32 matrix products and convolutions run in full float32, not TF32, so
that results match the JAX package's ``"highest"`` precision.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
