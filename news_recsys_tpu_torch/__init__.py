"""news_recsys_tpu_torch — the PyTorch + CUDA port of ``news_recsys_tpu``.

The port runs on one NVIDIA H100 (Hopper, ``sm_90a``). Its layout mirrors
the JAX package's, which stays as the reference: ``zoo``, ``ops/``
(hand-written CUDA kernels in ``csrc/``, each beside its plain PyTorch
version), ``models/``, ``training/``, ``serving``, ``convert`` and
``cli``. It imports no JAX and nothing of the JAX package: ``config``,
``zoo``, ``data.packed_dataset``, ``training.metrics`` and ``utils.logging``
are the port's own copies of the JAX package's backend-free modules, under
the same names. A config travels between the two packages as the plain dict
of ``config_to_dict`` / ``config_from_dict``, parameters and data as numpy
arrays.

Float32 matrix products and convolutions run in full float32, not TF32, so
that results match the JAX package's ``"highest"`` precision.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
