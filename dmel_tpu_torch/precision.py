"""The numeric settings the package's entry points run under.

``fit`` and ``predict`` run inside :func:`precision_scope`: float32
matmuls and cuDNN convolutions without TF32 (the JAX registry's
``precision="highest"``), and cuDNN's deterministic algorithms with its
autotuner off, so that two seeded ``fit`` calls give the same bits.  The
scope restores every flag it set when it exits; the package changes no
process-wide setting.

The scope sets no dtype.  A ``model_dtype="bfloat16"`` model casts
explicitly inside CNN6 (``models/panns.py``): the DMEL front end, the mel
batch norm and the classifier head run in float32, and only the conv
stack (convolutions, batch-norm outputs, ReLU, pooling, dropout) in
bf16, with float32 parameters and batch-norm statistics.  There is no
``torch.autocast``: it would put the exact route's mel matmul and
``torch.stft`` into bf16, and the front end's CUDA kernels take float32
operands only.  bf16 convolutions stay deterministic under the scope's
cuDNN flags.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision_scope():
    """Run the body with TF32 off for matmuls and convolutions, cuDNN's
    deterministic algorithms and no autotuner.  The flags come back as
    they were on exit.  The bf16 scope of a model is its own (the conv
    stack of a ``model_dtype="bfloat16"`` CNN6); this scope changes no
    dtype."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    try:
        matmul.allow_tf32 = False
        cudnn.allow_tf32 = False
        cudnn.deterministic = True
        cudnn.benchmark = False
        yield
    finally:
        (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved
