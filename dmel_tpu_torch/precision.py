"""The numeric settings the package's entry points run under.

``fit`` and ``predict`` run inside :func:`precision_scope`: float32
matmuls and cuDNN convolutions without TF32 (the JAX registry's
``precision="highest"``), and cuDNN's deterministic algorithms with its
autotuner off, so that two seeded ``fit`` calls give the same bits.  The
scope restores every flag it set when it exits; the package changes no
process-wide setting.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision_scope():
    """Run the body with TF32 off for matmuls and convolutions, cuDNN's
    deterministic algorithms and no autotuner.  The flags come back as
    they were on exit."""
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
