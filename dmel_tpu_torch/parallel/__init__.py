"""Parallelism (counterpart of ``dmel_tpu/parallel``): a whole sweep's
trials packed into one program on one card.  Data parallelism over a
``mesh`` of cards is not ported yet."""

from dmel_tpu_torch.parallel.trials import (fit_trials,  # noqa: F401
                                            make_multitrial_eval,
                                            make_multitrial_step)

__all__ = ["fit_trials", "make_multitrial_eval", "make_multitrial_step"]
