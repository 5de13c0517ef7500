"""Dropout (paddle_tpu/layer/base.py:228-256): keep each element with
probability ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``, in
the tensor's own dtype. The mask comes from ``keep_mask`` alone, so a
caller (the parity tests, chip_smoke.py's card-against-CPU check) can
substitute a mask of its own for the generator's."""

import torch


def keep_mask(shape, keep, generator, device):
    """Boolean mask of ``shape`` on ``device``: True with probability
    ``keep``, drawn from ``generator`` (a ``torch.Generator`` on
    ``device``)."""
    return torch.rand(shape, generator=generator, device=device) < keep


def dropout(x, rate, generator):
    """x with each element zeroed with probability ``rate`` and the rest
    divided by ``1 - rate`` (the JAX package's ``jnp.where(mask, d / keep,
    0.0)``)."""
    keep = 1.0 - rate
    mask = keep_mask(tuple(x.shape), keep, generator, x.device)
    return torch.where(mask, x / keep, 0.0)
