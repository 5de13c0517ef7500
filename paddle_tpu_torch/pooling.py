"""Pooling types (cf. trainer_config_helpers/poolings.py; C++ side
SequencePoolLayer, PoolLayer). Max pooling is the flagship's; average is
also img_pool's ``pool_type`` (ResNet's global average pool); sum and
sqrt-average arrive with the models that use them."""

import torch


class BasePoolingType:
    name = None


class MaxPooling(BasePoolingType):
    name = "max"

    def __init__(self, output_max_index=False):
        # output_max_index: emit the ARGMAX timestep per feature instead of
        # the max value
        self.output_max_index = output_max_index

    def reduce(self, data, mask):
        """data [B, T, D], mask [B, T] bool -> [B, D]."""
        neg = torch.finfo(data.dtype).min
        masked = torch.where(mask[..., None], data,
                             torch.full((), neg, dtype=data.dtype,
                                        device=data.device))
        if self.output_max_index:
            return torch.argmax(masked, dim=1).to(data.dtype)
        out = torch.amax(masked, dim=1)
        # all-empty sequences pool to 0 like the reference's empty handling
        any_valid = torch.any(mask, dim=1)[..., None]
        return torch.where(any_valid, out, torch.zeros_like(out))


class AvgPooling(BasePoolingType):
    name = "average"

    @staticmethod
    def reduce(data, mask):
        """data [B, T, D], mask [B, T] bool -> the mean over the valid
        steps [B, D] (an all-empty sequence pools to 0)."""
        m = mask[..., None].to(data.dtype)
        total = torch.sum(data * m, dim=1)
        count = torch.clamp(torch.sum(m, dim=1), min=1.0)
        return total / count


def to_pooling(pool):
    if pool is None:
        return MaxPooling()
    if isinstance(pool, BasePoolingType):
        return pool
    if isinstance(pool, type) and issubclass(pool, BasePoolingType):
        return pool()
    raise TypeError("cannot convert %r to pooling type" % (pool,))
