"""Sequence ops on padded [B, T, ...] data (paddle_tpu/ops/sequence.py)."""


def expand_to(data, target_mask):
    """Broadcast one row per sequence across its timesteps (reference:
    ExpandLayer): data [B, D] -> [B, T, D], zero where ``target_mask``
    [B, T] is false."""
    out = data[:, None, :].expand(data.shape[0], target_mask.shape[1],
                                  data.shape[-1])
    return out * target_mask[..., None].to(data.dtype)
