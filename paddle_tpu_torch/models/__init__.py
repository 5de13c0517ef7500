"""Model zoo: reference topologies rebuilt on paddle_tpu_torch."""

from paddle_tpu_torch.models import recommender, text, vision
