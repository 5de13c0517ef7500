"""The port's own counterparts of the reference demos that the demo runner
(paddle_tpu_torch/demo.py) cannot run unchanged, because the JAX
package's script calls ``jax`` itself: ``vae`` (demos/vae/train.py).
Each runs as ``python -m paddle_tpu_torch.demos.<name>``."""
