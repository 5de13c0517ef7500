"""The JAX package's training trajectory of a vision model in float64, the
reference that tests/test_torch_resnet.py and test_torch_vision_models.py
hold both packages' float32 trajectories (and the port's float64 one) to.
``jax_enable_x64`` holds for the whole of a process, so the trajectory
runs in a process of its own:

    python -m tests.jax_float64 IN.npz OUT.npz

``IN`` holds ``model`` (``resnet-<depth>`` at ``im_size=32,
num_classes=10``, or ``googlenet``), ``lr``, ``mu``, ``images`` [steps,
rows, width], ``labels`` [steps, rows], every parameter and moving
statistic as ``param/<name>``, and optionally ``dropout_mask``, which
every dropout layer then keeps (as the tests patch
``jax.random.bernoulli``). Per batch: the mean cost of the train-mode
graph, its gradients by ``jax.value_and_grad``, the moving statistics
from the step's state updates, and the Momentum step (v = mu * v - lr *
g; p += v) from zero velocity, all in float64. ``OUT`` gets ``costs``
[steps] and the final ``param/<name>``. ``run`` does both ends from a
test.
"""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(tmp_dir, model, np_params, batches, lr, mu, dropout_mask=None):
    """The JAX package's float64 trajectory over ``batches`` (lists of
    (image row, label)) from ``np_params`` -> (costs, {name: final
    value})."""
    src = os.path.join(str(tmp_dir), "float64_in.npz")
    dst = os.path.join(str(tmp_dir), "float64_out.npz")
    extra = {} if dropout_mask is None else {"dropout_mask": dropout_mask}
    np.savez(src, model=model, lr=lr, mu=mu,
             images=np.asarray([[x for x, _ in b] for b in batches]),
             labels=np.asarray([[y for _, y in b] for b in batches]),
             **extra, **{"param/" + k: v for k, v in np_params.items()})
    subprocess.run([sys.executable, "-m", "tests.jax_float64", src, dst],
                   cwd=ROOT, check=True, timeout=600)
    out = np.load(dst)
    return list(out["costs"]), {k[len("param/"):]: out[k]
                                for k in out.files if k.startswith("param/")}


def _model(name):
    """-> (output layer, classes) of the JAX package's ``name``."""
    from paddle_tpu.models import vision

    if name.startswith("resnet-"):
        depth = int(name[len("resnet-"):])
        return vision.resnet(depth=depth, num_classes=10, im_size=32), 10
    assert name == "googlenet", name
    return vision.googlenet(), 1000


def trajectory(model, np_params, images, labels, lr, mu, dropout_mask=None):
    import jax
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.graph import reset_name_counters
    from paddle_tpu.topology import Topology

    assert jax.config.jax_enable_x64
    if dropout_mask is not None:
        jax.random.bernoulli = lambda key, p, shape: jnp.asarray(dropout_mask)
    reset_name_counters()
    out, classes = _model(model)
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(classes))
    cost = paddle.layer.classification_cost(input=out, label=label)
    topo = Topology(cost)
    specs = topo.param_specs()
    trainable = sorted(n for n in np_params if not specs[n].is_state)
    values = {k: jnp.asarray(v, jnp.float64) for k, v in np_params.items()}
    velocity = {n: jnp.zeros_like(values[n]) for n in trainable}

    def loss(train, rest, feed):
        outs, updates = topo.apply({**train, **rest}, feed, mode="train",
                                   rng=jax.random.PRNGKey(0),
                                   outputs=[cost.name])
        return jnp.mean(outs[cost.name]), updates

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    costs = []
    for x, y in zip(images, labels):
        feed = {"image": jnp.asarray(x, jnp.float64),
                "label": jnp.asarray(y, jnp.int32)}
        train = {n: values[n] for n in trainable}
        rest = {n: v for n, v in values.items() if n not in train}
        (value, updates), grads = step(train, rest, feed)
        assert value.dtype == jnp.float64
        costs.append(float(value))
        for n in trainable:
            velocity[n] = mu * velocity[n] - lr * grads[n]
            values[n] = values[n] + velocity[n]
        for n, v in updates.items():
            values[n] = jnp.asarray(v, jnp.float64)
    return costs, {k: np.asarray(v) for k, v in values.items()}


def main(argv):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_enable_x64", True)
    src, dst = argv
    data = np.load(src)
    params = {k[len("param/"):]: data[k] for k in data.files
              if k.startswith("param/")}
    costs, final = trajectory(
        str(data["model"]), params, data["images"], data["labels"],
        float(data["lr"]), float(data["mu"]),
        data["dropout_mask"] if "dropout_mask" in data.files else None)
    np.savez(dst, costs=np.asarray(costs, np.float64),
             **{"param/" + k: v for k, v in final.items()})


if __name__ == "__main__":
    main(sys.argv[1:])
