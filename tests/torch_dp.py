"""Shared rig of the data-parallel tests (tests/test_torch_data_parallel.py):
the cases, each trained by both packages' single-device trainer in the
test process and by the port's DataParallel trainer in the ranks of a
gloo process group, spawned as ``python -m tests.torch_dp RANK WORLD PORT
OUTDIR`` (every case in one pair of processes; each rank writes
``OUTDIR/<case>-<rank>.npz`` with its per-step costs and
classification errors and its final parameters).

The cases, at tiny widths from numpy seeds, each with Momentum(0.1, 0.9)
and the classification_error evaluator (summed over the ranks in the
step); the port's runs also carry a label probe, an evaluator merged by
appending each batch's labels (not a sum, so the trainer gathers it from
the ranks at finalize), whose last result is the pass's labels in row
order:

- ``flagship``: text_classification_lstm(dict 50, emb 16, hidden 32, two
  layers), 3 ragged batches of 8;
- ``conv_bn``: img_conv 3x3 -> train-mode batch_norm -> fc over 2x6x6
  images, 3 batches of 8 (the moments are the global batch's);
- ``uneven``: the flagship over batches of 7, 7 and 1 rows (4 + 3 rows a
  rank, then 1 + 0: the last step's rank 1 holds no row);
- ``fused``: the flagship, 4 batches of 8 through ``steps_per_call=2``
  (the CPU's fused loop) with the pipelined feed.

The rank processes import neither JAX nor the JAX package.

``jax_coordinator_binary`` compiles the JAX package's coordinator source
into a test directory, for the tests that run it beside the port's
(tests/test_torch_coordinator.py, test_torch_elastic.py): the JAX
client's own build writes its binary in place under paddle_tpu/, which a
JAX test in another worker may be writing at the same moment.
"""

import os
import sys

import numpy as np

SMALL = dict(dict_size=50, emb_size=16, hidden=32, num_classes=2,
             num_layers=2)
IMAGE = (2, 6, 6)
CASES = ("flagship", "conv_bn", "uneven", "fused")


def _flagship(pkg):
    from importlib import import_module

    text = import_module(pkg.__name__ + ".models.text")
    out = text.text_classification_lstm(**SMALL)
    label = pkg.layer.data(name="label", type=pkg.data_type.integer_value(2))
    return out, label


def _conv_bn(pkg):
    L, dt, A = pkg.layer, pkg.data_type, pkg.activation
    c, h, w = IMAGE
    img = L.data(name="image", type=dt.dense_vector(c * h * w), height=h,
                 width=w)
    conv = L.img_conv(input=img, filter_size=3, num_filters=4,
                      num_channels=c, padding=1, act=A.Linear(),
                      name="conv")
    bn = L.batch_norm(input=conv, act=A.Relu(), name="bn")
    out = L.fc(input=bn, size=3, act=A.Softmax(), name="out")
    label = L.data(name="label", type=dt.integer_value(3))
    return out, label


def build(case, pkg):
    """(cost, error evaluator, topology, label layer) of ``case`` built by
    ``pkg`` (paddle_tpu or paddle_tpu_torch), names counted from zero."""
    from importlib import import_module

    import_module(pkg.__name__ + ".graph").reset_name_counters()
    out, label = (_conv_bn if case == "conv_bn" else _flagship)(pkg)
    cost = pkg.layer.classification_cost(input=out, label=label)
    err = pkg.evaluator.classification_error(input=out, label=label)
    topology = import_module(pkg.__name__ + ".topology").Topology(cost)
    return cost, err, topology, label


def label_probe(label):
    """The port's evaluator of the batch's labels, merged by appending."""
    from paddle_tpu_torch.evaluator import _mk_eval
    from paddle_tpu_torch.layer.base import data_of

    def forward(params, values, ctx):
        return {"labels": data_of(values[0]).float()}

    def merge(acc, stats):
        return (acc or []) + [np.asarray(stats["labels"])]

    def result(acc):
        return np.concatenate(acc).tolist() if acc else []

    return _mk_eval("label_probe", forward, [label], "label_probe", merge,
                    result)


def batches(case):
    rng = np.random.RandomState(CASES.index(case) + 11)
    if case == "conv_bn":
        return [[(rng.randn(int(np.prod(IMAGE))).astype(np.float32),
                  int(rng.randint(3))) for _ in range(8)]
                for _ in range(3)]
    sizes = {"flagship": [8, 8, 8], "uneven": [7, 7, 1],
             "fused": [8, 8, 8, 8]}[case]
    out = []
    for rows in sizes:
        lens = rng.randint(1, 13, rows)
        out.append([(rng.randint(0, SMALL["dict_size"], int(k)).tolist(),
                     int(rng.randint(2))) for k in lens])
    return out


def train_options(case):
    return ({"steps_per_call": 2, "feed_pipeline": 2} if case == "fused"
            else {})


def numpy_params(topology, seed=5):
    rng = np.random.RandomState(seed)
    return {name: (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
            for name, spec in sorted(topology.param_specs().items())}


def port_run(case, parallelism=None, keep=None):
    """Train ``case`` with the port on the CPU: (costs, errors, params,
    the label probe's last result); the trainer goes into the list
    ``keep`` when given."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.parameters import Parameters

    cost, err, topology, label = build(case, paddle)
    probe = label_probe(label)
    params = Parameters(params_from_numpy(numpy_params(topology), topology,
                                          device="cpu"),
                        topology.param_specs())
    trainer = paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=0.1, momentum=0.9),
        extra_layers=[err, probe], parallelism=parallelism, device="cpu")
    costs, errors, labels = [], [], []

    def handler(evt):
        if isinstance(evt, paddle.event.EndIteration):
            costs.append(evt.cost)
            errors.append(evt.metrics[err.name])
            labels[:] = evt.metrics[probe.name]

    data = batches(case)
    trainer.train(lambda: iter(data), num_passes=1, event_handler=handler,
                  **train_options(case))
    if keep is not None:
        keep.append(trainer)
    return (np.asarray(costs), np.asarray(errors),
            {n: params.get(n) for n in params.names()}, np.asarray(labels))


def jax_run(case, parallelism=None):
    """Train ``case`` with the JAX package's trainer (single-device, or
    over ``parallelism``, a JAX DataParallel) from the same numpy
    parameters: (costs, errors, params)."""
    import jax.numpy as jnp

    import paddle_tpu as jpaddle
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.parameters import Parameters as JaxParameters

    cost, err, topology, _ = build(case, jpaddle)
    params = JaxParameters()
    params._specs = topology.param_specs()
    params._values = {k: jnp.asarray(v)
                      for k, v in numpy_params(topology).items()}
    trainer = jpaddle.trainer.SGD(
        cost, params, jopt.Momentum(learning_rate=0.1, momentum=0.9),
        extra_layers=[err], parallelism=parallelism)
    costs, errors = [], []

    def handler(evt):
        if isinstance(evt, jpaddle.event.EndIteration):
            costs.append(evt.cost)
            errors.append(evt.metrics[err.name])

    data = batches(case)
    trainer.train(lambda: iter(data), num_passes=1, event_handler=handler,
                  **train_options(case))
    return (np.asarray(costs), np.asarray(errors),
            {n: np.asarray(params.get(n)) for n in params.names()})


def jax_coordinator_binary(out_dir):
    """The JAX package's coordinator (paddle_tpu/distributed/coordinator/
    coordinator.cc) built with its Makefile's flags into ``out_dir``;
    returns the binary's path."""
    import subprocess

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "paddle_tpu", "distributed",
        "coordinator", "coordinator.cc")
    out = os.path.join(str(out_dir), "jax-coordinator")
    subprocess.run(["g++", "-O2", "-std=c++17", "-pthread", "-Wall", "-o",
                    out, src], check=True, capture_output=True)
    return out


def main(argv):
    rank, world, port, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.multihost import initialize_multihost
    from paddle_tpu_torch.parallel import DataParallel, build_mesh

    paddle.init(use_tpu=False)
    assert initialize_multihost("127.0.0.1:" + port, world, rank)
    for case in CASES:
        dp = DataParallel(build_mesh({"data": world}))
        costs, errors, params, labels = port_run(case, parallelism=dp)
        np.savez(os.path.join(outdir, "%s-%d.npz" % (case, rank)),
                 costs=costs, errors=errors, labels=labels,
                 backend=dp.backend,
                 **{"param:" + n: v for n, v in params.items()})
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
