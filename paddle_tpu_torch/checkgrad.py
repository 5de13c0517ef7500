"""Numeric-against-analytic gradient check (``cli checkgrad``;
paddle_tpu/checkgrad.py, the reference's LayerGradUtil testLayerGrad and
``paddle train --job=checkgrad``, Trainer::checkGradient).

The subgraph ending at the layer under test runs in float64: the
analytic side is autograd through ``Topology`` evaluation, the numeric
side central differences on sampled coordinates of every parameter (and,
optionally, of every dense floating input). The recurrent layers take
their step loops in float64 (ops/rnn.py), as the JAX package's do, so no
hand-written kernel is asked to run float64.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, SequenceBatch
from paddle_tpu_torch.graph import Context
from paddle_tpu_torch.topology import Topology, _feed_on


def to_f64(value):
    """``value`` (a tensor, a sequence batch of them or a dict of those)
    with every floating tensor in float64."""
    if isinstance(value, dict):
        return {k: to_f64(v) for k, v in value.items()}
    if isinstance(value, (SequenceBatch, NestedSequenceBatch)):
        return value.map_data(to_f64)
    if isinstance(value, torch.Tensor) and value.is_floating_point():
        return value.to(torch.float64)
    return value


def check_layer_grad(output_node, feed, check_inputs=True, eps=1e-5,
                     rtol=2e-3, atol=1e-6, samples_per_tensor=6, seed=0,
                     mode="test", device=None):
    """Numeric-vs-analytic gradient check on every parameter (and, with
    ``check_inputs``, every dense floating input) of the subgraph ending
    at ``output_node``, on ``device`` (the default device unless given).
    The parameters are initialised from ``seed`` in float64; the loss is
    the sum of the output times a fixed random projection. ``mode`` is
    the evaluation mode (test: no dropout, batch norm's global
    statistics). Raises AssertionError at the first coordinate whose two
    gradients differ beyond ``rtol`` / ``atol``; returns True."""
    device = resolve_device(device)
    topo = Topology(output_node)
    params = topo.init_params(seed=seed, device=device, dtype=torch.float64)
    feed = to_f64(_feed_on(feed, params))
    proj = {}

    def loss(p, f):
        # a test-mode evaluation that autograd records (Topology.apply
        # runs test mode under inference_mode)
        out = topo._evaluate(p, f, Context(mode=mode), [output_node.name],
                             record=True)[output_node.name]
        if isinstance(out, SequenceBatch):
            data = out.data * out.mask(out.data.dtype).reshape(
                out.mask().shape + (1,) * (out.data.dim() - 2))
        elif isinstance(out, NestedSequenceBatch):
            data = out.data
        else:
            data = out
        if "proj" not in proj:
            proj["proj"] = torch.from_numpy(np.random.RandomState(7).randn(
                *data.shape)).to(device)
        return torch.sum(data * proj["proj"])

    rng = np.random.RandomState(seed + 1)

    def check_array(label, base, grad, rebuild):
        """rebuild(new tensor) -> (params, feed) with it substituted."""
        if not base.is_floating_point():
            return
        for idx in rng.choice(base.numel(),
                              size=min(samples_per_tensor, base.numel()),
                              replace=False):
            delta = torch.zeros(base.numel(), dtype=base.dtype,
                                device=base.device)
            delta[idx] = eps
            delta = delta.reshape(base.shape)
            with torch.no_grad():
                numeric = (float(loss(*rebuild(base + delta)))
                           - float(loss(*rebuild(base - delta)))) / (2 * eps)
            np.testing.assert_allclose(
                numeric, float(grad.reshape(-1)[idx]), rtol=rtol, atol=atol,
                err_msg="%s grad mismatch at flat index %d" % (label, idx))

    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    grads = _grads(loss(leaves, feed), leaves)
    for name in params:
        def rebuild(new, name=name):
            return {**params, name: new}, feed

        check_array("param:" + name, params[name], grads[name], rebuild)

    if check_inputs:
        dense = {k: _data(v) for k, v in feed.items()
                 if isinstance(v, (torch.Tensor, SequenceBatch))
                 and _data(v).is_floating_point()}

        def with_inputs(new):
            """The feed with the dense inputs of ``new`` substituted."""
            f = dict(feed)
            for k, x in new.items():
                f[k] = (feed[k].map_data(lambda _, x=x: x)
                        if isinstance(feed[k], SequenceBatch) else x)
            return f

        if dense:
            inputs = {k: v.detach().requires_grad_() for k, v in dense.items()}
            grads = _grads(loss(params, with_inputs(inputs)), inputs)
            for key in dense:
                def rebuild(new, key=key):
                    return params, with_inputs({key: new})

                check_array("input:" + key, dense[key], grads[key], rebuild)
    return True


def _grads(value, leaves):
    grads = torch.autograd.grad(value, list(leaves.values()),
                                allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)}


def _data(value):
    return value.data if isinstance(value, SequenceBatch) else value
