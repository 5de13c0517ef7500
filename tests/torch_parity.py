"""Shared rig of the port's layer parity tests (test_torch_mixed.py,
test_torch_text_layers.py): build one network in both packages from the
same ``build(pkg)``, feed both the same seeded numpy rows through each
package's ``convert_feed``, and compare every named output's value and
the gradients of the mean of the last output (a sequence's padding
zeroed) with respect to every parameter and every floating feed.

Tolerances: values within 1e-6 of max(1, max |JAX|), gradients within
1e-5 of max(1, max |JAX gradient|) (float32 sums in other orders).
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

import paddle_tpu as jpaddle
from paddle_tpu.core.sequence import NestedSequenceBatch as JaxNested
from paddle_tpu.core.sequence import SequenceBatch as JaxSequenceBatch
from paddle_tpu.graph import reset_name_counters as jax_reset_names
from paddle_tpu.topology import Topology as JaxTopology
from paddle_tpu.topology import convert_feed as jax_convert_feed

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, SequenceBatch
from paddle_tpu_torch.graph import reset_name_counters
from paddle_tpu_torch.topology import Topology, convert_feed

TOL_FWD = 1e-6
TOL_GRAD = 1e-5


def rel(got, want):
    """max |got - want| over max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max()) / max(
        1.0, float(np.abs(want).max()))


def both(build):
    """``build(pkg)`` in the JAX package, then in the port, each after its
    own name-counter reset: (JAX result, port result)."""
    jax_reset_names()
    jout = build(jpaddle)
    reset_name_counters()
    return jout, build(paddle)


def numpy_params(specs, seed, scale=1.0):
    """Weights N(0, scale^2 / fan_in) (fan_in: the first axis, 1 for a
    vector), from a numpy seed, in sorted-name order."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, spec in sorted(specs.items()):
        shape = tuple(spec.shape)
        fan_in = shape[0] if len(shape) > 1 else 1
        out[name] = (rng.randn(*shape) * scale / np.sqrt(fan_in)).astype(
            np.float32)
    return out


SEQ_TYPES = (SequenceBatch, JaxSequenceBatch, NestedSequenceBatch, JaxNested)


def _float_parts(feed, torch_side):
    """{name: the floating tensor of a feed value} (a sequence's data)."""
    parts = {}
    for name, v in feed.items():
        data = v.data if isinstance(v, SEQ_TYPES) else v
        floating = (data.is_floating_point() if torch_side
                    else jnp.issubdtype(data.dtype, jnp.floating))
        if floating:
            parts[name] = data
    return parts


def _with_parts(feed, parts, seq_cls):
    out = dict(feed)
    for name, data in parts.items():
        v = feed[name]
        if isinstance(v, (NestedSequenceBatch, JaxNested)):
            out[name] = type(v)(data, v.outer_lengths, v.inner_lengths)
        elif isinstance(v, (SequenceBatch, JaxSequenceBatch)):
            out[name] = seq_cls(data, v.lengths)
        else:
            out[name] = data
    return out


def _masked(value):
    """A sequence's data with its padding zeroed (a nested one's outside
    its real steps of its real sub-sequences); anything else as is."""
    if isinstance(value, (SequenceBatch, JaxSequenceBatch)):
        return value.masked_data()
    if isinstance(value, (NestedSequenceBatch, JaxNested)):
        m = value.inner_mask()
        return value.data * m.reshape(tuple(m.shape) + (1,) * (
            value.data.ndim - 3))
    return value


def _np(value):
    value = _masked(value)
    if torch.is_tensor(value):
        return value.detach().float().numpy()
    return np.asarray(value, np.float32)


def run_both(build, rows, outputs, seed=0, params=None, scale=1.0,
             mode="train", loss=True):
    """Values of ``outputs`` and, with ``loss``, the gradients of the mean
    of the last output with respect to every parameter and floating feed,
    in each package: ((values, grads), (jax values, jax grads)), grads
    keyed by parameter name and by ``"feed:<name>"``. ``build(pkg)``
    returns the layer (or list of layers) the topology is made from;
    ``rows`` are tuples in the topology's declaration order, or dicts by
    data layer name; ``params`` ({name: array}) replaces the seeded numpy
    parameters."""
    jout, out = both(build)
    topo, jtopo = Topology(out), JaxTopology(jout)
    specs = topo.param_specs()
    assert sorted(specs) == sorted(jtopo.param_specs())
    for name, spec in specs.items():
        assert tuple(spec.shape) == tuple(jtopo.param_specs()[name].shape)
    arrays = params if params is not None else numpy_params(specs, seed,
                                                            scale)
    if rows and isinstance(rows[0], dict):
        # {data layer name: column}: the columns the topology reads
        names = [n for n, _ in topo.data_types()]
        rows = [tuple(r[n] for n in names) for r in rows]
    feeding = {n: i for i, (n, _) in enumerate(topo.data_types())}
    feed = convert_feed(topo, rows, "cpu", feeding=feeding)
    jfeed = jax_convert_feed(jtopo, rows, feeding=feeding)
    tparams = {k: torch.from_numpy(np.array(v)).requires_grad_(loss)
               for k, v in arrays.items()}
    parts = {k: v.clone().requires_grad_(loss)
             for k, v in _float_parts(feed, True).items()}
    values, _ = topo.apply(tparams, _with_parts(feed, parts, SequenceBatch),
                        mode=mode, outputs=outputs,
                        rng=torch.Generator().manual_seed(0))
    grads = {}
    if loss:
        _masked(values[outputs[-1]]).float().mean().backward()
        grads = {k: p.grad.numpy() if p.grad is not None
                 else np.zeros(tuple(p.shape), np.float32)
                 for k, p in tparams.items()}
        grads.update({"feed:" + k: p.grad.numpy() if p.grad is not None
                      else np.zeros(tuple(p.shape), np.float32)
                      for k, p in parts.items()})

    def jrun(p, fparts):
        jvalues, _ = jtopo.apply(p, _with_parts(jfeed, fparts,
                                                JaxSequenceBatch),
                                 mode=mode, outputs=outputs,
                                 rng=jax.random.PRNGKey(0))
        return jnp.mean(_masked(jvalues[outputs[-1]]).astype(
            jnp.float32)), jvalues

    jarrays = {k: jnp.asarray(v) for k, v in arrays.items()}
    jparts = _float_parts(jfeed, False)
    if loss:
        (_, jvalues), (jg, jfg) = jax.value_and_grad(
            jrun, argnums=(0, 1), has_aux=True)(jarrays, jparts)
        jgrads = {k: np.asarray(v) for k, v in jg.items()}
        jgrads.update({"feed:" + k: np.asarray(v) for k, v in jfg.items()})
    else:
        _, jvalues = jrun(jarrays, jparts)
        jgrads = {}
    return (({k: _np(v) for k, v in values.items()}, grads),
            ({k: _np(v) for k, v in jvalues.items()}, jgrads))


def assert_match(port, jax_side, tol_fwd=TOL_FWD, tol_grad=TOL_GRAD):
    """Every value and gradient of ``run_both`` within tolerance; returns
    the worst relative errors ({name: error})."""
    (values, grads), (jvalues, jgrads) = port, jax_side
    worst = {}
    assert sorted(values) == sorted(jvalues)
    for name in values:
        worst[name] = rel(values[name], jvalues[name])
        assert worst[name] <= tol_fwd, (name, worst[name])
    assert sorted(grads) == sorted(jgrads)
    for name in grads:
        worst["d" + name] = rel(grads[name], jgrads[name])
        assert worst["d" + name] <= tol_grad, (name, worst["d" + name])
    return worst
