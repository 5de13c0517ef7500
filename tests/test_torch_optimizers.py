"""The port's optimizers against the JAX package's, on the CPU.

Each of the seven update rules (Momentum, Adam, Adamax, AdaGrad,
DecayedAdaGrad, AdaDelta, RMSProp), alone, with ``model_average``, with a
``StaticPruningHook`` on one parameter and through ``ParamPool``: three
steps from the same numpy parameters and gradients, a per-parameter
learning-rate multiplier on one of them, float32 update arithmetic on
both sides; parameters and every slot within 1e-6 (the two packages
round the same float32 operations; the differences are at the last
bit). The pool's entries and offsets equal the JAX pool's. The step count
and the learning-rate schedule live on the device: two calls of the same
step function use steps 1 and 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import optimizer as jopt
from paddle_tpu.attr import ParamAttr as JaxParamAttr

from paddle_tpu_torch import optimizer as opt
from paddle_tpu_torch.attr import ParamAttr

TOL = 1e-6
RULES = ["Momentum", "Adam", "Adamax", "AdaGrad", "DecayedAdaGrad",
         "AdaDelta", "RMSProp"]


def _kw(rule):
    return {"momentum": 0.9} if rule == "Momentum" else {}


def _data(seed=0):
    """Five parameters (two matrices, a vector, two small ones the pool
    takes) and three steps of gradients."""
    rng = np.random.RandomState(seed)
    params = {"a": rng.randn(6, 5).astype(np.float32),
              "b": rng.randn(5).astype(np.float32),
              "c": rng.randn(3, 2).astype(np.float32),
              "d": rng.randn(4).astype(np.float32),
              "big": rng.randn(70, 70).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


def _run(rule, variant):
    """Three steps in both packages; returns the JAX and port params,
    states and (for the pool variant) the two pools."""
    params, grads = _data(RULES.index(rule))
    jkw, tkw = _kw(rule), _kw(rule)
    jmeta = {"b": JaxParamAttr(learning_rate=0.5)}
    tmeta = {"b": ParamAttr(learning_rate=0.5)}
    if variant == "average":
        jkw["model_average"] = jopt.ModelAverage(0.9)
        tkw["model_average"] = opt.ModelAverage(0.9)
    if variant == "pruning":
        jmeta["a"] = JaxParamAttr(update_hooks=[jopt.StaticPruningHook(0.4)])
        tmeta["a"] = ParamAttr(update_hooks=[opt.StaticPruningHook(0.4)])
    jo = getattr(jopt, rule)(**jkw)
    to = getattr(opt, rule)(**tkw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pools = None
    if variant == "pool":
        jpool = jopt.ParamPool(params, jmeta)
        tpool = opt.ParamPool(tp, tmeta)
        pools = (jpool, tpool)
        jp = jpool.compress(jp)
        tp = tpool.compress(tp)
    jstate = jo.init_state(jp, jmeta)
    tstate = to.init_state(tp, tmeta)
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        if pools is not None:
            jg = pools[0].compress(jg)
            tg = pools[1].compress(tg)
        jp, jstate = jo.step(jp, jg, jstate, jmeta)
        to.step(tp, tg, tstate, tmeta)
    return jp, jstate, tp, tstate, pools


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + "/" + p, v) for k in sorted(tree)
                for p, v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [("%d/%s" % (i, p), v) for i, t in enumerate(tree)
                for p, v in _leaves(t)]
    return [("", tree)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("variant", ["plain", "average", "pruning", "pool"])
@pytest.mark.parametrize("rule", RULES)
def test_three_steps_match_jax(rule, variant):
    jp, jstate, tp, tstate, pools = _run(rule, variant)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    jleaves, tleaves = _leaves(jstate), _leaves(tstate)
    assert [p for p, _ in tleaves] == [p for p, _ in jleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        got, want = _np(t), np.asarray(j)
        assert got.shape == want.shape, path
        if want.dtype.kind in "iu":
            assert got.dtype == np.int32, path
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=path)
    if variant == "average":
        assert sorted(tstate["average"]) == sorted(params_names())
    if variant == "pruning":
        # the mask is the JAX mask: 40 % of a's 30 entries stay zero
        assert int((tp["a"] == 0).sum()) == 12
    if pools is not None:
        jpool, tpool = pools
        assert tpool.entries == jpool.entries
        assert tpool.special == jpool.special
        assert tpool.total == jpool.total


def params_names():
    return sorted(_data()[0])


def test_pool_views_share_one_buffer():
    """The pooled names expand to views of the flat buffer: an in-place
    update of the pool is an update of every view; the state translates
    to the per-name wire format and back."""
    params, _ = _data()
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pool = opt.ParamPool(tp)
    assert pool.enabled() and pool.special == ["big"]
    pooled = pool.compress(tp)
    views = pool.expand(pooled)
    pooled[opt.ParamPool.POOL_KEY].add_(1.0)
    np.testing.assert_allclose(views["c"].numpy(), params["c"] + 1.0)
    state = opt.Adam().init_state(pooled)
    np_state = {"step": np.asarray(3, np.int32),
                "slots": {k: tuple(_np(x) for x in v)
                          for k, v in state["slots"].items()}}
    flat = pool.unpool_state(np_state)
    assert sorted(flat["slots"]) == sorted(params)
    back = pool.pool_state(flat)
    for a, b in zip(back["slots"][opt.ParamPool.POOL_KEY],
                    np_state["slots"][opt.ParamPool.POOL_KEY]):
        np.testing.assert_array_equal(a, b)
    assert not opt.ParamPool.compatible_with(
        opt.Momentum(gradient_clipping_threshold=1.0))
    assert not opt.ParamPool.compatible_with(opt.Momentum(sparse=True))


@pytest.mark.parametrize("schedule", ["poly", "exp", "discexp", "linear",
                                      "caffe_poly"])
def test_step_count_and_schedule_live_on_the_device(schedule):
    """Two calls of the same step function use steps 1 and 2, not step 1
    twice: the step count is an int32 tensor the update advances in place,
    the schedule is computed from it (what a replayed CUDA graph reads),
    and each step's delta equals the JAX schedule's at that step."""
    kw = dict(learning_rate=0.1, learning_rate_schedule=schedule,
              learning_rate_decay_a=0.5, learning_rate_decay_b=2.0)
    if schedule == "caffe_poly":
        kw["learning_rate_decay_a"] = 10.0
    if schedule == "linear":
        kw.update(learning_rate_decay_a=0.01, learning_rate_decay_b=0.05)
    to = opt.Momentum(**kw)
    jo = jopt.Momentum(**kw)
    p = {"w": torch.zeros(3)}
    state = to.init_state(p)
    step_tensor = state["step"]
    assert step_tensor.dtype == torch.int32 and int(step_tensor) == 0
    g = {"w": torch.ones(3)}
    deltas = []
    for _ in range(2):
        before = p["w"].clone()
        to.step(p, g, state)
        deltas.append(float((before - p["w"])[0]))
    assert state["step"] is step_tensor and int(step_tensor) == 2
    want = [float(jo.lr_fn(jnp.float32(s))) for s in (1, 2)]
    np.testing.assert_allclose(deltas, want, rtol=1e-6)
    assert deltas[0] != deltas[1]


def test_adam_slot_counter_advances_in_place():
    to = opt.Adam(learning_rate=0.1)
    p = {"w": torch.ones(2)}
    state = to.init_state(p)
    m, v, t = state["slots"]["w"]
    for _ in range(2):
        to.step(p, {"w": torch.ones(2)}, state)
    assert state["slots"]["w"][2] is t and t.dtype == torch.int32
    assert int(t) == 2 and state["slots"]["w"][0] is m
