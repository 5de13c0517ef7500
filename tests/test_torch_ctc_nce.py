"""The port's structured and sampled losses against the JAX package on the
CPU: ``ops/ctc.py`` (``ctc_loss``, ``ctc_greedy_decode``), the ctc and
warp_ctc layers, nce and hsigmoid, mirroring tests/test_structured.py.

Same seeded numpy inputs and parameters in both packages
(``tests/torch_parity.py``): values within 1e-6 of max(1, max |JAX|),
gradients within 1e-5 of max(1, max |JAX gradient|). nce in train mode
draws its negatives from the port's generator (the JAX package's key
stream is not reproduced): it is held by the distribution of its draws
and by its cost on the port's own draws against a numpy formula.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops import ctc as jax_ctc

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core.sequence import PackedSequenceBatch
from paddle_tpu_torch.ops import ctc as ctc_ops
from paddle_tpu_torch.topology import Topology, convert_feed
from paddle_tpu_torch.utils.error import EnforceError

from torch_parity import TOL_FWD, assert_match, both, numpy_params, rel, \
    run_both


def _log_softmax(x):
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


def _brute_force_ctc(logp, label, blank=0):
    """-log of the summed probability of every alignment of ``label``
    (collapse repeats, drop blanks) over the frames of ``logp``."""
    t, c = logp.shape
    total = -np.inf
    for frames in itertools.product(range(c), repeat=t):
        out, prev = [], None
        for f in frames:
            if f != prev and f != blank:
                out.append(f)
            prev = f
        if out == list(label):
            total = np.logaddexp(total, sum(logp[i, f]
                                            for i, f in enumerate(frames)))
    return -total


# -- ops/ctc.py --------------------------------------------------------------

@pytest.mark.parametrize("label", [[2, 1], [1, 1], [2], [1, 2, 1]])
def test_ctc_loss_matches_brute_force(label):
    logp = _log_softmax(np.random.RandomState(len(label)).randn(1, 5, 3))
    got = ctc_ops.ctc_loss(torch.from_numpy(logp), torch.tensor([5]),
                           torch.tensor([label + [0]]),
                           torch.tensor([len(label)]))
    np.testing.assert_allclose(float(got[0]),
                               _brute_force_ctc(logp[0], label), rtol=1e-10)


def _ctc_case(seed, b=4, t=7, c=5, s=3):
    rng = np.random.RandomState(seed)
    logp = _log_softmax(rng.randn(b, t, c)).astype(np.float32)
    in_lens = rng.randint(3, t + 1, b)
    lab_lens = np.minimum(rng.randint(1, s + 1, b), in_lens // 2)
    labels = rng.randint(1, c, (b, s))
    labels[0, :2] = 1  # a repeat: the skip is barred
    return logp, in_lens, labels, lab_lens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_loss_and_gradient_match_jax(seed):
    import jax

    logp, in_lens, labels, lab_lens = _ctc_case(seed)
    x = torch.from_numpy(logp).requires_grad_()
    got = ctc_ops.ctc_loss(x, torch.from_numpy(in_lens),
                           torch.from_numpy(labels),
                           torch.from_numpy(lab_lens))
    got.sum().backward()

    def jloss(lp):
        nll = jax_ctc.ctc_loss(lp, jnp.asarray(in_lens),
                               jnp.asarray(labels, jnp.int32),
                               jnp.asarray(lab_lens))
        return jnp.sum(nll), nll

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logp))
    assert rel(got.detach().numpy(), np.asarray(want)) <= TOL_FWD
    assert rel(x.grad.numpy(), np.asarray(jgrad)) <= 1e-5
    assert np.all(np.isfinite(x.grad.numpy()))


def test_ctc_greedy_decode_matches_jax():
    logp = np.full((2, 6, 3), -10.0, np.float32)
    for t, c in enumerate([1, 1, 0, 2, 2, 1]):
        logp[0, t, c] = 0.0
    for t, c in enumerate([0, 2, 0, 2, 1, 1]):
        logp[1, t, c] = 0.0
    lens = np.asarray([5, 6])
    ids, n = ctc_ops.ctc_greedy_decode(torch.from_numpy(logp),
                                       torch.from_numpy(lens))
    jids, jn = jax_ctc.ctc_greedy_decode(jnp.asarray(logp), jnp.asarray(lens))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ids.numpy()[0, :2], [1, 2])
    assert ids.dtype == n.dtype == torch.int32


# -- the ctc and warp_ctc layers ---------------------------------------------

def _ctc_rows(seed, classes=4, dim=None):
    rng = np.random.RandomState(seed)
    rows = []
    for t, s in ((6, 2), (5, 1), (7, 3), (4, 2)):
        rows.append({"sc": rng.randn(t, dim or classes).astype(np.float32),
                     "lb": rng.randint(1, classes, s).tolist()})
    return rows


@pytest.mark.parametrize("which", ["ctc", "warp_ctc"])
@pytest.mark.parametrize("softmax", [False, True])
@pytest.mark.parametrize("norm_by_times", [False, True])
def test_ctc_layer_matches_jax(which, softmax, norm_by_times):
    def build(pkg):
        sc = pkg.layer.data(name="sc",
                            type=pkg.data_type.dense_vector_sequence(6))
        lb = pkg.layer.data(name="lb",
                            type=pkg.data_type.integer_value_sequence(4))
        scores = pkg.layer.fc(
            input=sc, size=5,
            act=pkg.activation.Softmax() if softmax else None)
        return getattr(pkg.layer, which)(input=scores, label=lb,
                                         norm_by_times=norm_by_times,
                                         name="out")

    jout, out = both(build)
    assert out.size == jout.size == 5  # the label dict + the blank
    assert_match(*run_both(build, _ctc_rows(3, dim=6), ["out"]))


def test_ctc_layer_contract_matches_jax():
    sc = paddle.layer.data(name="sc",
                           type=paddle.data_type.dense_vector_sequence(4))
    lb = paddle.layer.data(name="lb",
                           type=paddle.data_type.integer_value_sequence(4))
    assert paddle.layer.warp_ctc is paddle.layer.ctc
    assert paddle.layer.ctc(input=sc, label=lb, size=9).size == 9
    with pytest.raises(EnforceError, match="only blank=0"):
        paddle.layer.ctc(input=sc, label=lb, blank=3)
    cost = paddle.layer.ctc(input=sc, label=lb)
    topo = Topology(cost)
    feed = convert_feed(topo, [(r["sc"], r["lb"]) for r in _ctc_rows(4)],
                        device="cpu")
    packed = PackedSequenceBatch(feed["sc"].data, feed["sc"].lengths,
                                 torch.zeros_like(feed["sc"].data[..., 0],
                                                  dtype=torch.int32))
    with pytest.raises(EnforceError, match="packed"):
        topo.apply({}, dict(feed, sc=packed), mode="test")


# -- nce ---------------------------------------------------------------------

def _nce_rows(seed, n=6, classes=20, dim=8):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(dim).astype(np.float32),
             "y": int(rng.randint(0, classes)),
             "w": rng.uniform(0.5, 1.5, 1).astype(np.float32)}
            for _ in range(n)]


NCE_CASES = {
    "uniform": dict(),
    "distribution": dict(neg_distribution=[float(i % 5 + 1)
                                           for i in range(20)]),
    "weighted": dict(weight=True),
    "three_negatives": dict(num_neg_samples=3),
}


def _nce_build(case):
    def build(pkg):
        x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(8))
        y = pkg.layer.data(name="y", type=pkg.data_type.integer_value(20))
        kw = dict(NCE_CASES[case])
        if kw.pop("weight", False):
            kw["weight"] = pkg.layer.data(
                name="w", type=pkg.data_type.dense_vector(1))
        kw.setdefault("num_neg_samples", 5)
        feat = pkg.layer.fc(input=x, size=6, act=pkg.activation.Tanh())
        return pkg.layer.nce(input=feat, label=y, num_classes=20, name="out",
                             **kw)
    return build


@pytest.mark.parametrize("case", sorted(NCE_CASES))
def test_nce_in_test_mode_matches_jax(case):
    """Test mode: the strided pseudo-negatives of both packages."""
    assert_match(*run_both(_nce_build(case), _nce_rows(5), ["out"],
                           mode="test", loss=False))
    jout, out = both(_nce_build(case))
    assert sorted(s.name for s in out.param_specs) == sorted(
        s.name for s in jout.param_specs)


def test_nce_defaults_to_the_label_width():
    x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(8))
    y = paddle.layer.data(name="y", type=paddle.data_type.integer_value(13))
    cost = paddle.layer.nce(input=x, label=y)
    assert [tuple(s.shape) for s in cost.param_specs] == [(13, 8), (13,)]


def test_nce_train_mode_draws_from_the_noise_distribution():
    """Train mode: K negatives a row from the generator, distributed as
    neg_distribution (a chi-square bound at 20 classes), and repeatable
    from one seed."""
    dist = np.asarray([float(i % 5 + 1) for i in range(20)])
    dist /= dist.sum()
    seen = []
    real = torch.multinomial

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
        return out

    build = _nce_build("distribution")
    _, out = both(build)
    topo = Topology(out)
    params = {k: torch.from_numpy(v) for k, v in
              numpy_params(topo.param_specs(), 0).items()}
    rows = [(r["x"], r["y"]) for r in _nce_rows(6, n=400)]
    feed = convert_feed(topo, rows, device="cpu")
    torch.multinomial = spy
    try:
        first = topo.apply(params, feed, mode="train",
                           rng=torch.Generator().manual_seed(3))[0]
        again = topo.apply(params, feed, mode="train",
                           rng=torch.Generator().manual_seed(3))[0]
    finally:
        torch.multinomial = real
    np.testing.assert_array_equal(first["out"].detach().numpy(),
                                  again["out"].detach().numpy())
    draws = seen[0].numpy()
    assert draws.shape == (400, 5)
    counts = np.bincount(draws.reshape(-1), minlength=20)
    expected = dist * draws.size
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 45.3  # the 0.9995 quantile at 19 degrees of freedom
    with pytest.raises(Exception, match="rng="):
        topo.apply(params, feed, mode="train")


def test_nce_train_mode_cost_on_its_draws_matches_numpy():
    """The cost of the port's own draws against the numpy formula: the
    logistic loss of the label (1) and the negatives (0), each logit
    less log(q * K)."""
    dist = np.asarray([float(i % 5 + 1) for i in range(20)])
    dist /= dist.sum()
    seen = []
    real = torch.multinomial

    def spy(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    _, out = both(_nce_build("distribution"))
    topo = Topology(out)
    arrays = numpy_params(topo.param_specs(), 1)
    rows = _nce_rows(7)
    feed = convert_feed(topo, [(r["x"], r["y"]) for r in rows], device="cpu")
    torch.multinomial = spy
    try:
        got = topo.apply({k: torch.from_numpy(v) for k, v in arrays.items()},
                         feed, mode="train",
                         rng=torch.Generator().manual_seed(5))[0]["out"]
    finally:
        torch.multinomial = real
    fc_w = next(v for k, v in arrays.items() if k.endswith(".w0")
                and k != "out.w0")
    fc_b = next(v for k, v in arrays.items() if k.endswith(".wbias")
                and k != "out.wbias")
    feat = np.tanh(np.stack([r["x"] for r in rows]) @ fc_w + fc_b)
    ids = np.concatenate([np.asarray([r["y"] for r in rows])[:, None],
                          seen[0].numpy()], axis=1)
    logits = (np.einsum("bd,bkd->bk", feat, arrays["out.w0"][ids])
              + arrays["out.wbias"][ids]
              - np.log(dist * 5 + 1e-20)[ids])
    target = np.zeros_like(logits)
    target[:, 0] = 1.0
    want = (np.maximum(logits, 0) - logits * target
            + np.log1p(np.exp(-np.abs(logits)))).sum(1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("which", ["nce", "hsigmoid"])
def test_bias_free_nce_and_hsigmoid_fail_in_both(which):
    import paddle_tpu as jpaddle

    def build(pkg):
        x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(4))
        y = pkg.layer.data(name="y", type=pkg.data_type.integer_value(6))
        return getattr(pkg.layer, which)(input=x, label=y, num_classes=6,
                                         bias_attr=False)

    from paddle_tpu.topology import Topology as JaxTopology

    with pytest.raises(AttributeError, match="'NoneType'"):
        JaxTopology(build(jpaddle)).param_specs()
    with pytest.raises(EnforceError, match="fails in the JAX package"):
        build(paddle)


# -- hsigmoid ----------------------------------------------------------------

@pytest.mark.parametrize("num_classes", [2, 5, 8])
def test_hsigmoid_matches_jax(num_classes):
    def build(pkg):
        x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(5))
        y = pkg.layer.data(name="y",
                           type=pkg.data_type.integer_value(num_classes))
        return pkg.layer.hsigmoid(input=x, label=y, num_classes=num_classes,
                                  name="out")

    rng = np.random.RandomState(num_classes)
    rows = [{"x": rng.randn(5).astype(np.float32), "y": c % num_classes}
            for c in range(6)]
    assert_match(*run_both(build, rows, ["out"]))


def test_hsigmoid_probabilities_sum_to_one():
    x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(5))
    y = paddle.layer.data(name="y", type=paddle.data_type.integer_value(8))
    cost = paddle.layer.hsigmoid(input=x, label=y, num_classes=8)
    topo = Topology(cost)
    params = topo.init_params(seed=0, device="cpu")
    row = np.random.RandomState(0).randn(5).astype(np.float32)
    feed = convert_feed(topo, [(row, c) for c in range(8)], device="cpu")
    costs = topo.apply(params, feed, mode="test")[0][cost.name]
    np.testing.assert_allclose(float(torch.exp(-costs).sum()), 1.0,
                               rtol=1e-5)
