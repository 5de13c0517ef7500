"""The mixed-layer family of the port against the JAX package, on the CPU
(paddle_tpu/layer/mixed.py, paddle_tpu/ops/sequence.py):

- ``ops.sequence.shift_steps`` and ``context_projection`` (zero and
  trainable padding) on ragged batches with a zero-length row: values and
  gradients;
- each projection and operator alone in a ``mixed`` layer, all of them
  summed in one, the ``with mixed_layer(...) as m: m += ...`` form, and
  ``concat`` over projections: values within 1e-6 of max(1, max |JAX|),
  gradients with respect to every parameter and floating feed within 1e-5
  of max(1, max |JAX gradient|), parameter names and shapes equal
  (``tests/torch_parity.py``);
- ``conv_projection`` in the K7 family (1x1 and 3x3, C and F multiples of
  8) and outside it (5x5, stride 2, groups), and ``conv_operator``, each
  sample's conv through ``ops.conv.conv2d`` (the kernels' plain versions
  on the CPU; JAX runs its Pallas conv in interpret mode);
- what stays out raises: ``trans=True``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import sequence as jax_seq

from paddle_tpu_torch.ops import conv_kernels as ck
from paddle_tpu_torch.ops import sequence as seq_ops
from paddle_tpu_torch.utils.error import EnforceError

from torch_parity import assert_match, both, rel, run_both

B, T, D = 4, 7, 5
LENGTHS = np.array([7, 0, 3, 1], np.int32)


def _mask():
    return np.arange(T)[None, :] < LENGTHS[:, None]


# -- ops/sequence.py -------------------------------------------------------

@pytest.mark.parametrize("offset", [-3, -1, 0, 2, 7])
def test_shift_steps_matches_jax(offset):
    rng = np.random.RandomState(offset + 10)
    x = rng.randn(B, T, D).astype(np.float32)
    g = rng.randn(B, T, D).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jax_seq.shift_steps(v, _mask(), offset),
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = seq_ops.shift_steps(xt, torch.from_numpy(_mask()), offset)
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    assert rel(got.detach().numpy(), want) <= 1e-6
    assert rel(dx.numpy(), vjp(jnp.asarray(g))[0]) <= 1e-5


@pytest.mark.parametrize("start,length,trainable", [
    (-1, 3, False), (-2, 5, True), (0, 3, True), (-3, 2, True),
    (1, 2, True), (0, 1, False)])
def test_context_projection_op_matches_jax(start, length, trainable):
    rng = np.random.RandomState(length * 7 + start)
    x = rng.randn(B, T, D).astype(np.float32)
    pad_rows = max(0, -start) + max(0, start + length - 1)
    pad = rng.randn(max(pad_rows, 1), D).astype(np.float32)
    g = rng.randn(B, T, D * length).astype(np.float32)

    def jfn(v, p):
        return jax_seq.context_projection(v, _mask(), start, length,
                                          p if trainable else None)

    want, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(pad))
    xt = torch.from_numpy(x).requires_grad_()
    pt = torch.from_numpy(pad).requires_grad_()
    got = seq_ops.context_projection(xt, torch.from_numpy(_mask()), start,
                                     length, pt if trainable else None)
    dx, dp = torch.autograd.grad(got, (xt, pt), torch.from_numpy(g),
                                 allow_unused=True)
    jdx, jdp = vjp(jnp.asarray(g))
    assert rel(got.detach().numpy(), want) <= 1e-6
    assert rel(dx.numpy(), jdx) <= 1e-5
    if trainable:
        assert rel(dp.numpy(), jdp) <= 1e-5


# -- the projections and operators -------------------------------------------

def _seq_rows(seed, n=4, dim=6, vocab=11):
    """Ragged rows {xs: dense sequence, ids: id sequence, x: dense vector,
    id: id} with a zero-length row."""
    rng = np.random.RandomState(seed)
    lens = [5, 0, 3, 1][:n]
    return [{"xs": rng.randn(k, dim).astype(np.float32),
             "ids": rng.randint(0, vocab, k).tolist(),
             "x": rng.randn(dim).astype(np.float32),
             "id": int(rng.randint(0, vocab))}
            for k in lens]


def _inputs(pkg, dim=6, vocab=11):
    L, dt = pkg.layer, pkg.data_type
    return (L.data(name="xs", type=dt.dense_vector_sequence(dim)),
            L.data(name="ids", type=dt.integer_value_sequence(vocab)),
            L.data(name="x", type=dt.dense_vector(dim)),
            L.data(name="id", type=dt.integer_value(vocab)))


PROJECTIONS = {
    "full_matrix": lambda L, xs, ids: L.full_matrix_projection(
        input=xs, size=8),
    "trans_full_matrix": lambda L, xs, ids: L.trans_full_matrix_projection(
        input=xs, size=8),
    "identity": lambda L, xs, ids: L.identity_projection(input=xs),
    "identity_offset": lambda L, xs, ids: L.identity_projection(
        input=xs, offset=2, size=3),
    "table": lambda L, xs, ids: L.table_projection(input=ids, size=8),
    "dotmul": lambda L, xs, ids: L.dotmul_projection(input=xs),
    "scaling": lambda L, xs, ids: L.scaling_projection(input=xs),
    "context": lambda L, xs, ids: L.context_projection(
        input=xs, context_start=-1, context_len=3),
    "context_trainable": lambda L, xs, ids: L.context_projection(
        input=xs, context_start=-2, context_len=4, trainable_padding=True),
}


@pytest.mark.parametrize("kind", sorted(PROJECTIONS))
@pytest.mark.parametrize("bias", [False, True])
def test_each_projection_in_a_mixed_layer_matches_jax(kind, bias):
    def build(pkg):
        xs, ids, _, _ = _inputs(pkg)
        proj = PROJECTIONS[kind](pkg.layer, xs, ids)
        out = pkg.layer.mixed(input=proj, act=pkg.activation.Tanh(),
                              bias_attr=bias, name="mx")
        return pkg.layer.pooling(input=out, name="pooled",
                                 pooling_type=pkg.pooling.SumPooling())

    port, jax_side = run_both(build, _seq_rows(1), ["mx", "pooled"], seed=2)
    assert_match(port, jax_side)
    names = sorted(k for k in port[1] if not k.startswith("feed:"))
    assert names == sorted(
        (["mx.w0"] if kind not in ("identity", "identity_offset",
                                   "context") else [])
        + (["mx.wbias"] if bias else []))


def test_operators_and_every_projection_summed_in_one_mixed_match_jax():
    def build(pkg):
        L = pkg.layer
        xs, ids, x, _ = _inputs(pkg)
        h = L.fc(input=xs, size=6, name="h")
        branches = [
            L.full_matrix_projection(input=xs),
            L.trans_full_matrix_projection(input=h),
            L.identity_projection(input=h),
            L.table_projection(input=ids),
            L.dotmul_projection(input=xs),
            L.scaling_projection(input=h),
            L.dotmul_operator(a=xs, b=h, scale=0.5)]
        out = L.mixed(size=6, input=branches, bias_attr=True,
                      act=pkg.activation.Sigmoid(), name="all")
        return L.pooling(input=out, name="pooled")

    port, jax_side = run_both(build, _seq_rows(3), ["all", "pooled"],
                              seed=4)
    assert_match(port, jax_side)
    assert sorted(k for k in port[1] if k.startswith("all.")) == [
        "all.w0", "all.w1", "all.w3", "all.w4", "all.w5", "all.wbias"]


def test_with_mixed_layer_form_matches_jax():
    def build(pkg):
        L = pkg.layer
        _, _, x, ident = _inputs(pkg)
        with L.mixed(size=5, act=pkg.activation.Relu(), bias_attr=True,
                     name="ctx_mx") as m:
            m += L.full_matrix_projection(input=x)
            m += L.table_projection(input=ident)
        return L.fc(input=m, size=3, name="head")

    port, jax_side = run_both(build, _seq_rows(5), ["ctx_mx", "head"],
                              seed=6)
    assert_match(port, jax_side)
    _, out = both(build)
    assert out.inputs[0].name == "ctx_mx" and out.inputs[0].size == 5
    with pytest.raises(EnforceError, match="already finalized"):
        out.inputs[0] += None


def test_concat_over_projections_matches_jax():
    """concat_layer over projections wraps each in a one-branch mixed
    layer (auto-named ``__mixed_<i>__``), as the JAX package does."""
    def build(pkg):
        L = pkg.layer
        xs, ids, _, _ = _inputs(pkg)
        h = L.fc(input=xs, size=4, name="h")
        return L.concat(input=[L.identity_projection(input=xs),
                               L.full_matrix_projection(input=h, size=3),
                               h], name="cat", act=pkg.activation.Tanh())

    port, jax_side = run_both(build, _seq_rows(7), ["cat"], seed=8)
    assert_match(port, jax_side)
    jout, out = both(build)
    assert [i.name for i in out.inputs] == [i.name for i in jout.inputs] \
        == ["__mixed_0__", "__mixed_1__", "h"]
    assert out.size == 6 + 3 + 4


def test_mixed_refuses_mismatched_sizes_and_non_projections():
    _, _, x, _ = _inputs(__import__("paddle_tpu_torch"))
    import paddle_tpu_torch as paddle

    with pytest.raises(EnforceError, match="disagree on size"):
        paddle.layer.mixed(input=[
            paddle.layer.full_matrix_projection(input=x, size=3),
            paddle.layer.identity_projection(input=x)])
    with pytest.raises(TypeError, match="projections/operators"):
        paddle.layer.mixed(input=[x], size=6)


# -- conv_projection and conv_operator --------------------------------------

def _img_rows(seed, n, c, hw):
    rng = np.random.RandomState(seed)
    return [(rng.randn(c * hw * hw).astype(np.float32),) for _ in range(n)]


@pytest.mark.parametrize("k,stride,pad,groups,family", [
    (1, 1, 0, 1, True), (3, 1, 1, 1, True), (5, 1, 2, 1, False),
    (3, 2, 1, 1, False), (3, 1, 1, 2, False)])
def test_conv_projection_matches_jax(monkeypatch, k, stride, pad, groups,
                                     family):
    """A conv_projection in a mixed layer with a bias and relu, the
    filter HWIO (k, k, C/groups, F); a shape in the K7 family runs the
    kernel wrappers (their plain versions here), any other ``F.conv2d``."""
    c, hw, f = 8, 6, 16
    calls = []
    real = ck.conv2d_same_fwd
    monkeypatch.setattr(ck, "conv2d_same_fwd",
                        lambda *a: calls.append(1) or real(*a))

    def build(pkg):
        L = pkg.layer
        img = L.data(name="img", type=pkg.data_type.dense_vector(c * hw * hw))
        proj = L.conv_projection(input=img, filter_size=k, num_filters=f,
                                 num_channels=c, stride=stride, padding=pad,
                                 groups=groups)
        return L.mixed(input=proj, bias_attr=True, act=pkg.activation.Relu(),
                       name="cp")

    port, jax_side = run_both(build, _img_rows(k + stride, 3, c, hw), ["cp"],
                              seed=9)
    assert_match(port, jax_side)
    shape = tuple(np.asarray(port[1]["cp.w0"]).shape)
    assert shape == (k, k, c // groups, f)
    # forward, and the data gradient on the flipped weight
    assert len(calls) == (2 if family else 0)


def test_conv_operator_matches_jax_through_the_kernel_family(monkeypatch):
    """conv_operator: each sample convolved with its own filters (the
    second input read as [F, C, k, k]); a 3x3 at C = F = 8 is in the K7
    family, so each sample's conv, its data gradient and its filter
    gradient run the kernels' wrappers, one call a sample each."""
    c, hw, f, k, n = 8, 5, 8, 3, 3
    counts = {"fwd": 0, "bwdw": 0}
    real_fwd, real_bwdw = ck.conv2d_same_fwd, ck.conv2d_same_bwd_filter

    def fwd(*a):
        counts["fwd"] += 1
        return real_fwd(*a)

    def bwdw(*a):
        counts["bwdw"] += 1
        return real_bwdw(*a)

    monkeypatch.setattr(ck, "conv2d_same_fwd", fwd)
    monkeypatch.setattr(ck, "conv2d_same_bwd_filter", bwdw)

    def build(pkg):
        L = pkg.layer
        img = L.data(name="img", type=pkg.data_type.dense_vector(c * hw * hw))
        z = L.data(name="z", type=pkg.data_type.dense_vector(4))
        filt = L.fc(input=z, size=f * c * k * k, name="filt")
        op = L.conv_operator(img=img, filter=filt, filter_size=k,
                             num_filters=f, num_channels=c, padding=1)
        return L.mixed(input=op, name="co")

    rng = np.random.RandomState(11)
    rows = [(rng.randn(c * hw * hw).astype(np.float32),
             rng.randn(4).astype(np.float32)) for _ in range(n)]
    port, jax_side = run_both(build, rows, ["co"], seed=12)
    assert_match(port, jax_side)
    assert counts == {"fwd": 2 * n, "bwdw": n}


def test_conv_operator_outside_the_family_matches_jax():
    c, hw, f, k = 3, 6, 2, 2

    def build(pkg):
        L = pkg.layer
        img = L.data(name="img", type=pkg.data_type.dense_vector(c * hw * hw))
        filt = L.data(name="filt", type=pkg.data_type.dense_vector(
            f * c * k * k))
        op = L.conv_operator(img=img, filter=filt, filter_size=k,
                             num_filters=f, num_channels=c, stride=2)
        return L.mixed(input=op, name="co")

    rng = np.random.RandomState(13)
    rows = [(rng.randn(c * hw * hw).astype(np.float32),
             rng.randn(f * c * k * k).astype(np.float32)) for _ in range(2)]
    port, jax_side = run_both(build, rows, ["co"], seed=14)
    assert_match(port, jax_side)


def test_transposed_conv_projection_and_operator_are_refused():
    """Ported: ``trans=True`` builds the transposed conv where its
    geometry agrees with the conv it runs (2 * padding = filter_size - 1,
    tests/test_torch_image_layers.py holds it against the JAX package),
    and is refused elsewhere, where the JAX package fails."""
    import paddle_tpu_torch as paddle

    img = paddle.layer.data(name="img",
                            type=paddle.data_type.dense_vector(8 * 16))
    proj = paddle.layer.conv_projection(input=img, filter_size=3,
                                        num_filters=8, num_channels=8,
                                        padding=1, trans=True)
    assert proj.size == 8 * 16
    op = paddle.layer.conv_operator(img=img, filter=img, filter_size=3,
                                    num_filters=8, num_channels=8,
                                    padding=1, trans=True)
    assert op.size == 8 * 16
    with pytest.raises(EnforceError, match="agree only where"):
        paddle.layer.conv_projection(input=img, filter_size=3,
                                     num_filters=8, num_channels=8,
                                     trans=True)
    with pytest.raises(EnforceError, match="agree only where"):
        paddle.layer.conv_operator(img=img, filter=img, filter_size=3,
                                   num_filters=8, num_channels=8,
                                   trans=True)


# -- the reference's equivalences (tests/test_network_compare.py) -----------

def _fc_pair(pkg, mixed):
    L, dt = pkg.layer, pkg.data_type
    x = L.data(name="x", type=dt.dense_vector(16))
    if mixed:
        return L.mixed(size=8, input=[L.full_matrix_projection(
            input=x, param_attr=pkg.attr.ParamAttr(name="w"))])
    return L.fc(input=x, size=8, bias_attr=False, act=None,
                param_attr=pkg.attr.ParamAttr(name="w"))


def _addto_pair(pkg, mixed):
    L, dt = pkg.layer, pkg.data_type
    a, b = (L.fc(input=L.data(name=n, type=dt.dense_vector(16)), size=8,
                 bias_attr=False, param_attr=pkg.attr.ParamAttr(name="w" + n))
            for n in ("x", "y"))
    if mixed:
        return L.mixed(size=8, input=[L.identity_projection(input=a),
                                      L.identity_projection(input=b)])
    return L.addto(input=[a, b])


@pytest.mark.parametrize("pair", [_fc_pair, _addto_pair],
                         ids=["fc_vs_full_matrix", "addto_vs_identity"])
def test_mixed_equals_its_plain_layer_as_in_jax(pair):
    """fc(bias_attr=False) equals mixed(full_matrix_projection) and addto
    equals mixed over identity projections, from the same named
    parameters; each side also matches the JAX package."""
    rng = np.random.RandomState(20)
    rows = [{"x": rng.randn(16).astype(np.float32),
             "y": rng.randn(16).astype(np.float32)} for _ in range(3)]
    got = {}
    for mixed in (False, True):
        def build(pkg, mixed=mixed):
            return pair(pkg, mixed)

        out = both(build)[1].name
        port, jax_side = run_both(build, rows, [out], seed=21)
        assert_match(port, jax_side)
        got[mixed] = port
    (plain, dplain), (mixed_v, dmixed) = got[False], got[True]
    assert rel(list(plain.values())[0], list(mixed_v.values())[0]) <= 1e-6
    for name in dplain:
        assert rel(dplain[name], dmixed[name]) <= 1e-6, name


def test_trans_full_matrix_projection_is_the_transposed_weight():
    def build(pkg):
        L, dt = pkg.layer, pkg.data_type
        x = L.data(name="x", type=dt.dense_vector(6))
        return L.mixed(size=4, name="pair", input=[
            L.trans_full_matrix_projection(input=x, size=4),
            L.full_matrix_projection(input=x, size=4)])

    rng = np.random.RandomState(22)
    rows = [(rng.randn(6).astype(np.float32),) for _ in range(3)]
    w = rng.randn(6, 4).astype(np.float32)
    params = {"pair.w0": np.ascontiguousarray(w.T), "pair.w1": -w}
    port, jax_side = run_both(build, rows, ["pair"], params=params)
    assert_match(port, jax_side)
    assert np.abs(port[0]["pair"]).max() <= 1e-6


def test_conv_projection_on_an_image_data_layer_matches_jax():
    """conv_projection reads its geometry from a data layer declared with
    height and width, as tests/test_misc_layers.py builds it."""
    def build(pkg):
        L = pkg.layer
        img = L.data(name="img", type=pkg.data_type.dense_vector(2 * 6 * 6),
                     height=6, width=6)
        return L.mixed(input=[L.conv_projection(img, filter_size=3,
                                                num_filters=4, stride=1,
                                                padding=1)], name="cp")

    rng = np.random.RandomState(23)
    rows = [(rng.randn(72).astype(np.float32),) for _ in range(2)]
    port, jax_side = run_both(build, rows, ["cp"], seed=24)
    assert_match(port, jax_side)
