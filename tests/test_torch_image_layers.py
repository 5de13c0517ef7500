"""The port's remaining image layers against the JAX package on the CPU:
the transposed conv (``img_conv``, ``conv_projection`` and
``conv_operator`` with ``trans=True``), spp, maxout, pad, crop, rotate,
conv_shift, bilinear_interp, ``batch_norm(img3D=True)``, batch norm over
sequences and image layers over sequence inputs, mirroring the cases of
tests/test_layer_grad.py.

Same seeded numpy inputs and parameters in both packages
(``tests/torch_parity.py``): values within 1e-6 of max(1, max |JAX|),
gradients within 1e-5 of max(1, max |JAX gradient|), unless a test states
its own. Where the JAX package's transposed conv declares one size and
computes another (2p != f - 1), the JAX call fails in the next layer and
the port refuses at build time; the tests hold both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops import conv as jax_conv_ops
from paddle_tpu.topology import Topology as JaxTopology
from paddle_tpu.topology import convert_feed as jax_convert_feed

import paddle_tpu_torch as paddle
from paddle_tpu_torch.ops import conv as conv_ops
from paddle_tpu_torch.topology import Topology, convert_feed
from paddle_tpu_torch.utils.error import EnforceError

from torch_parity import (TOL_FWD, TOL_GRAD, assert_match, both,
                          numpy_params, rel, run_both)


def _img(pkg, c, h, w, name="img"):
    return pkg.layer.data(name=name,
                          type=pkg.data_type.dense_vector(c * h * w),
                          height=h, width=w)


def _rows(seed, n=3, **dims):
    rng = np.random.RandomState(seed)
    return [{k: rng.randn(d).astype(np.float32) for k, d in dims.items()}
            for _ in range(n)]


def _check(build, rows, out="out", **kw):
    tols = {k: kw.pop(k) for k in ("tol_fwd", "tol_grad") if k in kw}
    return assert_match(*run_both(build, rows, [out], **kw), **tols)


# -- the transposed conv -----------------------------------------------------

# (filter, stride, padding) where 2p = f - 1: the JAX package runs these
TRANS_RUNS = [(1, 1, 0), (1, 2, 0), (3, 1, 1), (3, 2, 1), (3, 3, 1),
              (5, 1, 2), (5, 2, 2)]
# and these it declares one size of and computes another
TRANS_FAILS = [(4, 2, 1), (2, 2, 0), (3, 1, 0), (3, 2, 0), (5, 2, 1)]


@pytest.mark.parametrize("f,s,p", TRANS_RUNS)
@pytest.mark.parametrize("shared_biases", [True, False])
def test_img_conv_trans_matches_jax(f, s, p, shared_biases):
    def build(pkg):
        conv = pkg.layer.img_conv(input=_img(pkg, 2, 5, 4), filter_size=f,
                                  num_filters=3, stride=s, padding=p,
                                  trans=True, shared_biases=shared_biases,
                                  act=pkg.activation.Tanh())
        assert conv.out_img_shape == (3, (5 - 1) * s - 2 * p + f,
                                      (4 - 1) * s - 2 * p + f)
        return pkg.layer.fc(input=conv, size=4, name="out")

    _check(build, _rows(f * 10 + s, img=40))


@pytest.mark.parametrize("f,s,p", TRANS_FAILS)
def test_img_conv_trans_refused_where_jax_fails(f, s, p):
    import paddle_tpu as jpaddle

    def build(pkg):
        conv = pkg.layer.img_conv(input=_img(pkg, 2, 5, 4), filter_size=f,
                                  num_filters=3, stride=s, padding=p,
                                  trans=True)
        return pkg.layer.fc(input=conv, size=4, name="out")

    jout = build(jpaddle)
    jtopo = JaxTopology(jout)
    arrays = numpy_params(jtopo.param_specs(), 1)
    rows = [(r["img"],) for r in _rows(2, img=40)]
    with pytest.raises(Exception):
        jtopo.apply({k: jnp.asarray(v) for k, v in arrays.items()},
                    jax_convert_feed(jtopo, rows), mode="test")
    with pytest.raises(EnforceError, match="agree only where"):
        build(paddle)


@pytest.mark.parametrize("f,s,p", [(3, 2, 1), (2, 1, 0), (4, 2, 1),
                                   (3, 1, 2), (5, 3, 0), (1, 2, 0)])
def test_conv2d_transpose_op_matches_lax_conv_transpose(f, s, p):
    """The op at any pads up to f - 1 (the layers use 2p = f - 1 only),
    against the JAX package's op in float32 (1e-5), and in float64
    against its definition: a conv over the stride-dilated input, the
    kernel not flipped (1e-12)."""
    rng = np.random.RandomState(f * 100 + s * 10 + p)
    x = rng.randn(2, 4, 3, 3)
    w = rng.randn(f, f, 3, 5)
    got = conv_ops.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w),
                                    stride=(s, s), padding=((p, p), (p, p)))
    got32 = conv_ops.conv2d_transpose(
        torch.from_numpy(x).float(), torch.from_numpy(w).float(),
        stride=(s, s), padding=((p, p), (p, p)))
    want = np.asarray(jax_conv_ops.conv2d_transpose(
        jnp.asarray(x, jnp.float32), jnp.asarray(w, jnp.float32),
        stride=(s, s), padding=((p, p), (p, p))))
    xd = torch.zeros(2, 3, (4 - 1) * s + 1, (3 - 1) * s + 1,
                     dtype=torch.float64)
    xd[:, :, ::s, ::s] = torch.from_numpy(x).permute(0, 3, 1, 2)
    direct = torch.nn.functional.conv2d(
        xd, torch.from_numpy(w).permute(3, 2, 0, 1), padding=p)
    assert got.shape == want.shape == (2, (4 - 1) * s + 2 * p - f + 2,
                                       (3 - 1) * s + 2 * p - f + 2, 5)
    assert rel(got32.numpy(), want) <= 1e-5
    np.testing.assert_allclose(got.numpy(),
                               direct.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_img_conv_trans_refuses_groups():
    with pytest.raises(EnforceError, match="no feature groups"):
        paddle.layer.img_conv(input=_img(paddle, 4, 3, 3), filter_size=3,
                              num_filters=4, padding=1, groups=2, trans=True)


def test_conv_projection_trans_matches_jax():
    def build(pkg):
        proj = pkg.layer.conv_projection(_img(pkg, 2, 4, 4), filter_size=3,
                                         num_filters=3, stride=2, padding=1,
                                         trans=True)
        return pkg.layer.mixed(input=[proj], name="out")

    _check(build, _rows(3, img=32))


def test_conv_operator_trans_matches_jax():
    def build(pkg):
        img = _img(pkg, 2, 3, 3)
        filt = pkg.layer.data(name="filt",
                              type=pkg.data_type.dense_vector(4 * 2 * 9))
        op = pkg.layer.conv_operator(img=img, filter=filt, filter_size=3,
                                     num_filters=4, num_channels=2, stride=2,
                                     padding=1, trans=True)
        return pkg.layer.mixed(input=[op], name="out")

    _check(build, _rows(4, img=18, filt=72))


# -- spp, maxout, pad, crop, rotate, conv_shift -------------------------------

@pytest.mark.parametrize("pool,height", [("Max", 1), ("Max", 2), ("Max", 3),
                                         ("Avg", 2)])
def test_spp_matches_jax(pool, height):
    def build(pkg):
        return pkg.layer.spp(input=_img(pkg, 4, 4, 4),
                             pool_type=getattr(pkg.pooling,
                                               pool + "Pooling")(),
                             pyramid_height=height, name="out")

    _check(build, _rows(5, img=64))


@pytest.mark.parametrize("groups", [2, 4])
def test_maxout_matches_jax(groups):
    def build(pkg):
        return pkg.layer.maxout(input=_img(pkg, 4, 3, 3), groups=groups,
                                name="out")

    _check(build, _rows(6, img=36))


def test_maxout_splits_a_tie_evenly_as_jax():
    def build(pkg):
        return pkg.layer.maxout(input=_img(pkg, 2, 1, 2), groups=2,
                                name="out")

    rows = [{"img": np.asarray([1.0, 3.0, 1.0, 2.0], np.float32)}]
    port, jax_side = run_both(build, rows, ["out"])
    assert_match(port, jax_side)
    np.testing.assert_allclose(port[1]["feed:img"], [[0.25, 0.5, 0.25, 0.0]])


@pytest.mark.parametrize("pads", [((1, 1), (0, 1), (1, 0)),
                                  ((0, 0), (2, 0), None)])
def test_pad_matches_jax(pads):
    def build(pkg):
        conv = pkg.layer.img_conv(input=_img(pkg, 2, 4, 4), filter_size=1,
                                  num_filters=2)
        return pkg.layer.pad(input=conv, pad_c=pads[0], pad_h=pads[1],
                             pad_w=pads[2], name="out")

    _check(build, _rows(7, img=32))


@pytest.mark.parametrize("axis,offset,shape", [
    (2, (1, 1), (1, 2, 2, 2)), (1, (1, 0, 1), (1, 1, 3, 2)), (2, (0,), None)])
def test_crop_matches_jax(axis, offset, shape):
    def build(pkg):
        x = _img(pkg, 2, 4, 4)
        if shape is None:
            ref = _img(pkg, 2, 3, 3, name="ref")
            return pkg.layer.crop(input=[x, ref], axis=axis, offset=offset,
                                  name="out")
        return pkg.layer.crop(input=x, axis=axis, offset=offset, shape=shape,
                              name="out")

    _check(build, _rows(8, img=32, ref=18))


def test_rotate_matches_jax():
    def build(pkg):
        x = pkg.layer.data(name="x", type=pkg.data_type.dense_vector(24))
        out = pkg.layer.rotate(input=x, height=3, width=4, name="out")
        assert out.out_img_shape == (2, 4, 3)
        return out

    (values, _), _ = run_both(build, [{"x": np.arange(24, dtype=np.float32)}],
                              ["out"])
    want = np.rot90(np.arange(24).reshape(2, 3, 4), 1, axes=(1, 2))
    np.testing.assert_array_equal(values["out"][0], want.reshape(-1))
    _check(build, _rows(9, x=24))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_conv_shift_matches_jax(n):
    def build(pkg):
        a = pkg.layer.data(name="a", type=pkg.data_type.dense_vector(6))
        b = pkg.layer.data(name="b", type=pkg.data_type.dense_vector(n))
        return pkg.layer.conv_shift(a, b, name="out")

    _check(build, _rows(10, a=6, b=n))


# -- bilinear_interp ---------------------------------------------------------

@pytest.mark.parametrize("h,w,oh,ow", [
    (4, 4, 8, 8), (3, 5, 7, 9), (8, 8, 3, 3), (6, 9, 4, 2), (4, 8, 6, 5),
    (5, 5, 5, 5)])
def test_bilinear_interp_matches_jax_both_ways(h, w, oh, ow):
    """Growing (half-pixel centres), shrinking (the triangle kernel
    widened by the scale: antialiasing) and both at once."""
    def build(pkg):
        return pkg.layer.bilinear_interp(input=_img(pkg, 2, h, w),
                                         out_size_x=ow, out_size_y=oh,
                                         name="out")

    _check(build, _rows(11, img=2 * h * w))


# -- batch norm: img3D, over sequences ---------------------------------------

def test_batch_norm_img3d_is_accepted_and_unused_as_in_jax():
    def build(pkg):
        conv = pkg.layer.img_conv(input=_img(pkg, 2, 4, 4), filter_size=3,
                                  num_filters=4, padding=1)
        return pkg.layer.batch_norm(input=conv, img3D=True, name="out")

    _check(build, _rows(12, img=32))


def _seq_rows(seed, dim, lens=(3, 2, 1)):
    rng = np.random.RandomState(seed)
    return [{"xs": rng.randn(k, dim).astype(np.float32)} for k in lens]


@pytest.mark.parametrize("use_global_stats", [None, True])
def test_batch_norm_over_a_sequence_on_moving_statistics_matches_jax(
        use_global_stats):
    """Normalised by the moving statistics (test mode, or
    use_global_stats in train mode): per feature over every step."""
    def build(pkg):
        xs = pkg.layer.data(name="xs",
                            type=pkg.data_type.dense_vector_sequence(4))
        return pkg.layer.batch_norm(input=xs, name="out",
                                    use_global_stats=use_global_stats)

    arrays = {"out.w0": np.full(4, 1.5, np.float32),
              "out.wbias": np.full(4, 0.5, np.float32),
              "out.moving_mean": np.arange(4, dtype=np.float32),
              "out.moving_var": np.arange(1, 5, dtype=np.float32)}
    _check(build, _seq_rows(13, 4),
           mode="train" if use_global_stats else "test", params=arrays,
           loss=bool(use_global_stats))


def test_batch_norm_over_a_sequence_refuses_batch_statistics():
    """Batch statistics over a sequence train in neither package: the JAX
    package's reduce per step ([T, D] against [D] parameters) and its
    gradient fails; the port refuses and says so."""
    def build(pkg):
        xs = pkg.layer.data(name="xs",
                            type=pkg.data_type.dense_vector_sequence(4))
        return pkg.layer.batch_norm(input=xs, name="out")

    jout, out = both(build)
    jtopo, topo = JaxTopology(jout), Topology(out)
    arrays = numpy_params(topo.param_specs(), 0)
    tuples = [(r["xs"],) for r in _seq_rows(13, 4)]

    def jloss(p):
        value = jtopo.apply(p, jax_convert_feed(jtopo, tuples),
                            mode="train")[0][jout.name]
        return jnp.sum(value.data)

    with pytest.raises(ValueError, match="shapes do not match"):
        jax.grad(jloss)({k: jnp.asarray(v) for k, v in arrays.items()})
    with pytest.raises(EnforceError, match="fails in the JAX package"):
        topo.apply({k: torch.from_numpy(v) for k, v in arrays.items()},
                   convert_feed(topo, tuples, device="cpu"), mode="train")


# -- image layers over sequence inputs ---------------------------------------

def _raw_run(build, rows, seed=0, tol_fwd=TOL_FWD, tol_grad=TOL_GRAD):
    """Each package's output data (as it is: an image layer over a
    sequence gives [B * T, D] rows with the input's lengths) and the
    gradients of sum(data * R) for a fixed random R, train mode."""
    jout, out = both(build)
    topo, jtopo = Topology(out), JaxTopology(jout)
    arrays = numpy_params(topo.param_specs(), seed)
    for name in arrays:
        if name.endswith(".moving_var"):
            arrays[name] = np.abs(arrays[name]) + 1.0
    tuples = [(r["xs"],) for r in rows]
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in arrays.items()}
    value = topo.apply(params, convert_feed(topo, tuples, device="cpu"),
                       mode="train")[0][out.name]
    data = value.data
    weights = np.random.RandomState(seed + 1).randn(
        *data.shape).astype(np.float32)
    (data * torch.from_numpy(weights)).sum().backward()

    def jloss(p):
        jv = jtopo.apply(p, jax_convert_feed(jtopo, tuples),
                         mode="train")[0][jout.name]
        return jnp.sum(jv.data * weights), jv

    (_, jvalue), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    assert type(value).__name__ == type(jvalue).__name__ == "SequenceBatch"
    np.testing.assert_array_equal(value.lengths.numpy(),
                                  np.asarray(jvalue.lengths))
    assert tuple(data.shape) == jvalue.data.shape
    assert rel(data.detach().numpy(), np.asarray(jvalue.data)) <= tol_fwd
    for name in jgrads:  # a running statistic has no gradient (zero)
        grad = params[name].grad
        grad = np.zeros(jgrads[name].shape) if grad is None else grad.numpy()
        assert rel(grad, np.asarray(jgrads[name])) <= tol_grad, name
    return data


IMAGE_OVER_SEQUENCE = ["img_conv", "img_conv_relu", "img_pool",
                       "img_cmrnorm", "batch_norm", "maxout", "spp"]


@pytest.mark.parametrize("kind", IMAGE_OVER_SEQUENCE)
def test_image_layer_over_a_sequence_matches_jax(kind):
    """Every step read as a 2 x 4 x 4 image, padding steps included: the
    output is [B * T, D] rows with the input's lengths in both packages
    (the JAX package's sequence layers downstream of it fail; an fc
    reads it)."""
    def build(pkg):
        xs = pkg.layer.data(name="xs",
                            type=pkg.data_type.dense_vector_sequence(32))
        if kind.startswith("img_conv"):
            layer = pkg.layer.img_conv(
                input=xs, filter_size=3, num_filters=4, num_channels=2,
                padding=1, act=pkg.activation.Relu()
                if kind.endswith("relu") else None)
        elif kind == "img_pool":
            layer = pkg.layer.img_pool(input=xs, pool_size=2, stride=2,
                                       num_channels=2)
        elif kind == "img_cmrnorm":
            layer = pkg.layer.img_cmrnorm(input=xs, size=3, num_channels=2)
        elif kind == "batch_norm":
            conv = pkg.layer.img_conv(input=xs, filter_size=1,
                                      num_filters=2, num_channels=2)
            layer = pkg.layer.batch_norm(input=conv)
        elif kind == "maxout":
            conv = pkg.layer.img_conv(input=xs, filter_size=1,
                                      num_filters=4, num_channels=2)
            layer = pkg.layer.maxout(input=conv, groups=2)
        else:
            conv = pkg.layer.img_conv(input=xs, filter_size=1,
                                      num_filters=2, num_channels=2)
            layer = pkg.layer.spp(input=conv, pyramid_height=2)
        return pkg.layer.fc(input=layer, size=3, name="out")

    # batch norm's float32 variance, mean(x^2) - mean^2 over 768 values a
    # channel, rounds to 1.3e-5 in the JAX package's reduction and to
    # 1.5e-6 of float64 in the port's, and the conv weight's gradient
    # through it is a difference of near-equal sums: batch norm's values
    # are held to 5e-5, its gradients to 2e-4
    bn = kind == "batch_norm"
    data = _raw_run(build, _seq_rows(14, 32, lens=(16, 14, 11)),
                    tol_fwd=5e-5 if bn else TOL_FWD,
                    tol_grad=2e-4 if bn else TOL_GRAD)
    assert data.shape[0] == 3 * 16  # every step of the length bucket
