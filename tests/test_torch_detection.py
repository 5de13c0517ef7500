"""The port's SSD detection suite against the JAX package on the CPU:
``ops/detection.py`` (bbox_area, jaccard_overlap, encode_box /
decode_box, match_priors, nms), the layers priorbox, cross_channel_norm,
multibox_loss and detection_output, and ``evaluator.detection_map``,
mirroring tests/test_misc_layers.py's SSD cases.

Values within 1e-6 of max(1, max |JAX|), gradients within 1e-5 of
max(1, max |JAX gradient|) (``tests/torch_parity.py``); match indices,
NMS picks, detection labels and the rows they index equal; the mAP within
1e-6. Ties (equal scores, equal IoUs) are broken by index in both
packages, which the tie cases hold.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.ops import detection as jax_det
from paddle_tpu.topology import Topology as JaxTopology
from paddle_tpu.topology import convert_feed as jax_convert_feed

import paddle_tpu_torch as paddle
from paddle_tpu_torch.evaluator import host_stats
from paddle_tpu_torch.ops import detection as det_ops
from paddle_tpu_torch.topology import Topology, convert_feed

from torch_parity import (TOL_FWD, assert_match, both, numpy_params, rel,
                          run_both)


def _boxes(rng, n):
    lo = rng.rand(n, 2) * 0.6
    return np.concatenate([lo, lo + 0.1 + rng.rand(n, 2) * 0.3],
                          axis=1).astype(np.float32)


# -- ops/detection.py --------------------------------------------------------

def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 5), _boxes(rng, 4)
    var = np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), (5, 1))
    loc = rng.randn(5, 4).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [
        (det_ops.bbox_area(ta), jax_det.bbox_area(ja)),
        (det_ops.jaccard_overlap(ta, tb), jax_det.jaccard_overlap(ja, jb)),
        (det_ops.encode_box(ta, torch.from_numpy(var), ta.flip(0)),
         jax_det.encode_box(ja, jnp.asarray(var), ja[::-1])),
        (det_ops.decode_box(ta, torch.from_numpy(var), torch.from_numpy(loc)),
         jax_det.decode_box(ja, jnp.asarray(var), jnp.asarray(loc))),
    ]
    for got, want in pairs:
        assert rel(got.numpy(), np.asarray(want)) <= TOL_FWD
    # decode inverts encode
    enc = det_ops.encode_box(ta, torch.from_numpy(var), ta.flip(0))
    np.testing.assert_allclose(
        det_ops.decode_box(ta, torch.from_numpy(var), enc).numpy(),
        a[::-1], atol=1e-6)


@pytest.mark.parametrize("tie", [False, True])
def test_match_priors_matches_jax(tie):
    rng = np.random.RandomState(1)
    priors = _boxes(rng, 12)
    gts = np.stack([_boxes(rng, 3), _boxes(rng, 3)])
    valid = np.asarray([[True, True, False], [True, False, True]])
    if tie:  # a gt equally overlapping two priors, and two equal gts
        priors[5] = priors[2]
        gts[0, 0] = priors[2]
        gts[1, 2] = gts[1, 0]
    match, iou = det_ops.match_priors(
        torch.from_numpy(priors), torch.from_numpy(gts),
        torch.from_numpy(valid), 0.3)
    for b in range(2):
        jm, jiou = jax_det.match_priors(jnp.asarray(priors),
                                        jnp.asarray(gts[b]),
                                        jnp.asarray(valid[b]), 0.3)
        np.testing.assert_array_equal(match[b].numpy(), np.asarray(jm))
        assert rel(iou[b].numpy(), np.asarray(jiou)) <= TOL_FWD
    if tie:
        assert int(match[0, 2]) == int(match[0, 5]) == 0


@pytest.mark.parametrize("case", ["random", "tied_scores", "all_invalid"])
def test_nms_matches_jax(case):
    rng = np.random.RandomState(2)
    boxes = _boxes(rng, 10)
    boxes[3] = boxes[1] + 0.01  # an overlapping pair
    scores = rng.rand(10).astype(np.float32)
    valid = scores > 0.2
    if case == "tied_scores":
        scores[[1, 3, 6, 8]] = 0.75
    if case == "all_invalid":
        valid[:] = False
    for top_k in (4, 10):
        idx, keep = det_ops.nms(torch.from_numpy(boxes),
                                torch.from_numpy(scores),
                                torch.from_numpy(valid), 0.45, top_k)
        jidx, jkeep = jax_det.nms(jnp.asarray(boxes), jnp.asarray(scores),
                                  jnp.asarray(valid), 0.45, top_k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))


def test_nms_batches_leading_dimensions():
    rng = np.random.RandomState(3)
    boxes = np.stack([_boxes(rng, 8) for _ in range(6)]).reshape(2, 3, 8, 4)
    scores = rng.rand(2, 3, 8).astype(np.float32)
    valid = scores > 0.3
    idx, keep = det_ops.nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores),
                            torch.from_numpy(valid), 0.45, 5)
    for i in range(2):
        for j in range(3):
            one = det_ops.nms(torch.from_numpy(boxes[i, j]),
                              torch.from_numpy(scores[i, j]),
                              torch.from_numpy(valid[i, j]), 0.45, 5)
            np.testing.assert_array_equal(idx[i, j].numpy(), one[0].numpy())
            np.testing.assert_array_equal(keep[i, j].numpy(),
                                          one[1].numpy())


# -- the layers --------------------------------------------------------------

def test_priorbox_table_matches_jax():
    def build(pkg):
        feat = pkg.layer.data(name="feat",
                              type=pkg.data_type.dense_vector(8 * 2 * 2),
                              height=2, width=2)
        img = pkg.layer.data(name="img",
                             type=pkg.data_type.dense_vector(3 * 8 * 8),
                             height=8, width=8)
        return pkg.layer.priorbox(input=feat, image=img, min_size=[4, 5],
                                  max_size=[8, 9], aspect_ratio=[2.0, 3.0],
                                  variance=[0.1, 0.1, 0.2, 0.2], name="out")

    jout, out = both(build)
    assert out.num_priors == jout.num_priors == 2 * 2 * 2 * 6
    assert out.size == jout.size
    rows = [{"feat": np.zeros(32, np.float32), "img": np.zeros(192,
                                                                np.float32)}]
    (values, _), (jvalues, _) = run_both(build, rows, ["out"], loss=False,
                                         mode="test")
    np.testing.assert_array_equal(values["out"], jvalues["out"])
    np.testing.assert_allclose(values["out"][0, :4], [0.0, 0.0, 0.5, 0.5],
                               atol=1e-6)


def test_cross_channel_norm_matches_jax():
    def build(pkg):
        img = pkg.layer.data(name="img",
                             type=pkg.data_type.dense_vector(3 * 2 * 2),
                             height=2, width=2)
        return pkg.layer.cross_channel_norm(input=img, name="out")

    rng = np.random.RandomState(4)
    rows = [{"img": (rng.randn(12) + 0.5).astype(np.float32)}
            for _ in range(3)]
    assert_match(*run_both(build, rows, ["out"]))


def _ssd(pkg, num_classes=3, two_maps=True):
    """Feature maps 8 x 4 x 4 (and 8 x 2 x 2) of a 3 x 16 x 16 image,
    3 x 3 loc and conf convs (the loc one in the K7 family), priorbox
    tables of 2 priors a cell."""
    img = pkg.layer.data(name="img",
                         type=pkg.data_type.dense_vector(3 * 16 * 16),
                         height=16, width=16)
    maps = [pkg.layer.data(name="f1",
                           type=pkg.data_type.dense_vector(8 * 4 * 4),
                           height=4, width=4)]
    if two_maps:
        maps.append(pkg.layer.data(name="f2",
                                   type=pkg.data_type.dense_vector(8 * 2 * 2),
                                   height=2, width=2))
    locs, confs, priors = [], [], []
    for i, fmap in enumerate(maps):
        priors.append(pkg.layer.priorbox(
            input=fmap, image=img, min_size=[4 + 4 * i], max_size=None,
            aspect_ratio=[2.0], variance=[0.1, 0.1, 0.2, 0.2]))
        per_cell = priors[-1].num_priors // (16 // 4 ** i)
        locs.append(pkg.layer.img_conv(input=fmap, filter_size=3, padding=1,
                                       num_filters=per_cell * 4,
                                       name="loc%d" % i))
        confs.append(pkg.layer.img_conv(input=fmap, filter_size=3,
                                        padding=1,
                                        num_filters=per_cell * num_classes,
                                        name="conf%d" % i))
    return locs, confs, priors


def _gt_rows(seed, n_images, num_classes=3, with_difficult=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_images):
        rows = []
        for _ in range(rng.randint(1, 6)):
            lo = rng.rand(2) * 0.6
            rows.append([float(rng.randint(1, num_classes)), lo[0], lo[1],
                         lo[0] + 0.15 + rng.rand() * 0.25,
                         lo[1] + 0.15 + rng.rand() * 0.25,
                         float(with_difficult and rng.rand() < 0.3)])
        out.append(np.asarray(rows, np.float32))
    return out


def _ssd_rows(seed, n=2, **kw):
    rng = np.random.RandomState(seed)
    gts = _gt_rows(seed + 1, n, **kw)
    return [{"img": np.zeros(768, np.float32),
             "f1": rng.randn(128).astype(np.float32),
             "f2": rng.randn(32).astype(np.float32), "gt": gts[b]}
            for b in range(n)]


@pytest.mark.parametrize("case", ["one_map", "two_maps", "tied_conf"])
def test_multibox_loss_matches_jax(case):
    def build(pkg):
        locs, confs, priors = _ssd(pkg, two_maps=case != "one_map")
        gt = pkg.layer.data(name="gt",
                            type=pkg.data_type.dense_vector_sequence(6))
        return pkg.layer.multibox_loss(
            input_loc=locs, input_conf=confs, priorbox=priors, label=gt,
            num_classes=3, name="out")

    params = None
    if case == "tied_conf":  # every conf 0: the negatives tie everywhere
        jout, out = both(build)
        params = numpy_params(Topology(out).param_specs(), 0)
        params = {k: (np.zeros_like(v) if k.startswith("conf") else v)
                  for k, v in params.items()}
    assert_match(*run_both(build, _ssd_rows(5, n=3), ["out"],
                           params=params))


@pytest.mark.parametrize("case", ["random", "tied_conf"])
def test_detection_output_matches_jax(case):
    def build(pkg):
        locs, confs, priors = _ssd(pkg)
        return pkg.layer.detection_output(
            input_loc=locs, input_conf=confs, priorbox=priors, num_classes=3,
            nms_threshold=0.45, nms_top_k=12, keep_top_k=20,
            confidence_threshold=0.01, name="out")

    _, out = both(build)
    params = numpy_params(Topology(out).param_specs(), 6, scale=3.0)
    if case == "tied_conf":
        params = {k: (np.zeros_like(v) if k.startswith("conf") else v)
                  for k, v in params.items()}
    (values, _), (jvalues, _) = run_both(build, _ssd_rows(7), ["out"],
                                         params=params, mode="test",
                                         loss=False)
    got, want = values["out"], jvalues["out"]
    assert got.shape == want.shape == (2, 20, 7)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    assert rel(got, want) <= TOL_FWD
    kept = got[..., 1] >= 0
    assert kept.any() and ((got[kept][:, 3:] >= 0) & (got[kept][:, 3:] <= 1)
                           ).all()


def test_detection_output_pads_short_results_with_minus_one():
    def build(pkg):
        locs, confs, priors = _ssd(pkg, two_maps=False)
        return pkg.layer.detection_output(
            input_loc=locs, input_conf=confs, priorbox=priors, num_classes=3,
            nms_top_k=5, keep_top_k=30, name="out")

    (values, _), (jvalues, _) = run_both(build, _ssd_rows(8), ["out"],
                                         mode="test", loss=False)
    np.testing.assert_array_equal(values["out"], jvalues["out"])
    assert (values["out"][:, 10:] == -1.0).all()  # 2 classes x 5 kept


# -- evaluator.detection_map -------------------------------------------------

def _map_net(pkg, evaluate_difficult, ap_type):
    locs, confs, priors = _ssd(pkg)
    det = pkg.layer.detection_output(
        input_loc=locs, input_conf=confs, priorbox=priors, num_classes=3,
        nms_top_k=30, keep_top_k=40, confidence_threshold=0.05, name="det")
    gt = pkg.layer.data(name="gt",
                        type=pkg.data_type.dense_vector_sequence(6))
    return pkg.evaluator.detection_map(
        input=det, label=gt, overlap_threshold=0.3,
        evaluate_difficult=evaluate_difficult, ap_type=ap_type, name="map")


def _map_params(topology, seed):
    """Loc convs zero (the detections are the priors), conf biases and
    weights that score the priors unevenly."""
    params = numpy_params(topology.param_specs(), seed, scale=2.0)
    return {k: (np.zeros_like(v) if k.startswith("loc") else v)
            for k, v in params.items()}


@pytest.mark.parametrize("evaluate_difficult", [False, True])
@pytest.mark.parametrize("ap_type", ["11point", "integral"])
def test_detection_map_matches_jax(evaluate_difficult, ap_type):
    jmap, pmap = both(lambda pkg: _map_net(pkg, evaluate_difficult, ap_type))
    topo, jtopo = Topology(pmap), JaxTopology(jmap)
    arrays = _map_params(topo, 9)
    rows = _ssd_rows(10, n=4, with_difficult=True)
    # half the ground truth on the prior boxes, so detections hit
    priors = np.concatenate([
        paddle.layer.detection._make_priors(4, 4, 16, 16, [4], None, [2.0],
                                            [0.1] * 4),
        paddle.layer.detection._make_priors(2, 2, 16, 16, [8], None, [2.0],
                                            [0.1] * 4)])[:, :4]
    rng = np.random.RandomState(11)
    for row in rows:
        pick = rng.choice(len(priors), size=len(row["gt"]), replace=False)
        row["gt"][::2, 1:5] = priors[pick][::2]
    names = [n for n, _ in topo.data_types()]
    tuples = [tuple(r[n] for n in names) for r in rows]
    stats = topo.apply({k: torch.from_numpy(v) for k, v in arrays.items()},
                       convert_feed(topo, tuples, device="cpu"),
                       mode="test")[0]["map"]
    jstats = jtopo.apply({k: jnp.asarray(v) for k, v in arrays.items()},
                         jax_convert_feed(jtopo, tuples), mode="test")[0][
        "map"]
    for key in jstats:
        if key == "rows_score":
            assert rel(stats[key].numpy(), np.asarray(jstats[key])) \
                <= TOL_FWD
        else:
            np.testing.assert_array_equal(stats[key].numpy(),
                                          np.asarray(jstats[key]),
                                          err_msg=key)
    assert stats["tp"].any()
    host = host_stats(stats)  # the trainer's merge takes host arrays
    got = pmap.result(pmap.merge(pmap.merge(None, host), host))
    want = jmap.result(jmap.merge(jmap.merge(None, jstats), jstats))
    assert 0.0 < want < 1.0
    assert abs(got - want) <= 1e-6


def test_detection_map_is_an_evaluator_as_in_jax():
    pmap, jmap = (_map_net(pkg, False, "11point")
                  for pkg in (paddle, jpaddle))
    assert pmap.is_evaluator and jmap.is_evaluator
    assert pmap.result(None) == jmap.result(None) == 0.0
