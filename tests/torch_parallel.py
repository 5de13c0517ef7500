"""Shared rig of tests/test_torch_parallel.py: the port's tensor, sequence,
pipeline and sharded-embedding parallelism run by the ranks of a gloo
process group on the CPU, spawned as ``python -m tests.torch_parallel
RANK WORLD PORT OUTDIR`` (every case of that world size in one set of
processes; each rank writes ``OUTDIR/<case>-<rank>.npz``).

The inputs come from numpy seeds (``inputs``), so the test process feeds
the JAX package the same ones. Each case saves what the test compares:
this rank's block of a result, and the gradients of the global inputs
(whole on every rank). The rank processes import neither JAX nor the JAX
package.

World 2: ``attn`` at {"seq": 2}; ``ctr`` (the sharded Wide&Deep CTR) at
{"data": 1, "model": 2}. World 4: ``pair`` and ``tp_rules`` at {"model":
4}, ``pipeline`` at {"pipe": 4}, ``lookup`` and ``emb_layer`` at
{"model": 4}, ``flagship`` (the sharded flagship) and ``checkpoint``
(its checkpoints and resume) at {"data": 2, "model": 2}. World 8: ``attn`` at {"seq": 8}, ``pair_dp`` at {"data": 2,
"model": 4}, ``fc_stack`` (ExtraAttr(sharding=)) at {"model": 8},
``transformer`` at {"data": 2, "model": 2, "pipe": 2}.
"""

import os
import sys

import numpy as np

CASES = {2: ("attn", "ctr"),
         4: ("pair", "tp_rules", "pipeline", "lookup", "emb_layer",
             "flagship", "checkpoint"),
         8: ("attn", "pair_dp", "fc_stack", "transformer")}
ATTN = dict(B=2, L=32, H=8, D=16)
FLAGSHIP = dict(dict_size=64, emb=8, hidden=16, classes=2)
CTR = dict(sparse_dim=500, field_dims=(50, 40, 10), emb=8, hidden=(16, 8))
TRANSFORMER = dict(vocab=32, emb=8, heads=2, classes=3, n_micro=2)
LR = 0.1


def inputs(case):
    """The numpy inputs of ``case`` (the same on both sides)."""
    rng = np.random.RandomState(sorted({c for cs in CASES.values()
                                        for c in cs}).index(case) + 3)

    def f32(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype(np.float32)

    if case == "attn":
        b, l, h, d = (ATTN[k] for k in "BLHD")
        return {"q": f32(b, l, h, d), "k": f32(b, l, h, d),
                "v": f32(b, l, h, d)}
    if case in ("pair", "pair_dp"):
        rows = 6 if case == "pair" else 8
        return {"x": f32(rows, 10), "w1": f32(10, 16, scale=0.3),
                "b1": f32(16, scale=0.1), "w2": f32(16, 5, scale=0.3),
                "b2": f32(5, scale=0.1)}
    if case == "pipeline":
        return {"w": f32(4, 8, 8, scale=0.2), "b": f32(4, 8, scale=0.1),
                "xs": f32(3, 2, 8)}
    if case == "lookup":
        return {"table": f32(64, 5), "ids": rng.randint(0, 64, (4, 7)),
                "gtable": f32(32, 4), "gids": rng.randint(0, 32, (6,)),
                "tgt": f32(6, 4)}
    if case == "emb_layer":
        return {"ids": rng.randint(0, 64, (6,)).astype(np.int32)}
    if case == "fc_stack":
        return {"x": f32(8, 16)}
    if case == "transformer":
        e, c, v = (TRANSFORMER[k] for k in ("emb", "classes", "vocab"))
        return {"embed": f32(v, e), "qkv_w": f32(e, 3 * e, scale=0.35),
                "proj_w": f32(e, e, scale=0.35),
                "head_w1": f32(e, 2 * e, scale=0.35),
                "head_b1": np.zeros(2 * e, np.float32),
                "head_w2": f32(2 * e, c, scale=0.25),
                "head_b2": np.zeros(c, np.float32),
                "pipe.w": f32(2, e, e, scale=0.35),
                "pipe.b": np.zeros((2, e), np.float32),
                "tokens": rng.randint(0, v, (4, 8)).astype(np.int32),
                "labels": rng.randint(0, c, (4,)).astype(np.int32)}
    if case == "flagship":
        batches = []
        for _ in range(2):
            lens = rng.randint(1, 11, 8)
            batches.append([(rng.randint(0, FLAGSHIP["dict_size"],
                                         int(n)).tolist(),
                             int(rng.randint(2))) for n in lens])
        return {"batches": batches}
    if case == "ctr":
        batches = []
        for _ in range(2):
            batches.append([(sorted(set(rng.randint(0, 300, rng.randint(
                1, 9)).tolist())), int(rng.randint(50)),
                int(rng.randint(40)), int(rng.randint(10)),
                np.array([float(rng.randint(2))], np.float32))
                for _ in range(8)])
        return {"batches": batches}
    raise KeyError(case)


def numpy_params(specs, seed=5):
    """Standard-normal parameters times 0.3 by sorted name (global
    shapes)."""
    rng = np.random.RandomState(seed)
    return {name: (rng.standard_normal(spec.shape) * 0.3).astype(np.float32)
            for name, spec in sorted(specs.items())}


def fc_stack(pkg, with_sharding=True):
    """tests/test_layer_sharding.py's stack: fc 32 sharded on its features,
    fc 32 replicated, fc 32 sharded again, fc 4."""
    from importlib import import_module

    import_module(pkg.__name__ + ".graph").reset_name_counters()
    L, dt, attr = pkg.layer, pkg.data_type, pkg.attr
    sh = ((lambda *s: attr.ExtraAttr(sharding=s)) if with_sharding
          else (lambda *s: None))
    x = L.data(name="x", type=dt.dense_vector(16))
    h1 = L.fc(input=x, size=32, name="sh_fc1", layer_attr=sh(None, "model"))
    h2 = L.fc(input=h1, size=32, name="sh_fc2", layer_attr=sh(None, None))
    h3 = L.fc(input=h2, size=32, name="sh_fc3", layer_attr=sh(None, "model"))
    return L.fc(input=h3, size=4, name="sh_out")


def emb_layer(pkg, mesh):
    """ids -> sharded embedding (dim 5) -> fc 3."""
    from importlib import import_module

    import_module(pkg.__name__ + ".graph").reset_name_counters()
    se = import_module(pkg.__name__ + ".parallel.sharded_embedding")
    ids = pkg.layer.data(name="ids", type=pkg.data_type.integer_value(64))
    emb = se.sharded_embedding_layer(ids, 5, mesh, axis="model",
                                     name="semb")
    return pkg.layer.fc(input=emb, size=3, name="semb_out")


# -- the rank side ------------------------------------------------------------

def _t(a, grad=False):
    import torch

    return torch.tensor(a, requires_grad=grad)


def _np(t):
    return t.detach().numpy()


def run_attn(mesh, world):
    from paddle_tpu_torch.parallel import ring_attention, ulysses_attention

    out = {}
    data = inputs("attn")
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for causal in (False, True):
            q, k, v = (_t(data[n], True) for n in "qkv")
            got = fn(q, k, v, mesh, seq_axis="seq", causal=causal)
            (got ** 2).sum().backward()
            key = "%s_%d_" % (name, causal)
            out[key + "out"] = _np(got)
            for n, t in zip("qkv", (q, k, v)):
                out[key + "g" + n] = _np(t.grad)
    return out


def run_pair(mesh, batch_axis=None, case="pair"):
    from paddle_tpu_torch.parallel import megatron_dense_pair

    data = {k: _t(v, True) for k, v in inputs(case).items()}
    got = megatron_dense_pair(data["x"], data["w1"], data["b1"], data["w2"],
                              data["b2"], mesh, batch_axis=batch_axis)
    (got ** 2).sum().backward()
    out = {"out": _np(got)}
    out.update({"g" + k: _np(v.grad) for k, v in data.items()})
    return out


def run_tp_rules(mesh):
    import torch

    from paddle_tpu_torch.parallel import TensorParallel
    from paddle_tpu_torch.parallel.mesh import P

    tp = TensorParallel(mesh, rules=[("fc.w", P(None, "model"))])
    params = {"fc.w": torch.arange(64.0).reshape(8, 8),
              "fc.b": torch.arange(8.0)}
    sh = tp.param_shardings(params)
    placed = tp.place(params)
    return {"w_spec": np.array(repr(sh["fc.w"].spec)),
            "b_spec": np.array(repr(sh["fc.b"].spec)),
            "w": _np(placed["fc.w"]), "b": _np(placed["fc.b"]),
            "w_gathered": _np(sh["fc.w"].gather(placed["fc.w"]))}


def run_pipeline(mesh):
    from paddle_tpu_torch.parallel import pipeline_apply

    data = {k: _t(v, True) for k, v in inputs("pipeline").items()}
    stacked = {"w": data["w"], "b": data["b"]}

    def stage(p, x):
        import torch

        return x + torch.tanh(x @ p["w"] + p["b"])

    got = pipeline_apply(stage, stacked, data["xs"], mesh)
    (got ** 2).sum().backward()
    return {"out": _np(got), "gw": _np(data["w"].grad),
            "gb": _np(data["b"].grad), "gxs": _np(data["xs"].grad)}


def run_lookup(mesh):
    import torch

    from paddle_tpu_torch.parallel.sharded_embedding import sharded_lookup

    data = inputs("lookup")
    got = sharded_lookup(_t(data["table"]), torch.tensor(data["ids"]), mesh,
                         "model")
    table = _t(data["gtable"], True)
    loss = ((sharded_lookup(table, torch.tensor(data["gids"]), mesh, "model")
             - _t(data["tgt"])) ** 2).sum()
    loss.backward()
    return {"out": _np(got), "gtable": _np(table.grad)}


def run_emb_layer(mesh):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology

    out_layer = emb_layer(paddle, mesh)
    topo = Topology(out_layer)
    specs = topo.param_specs()
    params = Parameters(params_from_numpy(numpy_params(specs), topo,
                                          device="cpu"), specs)
    values = {k: v.clone().requires_grad_()
              for k, v in params.as_dict().items()}
    got, _ = topo.apply(values, {"ids": inputs("emb_layer")["ids"]},
                        mode="train")
    y = got[out_layer.name]
    (y ** 2).sum().backward()
    table = specs["semb.w0"].sharding
    return {"out": _np(y), "table_rows": np.array(values["semb.w0"].shape),
            "g_semb.w0": _np(table.gather(values["semb.w0"].grad)),
            **{"g_" + k: _np(v.grad) for k, v in values.items()
               if k != "semb.w0"},
            "table_get": params.get("semb.w0")}


def run_fc_stack(mesh):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.parallel import use_mesh
    from paddle_tpu_torch.topology import Topology

    out_layer = fc_stack(paddle)
    topo = Topology(out_layer)
    values = {k: v.requires_grad_() for k, v in params_from_numpy(
        numpy_params(topo.param_specs()), topo, device="cpu").items()}
    feed = {"x": inputs("fc_stack")["x"]}
    with use_mesh(mesh):
        got, _ = topo.apply(values, feed, mode="test")
        train, _ = topo.apply(values, feed, mode="train")
    (train[out_layer.name] ** 2).sum().backward()
    return {"out": _np(got[out_layer.name]),
            **{"g_" + k: _np(v.grad) for k, v in values.items()}}


def run_transformer(mesh):
    import torch

    from paddle_tpu_torch.models.transformer import ParallelTransformer

    data = inputs("transformer")
    out = {}
    for attention in ("ring", "ulysses"):
        model = ParallelTransformer(mesh, attention=attention, **TRANSFORMER)
        glob = {k: _t(data[k]) for k in data
                if k not in ("tokens", "labels") and not k.startswith("pipe")}
        glob["pipe"] = {"w": _t(data["pipe.w"]), "b": _t(data["pipe.b"])}
        tokens = torch.tensor(data["tokens"])
        out[attention + "_out"] = _np(model.apply(model.place(glob), tokens))
        out[attention + "_ref"] = _np(model.apply_reference(glob, tokens))
        if attention != "ring":
            continue
        params = model.place(glob)
        shardings = model.param_shardings(glob)
        losses = []
        for _ in range(2):
            leaves = {k: v.requires_grad_() for k, v in params.items()
                      if k != "pipe"}
            leaves.update({"pipe." + k: v.requires_grad_()
                           for k, v in params["pipe"].items()})
            loss = model.loss(params, tokens, torch.tensor(data["labels"]))
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss))
            new = {k: (v - LR * g).detach()
                   for (k, v), g in zip(leaves.items(), grads)}
            params = {k: v for k, v in new.items()
                      if not k.startswith("pipe.")}
            params["pipe"] = {"w": new["pipe.w"], "b": new["pipe.b"]}
        out["losses"] = np.array(losses)
        for k, v in params.items():
            if k == "pipe":
                for kk, vv in v.items():
                    out["p_pipe." + kk] = _np(shardings["pipe"][kk].gather(vv))
            else:
                out["p_" + k] = _np(shardings[k].gather(v))
    return out


def run_trainer(case, mesh):
    """The sharded flagship or CTR trained 2 Momentum steps under
    DataParallel on ``mesh``: costs, the global parameters, and the
    shapes each rank holds of the table and its slot."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.models import recommender, text
    from paddle_tpu_torch.parallel import DataParallel
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology

    if case == "flagship":
        cost = text.flagship(sharded_emb_mesh=mesh, **FLAGSHIP)[3]
        table = "flag_emb.w0"
        feeding = None
    else:
        from paddle_tpu_torch.graph import reset_name_counters

        reset_name_counters()
        cost = recommender.wide_deep_ctr(sharded_mesh=mesh, **CTR)[2]
        table = "ctr_field0_emb.w0"
        feeding = {"wide_features": 0, "field0": 1, "field1": 2,
                   "field2": 3, "click": 4}
    topo = Topology(cost)
    specs = topo.param_specs()
    params = Parameters(params_from_numpy(numpy_params(specs), topo,
                                          device="cpu"), specs)
    trainer = paddle.trainer.SGD(
        cost, params, opt.Momentum(learning_rate=LR, momentum=0.9),
        parallelism=DataParallel(mesh), device="cpu")
    costs = []

    def handler(evt):
        if isinstance(evt, paddle.event.EndIteration):
            costs.append(evt.cost)

    data = inputs(case)["batches"]
    trainer.train(lambda: iter(data), num_passes=1, event_handler=handler,
                  feeding=feeding)
    from paddle_tpu_torch.trainer import _tree_tensors

    slots = _tree_tensors(trainer._opt_state["slots"][table])
    return {"costs": np.array(costs),
            "table_local": np.array(params.as_dict()[table].shape),
            "slot_local": np.array([t.shape for t in slots]),
            **{"p_" + n: params.get(n) for n in params.names()}}


def run_checkpoint(mesh, outdir):
    """The sharded flagship's checkpoints: trainer A takes 2 steps under
    ``checkpoint_every=1`` (the overlapped writer, into ``ckpt-async``)
    and then a blocking ``save_checkpoint`` (into ``ckpt-sync``); trainer
    B, from other parameters, resumes ``ckpt-async`` and trains the
    second pass; trainer C trains both passes without a break. Saves B's
    and C's costs and parameters, B's held shapes, whether this rank
    wrote, and whether ``save_checkpoint(coordinator=)`` was refused."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as opt
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.models import text
    from paddle_tpu_torch.parallel import DataParallel
    from paddle_tpu_torch.parameters import Parameters
    from paddle_tpu_torch.topology import Topology
    from paddle_tpu_torch.trainer import _tree_tensors
    from paddle_tpu_torch.utils.error import EnforceError

    cost = text.flagship(sharded_emb_mesh=mesh, **FLAGSHIP)[3]
    topo = Topology(cost)
    specs = topo.param_specs()
    data = inputs("flagship")["batches"]

    def trainer(seed):
        params = Parameters(params_from_numpy(numpy_params(specs, seed),
                                              topo, device="cpu"), specs)
        return params, paddle.trainer.SGD(
            cost, params, opt.Momentum(learning_rate=LR, momentum=0.9),
            parallelism=DataParallel(mesh), device="cpu")

    def train(tr, **kw):
        costs = []

        def handler(evt):
            if isinstance(evt, paddle.event.EndIteration):
                costs.append(evt.cost)

        tr.train(lambda: iter(data), event_handler=handler, **kw)
        return costs

    async_dir = os.path.join(outdir, "ckpt-async")
    _, a = trainer(5)
    train(a, num_passes=1, checkpoint_dir=async_dir, checkpoint_every=1)
    wrote = a.save_checkpoint(os.path.join(outdir, "ckpt-sync"), pass_id=0,
                              resume_at=(0, len(data)))
    try:
        a.save_checkpoint(os.path.join(outdir, "ckpt-elected"),
                          coordinator=object())
        refused = False
    except EnforceError:
        refused = True
    b_params, b = trainer(9)
    b_costs = train(b, num_passes=2, checkpoint_dir=async_dir, resume=True)
    c_params, c = trainer(5)
    c_costs = train(c, num_passes=2)
    table = "flag_emb.w0"
    return {"b_costs": np.array(b_costs), "c_costs": np.array(c_costs),
            "wrote": np.array(wrote is not None), "refused": np.array(refused),
            "b_table_local": np.array(b_params.as_dict()[table].shape),
            "b_slot_local": np.array([t.shape for t in _tree_tensors(
                b._opt_state["slots"][table])]),
            **{"b_" + n: b_params.get(n) for n in b_params.names()},
            **{"c_" + n: c_params.get(n) for n in c_params.names()}}


def run(case, mesh_axes, world, outdir):
    from paddle_tpu_torch.parallel import build_mesh

    mesh = build_mesh(mesh_axes)
    if case == "checkpoint":
        return run_checkpoint(mesh, outdir)
    if case == "attn":
        return run_attn(mesh, world)
    if case == "pair":
        return run_pair(mesh)
    if case == "pair_dp":
        return run_pair(mesh, batch_axis="data", case="pair_dp")
    if case == "tp_rules":
        return run_tp_rules(mesh)
    if case == "pipeline":
        return run_pipeline(mesh)
    if case == "lookup":
        return run_lookup(mesh)
    if case == "emb_layer":
        return run_emb_layer(mesh)
    if case == "fc_stack":
        return run_fc_stack(mesh)
    if case == "transformer":
        return run_transformer(mesh)
    return run_trainer(case, mesh)


MESHES = {(2, "attn"): {"seq": 2}, (2, "ctr"): {"data": 1, "model": 2},
          (4, "pipeline"): {"pipe": 4},
          (4, "flagship"): {"data": 2, "model": 2},
          (4, "checkpoint"): {"data": 2, "model": 2},
          (8, "attn"): {"seq": 8}, (8, "pair_dp"): {"data": 2, "model": 4},
          (8, "transformer"): {"data": 2, "model": 2, "pipe": 2}}


def mesh_of(world, case):
    return MESHES.get((world, case), {"model": world})


def main(argv):
    rank, world, port, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    import torch.distributed as dist

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.multihost import initialize_multihost

    paddle.init(use_tpu=False)
    assert initialize_multihost("127.0.0.1:" + port, world, rank)
    for case in CASES[world]:
        np.savez(os.path.join(outdir, "%s-%d.npz" % (case, rank)),
                 **run(case, mesh_of(world, case), world, outdir))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
