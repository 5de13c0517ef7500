"""Long-context parallel transformer: the framework's scale showcase
(paddle_tpu/models/transformer.py).

Composes every parallelism axis of the port in one train step, over a mesh
of ``data`` x ``model`` x ``pipe`` ranks:

- dp: the batch rows split over ``data``;
- ep: the embedding table vocab-sharded over ``model``;
- sp: ring (or Ulysses) causal self-attention with the sequence split
  over ``model`` (Megatron-SP style: sp rides the tp axis);
- tp: the Megatron column -> row classifier pair over ``model``;
- pp: the GPipe pipeline of residual MLP blocks over ``pipe``.

The model: token embedding -> multi-head causal self-attention -> N
pipelined residual MLP blocks -> mean-pool -> tp-sharded classifier head.

The JAX package writes the program once and lets GSPMD place the
collectives; here each rank runs its block of the work and the
collectives are explicit (parallel/collectives.py). The attention's
``qkv_w`` and ``proj_w`` are replicated over ``model`` (each rank
projects its own sequence chunk), where the JAX package declares them
column- and row-parallel and lets GSPMD gather them; their gradient is
summed over ``model`` and ``data``. ``loss`` is the global mean, and its
backward gives every rank the whole gradient of the global loss for the
parameters it holds (its blocks of the sharded ones).
"""

import numpy as np
import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.parallel.collectives import (copy_to, reduce_from,
                                                   reduce_scatter)
from paddle_tpu_torch.parallel.context_parallel import (full_attention,
                                                        ring_local,
                                                        ulysses_local)
from paddle_tpu_torch.parallel.mesh import NamedSharding, P
from paddle_tpu_torch.parallel.pipeline import (pipeline_local,
                                                stack_stage_params, tree_map)
from paddle_tpu_torch.parallel.tensor_parallel import pair_local
from paddle_tpu_torch.utils.error import enforce


def _stage(p, t):
    return t + torch.tanh(torch.matmul(t, p["w"]) + p["b"])


class ParallelTransformer:
    """See the module docstring. Axis names are configurable; the mesh
    gives their sizes. ``n_micro`` microbatches stream the pipeline."""

    def __init__(self, mesh, vocab=128, emb=16, heads=4, classes=4,
                 n_micro=2, data_axis="data", model_axis="model",
                 pipe_axis="pipe", attention="ring"):
        enforce(emb % heads == 0, "heads %d must divide emb %d", heads, emb)
        enforce(attention in ("ring", "ulysses"),
                "unknown attention strategy %r", attention)
        self.mesh = mesh
        self.vocab, self.emb, self.heads, self.classes = (vocab, emb, heads,
                                                          classes)
        self.head_dim = emb // heads
        self.n_micro = n_micro
        self.data_axis, self.model_axis, self.pipe_axis = (
            data_axis, model_axis, pipe_axis)
        self.n_pipe = mesh.shape[pipe_axis]
        self.attention = attention

    # parameters -------------------------------------------------------------
    def init_params(self, rng, device=None):
        """Global parameters on ``device`` (the default device unless
        given), drawn from ``rng``: an int seed or a ``torch.Generator``
        (a JAX key cannot cross; the shapes and scales are the JAX
        package's)."""
        gen = (rng if isinstance(rng, torch.Generator)
               else torch.Generator().manual_seed(int(rng)))
        device = resolve_device(device)
        e = self.emb

        def dense(shape, scale=None):
            scale = scale or (1.0 / np.sqrt(shape[0]))
            return (torch.randn(shape, generator=gen) * scale).to(device)

        def zeros(n):
            return torch.zeros(n, device=device)

        params = {"embed": dense((self.vocab, e), 1.0),
                  "qkv_w": dense((e, 3 * e)),
                  "proj_w": dense((e, e)),
                  "head_w1": dense((e, 2 * e)),
                  "head_b1": zeros(2 * e),
                  "head_w2": dense((2 * e, self.classes)),
                  "head_b2": zeros(self.classes)}
        params["pipe"] = stack_stage_params(
            [{"w": dense((e, e)), "b": zeros(e)} for _ in range(self.n_pipe)])
        return params

    def param_shardings(self, params):
        """The port's layout, as NamedShardings: the table vocab-sharded
        (ep), the head pair column- then row-parallel (tp), the stages
        over ``pipe`` (pp), the rest replicated."""
        mesh, ma, pa = self.mesh, self.model_axis, self.pipe_axis

        def s(*spec):
            return NamedSharding(mesh, P(*spec))

        return {"embed": s(ma, None), "qkv_w": s(), "proj_w": s(),
                "head_w1": s(None, ma), "head_b1": s(ma),
                "head_w2": s(ma, None), "head_b2": s(),
                "pipe": tree_map(lambda l: s(*((pa,) + (None,)
                                               * (l.dim() - 1))),
                                 params["pipe"])}

    def place(self, params):
        """This rank's block of every parameter (copies, so the global
        tensors can be freed)."""
        return tree_map(lambda v, sh: sh.shard(v.detach()).clone(), params,
                        self.param_shardings(params))

    def _local(self, params):
        """Blocks as ``place`` gives them: a global tensor is split
        differentiably (its gradient is gathered back whole)."""
        shardings = self.param_shardings(params)
        e = self.emb
        shapes = {"embed": (self.vocab, e), "qkv_w": (e, 3 * e),
                  "proj_w": (e, e), "head_w1": (e, 2 * e),
                  "head_b1": (2 * e,), "head_w2": (2 * e, self.classes),
                  "head_b2": (self.classes,), "pipe.w": (self.n_pipe, e, e),
                  "pipe.b": (self.n_pipe, e)}
        out = {k: shardings[k].block(params[k], shapes[k], grad=True)
               for k in params if k != "pipe"}
        out["pipe"] = {k: shardings["pipe"][k].block(
            params["pipe"][k], shapes["pipe." + k], grad=True)
            for k in params["pipe"]}
        return out

    # forward ----------------------------------------------------------------
    def _rows(self, x):
        """This rank's rows of a global [B, ...] tensor (its ``data``
        block)."""
        dp = self.mesh.axis(self.data_axis)
        enforce(x.shape[0] % dp.size == 0, "data axis %d must divide batch "
                "%d", dp.size, x.shape[0])
        return x.chunk(dp.size, 0)[dp.index]

    def apply(self, params, tokens):
        """tokens [B, L] int (global) -> logits [B/D, classes]: this rank's
        rows (its block of the ``data`` axis), replicated over ``model``
        and ``pipe``. ``params`` global or placed."""
        dp = self.mesh.axis(self.data_axis)
        mp = self.mesh.axis(self.model_axis)
        pp = self.mesh.axis(self.pipe_axis)
        b_all, l = tokens.shape
        enforce(l % mp.size == 0, "model axis %d must divide seq len %d",
                mp.size, l)
        enforce(b_all % self.n_micro == 0,
                "microbatch count %d must divide batch %d", self.n_micro,
                b_all)
        enforce(self.n_micro % dp.size == 0,
                "data axis %d must divide microbatch count %d (each data "
                "shard pipelines its own microbatches)", dp.size,
                self.n_micro)
        p = self._local(params)

        def shared(w):
            # a weight used on this rank's rows and sequence chunk: its
            # gradient summed over both axes
            return copy_to(copy_to(w, dp), mp)

        tokens = self._rows(torch.as_tensor(tokens, device=p["embed"].device))
        b, lc = tokens.shape[0], l // mp.size
        e, h, hd = self.emb, self.heads, self.head_dim
        # ep: this rank's table rows for every position of its rows, summed
        # over the model axis and split there along the sequence (sp)
        rows = self.vocab // mp.size
        ids = tokens.long().clamp(0, self.vocab - 1) - mp.index * rows
        table = copy_to(p["embed"], dp)
        got = table[ids.clamp(0, rows - 1)]
        got = torch.where(((ids >= 0) & (ids < rows))[..., None], got,
                          torch.zeros_like(got))
        x = reduce_scatter(got, mp, 1)                       # [b, lc, e]
        # sp: causal self-attention over the sequence chunks
        q, k, v = torch.matmul(x, shared(p["qkv_w"])).split(e, dim=-1)
        attend = ring_local if self.attention == "ring" else ulysses_local
        attn = attend(q.reshape(b, lc, h, hd), k.reshape(b, lc, h, hd),
                      v.reshape(b, lc, h, hd), mp, causal=True)
        x = x + torch.matmul(attn.reshape(b, lc, e), shared(p["proj_w"]))
        # pp: each data rank pipelines its own microbatches
        mb = b_all // self.n_micro
        xs = x.reshape(self.n_micro // dp.size, mb, lc, e)
        stage = tree_map(lambda w: shared(w)[0], p["pipe"])
        x = pipeline_local(_stage, stage, xs, pp).reshape(b, lc, e)
        # mean-pool over the whole sequence + the tp classifier pair
        pooled = reduce_from(x.sum(dim=1), mp) / l
        return pair_local(pooled, copy_to(p["head_w1"], dp),
                          copy_to(p["head_b1"], dp),
                          copy_to(p["head_w2"], dp),
                          copy_to(p["head_b2"], dp), mp)

    def loss(self, params, tokens, labels):
        """The global batch's mean cross entropy, the same on every rank;
        its backward gives each rank the global loss's gradient of the
        parameters it holds."""
        logits = self.apply(params, tokens)
        labels = self._rows(torch.as_tensor(labels,
                                            device=logits.device)).long()
        logp = torch.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, labels[:, None]).sum() / tokens.shape[0]
        return reduce_from(nll, self.mesh.axis(self.data_axis))

    # reference (unsharded) path for equivalence tests -----------------------
    def apply_reference(self, params, tokens):
        b, l = tokens.shape
        e, h, hd = self.emb, self.heads, self.head_dim
        tokens = torch.as_tensor(tokens, device=params["embed"].device)
        x = params["embed"][tokens.long()]
        q, k, v = torch.matmul(x, params["qkv_w"]).split(e, dim=-1)
        attn = full_attention(q.reshape(b, l, h, hd), k.reshape(b, l, h, hd),
                              v.reshape(b, l, h, hd), causal=True)
        x = x + torch.matmul(attn.reshape(b, l, e), params["proj_w"])
        for i in range(self.n_pipe):
            x = _stage({"w": params["pipe"]["w"][i],
                        "b": params["pipe"]["b"][i]}, x)
        pooled = x.mean(dim=1)
        hmid = torch.tanh(pooled @ params["head_w1"] + params["head_b1"])
        return hmid @ params["head_w2"] + params["head_b2"]
