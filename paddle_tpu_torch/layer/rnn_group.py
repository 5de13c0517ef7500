"""recurrent_group, memory and beam search (paddle_tpu/layer/rnn_group.py;
reference RecurrentGradientMachine and the recurrent_group / memory DSL).

The user's ``step`` function is traced ONCE into a step subgraph
(:class:`_StepProgram`): the nodes it builds are recorded by the group
trace stack of graph.py, and its inputs and memories are placeholders.
:func:`recurrent_group` evaluates that subgraph in a Python loop over the
timesteps, on time slices of the sequence inputs, with the memories
carried from step to step and frozen past each sequence's end
(``new * keep + old * (1 - keep)``); autograd records the loop. The group
node runs the loop once per ``Topology.apply``, and its output reads that
one run.

Step nodes that feed no memory (the NMT decoder's vocabulary fc) are not
part of the recurrence: they are hoisted out of the loop and applied once
to the stacked [B, T, ...] values (``_plan_hoisting``), one [B*T, H] x
[H, V] product in place of T thin ones that would each read the weight.

:func:`beam_search` runs the same step subgraph over a beam-expanded
batch: top-k pruning over [B, beam * V], eos handling, and memories
reordered by parent; it stops when every beam has finished.

Not ported yet: ``get_output`` of an inner layer, ``SubsequenceInput``
and nested (sub-sequence) inputs, which are refused, as are
``memory(is_seq=True)`` and ``boot_bias``; a step may read a layer from
outside its group only through a StaticInput or a memory's boot layer.
"""

import numpy as np
import torch

from paddle_tpu_torch.core import dtype as dtype_mod
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.sequence import SequenceBatch
from paddle_tpu_torch.graph import (Context, LayerNode, auto_name,
                                    begin_group, current_group, end_group)
from paddle_tpu_torch.layer.base import (data_of, is_seq, make_node,
                                         register_layer, to_list)
from paddle_tpu_torch.utils.error import enforce


class StaticInput:
    """An input visible unchanged at every step. With ``is_seq=True`` a
    sequence stays a SequenceBatch inside the step (the attention's
    encoder states, whose padding it masks)."""

    def __init__(self, input, is_seq=False, size=None):
        self.input = input
        self.is_seq = is_seq
        self.size = size or input.size


class GeneratedInput:
    """Generation-mode input of beam_search: at step t the embedding (the
    rows of the parameter ``embedding_name``) of the word generated at
    t-1, ``bos_id`` at step 0."""

    def __init__(self, size, embedding_name, embedding_size, bos_id=0,
                 eos_id=1):
        self.size = size  # vocabulary size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size
        self.bos_id = bos_id
        self.eos_id = eos_id


@register_layer("memory")
def memory(name, size, boot_layer=None, boot_with_const_value=None,
           is_seq=False, boot_bias=None):
    """The previous step's value of the step layer called ``name``; at the
    first step the boot layer's value, or ``boot_with_const_value``, or
    zeros. Must be called inside a recurrent_group step function."""
    group = current_group()
    enforce(group is not None, "memory() must be used inside "
            "recurrent_group")
    enforce(not is_seq, "memory(is_seq=True) is not ported yet")
    enforce(boot_bias is None, "memory(boot_bias=...) is not ported yet")

    def forward(params, values, ctx):  # replaced by the loop's carry
        raise AssertionError("memory placeholder evaluated outside its "
                             "group")

    node = LayerNode("memory_placeholder", forward, inputs=(), size=size)
    node.memory_of = name
    node.boot_layer = boot_layer
    node.boot_const = boot_with_const_value
    group["memories"].append(node)
    return node


def _step_input(size):
    def forward(params, values, ctx):
        raise AssertionError("step input evaluated outside its group")

    return LayerNode("step_input", forward, inputs=(), size=size)


class _StepProgram:
    """The traced step subgraph and its evaluation."""

    # step layers that may be hoisted out of the loop
    HOISTABLE_TYPES = ("fc", "mixed", "addto")

    def __init__(self, step, inputs, group_id):
        self.seq_inputs = []      # (outer LayerNode, placeholder)
        self.static_inputs = []   # (outer LayerNode, placeholder, is_seq)
        self.generated = None     # the GeneratedInput
        self.gen_placeholder = None

        frame = begin_group(group_id)
        try:
            placeholders = []
            for item in inputs:
                if isinstance(item, StaticInput):
                    ph = _step_input(item.size)
                    self.static_inputs.append((item.input, ph, item.is_seq))
                elif isinstance(item, GeneratedInput):
                    enforce(self.generated is None,
                            "only one GeneratedInput supported")
                    ph = _step_input(item.embedding_size)
                    self.generated, self.gen_placeholder = item, ph
                else:  # a sequence layer: one time slice per step
                    enforce(isinstance(item, LayerNode), "recurrent_group "
                            "input %r is not a layer, a StaticInput or a "
                            "GeneratedInput (nested inputs are not ported "
                            "yet)", item)
                    ph = _step_input(item.size)
                    self.seq_inputs.append((item, ph))
                placeholders.append(ph)
            self.outputs = to_list(step(*placeholders))
        finally:
            end_group()
        self.memories = frame["memories"]
        self.group_nodes = set(id(n) for n in frame["nodes"])

        self.step_order = []
        seen = set()

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            enforce(id(node) in self.group_nodes,
                    "the step of %r reads layer %r from outside the group: "
                    "pass it in as a StaticInput", group_id, node.name)
            for parent in node.inputs:
                visit(parent)
            self.step_order.append(node)

        for out in self.outputs:
            visit(out)
        # a memory binds by name to a step layer, which may lie off the
        # output path: its chain joins the step program too
        all_by_name = {n.name: n for n in frame["nodes"]}
        for m in self.memories:
            enforce(m.memory_of in all_by_name,
                    "memory(%r) does not match any layer in the step",
                    m.memory_of)
            visit(all_by_name[m.memory_of])
        self.by_name = {n.name: n for n in self.step_order}
        self.param_specs = [s for n in self.step_order
                            for s in n.param_specs]
        self._plan_hoisting()

    def _plan_hoisting(self):
        """Hoist the step nodes that are not part of the recurrence: fc or
        addto nodes outside every memory's ancestry whose in-step
        consumers are hoisted too and whose inputs all change per step
        (a static input would broadcast wrongly once stacked). Sets
        ``hoisted_ids``, ``hoisted_order`` and ``frontier``: the
        non-hoisted nodes whose stacked values the hoisted ones read."""
        core = set()  # memory ancestry: stays in the loop
        stack = [self.by_name[m.memory_of] for m in self.memories]
        while stack:
            n = stack.pop()
            if id(n) in core or id(n) not in self.group_nodes:
                continue
            core.add(id(n))
            stack.extend(n.inputs)
        static_ph = set(id(ph) for _, ph, _ in self.static_inputs)
        if self.gen_placeholder is not None:
            static_ph.add(id(self.gen_placeholder))
        consumers = {}
        for n in self.step_order:
            for p in n.inputs:
                consumers.setdefault(id(p), []).append(n)
        hoisted = set()
        for n in reversed(self.step_order):
            if id(n) in core or n.layer_type not in self.HOISTABLE_TYPES:
                continue
            if not all(id(c) in hoisted for c in consumers.get(id(n), [])):
                continue
            if not all(id(p) in self.group_nodes and id(p) not in static_ph
                       for p in n.inputs):
                continue
            hoisted.add(id(n))
        self.hoisted_ids = hoisted
        self.hoisted_order = [n for n in self.step_order if id(n) in hoisted]
        frontier, seen = [], set()
        for n in self.hoisted_order:
            for p in n.inputs:
                if id(p) not in hoisted and id(p) not in seen:
                    seen.add(id(p))
                    frontier.append(p)
        self.frontier = frontier

    def eval_step(self, params, leaf_values, ctx, skip=()):
        """Evaluate the step subgraph from its leaf values {id(node):
        value}, leaving out the nodes in ``skip``."""
        values = dict(leaf_values)
        for node in self.step_order:
            if id(node) in values or id(node) in skip:
                continue
            values[id(node)] = node.forward(
                params, [values[id(p)] for p in node.inputs], ctx)
        return values

    def eval_hoisted(self, params, stacked_values, ctx):
        """The hoisted nodes over the frontier's stacked [B, T, ...]
        values ({id(node): tensor})."""
        values = dict(stacked_values)
        for n in self.hoisted_order:
            values[id(n)] = n.forward(params, [values[id(p)]
                                               for p in n.inputs], ctx)
        return values

    def static_leaf_values(self, outer_values):
        """{id(placeholder): value} of the static inputs; an is_seq static
        stays a SequenceBatch."""
        return {id(ph): (outer_values[id(outer)]
                         if stat_seq and is_seq(outer_values[id(outer)])
                         else data_of(outer_values[id(outer)]))
                for outer, ph, stat_seq in self.static_inputs}

    def boot_values(self, outer_values, batch, dtype, device):
        boots = []
        for m in self.memories:
            if m.boot_layer is not None:
                boots.append(data_of(outer_values[id(m.boot_layer)]))
            else:
                boots.append(torch.full(
                    (batch, m.size), float(m.boot_const or 0.0),
                    dtype=dtype, device=device))
        return boots

    def outer_nodes(self):
        """The layers outside the group that the program reads: the
        static inputs and the memories' boot layers, in order, once
        each."""
        nodes = [outer for outer, _, _ in self.static_inputs] + [
            m.boot_layer for m in self.memories if m.boot_layer is not None]
        return list({id(n): n for n in nodes}.values())


@register_layer("recurrent_group")
def recurrent_group(step, input, reverse=False, name=None, targetInlink=None):
    """Run ``step`` over the timesteps of the sequence inputs; the step's
    first output, stacked over the steps, is the group's sequence output
    (masked to the first sequence input's lengths). ``reverse=True`` runs
    each sequence right to left within its valid region. The group owns
    its step layers' parameters."""
    name = name or auto_name("recurrent_group")
    program = _StepProgram(step, to_list(input), group_id=name)
    enforce(program.generated is None,
            "GeneratedInput is for beam_search, not recurrent_group")
    enforce(len(program.seq_inputs) >= 1,
            "recurrent_group needs at least one sequence input")
    enforce(targetInlink is None or targetInlink is program.seq_inputs[0][0],
            "recurrent_group(targetInlink=...) other than the first "
            "sequence input is not ported yet")
    graph_inputs = list({id(n): n for n in
                         [outer for outer, _ in program.seq_inputs]
                         + program.outer_nodes()}.values())
    slot_of = {id(n): i for i, n in enumerate(graph_inputs)}
    out_node = program.outputs[0]
    # what the loop keeps of each step: the output unless it is hoisted,
    # and the frontier the hoisted nodes read
    emit = [] if id(out_node) in program.hoisted_ids else [out_node]
    emit += [f for f in program.frontier if f is not out_node]

    def forward(params, values, ctx):
        seq_vals = [values[slot_of[id(outer)]]
                    for outer, _ in program.seq_inputs]
        for sv in seq_vals:
            enforce(is_seq(sv), "recurrent_group inputs must be sequences")
        ref = seq_vals[0]
        steps = ref.max_len
        enforce(all(sv.max_len == steps for sv in seq_vals),
                "recurrent_group sequence inputs differ in padded length: "
                "%s", [sv.max_len for sv in seq_vals])
        outer_values = {id(n): values[slot_of[id(n)]] for n in graph_inputs}
        static_leaf = program.static_leaf_values(outer_values)
        mems = program.boot_values(outer_values, ref.batch_size,
                                   ref.data.dtype, ref.data.device)
        # one sub-context for the whole loop, drawing from the caller's
        # generator
        sub_ctx = Context(mode=ctx.mode, generator=ctx.generator)
        # the time slices of each input (unbind: one stack in the
        # backward, where a slice per step would add T full-size zero
        # fills and adds)
        slices = [(sv.reverse().data if reverse else sv.data).unbind(1)
                  for sv in seq_vals]
        keeps = ref.mask()[..., None].unbind(1)
        per_step = [[] for _ in emit]
        for t in range(steps):
            leaf = dict(static_leaf)
            for (_, ph), x in zip(program.seq_inputs, slices):
                leaf[id(ph)] = x[t]
            for m, mv in zip(program.memories, mems):
                leaf[id(m)] = mv
            vals = program.eval_step(params, leaf, sub_ctx,
                                     skip=program.hoisted_ids)
            # a memory keeps its old value past its sequence's end
            new_mems = []
            for m, old in zip(program.memories, mems):
                new = data_of(vals[id(program.by_name[m.memory_of])])
                keep = keeps[t].to(new.dtype)
                new_mems.append(new * keep + old * (1.0 - keep))
            mems = new_mems
            for out, n in zip(per_step, emit):
                out.append(data_of(vals[id(n)]))
        stacked = {id(n): torch.stack(out, dim=1)
                   for n, out in zip(emit, per_step)}
        if id(out_node) in program.hoisted_ids:
            stacked = program.eval_hoisted(params, stacked, sub_ctx)
        out_seq = data_of(stacked[id(out_node)])
        result = SequenceBatch(out_seq, ref.lengths)
        if reverse:
            result = result.reverse()
        return SequenceBatch(
            result.data * ref.mask(out_seq.dtype)[..., None], ref.lengths)

    node = make_node("recurrent_group", forward, graph_inputs, name=name,
                     size=out_node.size, param_specs=program.param_specs)
    # a softmax step output stays marked as probabilities for the costs
    node.output_activation = getattr(out_node, "output_activation", None)
    node._step_program = program
    return node


class BeamSearchControlCallbacks:
    """User hooks steering generation (reference: RecurrentGradientMachine
    BeamSearchControlCallbacks).

    * ``candidate_adjust(t, tokens, history, logp) -> logp``: called every
      step with the per-beam next-token log-probabilities [B*beam, V]
      before expansion and top-k; returns the adjusted tensor (mask
      tokens with -inf, force a prefix, ...). ``tokens`` [B*beam] are the
      current last tokens, ``history`` [B*beam, max_length] the decoded
      prefixes (eos-padded).
    * ``on_step(t, tokens, scores, finished)``: called after each
      expansion with the surviving beams.
    """

    def __init__(self, candidate_adjust=None, on_step=None):
        self.candidate_adjust = candidate_adjust
        self.on_step = on_step


def beam_search(step, input, bos_id, eos_id, beam_size, max_length=30,
                name=None, num_results_per_sample=None,
                control_callbacks=None):
    """Beam-search sequence generation. ``step`` receives the
    GeneratedInput's embedding placeholder (and any StaticInput contexts)
    and returns a softmax layer over the vocabulary. Returns a
    :class:`BeamSearchGenerator`; ``.generate(parameters, feed)`` decodes."""
    name = name or auto_name("beam_search")
    program = _StepProgram(step, to_list(input), group_id=name)
    enforce(program.generated is not None,
            "beam_search needs a GeneratedInput")
    enforce(len(program.seq_inputs) == 0,
            "beam_search inputs must be StaticInput/GeneratedInput")
    return BeamSearchGenerator(name, program, program.generated, bos_id,
                               eos_id, beam_size, max_length,
                               num_results_per_sample or beam_size,
                               control_callbacks)


def _top_k(total, k):
    """The ``k`` largest entries of each row of ``total`` and their
    indices, equal entries in the order of their indices, lowest first
    (lax.top_k's order; torch.topk promises none)."""
    values, idx = torch.sort(total, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


class BeamSearchGenerator:
    def __init__(self, name, program, gen, bos_id, eos_id, beam_size,
                 max_length, num_results, control_callbacks=None):
        self.control = control_callbacks or BeamSearchControlCallbacks()
        self.name = name
        self.program = program
        self.gen = gen
        self.bos_id, self.eos_id = bos_id, eos_id
        self.beam_size = beam_size
        self.max_length = max_length
        self.num_results = num_results
        # the outer context (the encoder) the step reads
        self.context_nodes = program.outer_nodes()

    def param_specs(self):
        return self.program.param_specs

    def generate(self, parameters, feed=None, rng=None, device=None):
        """Decode on ``device`` (the card unless ``device="cpu"``).
        ``parameters``: a Parameters object holding the step's, the
        context's and the embedding's parameters; ``feed``:
        {data_layer_name: value} of the context subgraph; ``rng``: a
        ``torch.Generator`` on ``device`` for stochastic context layers.
        Returns numpy (sequences [B, k, max_length] int32, lengths [B, k],
        scores [B, k]), k = num_results_per_sample, best first."""
        from paddle_tpu_torch.topology import Topology

        device = resolve_device(device)
        with torch.inference_mode():
            params = {k: v.to(device) for k, v in
                      parameters.as_dict().items()}
            feed = {k: _to_device(v, device) for k, v in
                    (feed or {}).items()}
            outer_values, batch = {}, 1
            if self.context_nodes:
                vals = Topology(self.context_nodes).apply(
                    params, feed, mode="test", generator=rng,
                    outputs=[n.name for n in self.context_nodes])
                outer_values = {id(n): vals[n.name]
                                for n in self.context_nodes}
                batch = data_of(vals[self.context_nodes[0].name]).shape[0]
            params = {k: dtype_mod.to_compute(v) for k, v in params.items()}
            return self._search(params, outer_values, batch, device)

    def _search(self, params, outer_values, batch, device):
        program, beam, eos = self.program, self.beam_size, self.eos_id
        emb_table = params[self.gen.embedding_name]
        rows = batch * beam

        def tile(x):
            if is_seq(x):
                return SequenceBatch(torch.repeat_interleave(x.data, beam, 0),
                                     torch.repeat_interleave(x.lengths, beam,
                                                             0))
            return torch.repeat_interleave(x, beam, 0)

        static_leaf = {k: tile(v) for k, v in
                       program.static_leaf_values(outer_values).items()}
        mems = [tile(b) for b in program.boot_values(
            outer_values, batch, emb_table.dtype, device)]
        tokens = torch.full((rows,), self.bos_id, dtype=torch.long,
                            device=device)
        scores = torch.tensor([0.0] + [-1e30] * (beam - 1),
                              device=device).repeat(batch)
        finished = torch.zeros((rows,), dtype=torch.bool, device=device)
        history = torch.full((rows, self.max_length), self.eos_id,
                             dtype=torch.long, device=device)
        row_base = (torch.arange(batch, device=device) * beam)[:, None]
        ctx = Context(mode="test")
        for t in range(self.max_length):
            leaf = dict(static_leaf)
            leaf[id(program.gen_placeholder)] = emb_table[tokens]
            for m, mv in zip(program.memories, mems):
                leaf[id(m)] = mv
            vals = program.eval_step(params, leaf, ctx)
            probs = data_of(vals[id(program.outputs[0])])  # [rows, V]
            logp = torch.log(torch.clamp(probs, min=1e-20))
            if self.control.candidate_adjust is not None:
                logp = self.control.candidate_adjust(t, tokens, history,
                                                     logp)
            vocab = logp.shape[-1]
            # a finished beam extends only with eos, at no cost
            eos_only = torch.full((vocab,), -1e30, device=device)
            eos_only[eos] = 0.0
            logp = torch.where(finished[:, None], eos_only[None, :], logp)
            total = (scores[:, None] + logp).reshape(batch, beam * vocab)
            top_scores, top_idx = _top_k(total, beam)
            parent = (top_idx // vocab + row_base).reshape(-1)
            tokens = (top_idx % vocab).reshape(-1)
            scores = top_scores.reshape(-1)
            history = history[parent]
            history[:, t] = tokens
            # each memory advances to its stepped value (a finished beam
            # keeps its own), then follows its beam's parent
            mems = [torch.where(finished[:, None], old, data_of(
                vals[id(program.by_name[m.memory_of])]))[parent]
                for m, old in zip(program.memories, mems)]
            finished = finished[parent] | (tokens == eos)
            if self.control.on_step is not None:
                self.control.on_step(t, tokens, scores, finished)
            if bool(finished.all()):  # one host sync a step
                break
        return self._results(history, scores, batch)

    def _results(self, history, scores, batch):
        beam = self.beam_size
        seqs = history.cpu().numpy().astype(np.int32).reshape(
            batch, beam, self.max_length)
        sc = scores.float().cpu().numpy().reshape(batch, beam)
        is_eos = seqs == self.eos_id
        lengths = np.where(is_eos.any(axis=2), is_eos.argmax(axis=2) + 1,
                           self.max_length).astype(np.int32)
        order = np.argsort(-sc, axis=1)
        seqs = np.take_along_axis(seqs, order[:, :, None], axis=1)
        sc = np.take_along_axis(sc, order, axis=1)
        lengths = np.take_along_axis(lengths, order, axis=1)
        k = self.num_results
        return seqs[:, :k], lengths[:, :k], sc[:, :k]


def _to_device(value, device):
    if is_seq(value):
        return SequenceBatch(value.data.to(device), value.lengths.to(device))
    return value.to(device)
