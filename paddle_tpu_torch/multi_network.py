"""MultiNetwork: N named sub-networks under one trainer
(paddle_tpu/multi_network.py; reference: the ``multi_nn`` gradient
machine, gserver/gradientmachines/MultiNetwork.h).

The sub-networks are cost DAGs over one shared parameter namespace
(parameters are shared by name), so

* **joint training** is ``trainer.SGD(cost=MultiNetwork(...))``, which
  minimizes ``sum_i w_i * mean(cost_i)``;
* **alternating training** (the reference GAN recipe, one
  GradientMachine per phase with ``is_static`` freezing) is
  :class:`MultiNetworkTrainer`: one parameter store on the device, one
  eager train step per phase, each phase differentiating and updating
  only its own trainable subset with its own optimizer state.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.graph import LayerNode
from paddle_tpu_torch.layer.base import data_of
from paddle_tpu_torch.topology import Topology, convert_feed
from paddle_tpu_torch.utils.error import enforce


class MultiNetwork:
    """Named sub-networks: ``{name: cost}`` or ``[(name, cost, weight)]``.

    Pass it as ``trainer.SGD(cost=MultiNetwork(...))`` for joint
    training, or to :class:`MultiNetworkTrainer` for per-phase updates.
    """

    def __init__(self, subs, weights=None):
        if isinstance(subs, dict):
            items = [(n, c, 1.0) for n, c in subs.items()]
        else:
            items = [(s[0], s[1], float(s[2]) if len(s) > 2 else 1.0)
                     for s in subs]
        enforce(len(items) >= 1, "MultiNetwork needs at least one "
                "sub-network (the reference checks sub_models_size > 1 "
                "counting its root)")
        for n, c, _ in items:
            enforce(isinstance(c, LayerNode),
                    "sub-network %r cost must be a LayerNode", n)
        self.names = [n for n, _, _ in items]
        enforce(len(set(self.names)) == len(self.names),
                "duplicate sub-network names")
        self.costs = [c for _, c, _ in items]
        self.weights = [w for _, _, w in items]

    def sub(self, name):
        return self.costs[self.names.index(name)]


class MultiNetworkTrainer:
    """Alternating-phase trainer over one shared parameter store on
    ``device`` (the default device unless given).

    ``update_equations``: one Optimizer per phase (``{name: opt}``) or a
    factory ``lambda: opt`` called once per phase (separate slot state per
    phase, as the reference's per-machine updaters). ``phase_trainable``:
    ``{phase: predicate or collection of names}`` restricting which
    parameters that phase updates (``is_static`` parity); by default every
    trainable parameter reachable from the phase's cost. ``extra_outputs``:
    ``{phase: [layers]}`` that :meth:`infer` returns.

    A step computes the phase's loss and gradients before it writes
    anything, so a step that raises leaves the parameters and the
    optimizer state as they were.
    """

    def __init__(self, multi, update_equations, phase_trainable=None,
                 extra_outputs=None, seed=0, device=None):
        from paddle_tpu_torch.optimizer import Optimizer

        enforce(isinstance(multi, MultiNetwork),
                "multi must be a MultiNetwork")
        self.multi = multi
        self.device = resolve_device(device)
        phase_trainable = phase_trainable or {}
        extra_outputs = extra_outputs or {}
        if isinstance(update_equations, Optimizer):
            enforce(len(multi.names) == 1,
                    "one Optimizer instance cannot hold slot state for "
                    "several phases — pass {phase: Optimizer} or a factory")
            update_equations = {multi.names[0]: update_equations}
        elif callable(update_equations) and \
                not isinstance(update_equations, dict):
            update_equations = {n: update_equations() for n in multi.names}
        enforce(set(update_equations) == set(multi.names),
                "update_equations must cover exactly the phases %r",
                multi.names)

        # one topology per phase over the union parameter namespace
        topos = {n: Topology(c) for n, c in zip(multi.names, multi.costs)}
        all_specs = {}
        for topo in topos.values():
            for pname, spec in topo.param_specs().items():
                prev = all_specs.get(pname)
                enforce(prev is None or prev.shape == spec.shape,
                        "shared parameter %r shape mismatch across "
                        "sub-networks: %r vs %r (the single-topology joint "
                        "path enforces the same)", pname,
                        prev and prev.shape, spec.shape)
                all_specs[pname] = spec
        self._params = {}
        for i, (_, topo) in enumerate(sorted(topos.items())):
            for pname, v in topo.init_params(seed=seed + i,
                                             device=self.device).items():
                self._params.setdefault(pname, v)
        state_names = {p for p, s in all_specs.items() if s.is_state}
        self._generator = torch.Generator(
            device=self.device).manual_seed(seed + 1)
        self._phases = {}
        for phase, cost in zip(multi.names, multi.costs):
            topo = topos[phase]
            specs = topo.param_specs()
            reachable = [p for p in specs if p not in state_names
                         and not specs[p].attr.is_static]
            sel = phase_trainable.get(phase)
            if sel is None:
                train_names = reachable
            elif callable(sel):
                train_names = [p for p in reachable if sel(p)]
            else:
                train_names = [p for p in reachable if p in set(sel)]
            enforce(train_names, "phase %r has no trainable parameters",
                    phase)
            optimizer = update_equations[phase]
            meta = {p: specs[p].attr for p in train_names}
            self._phases[phase] = {
                "topo": topo,
                "cost": cost.name,
                "train_names": train_names,
                "needed": set(specs),
                "optimizer": optimizer,
                "meta": meta,
                "opt_state": optimizer.init_state(
                    {p: self._params[p] for p in train_names}, meta),
                "outputs": [o.name for o in extra_outputs.get(phase, [])],
            }

    def train_batch(self, phase, batch, feeding=None):
        """One optimizer step of ``phase`` on a host minibatch (a list of
        sample tuples, the v2 reader convention). Returns the phase's
        loss, the mean of its cost."""
        ph = self._phases[phase]
        feed = convert_feed(ph["topo"], batch, feeding,
                            device=self.device)
        leaves = {p: self._params[p].detach().requires_grad_()
                  for p in ph["train_names"]}
        params = {p: leaves.get(p, v) for p, v in self._params.items()
                  if p in ph["needed"]}
        values, updates = ph["topo"].apply(params, feed, mode="train",
                                           rng=self._generator)
        loss = values[ph["cost"]].float().mean()
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {p: torch.zeros_like(leaves[p]) if g is None else g
                 for p, g in zip(leaves, grads)}
        ph["optimizer"].step({p: self._params[p] for p in leaves}, grads,
                             ph["opt_state"], ph["meta"])
        with torch.no_grad():
            for name, value in updates.items():
                self._params[name].copy_(value)
        return float(loss.detach())

    def infer(self, phase, batch, feeding=None):
        """Forward ``phase``'s sub-network (test mode) on a minibatch: its
        declared extra outputs (or its cost) as host numpy arrays."""
        ph = self._phases[phase]
        feed = convert_feed(ph["topo"], batch, feeding,
                            device=self.device)
        params = {p: v for p, v in self._params.items() if p in ph["needed"]}
        outputs = ph["outputs"] or [ph["cost"]]
        values, _ = ph["topo"].apply(params, feed, mode="test",
                                     outputs=outputs)
        return {k: data_of(values[k]).float().cpu().numpy()
                for k in outputs}

    def get_params(self):
        """Host copies of the shared parameter store."""
        return {p: v.detach().float().cpu().numpy().copy()
                for p, v in self._params.items()}
