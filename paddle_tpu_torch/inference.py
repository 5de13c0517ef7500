"""Inference helper (parity: python/paddle/v2/inference.py infer :93;
paddle_tpu/inference.py)."""

import torch

from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.core.sequence import NestedSequenceBatch, SequenceBatch
from paddle_tpu_torch.graph import LayerNode
from paddle_tpu_torch.topology import Topology, convert_feed
from paddle_tpu_torch.utils.error import enforce


class Inference:
    """Forward pass over output layers on one device (the default device
    of ``core.place`` unless ``device`` is given)."""

    def __init__(self, output_layer, parameters, device=None):
        self.outputs = ([output_layer] if isinstance(output_layer, LayerNode)
                        else list(output_layer))
        self.topology = Topology(self.outputs)
        self.device = resolve_device(device)
        self._params = {k: v.to(self.device)
                        for k, v in parameters.as_dict().items()}

    def infer(self, input, feeding=None, field="value"):
        """The output layers' values as numpy arrays (``field="value"``,
        the JAX package's default and the one field ported)."""
        enforce(field == "value", "infer(field=%r) is not ported yet",
                field)
        feed = convert_feed(self.topology, input, self.device, feeding)
        out, _ = self.topology.apply(self._params, feed, mode="test")
        results = []
        for node in self.outputs:
            val = out[node.name]
            if isinstance(val, (SequenceBatch, NestedSequenceBatch)):
                val = val.data
            results.append(val.float().cpu().numpy()
                           if val.dtype == torch.bfloat16
                           else val.cpu().numpy())
        return results[0] if len(results) == 1 else results


def infer(output_layer, parameters, input, feeding=None, field="value",
          device=None):
    return Inference(output_layer, parameters, device).infer(input, feeding,
                                                             field)

