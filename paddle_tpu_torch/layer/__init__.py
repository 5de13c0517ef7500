"""The layer library (surface parity with paddle_tpu/layer): constructors
building a lazy DAG that paddle_tpu_torch.topology.Topology evaluates.

  io.py         data
  basic.py      fc, embedding, addto
  conv.py       img_conv, img_pool, batch_norm
  recurrent.py  lstmemory, grumemory
  sequence.py   pooling
  cost.py       classification_cost, cross_entropy
"""

from paddle_tpu_torch.graph import LayerNode, LayerOutput, reset_name_counters
from paddle_tpu_torch.layer.base import layer_registry
from paddle_tpu_torch.layer.basic import addto, embedding, fc
from paddle_tpu_torch.layer.conv import batch_norm, img_conv, img_pool
from paddle_tpu_torch.layer.cost import classification_cost, cross_entropy
from paddle_tpu_torch.layer.io import data
from paddle_tpu_torch.layer.recurrent import grumemory, lstmemory
from paddle_tpu_torch.layer.sequence import pooling
