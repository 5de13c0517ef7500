"""The layer library (surface parity with paddle_tpu/layer): constructors
building a lazy DAG that paddle_tpu_torch.topology.Topology evaluates.

  io.py         data
  basic.py      fc, embedding, concat, addto, dropout, cos_sim
  conv.py       img_conv, img_pool, batch_norm, img_cmrnorm
  recurrent.py  lstmemory, grumemory
  sequence.py   pooling
  cost.py       classification_cost, cross_entropy, square_error_cost
                (mse_cost, regression_cost),
                multi_binary_label_cross_entropy
  extra.py      crf, crf_decoding
"""

from paddle_tpu_torch.graph import LayerNode, LayerOutput, reset_name_counters
from paddle_tpu_torch.layer.base import layer_registry
from paddle_tpu_torch.layer.basic import (addto, concat, cos_sim, dropout,
                                          embedding, fc)
from paddle_tpu_torch.layer.conv import (batch_norm, img_cmrnorm, img_conv,
                                         img_pool)
from paddle_tpu_torch.layer.cost import (classification_cost, cross_entropy,
                                         mse_cost,
                                         multi_binary_label_cross_entropy,
                                         regression_cost, square_error_cost)
from paddle_tpu_torch.layer.extra import crf, crf_decoding
from paddle_tpu_torch.layer.io import data
from paddle_tpu_torch.layer.recurrent import grumemory, lstmemory
from paddle_tpu_torch.layer.sequence import pooling
