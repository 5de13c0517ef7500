"""Datasets (paddle_tpu/dataset; parity surface: python/paddle/v2/dataset
— mnist, cifar, imdb, imikolov, movielens, conll05, uci_housing, wmt14,
flowers, voc2012, mq2007, sentiment, and the download cache in
common.py). Host code with numpy: each reader reads the real archive from
``common.DATA_HOME`` when it is there, else gives synthetic samples of the
same schema, sample for sample the JAX package's for the same arguments.
"""

from paddle_tpu_torch.dataset import common
from paddle_tpu_torch.dataset import mnist
from paddle_tpu_torch.dataset import cifar
from paddle_tpu_torch.dataset import uci_housing
from paddle_tpu_torch.dataset import imdb
from paddle_tpu_torch.dataset import imikolov
from paddle_tpu_torch.dataset import movielens
from paddle_tpu_torch.dataset import conll05
from paddle_tpu_torch.dataset import wmt14
from paddle_tpu_torch.dataset import mq2007
from paddle_tpu_torch.dataset import sentiment
from paddle_tpu_torch.dataset import flowers
from paddle_tpu_torch.dataset import voc2012
