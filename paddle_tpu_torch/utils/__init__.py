"""Process-wide utilities: flags, logging, timers, errors, registries
(reference: paddle/utils/Flags.cpp, Logging.h, Stat.h, Error.h,
ClassRegistrar.h)."""

from paddle_tpu_torch.utils import flags
from paddle_tpu_torch.utils.error import EnforceError, enforce
from paddle_tpu_torch.utils.logger import logger, set_level
from paddle_tpu_torch.utils.registry import Registry
from paddle_tpu_torch.utils.stat import StatSet, global_stats, timer
