"""Parameter initializers (reference: ParameterConfig initial_mean/
initial_std/initial_strategy, Parameter::randomize).

Each initializer draws on the CPU from the ``torch.Generator`` it is
given, then moves the tensor to ``device``, so one seed gives the same
numbers on every device. Xavier (std = 1/sqrt(fan_in) normal) is the
default for weights (``default_weight_init``), zeros for biases; MSRA
(std = sqrt(2/fan_in)) is He's init for relu stacks.
"""

import math

import torch


class Initializer:
    def __call__(self, generator, shape, dtype, device):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, generator, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=0.01):
        self.mean = mean
        self.std = std

    def __call__(self, generator, shape, dtype, device):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (self.mean + self.std * x).to(device=device, dtype=dtype)


class Uniform(Initializer):
    def __init__(self, low=-0.05, high=0.05):
        self.low = low
        self.high = high

    def __call__(self, generator, shape, dtype, device):
        x = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (self.low + (self.high - self.low) * x).to(device=device,
                                                           dtype=dtype)


class Xavier(Initializer):
    """std = 1/sqrt(fan_in) normal — the reference's default weight init."""

    def __init__(self, fan_in=None):
        self.fan_in = fan_in

    def __call__(self, generator, shape, dtype, device):
        fan_in = self.fan_in
        if fan_in is None:
            fan_in = shape[0] if shape else 1
        std = 1.0 / math.sqrt(max(fan_in, 1))
        return Normal(0.0, std)(generator, shape, dtype, device)


class MSRA(Initializer):
    """He init for relu conv stacks: std = sqrt(2/fan_in) normal."""

    def __init__(self, fan_in=None):
        self.fan_in = fan_in

    def __call__(self, generator, shape, dtype, device):
        fan_in = self.fan_in
        if fan_in is None:
            fan_in = shape[0] if len(shape) > 1 else 1
        std = math.sqrt(2.0 / max(fan_in, 1))
        return Normal(0.0, std)(generator, shape, dtype, device)


def default_weight_init(fan_in):
    return Xavier(fan_in=fan_in)


def default_bias_init():
    return Constant(0.0)
