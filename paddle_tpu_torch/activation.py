"""Activation functions (reference: paddle/gserver/activations/
ActivationFunction.cpp; paddle_tpu/activation.py). Each is a stateless
object with ``.apply`` over tensors, registered under the JAX package's
name: sigmoid, softmax, sequence_softmax, relu, brelu, tanh, stanh,
softrelu, abs, square, exponential, reciprocal, sqrt, log and linear
(``Identity``)."""

import torch

from paddle_tpu_torch.utils.registry import Registry

activation_registry = Registry("activation")


class BaseActivation:
    name = None
    # elementwise activations commute with the NHWC <-> flat NCHW layout
    # bridge, so image layers apply them to the NHWC tensor (paddle_tpu/
    # activation.py); the softmax family is defined on the flat vector
    elementwise = True

    def apply(self, x):
        raise NotImplementedError

    def __call__(self, x):
        return self.apply(x)

    def __repr__(self):
        return "%s()" % type(self).__name__


def _register(cls):
    activation_registry.register(cls.name, cls)
    return cls


@_register
class Linear(BaseActivation):
    name = "linear"

    def apply(self, x):
        return x


Identity = Linear


@_register
class Sigmoid(BaseActivation):
    name = "sigmoid"

    def apply(self, x):
        return torch.sigmoid(x)


@_register
class Tanh(BaseActivation):
    name = "tanh"

    def apply(self, x):
        return torch.tanh(x)


@_register
class STanh(BaseActivation):
    """Scaled tanh: 1.7159 * tanh(2/3 x) (ActivationFunction.cpp stanh)."""

    name = "stanh"

    def apply(self, x):
        return 1.7159 * torch.tanh((2.0 / 3.0) * x)


@_register
class Relu(BaseActivation):
    name = "relu"

    def apply(self, x):
        return torch.relu(x)


@_register
class BRelu(BaseActivation):
    """Bounded relu: min(max(x, 0), 24) (ActivationFunction.cpp brelu)."""

    name = "brelu"

    def apply(self, x):
        return torch.clamp(x, 0.0, 24.0)


@_register
class SoftRelu(BaseActivation):
    """log(1 + e^x), the input clipped to +-40 as in the reference."""

    name = "softrelu"

    def apply(self, x):
        return torch.log(1.0 + torch.exp(torch.clamp(x, -40.0, 40.0)))


@_register
class Softmax(BaseActivation):
    name = "softmax"
    elementwise = False

    def apply(self, x):
        return torch.softmax(x, dim=-1)


@_register
class SequenceSoftmax(BaseActivation):
    """Softmax across the time axis of a sequence of scalars
    (ActivationFunction.cpp sequence_softmax): ``apply(x, mask)`` with
    values [B, T] and a [B, T] mask gives masked steps weight exactly 0
    (an all-masked row gives zeros); without a mask, the last axis's
    softmax, as a layer's ``finalize`` applies it."""

    name = "sequence_softmax"
    elementwise = False

    def apply(self, x, mask=None):
        if mask is None:
            return torch.softmax(x, dim=-1)
        mask = mask.to(torch.bool)
        masked = torch.where(mask, x, torch.full_like(
            x, torch.finfo(x.dtype).min))
        z = masked - torch.amax(masked, dim=-1, keepdim=True)
        e = torch.exp(z) * mask.to(x.dtype)
        return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True),
                               min=1e-12)


@_register
class Exp(BaseActivation):
    name = "exponential"

    def apply(self, x):
        return torch.exp(x)


@_register
class Log(BaseActivation):
    name = "log"

    def apply(self, x):
        return torch.log(x)


@_register
class Abs(BaseActivation):
    name = "abs"

    def apply(self, x):
        return torch.abs(x)


@_register
class Square(BaseActivation):
    name = "square"

    def apply(self, x):
        return x * x


@_register
class Reciprocal(BaseActivation):
    name = "reciprocal"

    def apply(self, x):
        return 1.0 / x


@_register
class Sqrt(BaseActivation):
    name = "sqrt"

    def apply(self, x):
        return torch.sqrt(x)


def to_activation(act):
    """Accept an activation object, a registered name, or None (linear)."""
    if act is None:
        return Linear()
    if isinstance(act, BaseActivation):
        return act
    if isinstance(act, str):
        return activation_registry.create(act)
    if isinstance(act, type) and issubclass(act, BaseActivation):
        return act()
    raise TypeError("cannot convert %r to an activation" % (act,))
