"""Activation functions (reference: paddle/gserver/activations/
ActivationFunction.cpp). Each is a stateless object with ``.apply`` over
tensors, registered by name; the rest of the reference's inventory
arrives with the layers that use it."""

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
class Relu(BaseActivation):
    name = "relu"

    def apply(self, x):
        return torch.relu(x)


@_register
class Softmax(BaseActivation):
    name = "softmax"
    elementwise = False

    def apply(self, x):
        return torch.softmax(x, dim=-1)


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
