"""Model zoo registry (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/__init__.py``), holding the
ported ResNet family."""
from .resnet import *  # noqa: F401,F403

from ....base import MXNetError

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """Reference model_zoo/__init__.py get_model."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"unknown model {name}; available: {sorted(_models)}")
    return _models[name](**kwargs)
