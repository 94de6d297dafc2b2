"""ResNet, spec-driven.

Counterpart of ``incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py``:
one residual-unit block covers basic/bottleneck x post-act (v1) / pre-act
(v2), and the family is generated from a depth -> (unit kind, stage
repeats) table. Same class names, attribute names and structured parameter
names, so ``.params`` files cross between the two packages.

With ``MXTPU_FUSED_BLOCK`` on (the default) inference runs every v1
residual leg through ``FusedConvBNReLU``: the hand conv+BN+ReLU kernel for
the stride-1 legs, a plain conv plus the hand epilogue kernel otherwise.
Training materializes each leg's conv output for the batch statistics and
runs the BN(+add)+ReLU through ``FusedBNAddReLU`` (the hand epilogue
kernels), with the running-stat update ``nn.BatchNorm`` would do.
"""
from __future__ import annotations

from ....base import MXNetError
from ....util import getenv_bool
from .... import autograd, nd
from ...block import HybridBlock
from ...parameter import DeferredInitializationError
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]

_BN_PARAMS = ("gamma", "beta", "running_mean", "running_var")


def _fused_blocks(F):
    """Route residual units through the fused conv+BN(+add)+ReLU ops?
    Behind MXTPU_FUSED_BLOCK; off restores the layer-by-layer oracle."""
    return F is nd and getenv_bool("MXTPU_FUSED_BLOCK")


def _layer_args(layer, probe, names):
    """Parameter NDArrays of a child layer, finishing deferred init from
    ``probe`` (the layer's input, or a shape-only stand-in) when needed."""
    try:
        return [getattr(layer, n).data() for n in names]
    except DeferredInitializationError:
        layer._finish_deferred(probe)
        return [getattr(layer, n).data() for n in names]


class _Shape:
    """Shape-only stand-in for infer_shape() when the fused inference
    path never materializes the intermediate activation."""

    def __init__(self, shape):
        self.shape = shape


# depth -> (unit kind, per-stage unit counts); stage base widths are fixed
_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}
_WIDTHS = (64, 128, 256, 512)


class _ResUnit(HybridBlock):
    """One residual unit.

    kind='basic': two 3x3 convs. kind='bottleneck': 1x1 reduce, 3x3, 1x1
    expand (4x). preact=False is the v1 arrangement (conv-bn-relu chain,
    add, final relu); preact=True is v2 (bn-relu before each conv, identity
    add, projection taken from the pre-activated input).
    """

    def __init__(self, width, stride, kind, preact, project, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._preact = preact
        out = width if kind == "basic" else width * 4
        if kind == "basic":
            plan = [(width, 3, stride), (out, 3, 1)]
        elif not preact:
            # v1 bottleneck strides at the 1x1 reduce, v2 at the 3x3
            plan = [(width, 1, stride), (width, 3, 1), (out, 1, 1)]
        else:
            plan = [(width, 1, 1), (width, 3, stride), (out, 1, 1)]

        self.convs = nn.HybridSequential(prefix="")
        self.norms = nn.HybridSequential(prefix="")
        for ch, ksz, st in plan:
            self.convs.add(nn.Conv2D(ch, ksz, strides=st, padding=ksz // 2,
                                     use_bias=False))
            self.norms.add(nn.BatchNorm())
        self.shortcut = (nn.Conv2D(out, 1, strides=stride, use_bias=False,
                                   in_channels=in_channels)
                         if project else None)
        self.shortcut_norm = (nn.BatchNorm()
                              if project and not preact else None)

    def _fused_bn_act(self, F, norm, z, residual):
        """FusedBNAddReLU through a BatchNorm child, plus the running-stat
        update the layer would do in training."""
        training = autograd.is_training() and not norm._use_global_stats
        gamma, beta, rm, rv = _layer_args(norm, z, _BN_PARAMS)
        args = ((z, gamma, beta, rm, rv) if residual is None
                else (z, gamma, beta, rm, rv, residual))
        out, mean, var = F.FusedBNAddReLU(
            *args, eps=norm._epsilon, momentum=norm._momentum,
            fix_gamma=not norm._scale,
            use_global_stats=norm._use_global_stats, axis=norm._axis,
            training=training)
        if training:
            norm._update_running_stats(rm, rv, mean, var)
        return out

    def _fused_unit(self, F, conv, norm, x, residual):
        """One conv->bn(->add)->relu leg through the fused ops. Training
        materializes the conv output (the batch statistics need it);
        inference folds the whole chain into one fused-forward call."""
        training = autograd.is_training() and not norm._use_global_stats
        if training:
            return self._fused_bn_act(F, norm, conv(x), residual)
        (weight,) = _layer_args(conv, x, ("weight",))
        gamma, beta, rm, rv = _layer_args(
            norm, _Shape((0, conv._channels, 0, 0)), _BN_PARAMS)
        args = ((x, weight, gamma, beta, rm, rv) if residual is None
                else (x, weight, gamma, beta, rm, rv, residual))
        out, _mean, _var = F.FusedConvBNReLU(
            *args, kernel=conv._kernel, stride=conv._strides,
            dilate=conv._dilation, pad=conv._padding,
            num_filter=conv._channels, num_group=conv._groups,
            eps=norm._epsilon, momentum=norm._momentum,
            fix_gamma=not norm._scale,
            use_global_stats=norm._use_global_stats, training=False)
        return out

    def _forward_v1(self, F, x):
        if _fused_blocks(F):
            return self._forward_v1_fused(F, x)
        y = x
        n = len(self.convs)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y))
            if i < n - 1:
                y = F.relu(y)
        s = x
        if self.shortcut is not None:
            s = self.shortcut_norm(self.shortcut(s))
        return F.relu(y + s)

    def _forward_v1_fused(self, F, x):
        # the projection shortcut stays a child-layer call: its BatchNorm
        # apply already dispatches the epilogue kernel
        s = x
        if self.shortcut is not None:
            s = self.shortcut_norm(self.shortcut(s))
        y = x
        n = len(self.convs)
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = self._fused_unit(F, conv, norm, y,
                                 s if i == n - 1 else None)
        return y

    def _forward_v2(self, F, x):
        convs = list(self.convs)
        norms = list(self.norms)
        fused = _fused_blocks(F)
        y = (self._fused_bn_act(F, norms[0], x, None) if fused
             else F.relu(norms[0](x)))
        s = self.shortcut(y) if self.shortcut is not None else x
        y = convs[0](y)
        for conv, norm in zip(convs[1:], norms[1:]):
            y = conv(self._fused_bn_act(F, norm, y, None) if fused
                     else F.relu(norm(y)))
        return y + s

    def hybrid_forward(self, F, x):
        return self._forward_v2(F, x) if self._preact else self._forward_v1(F, x)


class _ResNet(HybridBlock):
    """Shared trunk builder for both versions."""

    def __init__(self, num_layers, preact, classes=1000, thumbnail=False,
                 **kwargs):
        super().__init__(**kwargs)
        if num_layers not in _SPECS:
            raise MXNetError(f"no resnet spec for depth {num_layers}; "
                             f"choose from {sorted(_SPECS)}")
        kind, repeats = _SPECS[num_layers]
        expansion = 1 if kind == "basic" else 4

        self.features = nn.HybridSequential(prefix="")
        if preact:
            self.features.add(nn.BatchNorm(scale=False, center=False))
        if thumbnail:
            # CIFAR-style 3x3 stem
            self.features.add(nn.Conv2D(64, 3, strides=1, padding=1,
                                        use_bias=False))
        else:
            self.features.add(nn.Conv2D(64, 7, strides=2, padding=3,
                                        use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1))

        in_ch = 64
        for stage, (width, count) in enumerate(zip(_WIDTHS, repeats)):
            out_ch = width * expansion
            for unit in range(count):
                stride = 2 if (unit == 0 and stage > 0) else 1
                self.features.add(_ResUnit(
                    width, stride, kind, preact,
                    project=(unit == 0 and (in_ch != out_ch or stride != 1)),
                    in_channels=in_ch))
                in_ch = out_ch
        if preact:
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_ch)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    def __init__(self, num_layers=50, **kwargs):
        super().__init__(num_layers, preact=False, **kwargs)


class ResNetV2(_ResNet):
    def __init__(self, num_layers=50, **kwargs):
        super().__init__(num_layers, preact=True, **kwargs)


# unit-level classes kept for API parity with the reference's exports;
# `channels` is the unit's OUTPUT channel count, as in the reference
class BasicBlockV1(_ResUnit):
    def __init__(self, channels, stride, downsample=False, in_channels=0, **kw):
        super().__init__(channels, stride, "basic", False, downsample,
                         in_channels, **kw)


class BasicBlockV2(_ResUnit):
    def __init__(self, channels, stride, downsample=False, in_channels=0, **kw):
        super().__init__(channels, stride, "basic", True, downsample,
                         in_channels, **kw)


class BottleneckV1(_ResUnit):
    def __init__(self, channels, stride, downsample=False, in_channels=0, **kw):
        super().__init__(channels // 4, stride, "bottleneck", False,
                         downsample, in_channels, **kw)


class BottleneckV2(_ResUnit):
    def __init__(self, channels, stride, downsample=False, in_channels=0, **kw):
        super().__init__(channels // 4, stride, "bottleneck", True,
                         downsample, in_channels, **kw)


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """Reference model_zoo get_resnet signature. There are no pretrained
    weights for the port: carry trained weights across with
    ``convert.load_jax_params`` instead."""
    if version not in (1, 2):
        raise MXNetError(f"resnet version must be 1 or 2, got {version}")
    if pretrained:
        raise MXNetError("pretrained weights are not available to the port; "
                         "load a .params file with convert.load_jax_params")
    return (ResNetV1 if version == 1 else ResNetV2)(num_layers, **kwargs)


def _make_ctor(version, depth):
    def ctor(**kwargs):
        return get_resnet(version, depth, **kwargs)
    ctor.__name__ = f"resnet{depth}_v{version}"
    ctor.__doc__ = f"ResNet-{depth} v{version} (reference resnet.py)."
    return ctor


resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1, resnet152_v1 = \
    (_make_ctor(1, d) for d in (18, 34, 50, 101, 152))
resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2 = \
    (_make_ctor(2, d) for d in (18, 34, 50, 101, 152))
