"""The dmlc ``.params`` container is byte-compatible between the packages:
files the JAX package writes load in the port, files the port writes load in
the JAX package, and the same dict gives byte-identical files. (64-bit
dtypes are left out: the JAX package runs without x64 and narrows them.)"""
import ml_dtypes
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx


def _arrays():
    r = np.random.RandomState(0)
    return {
        "conv.weight": r.standard_normal((4, 3, 3, 3)).astype(np.float32),
        "bn.running_var": r.rand(4).astype(np.float32),
        "half.weight": r.standard_normal((2, 5)).astype(ml_dtypes.bfloat16),
        "f16": r.standard_normal((3,)).astype(np.float16),
        "idx32": r.randint(-9, 9, (6,)).astype(np.int32),
        "bytes": r.randint(0, 255, (5,)).astype(np.uint8),
        "small": r.randint(-9, 9, (5,)).astype(np.int8),
        "flags": r.rand(4) > 0.5,
        "scalar": np.asarray(3.5, np.float32),
    }


def _same_values(port_nd, ref):
    got = port_nd.asnumpy()
    want = np.asarray(ref, np.float32 if ref.dtype == ml_dtypes.bfloat16
                      else ref.dtype)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_same_dict_gives_identical_bytes():
    arrays = _arrays()
    jbytes = jmx.nd.utils.save_bytes(
        {k: jmx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()})
    tbytes = tmx.nd.save_bytes(
        {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in arrays.items()})
    assert jbytes == tbytes


def test_jax_file_loads_in_port(tmp_path):
    arrays = _arrays()
    path = str(tmp_path / "jax.params")
    jmx.nd.save(path, {k: jmx.nd.array(v, dtype=v.dtype)
                       for k, v in arrays.items()})
    loaded = tmx.nd.load(path)
    assert list(loaded) == list(arrays)
    for k, v in arrays.items():
        assert loaded[k].context == tmx.cpu()
        _same_values(loaded[k], v)
    assert loaded["half.weight"].dtype == "bfloat16"


def test_port_file_loads_in_jax(tmp_path):
    arrays = _arrays()
    path = str(tmp_path / "port.params")
    tmx.nd.save(path, {k: tmx.nd.array(v, ctx=tmx.cpu())
                       for k, v in arrays.items()})
    loaded = jmx.nd.load(path)
    assert list(loaded) == list(arrays)
    for k, v in arrays.items():
        got = np.asarray(loaded[k].asnumpy())
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v)


def test_list_container_both_ways(tmp_path):
    arrays = list(_arrays().values())[:4]
    path = str(tmp_path / "list.params")
    tmx.nd.save(path, [tmx.nd.array(v, ctx=tmx.cpu()) for v in arrays])
    jl = jmx.nd.load(path)
    assert isinstance(jl, list) and len(jl) == len(arrays)
    jmx.nd.save(path, jl)
    tl = tmx.nd.load(path)
    assert isinstance(tl, list)
    for got, want in zip(tl, arrays):
        _same_values(got, want)


def test_gluon_save_load_parameters_roundtrip(tmp_path):
    """Port save_parameters -> JAX load_parameters -> JAX save -> port load."""
    from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision

    x = np.random.RandomState(1).standard_normal((1, 8, 8, 8)).astype(
        np.float32)
    tnet = tvision.BottleneckV1(16, 1, downsample=True, in_channels=8)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    ref = tnet(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy()
    path = str(tmp_path / "unit.params")
    tnet.save_parameters(path)

    jnet = jvision.BottleneckV1(16, 1, downsample=True, in_channels=8)
    jnet.load_parameters(path)
    jnet.save_parameters(path)
    back = tvision.BottleneckV1(16, 1, downsample=True, in_channels=8)
    back.load_parameters(path, ctx=tmx.cpu())
    np.testing.assert_array_equal(
        back(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(), ref)


def test_truncated_container_raises():
    payload = tmx.nd.save_bytes({"a": tmx.nd.array(np.ones(4, np.float32),
                                                   ctx=tmx.cpu())})
    with pytest.raises(tmx.MXNetError, match="truncated"):
        tmx.nd.load_frombuffer(payload[:-3])
    with pytest.raises(tmx.MXNetError, match="magic"):
        tmx.nd.load_frombuffer(b"\x00" * 16)
