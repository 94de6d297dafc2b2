"""The port's serve.DynamicBatcher over a port network on the CPU:
concurrent single-sample requests get the rows of the direct batched
forward, padding rows are inert, a full queue sheds Overloaded and an
expired request fails DeadlineExceeded.

Tolerance for served rows vs the direct forward: 1e-5 relative and
absolute — PyTorch's CPU convolution may pick another blocking for another
batch size, which only reorders fp32 sums.
"""
import threading
import time

import numpy as np
import pytest

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
from incubator_mxnet_tpu_torch.serve import (DeadlineExceeded,
                                             DynamicBatcher, Overloaded)

TOL = 1e-5
JOIN_S = 60


@pytest.fixture(scope="module")
def net():
    import torch
    n = vision.resnet18_v1(classes=5, thumbnail=True)
    n.initialize(mx.init.Xavier(generator=torch.Generator().manual_seed(0)),
                 ctx=mx.cpu())
    n(mx.nd.array(np.zeros((1, 3, 16, 16), np.float32), ctx=mx.cpu()))
    return n


def _predict(net):
    def predict(batch):
        return [net(mx.nd.array(batch["data"], ctx=mx.cpu())).asnumpy()]
    return predict


def _images(n, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (n, 3, 16, 16)).astype(np.float32)


def test_concurrent_requests_get_their_rows(net):
    images = _images(12)
    direct = net(mx.nd.array(images, ctx=mx.cpu())).asnumpy()
    results = [None] * len(images)
    batcher = DynamicBatcher(_predict(net), buckets=(1, 2, 4, 8),
                             max_latency_ms=20.0)

    def client(i):
        results[i] = batcher.submit({"data": images[i]}).result(timeout=JOIN_S)

    with batcher:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in threads)
        assert batcher.quiesce(timeout=JOIN_S)
    for i, res in enumerate(results):
        assert len(res) == 1 and res[0].shape == (5,)
        np.testing.assert_allclose(res[0], direct[i], rtol=TOL, atol=TOL)
    snap = batcher.stats.snapshot()
    assert snap["responses_ok"] == len(images) and snap["errors"] == 0
    assert 1 <= snap["batches_total"] <= len(images)
    assert batcher.stats.last_published is not None


def test_padding_rows_are_inert(net):
    image = _images(1, seed=1)[0]
    alone = net(mx.nd.array(image[None], ctx=mx.cpu())).asnumpy()[0]
    seen = []

    def predict(batch):
        seen.append(batch["data"].shape[0])
        return _predict(net)(batch)

    with DynamicBatcher(predict, buckets=(4,), max_latency_ms=1.0) as b:
        out = b.submit({"data": image}).result(timeout=JOIN_S)
        assert b.quiesce(timeout=JOIN_S)
    assert seen == [4]
    np.testing.assert_allclose(out[0], alone, rtol=TOL, atol=TOL)
    assert b.stats.snapshot()["padded_rows_total"] == 3


def test_full_queue_sheds_overloaded():
    release = threading.Event()

    def predict(batch):
        release.wait(JOIN_S)
        return [batch["data"] * 2]

    b = DynamicBatcher(predict, buckets=(1,), max_latency_ms=0.0,
                       max_queue=2).start()
    try:
        futures = [b.submit({"data": np.ones(2, np.float32)})]
        with pytest.raises(Overloaded):
            for _ in range(10):
                futures.append(b.submit({"data": np.ones(2, np.float32)}))
        assert b.stats.snapshot()["shed_queue_full"] == 1
    finally:
        release.set()
        b.stop()
    for f in futures:
        np.testing.assert_array_equal(f.result(timeout=JOIN_S)[0], [2, 2])


def test_expired_request_fails_deadline():
    release = threading.Event()

    def predict(batch):
        release.wait(JOIN_S)
        return [batch["data"]]

    with DynamicBatcher(predict, buckets=(1,), max_latency_ms=0.0) as b:
        first = b.submit({"data": np.zeros(1, np.float32)})
        late = b.submit({"data": np.zeros(1, np.float32)}, deadline_ms=1.0)
        time.sleep(0.05)        # `late` expires while `first` holds the loop
        release.set()
        first.result(timeout=JOIN_S)
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=JOIN_S)
    assert b.stats.snapshot()["shed_deadline"] == 1
