"""Serving telemetry: latency histograms, queue/shed counters.

Counterpart of ``incubator_mxnet_tpu/serve/stats.py``, trimmed to what the
DynamicBatcher touches. ``publish()`` keeps its snapshot in memory
(``last_published``); feeding the profiler's counters comes with the
profiler port.
"""
from __future__ import annotations

import math

from .. import mxsan as _mxsan

__all__ = ["LatencyHistogram", "ServingStats"]


class LatencyHistogram:
    """Fixed log-spaced latency buckets (10us .. ~105s, x1.5 steps).

    ``percentile`` linearly interpolates inside the winning bucket, which
    bounds the error to one bucket width (<= 50% relative).
    """

    _GROWTH = 1.5
    _FLOOR = 10e-6  # seconds

    def __init__(self, nbuckets=40):
        self._bounds = [self._FLOOR * self._GROWTH ** i
                        for i in range(nbuckets)]
        self._counts = [0] * (nbuckets + 1)  # +1: overflow bucket
        self._lock = _mxsan.lock("serve/stats.py", "self._lock")
        self.count = 0
        self.sum = 0.0

    def _index(self, seconds):
        if seconds <= self._FLOOR:
            return 0
        i = int(math.log(seconds / self._FLOOR) / math.log(self._GROWTH)) + 1
        return min(i, len(self._bounds))

    def observe(self, seconds):
        seconds = max(0.0, float(seconds))
        with self._lock:
            self._counts[self._index(seconds)] += 1
            self.count += 1
            self.sum += seconds

    def percentile(self, q):
        """q in [0, 100] -> seconds (0.0 when empty)."""
        with self._lock:
            total = self.count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        rank = q / 100.0 * total
        seen = 0
        for i, c in enumerate(counts):
            if seen + c >= rank and c > 0:
                lo = 0.0 if i == 0 else self._bounds[i - 1]
                hi = self._bounds[min(i, len(self._bounds) - 1)]
                frac = (rank - seen) / c
                return lo + (hi - lo) * min(1.0, frac)
            seen += c
        return self._bounds[-1]

    @property
    def mean(self):
        with self._lock:
            return self.sum / self.count if self.count else 0.0


class ServingStats:
    """Aggregated serving counters + histograms for one model endpoint.

    Counter semantics:
      requests_total     every submit() that entered the system
      responses_ok       completed with a result
      shed_queue_full    rejected at admission (bounded queue full)
      shed_deadline      expired before dispatch
      errors             predict raised
      batches_total      bucket dispatches
      padded_rows_total  bucket_size - real rows, summed over batches
      queue_depth        gauge, sampled at publish time
      batch_occupancy    real_rows / bucket_size of the last batch
    """

    def __init__(self, name="serve"):
        self.name = name
        self._lock = _mxsan.lock("serve/stats.py", "self._lock")
        self.latency = LatencyHistogram()       # end-to-end (submit->result)
        self.queue_wait = LatencyHistogram()    # submit->dispatch
        self.forward_time = LatencyHistogram()  # batched predict call
        self.requests_total = 0
        self.responses_ok = 0
        self.shed_queue_full = 0
        self.shed_deadline = 0
        self.errors = 0
        self.batches_total = 0
        self.padded_rows_total = 0
        self.queue_depth = 0
        self.batch_occupancy = 0.0
        # per-bucket split: how much of the end-to-end time each bucket
        # spends WAITING vs ON DEVICE
        self._bucket_hists = {}     # bucket -> (queue_wait LH, device LH)
        self.last_published = None

    def incr(self, field, n=1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def set_gauge(self, field, value):
        with self._lock:
            setattr(self, field, value)

    def observe_bucket(self, bucket, queue_waits, device_seconds):
        """Record one dispatch of ``bucket``: each request's queue wait
        and the single batched forward time (seconds)."""
        bucket = int(bucket)
        with self._lock:
            pair = self._bucket_hists.get(bucket)
            if pair is None:
                pair = self._bucket_hists[bucket] = (LatencyHistogram(),
                                                     LatencyHistogram())
        qh, dh = pair
        for s in queue_waits:
            qh.observe(s)
        dh.observe(device_seconds)

    def bucket_snapshot(self):
        with self._lock:
            pairs = sorted(self._bucket_hists.items())
        return {b: {"queue_wait_p50_ms": round(qh.percentile(50) * 1e3, 4),
                    "queue_wait_p95_ms": round(qh.percentile(95) * 1e3, 4),
                    "device_p50_ms": round(dh.percentile(50) * 1e3, 4),
                    "device_p95_ms": round(dh.percentile(95) * 1e3, 4),
                    "dispatches": dh.count}
                for b, (qh, dh) in pairs}

    def snapshot(self):
        with self._lock:
            snap = {
                "requests_total": self.requests_total,
                "responses_ok": self.responses_ok,
                "shed_queue_full": self.shed_queue_full,
                "shed_deadline": self.shed_deadline,
                "shed_total": self.shed_queue_full + self.shed_deadline,
                "errors": self.errors,
                "batches_total": self.batches_total,
                "padded_rows_total": self.padded_rows_total,
                "queue_depth": self.queue_depth,
                "batch_occupancy": round(self.batch_occupancy, 4),
            }
        for prefix, h in (("latency", self.latency),
                          ("queue_wait", self.queue_wait),
                          ("forward", self.forward_time)):
            snap[f"{prefix}_p50_ms"] = round(h.percentile(50) * 1e3, 4)
            snap[f"{prefix}_p95_ms"] = round(h.percentile(95) * 1e3, 4)
            snap[f"{prefix}_p99_ms"] = round(h.percentile(99) * 1e3, 4)
            snap[f"{prefix}_mean_ms"] = round(h.mean * 1e3, 4)
        for b, row in self.bucket_snapshot().items():
            for k, v in row.items():
                snap[f"bucket{b}_{k}"] = v
        return snap

    def publish(self):
        """Take a snapshot and keep it as ``last_published``."""
        snap = self.snapshot()
        self.last_published = snap
        return snap
