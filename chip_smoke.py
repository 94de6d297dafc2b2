#!/usr/bin/env python3
"""Drive the PyTorch port (incubator_mxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, each of which fails the run (exit code != 0, no result line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the hand CUDA kernels from the repository's sources (nvcc,
     sm_90a);
  3. hold every kernel against its plain PyTorch twin on the card, at every
     shape the ResNet-50 v1 batch-32 forward launches it with (fp32), plus
     one bf16 shape each, and time kernel, twin and the one PyTorch call
     that computes the same function where there is one (CUDA graphs of
     back-to-back launches, inputs rotated to spill the 50 MB L2);
  4. build resnet50_v1(classes=1000) on cuda:0 with seeded weights and
     non-trivial BatchNorm statistics, serve 64 single-image requests from
     8 threads through serve.DynamicBatcher (buckets 1..32) and check each
     answer against the row of a direct batch-32 forward;
  5. check the launch counters: per batch-32 forward conv_bn_relu 29,
     bn_add_act 16, bn_act 3, bn_apply 5, and the serving run's counts are
     those times the batches it dispatched;
  6. compare the batch-32 logits with the same net run through the plain
     twins on the card;
  7. time the batch-32 fp32 forward (img/s) through the kernels and through
     the twins.
It prints the card line, the kernels line and, last,
{"ok": true, "device": {...}}; details go to chiprun_out/chip_smoke.json.
Without a CUDA device, or without the package beside it, it exits non-zero.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32 FMA FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
L2_BYTES = 50 * 2 ** 20

BATCH = 32
N_REQUESTS = 64
N_THREADS = 8
SEED = 0
PER_FORWARD = {"conv_bn_relu": 29, "bn_add_act": 16, "bn_act": 3,
               "bn_apply": 5}
SOURCE = "incubator_mxnet_tpu_torch/csrc/fused_conv.cu"
REPLACES = {
    "conv_bn_relu": "incubator_mxnet_tpu/parallel/fused_conv.py:255",
    "bn_add_act": "incubator_mxnet_tpu/parallel/fused_conv.py:108",
    "bn_act": "incubator_mxnet_tpu/parallel/fused_conv.py:103",
    "bn_apply": "incubator_mxnet_tpu/parallel/fused_conv.py:103",
}
# tolerances, kernel vs twin on the same inputs:
#  epilogues: the kernel rounds the multiply and the add separately, as the
#  twin's two PyTorch ops do, so both dtypes are bit-exact; 1 ulp allowed.
EPI_MAX_ULP = 1
#  conv: another summation order than cuDNN's (both fp32 FMA, no TF32):
#  max|kernel - twin| <= tol * max|twin|.
CONV_REL_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
#  whole net, batch-32 logits through kernels vs through twins (50 layers of
#  conv-order differences): max|d| <= 1e-3 * max|logits|.
NET_REL_TOL = 1e-3
#  served rows vs the direct batch-32 forward: the hand kernels give a row
#  the same bits in any batch, but cuDNN/cuBLAS may pick other algorithms
#  for other batch sizes: max|d| <= 1e-4 * max|logits|.
SERVE_REL_TOL = 1e-4


class PhaseError(RuntimeError):
    pass


def _check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# shapes of the ResNet-50 v1 forward
# ---------------------------------------------------------------------------

def resnet50_kernel_shapes(n):
    """{kernel: Counter(shape -> launches per forward)} for a batch of n
    224x224 images (stage repeats 3,4,6,3; v1 strides at the 1x1 reduce).
    conv shapes are (n, c_in, h, w, c_out, k); epilogue shapes NCHW."""
    conv, act, add, apply = Counter(), Counter(), Counter(), Counter()
    apply[(n, 64, 112, 112)] += 1                       # stem BatchNorm
    in_ch, hw = 64, 56
    for stage, (width, count) in enumerate(zip((64, 128, 256, 512),
                                               (3, 4, 6, 3))):
        out_ch = width * 4
        for unit in range(count):
            stride = 2 if unit == 0 and stage > 0 else 1
            h = hw // stride
            if unit == 0:
                apply[(n, out_ch, h, h)] += 1           # projection shortcut
            if stride == 1:
                conv[(n, in_ch, hw, hw, width, 1)] += 1  # 1x1 reduce
            else:
                act[(n, width, h, h)] += 1               # s2 1x1 reduce
            conv[(n, width, h, h, width, 3)] += 1        # 3x3
            add[(n, out_ch, h, h)] += 1                  # 1x1 expand + add
            in_ch, hw = out_ch, h
    return {"conv_bn_relu": conv, "bn_add_act": add, "bn_act": act,
            "bn_apply": apply}


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def _graph_ms(torch, fn, sets, reps=20):
    """Device time of one fn(*inputs) call: a CUDA graph of `reps` calls
    cycling over the input sets, replayed under CUDA events."""
    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for args in sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(3):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best


def _n_sets(bytes_per_call):
    return max(1, min(8, math.ceil(2 * L2_BYTES / max(bytes_per_call, 1))))


def _ulp_dist(torch, a, b):
    """Largest distance in units in the last place between two float32 or
    bfloat16 tensors (-0 and +0 are 0 apart)."""
    if a.dtype == torch.float32:
        ia, ib, mask = a.view(torch.int32), b.view(torch.int32), 0x7FFFFFFF
    else:
        ia, ib, mask = a.view(torch.int16), b.view(torch.int16), 0x7FFF

    def ordered(i):
        i = i.to(torch.int64)
        mag = i & mask
        return torch.where(i < 0, -mag, mag)

    return int((ordered(ia) - ordered(ib)).abs().max())


def _epi_inputs(torch, shape, dtype, residual, gen, device):
    c = shape[1]
    z = torch.randn(shape, generator=gen, device=device).to(dtype)
    scale = torch.rand(c, generator=gen, device=device) + 0.5
    bias = torch.randn(c, generator=gen, device=device) * 0.1
    if residual:
        r = torch.randn(shape, generator=gen, device=device).to(dtype)
        return (z, scale, bias, r)
    return (z, scale, bias)


def _conv_inputs(torch, shape, dtype, gen, device):
    n, c, h, w, co, k = shape
    x = torch.randn((n, c, h, w), generator=gen, device=device).to(dtype)
    wt = (torch.randn((co, c, k, k), generator=gen, device=device)
          / math.sqrt(c * k * k)).to(dtype)
    scale = torch.rand(co, generator=gen, device=device) + 0.5
    bias = torch.randn(co, generator=gen, device=device) * 0.1
    return (x, wt, scale, bias)


def _conv_bound(shape, itemsize):
    n, c, h, w, co, k = shape
    flops = 2.0 * n * h * w * co * c * k * k
    nbytes = (n * c * h * w + co * c * k * k + n * co * h * w) * itemsize \
        + 2 * co * 4
    return flops, nbytes


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    _check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


def phase_build(fc, cuda):
    t0 = time.perf_counter()
    fc.build()
    secs = time.perf_counter() - t0
    log = cuda.log_path("fused_conv")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    print(f"build: fused_conv in {secs:.1f} s; ptxas lines: {len(ptxas)}",
          flush=True)
    for ln in ptxas:
        if "spill" in ln and not ln.startswith("0 bytes"):
            print(f"  ptxas: {ln}")
    return {"seconds": secs, "ptxas": ptxas}


def phase_kernels(torch, F, fc, shapes, device):
    """Kernel vs twin at every batch-32 shape (fp32) + one bf16 shape each;
    per-shape times of kernel, twin and library call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = []
    epi = {"bn_apply": (fc.bn_apply, False), "bn_act": (fc.bn_act, False),
           "bn_add_act": (fc.bn_add_act, True)}
    for name, (kern, residual) in epi.items():
        cases = [(s, "float32") for s in shapes[name]]
        cases.append((min(shapes[name]), "bfloat16"))
        for shape, dt in cases:
            dtype = getattr(torch, dt)
            args = _epi_inputs(torch, shape, dtype, residual, gen, device)
            out = kern(*args)
            ref = kern.plain(*args)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            ulp = _ulp_dist(torch, out, ref)
            _check(torch.isfinite(out.float()).all().item(),
                   f"{name} {shape} {dt}: non-finite output")
            _check(ulp <= EPI_MAX_ULP,
                   f"{name} {shape} {dt}: {ulp} ulp from its twin "
                   f"(max_abs_err {err:.3e})")
            row = {"kernel": name, "shape": list(shape), "dtype": dt,
                   "max_abs_err": err, "max_ulp": ulp,
                   "per_forward": shapes[name][shape] if dt == "float32"
                   else 0}
            if dt == "float32":
                numel = math.prod(shape)
                nbytes = numel * 4 * (3 if residual else 2) + 2 * shape[1] * 4
                sets = [args] + [_epi_inputs(torch, shape, dtype, residual,
                                             gen, device)
                                 for _ in range(_n_sets(nbytes) - 1)]
                row["ms"] = _graph_ms(torch, kern, sets)
                row["plain_ms"] = _graph_ms(torch, kern.plain, sets)
                row["library_ms"] = None
                if name == "bn_apply":
                    row["library_ms"] = _graph_ms(
                        torch, lambda z, s, b: torch.addcmul(
                            b.view(1, -1, 1, 1), z, s.view(1, -1, 1, 1)),
                        sets)
                row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
                row["bound_by"] = "bytes"
                del sets
            rows.append(row)
            print(f"  {name:12s} {dt:8s} {str(shape):24s} ulp={ulp} "
                  f"err={err:.2e}" + (f" ms={row['ms']:.4f} "
                                      f"plain={row['plain_ms']:.4f} "
                                      f"bound={row['bound_ms']:.4f}"
                                      if "ms" in row else ""), flush=True)
    kern = fc.conv_bn_relu
    conv_shapes = shapes["conv_bn_relu"]
    cases = [(s, "float32", s[5] // 2) for s in conv_shapes]
    cases.append((min(s for s in conv_shapes if s[5] == 3), "bfloat16", 1))
    # off the batch-32 path, checked so every tile and k template is:
    # the 128x128 tile (batch 64, stage 2) and the runtime-k kernel on the
    # k=4 pad-(2,1) geometry of the JAX package's space-to-depth stem
    cases += [((2 * BATCH, 128, 28, 28, 128, 3), "float32", 1),
              ((2, 12, 16, 16, 32, 4), "float32", 2),
              ((2, 12, 16, 16, 32, 4), "bfloat16", 2)]
    for shape, dt, plo in cases:
        dtype = getattr(torch, dt)
        k = shape[5]
        kw = {"k": k, "pad_lo": (plo, plo), "pad_hi": (k - 1 - plo,) * 2}
        args = _conv_inputs(torch, shape, dtype, gen, device)
        out = kern(*args, **kw)
        ref = kern.plain(*args, **kw)
        torch.cuda.synchronize()
        _check(torch.isfinite(out.float()).all().item(),
               f"conv_bn_relu {shape} {dt}: non-finite output")
        err = float((out.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        rel = err / max(scale, 1e-30)
        _check(rel <= CONV_REL_TOL[dt],
               f"conv_bn_relu {shape} {dt}: max|kernel-twin| {err:.3e} is "
               f"{rel:.2e} of max|twin| {scale:.3e} (tol {CONV_REL_TOL[dt]})")
        on_path = dt == "float32" and shape in conv_shapes
        row = {"kernel": "conv_bn_relu", "shape": list(shape), "dtype": dt,
               "pad_lo": plo, "max_abs_err": err, "rel_err": rel,
               "per_forward": conv_shapes[shape] if on_path else 0}
        if on_path:
            flops, nbytes = _conv_bound(shape, 4)
            sets = [args] + [_conv_inputs(torch, shape, dtype, gen, device)
                             for _ in range(_n_sets(nbytes) - 1)]
            row["ms"] = _graph_ms(torch, lambda *a: kern(*a, **kw), sets)
            row["plain_ms"] = _graph_ms(torch,
                                        lambda *a: kern.plain(*a, **kw), sets)
            row["library_ms"] = _graph_ms(
                torch, lambda x, w, s, b: F.conv2d(x, w, padding=k // 2),
                sets)
            t_ops = flops / FP32_FLOP_PER_S * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            row["bound_ms"] = max(t_ops, t_bytes)
            row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
            del sets
        rows.append(row)
        print(f"  conv_bn_relu {dt:8s} {str(shape):28s} rel={rel:.2e}"
              + (f" ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                 f"conv2d={row['library_ms']:.4f} "
                 f"bound={row['bound_ms']:.4f} ({row['tflops']:.1f} TFLOP/s)"
                 if "ms" in row else ""), flush=True)
    return rows


def _set_bn_stats(torch, net, gen):
    """Non-trivial BatchNorm parameters and running statistics, as a
    trained net has (drawn on the CPU from the seeded generator)."""
    for name, p in net._collect_params_with_prefix().items():
        t = p.data().astorch()
        leaf = name.rsplit(".", 1)[-1]
        draw = {"gamma": lambda: torch.rand(t.shape, generator=gen) * 0.4
                + 0.8,
                "beta": lambda: torch.randn(t.shape, generator=gen) * 0.05,
                "running_mean": lambda: torch.randn(t.shape,
                                                    generator=gen) * 0.05,
                "running_var": lambda: torch.rand(t.shape, generator=gen)
                * 0.4 + 0.8}.get(leaf)
        if draw is not None:
            t.copy_(draw())


def phase_model(torch, mx, fc):
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from incubator_mxnet_tpu_torch.serve import DynamicBatcher

    ctx = mx.gpu(0)
    gen = torch.Generator().manual_seed(SEED)
    net = resnet50_v1(classes=1000)
    net.initialize(mx.init.Xavier(generator=gen), ctx=ctx)
    rng = np.random.RandomState(SEED)
    images = rng.standard_normal((N_REQUESTS, 3, 224, 224)).astype(np.float32)
    net(mx.nd.array(images[:1], ctx=ctx))          # finish deferred init
    _set_bn_stats(torch, net, gen)
    net.hybridize()
    kernels = [fc.conv_bn_relu, fc.bn_add_act, fc.bn_act, fc.bn_apply]

    def forward(x):
        out = net(mx.nd.array(x, ctx=ctx)).asnumpy()
        return out

    forward(images[:BATCH])                          # warm-up

    # --- main path: serve 64 single-image requests ---------------------
    def predict(batch):
        return [forward(batch["data"])]

    batcher = DynamicBatcher(predict, buckets=(1, 2, 4, 8, 16, 32),
                             max_latency_ms=5.0, max_queue=128, name="r50")
    futures = [None] * N_REQUESTS

    def client(tid):
        for i in range(tid, N_REQUESTS, N_THREADS):
            futures[i] = batcher.submit({"data": images[i]})

    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with batcher:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        _check(not any(t.is_alive() for t in threads), "client threads hung")
        answers = [f.result(timeout=300)[0] for f in futures]
        _check(batcher.quiesce(timeout=60), "batcher did not drain")
    serve_s = time.perf_counter() - t0
    served = {k.name: k.launches for k in kernels}
    stats = batcher.stats.snapshot()
    batches = stats["batches_total"]
    print(f"serve: {N_REQUESTS} requests in {serve_s:.3f} s, {batches} "
          f"batches, launches {served}", flush=True)
    _check(stats["responses_ok"] == N_REQUESTS and stats["errors"] == 0,
           f"serving errors: {stats}")
    for name, per in PER_FORWARD.items():
        _check(served[name] == per * batches,
               f"{name}: {served[name]} launches over {batches} batches, "
               f"expected {per} per forward")

    # --- direct batch-32 forwards; per-forward launch counts -------------
    for k in kernels:
        k.launches = 0
    direct = np.concatenate([forward(images[i:i + BATCH])
                             for i in range(0, N_REQUESTS, BATCH)])
    per_forward = {k.name: k.launches * BATCH // N_REQUESTS for k in kernels}
    print(f"launches per batch-{BATCH} forward: {per_forward}", flush=True)
    _check(per_forward == PER_FORWARD and
           all(k.launches == PER_FORWARD[k.name] * N_REQUESTS // BATCH
               for k in kernels),
           f"launch counts {per_forward}, expected {PER_FORWARD}")
    _check(direct.shape == (N_REQUESTS, 1000) and np.isfinite(direct).all(),
           f"logits: shape {direct.shape}, finite {np.isfinite(direct).all()}")
    scale = float(np.abs(direct).max())
    serve_err = max(float(np.abs(a - direct[i]).max())
                    for i, a in enumerate(answers))
    exact_rows = sum(bool(np.array_equal(a, direct[i]))
                     for i, a in enumerate(answers))
    print(f"serve vs direct: max|d| {serve_err:.3e} (max|logit| "
          f"{scale:.3e}), {exact_rows}/{N_REQUESTS} rows bit-equal",
          flush=True)
    _check(serve_err <= SERVE_REL_TOL * scale,
           f"served answers differ from the direct forward by {serve_err}")

    # --- the same net through the plain twins on the card ----------------
    from incubator_mxnet_tpu_torch import tune
    saved = tune.kernels()
    try:
        for name, k in saved.items():
            tune.register_kernel(name, k.plain)
        for k in kernels:
            k.launches = 0
        plain = forward(images[:BATCH])
        _check(all(k.launches == 0 for k in kernels),
               "the plain run launched a kernel")
        plain_fps = _throughput(torch, forward, images[:BATCH])
    finally:
        for name, k in saved.items():
            tune.register_kernel(name, k)
    net_err = float(np.abs(direct[:BATCH] - plain).max())
    print(f"kernels vs twins, batch-{BATCH} logits: max|d| {net_err:.3e} "
          f"({net_err / scale:.2e} of max|logit|)", flush=True)
    _check(net_err <= NET_REL_TOL * scale,
           f"logits through kernels differ from twins by {net_err}")

    torch.cuda.reset_peak_memory_stats()
    fps = _throughput(torch, forward, images[:BATCH])
    peak = torch.cuda.max_memory_allocated()
    print(f"resnet50_v1 fp32 batch {BATCH}: {fps:.2f} img/s through the "
          f"kernels, {plain_fps:.2f} img/s through the twins; peak "
          f"{peak / 2 ** 20:.0f} MiB", flush=True)
    profile = phase_profile(torch, forward, images[:BATCH])
    return {"served_launches": served, "serve_seconds": serve_s,
            "serve_stats": stats, "per_forward": per_forward,
            "serve_max_abs_err": serve_err, "serve_rows_bit_equal":
            exact_rows, "net_max_abs_err": net_err, "max_abs_logit": scale,
            "img_per_s": fps, "plain_img_per_s": plain_fps,
            "peak_bytes": peak, "profile": profile}


_CATEGORIES = (("conv_bn_relu_kernel", "conv_bn_relu (hand)"),
               ("bn_epilogue_kernel", "bn epilogues (hand)"),
               ("memcpy", "copies"), ("conv", "cuDNN convolution"),
               ("xmma", "cuDNN convolution"), ("cudnn", "cuDNN convolution"),
               ("gemm", "cuBLAS matmul"), ("pool", "pooling"))


def phase_profile(torch, forward, x, iters=3):
    """Device time by kernel over `iters` batch-32 forwards under
    torch.profiler, and the device's idle share of the wall time (both
    under the profiler's own overhead)."""
    from torch.profiler import ProfilerActivity, profile
    forward(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            forward(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            kernels.append((e.key, dev_us / 1e3 / iters, e.count / iters))
    busy = sum(k[1] for k in kernels)
    by_cat = Counter()
    for key, ms, _ in kernels:
        low = key.lower()
        cat = next((c for tag, c in _CATEGORIES if tag in low),
                   "other elementwise")
        by_cat[cat] += ms
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    print(f"profile, per batch-{BATCH} forward: wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share "
          f"{(1 - busy / wall_ms) if busy else float('nan'):.3f}", flush=True)
    for cat, ms in by_cat.most_common():
        print(f"  {cat:22s} {ms:8.3f} ms")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1 - busy / wall_ms) if busy else None,
            "by_category_ms": dict(by_cat),
            "top_kernels": [{"name": k[0][:160], "ms": k[1], "calls": k[2]}
                            for k in top]}


def _throughput(torch, forward, x, iters=10):
    for _ in range(3):
        forward(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        forward(x)
    torch.cuda.synchronize()
    return iters * x.shape[0] / (time.perf_counter() - t0)


def kernels_line(rows, served):
    out = []
    for name in ("conv_bn_relu", "bn_add_act", "bn_act", "bn_apply"):
        mine = [r for r in rows if r["kernel"] == name]
        timed = [r for r in mine if "ms" in r]

        def per_forward(key):
            if any(r[key] is None for r in timed):
                return None
            return sum(r[key] * r["per_forward"] for r in timed)

        ops = sum(r["per_forward"] for r in timed
                  if r["bound_by"] == "operations")
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": served[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine
                               if r["dtype"] == "float32"),
            "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
            "bound_ms": per_forward("bound_ms"),
            "bound_by": "operations" if ops * 2 > sum(
                r["per_forward"] for r in timed) else "bytes",
            "library_ms": per_forward("library_ms")})
    return {"kernels": out}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch.nn.functional as F
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch import _cuda
    from incubator_mxnet_tpu_torch.parallel import fused_conv as fc

    report = {"card": phase_card(), "torch": torch.__version__,
              "cuda": torch.version.cuda}
    report["build"] = phase_build(fc, _cuda)
    device = torch.device("cuda", 0)
    shapes = resnet50_kernel_shapes(BATCH)
    for name, per in PER_FORWARD.items():
        _check(sum(shapes[name].values()) == per, f"shape table of {name}")
    print("kernel checks (kernel vs plain twin on the card):", flush=True)
    report["kernels"] = phase_kernels(torch, F, fc, shapes, device)
    torch.cuda.empty_cache()
    report["model"] = phase_model(torch, mx, fc)
    line = kernels_line(report["kernels"], report["model"]["served_launches"])
    report["kernels_line"] = line
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
