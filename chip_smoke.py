#!/usr/bin/env python3
"""Drive the PyTorch port (incubator_mxnet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, each of which fails the run (exit code != 0, no result line):
  1. print the card's name and power limit (nvidia-smi);
  2. build the hand CUDA kernels from the repository's sources (one nvcc
     per source, all at once, sm_90a);
  3. hold every forward kernel against its plain PyTorch twin on the card,
     at every shape the ResNet-50 v1 batch-32 forward launches it with
     (fp32), plus one bf16 shape each, and time kernel, twin and the one
     PyTorch call that computes the same function where there is one (CUDA
     graphs of back-to-back launches, inputs rotated to spill the 50 MB L2);
  4. the same for the fused 3x3 conv backward (conv3x3) at the four
     batch-32 shapes of the training step plus one bf16 shape, and check
     that a rerun gives a bit-identical dW;
  5. build resnet50_v1(classes=1000) on cuda:0 with seeded weights and
     non-trivial BatchNorm statistics, serve 64 single-image requests from
     8 threads through serve.DynamicBatcher (buckets 1..32) and check each
     answer against the row of a direct batch-32 forward;
  6. check the launch counters: per batch-32 forward conv_bn_relu 29,
     bn_add_act 16, bn_act 3, bn_apply 5, and the serving run's counts are
     those times the batches it dispatched;
  7. compare the batch-32 logits with the same net run through the plain
     twins on the card, and time the forward (img/s) both ways;
  8. train resnet50_v1(classes=1000), fp32, batch 32, from seeded weights
     for 3 steps of autograd.record / backward / Trainer.step (SGD, lr
     0.01, momentum 0.9) with MXTPU_FUSED_CONV_BWD=1; check the launches
     per step (conv3x3 16, bn_act 32, bn_add_act 16, bn_apply 5,
     conv_bn_relu 0), that no parameter's gradient is all zero, that the
     same steps through the twins give the same losses and weights, and
     that TrainStep.run_steps(3) gives the same losses;
  9. time the training step (img/s) with the knob on (hand backward) and
     off (cuDNN's), with a torch.profiler breakdown and peak memory;
 10. hold the three flash-attention kernels (fa_fwd, fa_bwd_dq with a
     non-zero dlse, fa_bwd_dkv) against their twins: bf16 at the flagship
     shape (BH 512, T 2048, D 64, causal), fp32 at (64, 512, 64) causal and
     not, and Tq != Tk non-causal in both dtypes; reruns bit-identical;
     time kernel, twin and PyTorch's flash-attention ops;
 11. the Transformer-LM flagship training step (12 x 1024, 16 heads,
     d_ff 4096, vocab 32000, T 2048, batch 32, bf16, remat, Adam lr 1e-3)
     through models.TransformerLM.make_train_step: launches per step
     fa_fwd 24, fa_bwd_dq 12, fa_bwd_dkv 12; finite loss; no all-zero
     gradient among the 124 parameters; n_steps=3 equals 3 single steps;
     3 steps through the twins against the kernels (2 layers, full width);
     tokens/s, MFU, peak memory and a torch.profiler breakdown.
It prints the card line, the kernels line and, last,
{"ok": true, "device": {...}}; details go to chiprun_out/chip_smoke.json.
Without a CUDA device, or without the package beside it, it exits non-zero.
"""
from __future__ import annotations

import importlib
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

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, fp32 FMA FLOP/s,
# dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
L2_BYTES = 50 * 2 ** 20

BATCH = 32
N_REQUESTS = 64
N_THREADS = 8
SEED = 0
PER_FORWARD = {"conv_bn_relu": 29, "bn_add_act": 16, "bn_act": 3,
               "bn_apply": 5}
PER_TRAIN_STEP = {"conv3x3": 16, "bn_act": 32, "bn_add_act": 16,
                  "bn_apply": 5, "conv_bn_relu": 0}
TRAIN_STEPS = 3
LR, MOMENTUM = 0.01, 0.9
SOURCES = ("fused_conv", "conv_backward", "flash_attention")
SOURCE = {name: "incubator_mxnet_tpu_torch/csrc/fused_conv.cu"
          for name in PER_FORWARD}
SOURCE["conv3x3"] = "incubator_mxnet_tpu_torch/csrc/conv_backward.cu"
for _fa in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"):
    SOURCE[_fa] = "incubator_mxnet_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "conv_bn_relu": "incubator_mxnet_tpu/parallel/fused_conv.py:255",
    "bn_add_act": "incubator_mxnet_tpu/parallel/fused_conv.py:108",
    "bn_act": "incubator_mxnet_tpu/parallel/fused_conv.py:103",
    "bn_apply": "incubator_mxnet_tpu/parallel/fused_conv.py:103",
    "conv3x3": "incubator_mxnet_tpu/parallel/conv_backward.py:126",
    "fa_fwd": "incubator_mxnet_tpu/parallel/flash_attention.py:75",
    "fa_bwd_dq": "incubator_mxnet_tpu/parallel/flash_attention.py:201",
    "fa_bwd_dkv": "incubator_mxnet_tpu/parallel/flash_attention.py:265",
}
# the Transformer-LM flagship (bench.py:322-330 bench_transformer)
LM_CONFIG = dict(vocab_size=32000, d_model=1024, n_heads=16, n_layers=12,
                 d_ff=4096, max_len=2048, dtype="bfloat16", remat=True)
LM_BATCH, LM_LR = 32, 1e-3
LM_TIMED_STEPS, LM_WARMUP_STEPS = 5, 2
LM_TWIN_LAYERS = 2
PER_LM_STEP = {"fa_fwd": 24, "fa_bwd_dq": 12, "fa_bwd_dkv": 12}
# flash kernels vs their twins (the same block recurrence at the JAX
# package's 1024-row blocks, in PyTorch): the kernels run 64-row tiles,
# so the online softmax rescales at other points and the bf16 roundings of
# P and dS (before their products, on both sides) may go the other way:
# max|kernel - twin| <= tol * max|twin| for out, dq, dk, dv and delta, and
# |lse_kernel - lse_twin| <= 1e-5 (float32 in both dtypes: the bf16
# products are exact in f32). Set at about 2x (bf16) and 10x (fp32, lse)
# the worst errors of the first runs on the card (4.9e-3 bf16 dv at the
# flagship shape, 8e-7 fp32, 9.5e-7 lse); the first gates were 2e-2 /
# 1e-4 and lse 1e-3 / 1e-5.
FA_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
FA_LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-5}
# the flagship through the twins vs through the kernels, 3 Adam steps at
# full width and 2 layers: each step's loss within 1e-3 relative, and
# ||w_kernels - w_twins|| <= 0.1 ||w_twins - w_0|| over all parameters.
# The first run on the card measured 1.0e-5 and 0.027: the bf16 weights
# take Adam updates of a few bf16 ulps, so a weight that the two sides
# round the other way moves its update by a whole ulp.
LM_LOSS_REL_TOL = 1e-3
LM_UPDATE_REL_TOL = 0.1
# make_train_step(n_steps=3) vs 3 single steps: the same kernels and
# cuBLAS calls in the same order, so the same loss and weights to 1e-6.
LM_NSTEPS_REL_TOL = 1e-6
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
#  conv3x3 backward vs its twin (the same backward summed in float64 by
#  PyTorch, cast to the working dtype): dx sums O*9 terms and dW up to
#  N*H*W = 100,352 terms in fp32, in another order: max|kernel - twin| <=
#  tol * max|twin| for dx and for dW. cuDNN's own fp32 backward (the
#  library call) is held to nothing; its distance to the twin is recorded.
BWD_REL_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
#  training checks run with cuDNN's deterministic algorithms: with its
#  default ones the same 3-step Trainer loop run twice already differs in
#  the step-3 loss and the weight updates (phase 8 measures and reports
#  it), because this randomly initialised net's trajectory amplifies
#  last-bit differences. Kernels vs twins: the hand conv3x3 backward and
#  cuDNN's sum in other orders, which the trajectory amplifies the same
#  way. So: each step's mean loss within 5e-3 relative, and
#  ||w_kernels - w_twins|| <= 0.2 * ||w_twins - w_0|| summed over all
#  parameters, which a missing or doubled gradient in any large part of
#  the net exceeds.
TRAIN_LOSS_REL_TOL = 5e-3
TRAIN_UPDATE_REL_TOL = 0.2
#  TrainStep.run_steps vs the record/backward/Trainer loop, both through
#  the kernels and deterministic: the same arithmetic up to an exact 1/32
#  scaling of the head gradient, so the same losses to 1e-6 relative.
TRAINSTEP_LOSS_REL_TOL = 1e-6


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


def phase_build(cuda, modules):
    """Build every source at once (one nvcc each), then load each."""
    t0 = time.perf_counter()
    cuda.build(SOURCES)
    for mod in modules:
        mod.build()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in SOURCES:
        log = cuda.log_path(name)
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "spill" in ln] \
            if log.exists() else []
        for ln in ptxas[name]:
            if "spill" in ln and not ln.startswith("0 bytes"):
                print(f"  ptxas {name}: {ln}")
    print(f"build: {', '.join(SOURCES)} in {secs:.1f} s", flush=True)
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
            with torch.no_grad():       # gamma/beta are autograd leaves
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
    profile = phase_profile(torch, lambda: forward(images[:BATCH]),
                            f"batch-{BATCH} forward")
    return {"served_launches": served, "serve_seconds": serve_s,
            "serve_stats": stats, "per_forward": per_forward,
            "serve_max_abs_err": serve_err, "serve_rows_bit_equal":
            exact_rows, "net_max_abs_err": net_err, "max_abs_logit": scale,
            "img_per_s": fps, "plain_img_per_s": plain_fps,
            "peak_bytes": peak, "profile": profile}


_CATEGORIES = (("conv_bn_relu_kernel", "conv_bn_relu (hand)"),
               ("bn_epilogue_kernel", "bn epilogues (hand)"),
               ("namespace)::dgrad_kernel", "conv3x3 backward (hand)"),
               ("namespace)::wgrad_kernel", "conv3x3 backward (hand)"),
               ("namespace)::reduce_kernel", "conv3x3 backward (hand)"),
               ("foreach", "optimizer (foreach)"),
               ("memcpy", "copies"), ("conv", "cuDNN convolution"),
               ("xmma", "cuDNN convolution"), ("cudnn", "cuDNN convolution"),
               ("gemm", "cuBLAS matmul"), ("pool", "pooling"))


_LM_CATEGORIES = (("fa_fwd_kernel", "flash attention fwd (hand)"),
                  ("fa_bwd_dq_kernel", "flash attention dq (hand)"),
                  ("fa_bwd_dkv_kernel", "flash attention dk/dv (hand)"),
                  ("gemm", "cuBLAS matmul"), ("xmma", "cuBLAS matmul"),
                  ("nvjet", "cuBLAS matmul"), ("cutlass", "cuBLAS matmul"),
                  ("softmax", "log_softmax"), ("foreach", "optimizer"),
                  ("embedding", "embedding"), ("index", "embedding"),
                  ("memcpy", "copies"), ("reduce", "reductions (LayerNorm, "
                                                    "loss)"))


def phase_profile(torch, fn, label, iters=3, categories=_CATEGORIES):
    """Device time by kernel over `iters` calls of fn() under
    torch.profiler, and the device's idle share of the wall time (both
    under the profiler's own overhead)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
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
        cat = next((c for tag, c in categories if tag in low),
                   "other elementwise")
        by_cat[cat] += ms
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    print(f"profile, per {label}: wall {wall_ms:.3f} ms, "
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


def conv3x3_train_shapes(shapes):
    """Counter((n, c, h, w) -> launches per training step) of the conv3x3
    backward: the 3x3 conv of every bottleneck unit (c in = c out)."""
    return Counter({s[:4]: n for s, n in shapes["conv_bn_relu"].items()
                    if s[5] == 3})


def _bwd_inputs(torch, shape, dtype, gen, device):
    n, c, h, w = shape
    x = torch.randn(shape, generator=gen, device=device).to(dtype)
    wt = (torch.randn((c, c, 3, 3), generator=gen, device=device)
          / math.sqrt(9 * c)).to(dtype)
    go = torch.randn(shape, generator=gen, device=device).to(dtype)
    return (x, wt, go)


def _cudnn_bwd(torch):
    """PyTorch's conv backward in the working dtype (cuDNN on the card):
    the library call beside the hand conv3x3 backward."""
    def bwd(x, wt, go):
        return (torch.nn.grad.conv2d_input(x.shape, wt, go, padding=1),
                torch.nn.grad.conv2d_weight(x, wt.shape, go, padding=1))
    return bwd


def phase_conv_backward(torch, cb, shapes, device):
    """conv3x3 backward vs its twin at every batch-32 training shape (fp32)
    plus one bf16 shape; a rerun must give bit-identical dx and dW."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    kern = cb.conv3x3_bwd
    cases = [(s, "float32") for s in shapes] + [(min(shapes), "bfloat16")]
    rows = []
    for shape, dt in cases:
        dtype = getattr(torch, dt)
        args = _bwd_inputs(torch, shape, dtype, gen, device)
        dx, dw = kern(*args)
        rdx, rdw = kern.plain(*args)
        dx2, dw2 = kern(*args)
        torch.cuda.synchronize()
        row = {"kernel": "conv3x3", "shape": list(shape), "dtype": dt,
               "bit_identical_rerun": bool(torch.equal(dw, dw2)
                                           and torch.equal(dx, dx2))}
        for name, out, ref in (("dx", dx, rdx), ("dw", dw, rdw)):
            _check(torch.isfinite(out.float()).all().item(),
                   f"conv3x3 {shape} {dt}: non-finite {name}")
            err = float((out.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            rel = err / max(scale, 1e-30)
            _check(rel <= BWD_REL_TOL[dt],
                   f"conv3x3 {shape} {dt}: max|{name} - twin| {err:.3e} is "
                   f"{rel:.2e} of max|twin| {scale:.3e} "
                   f"(tol {BWD_REL_TOL[dt]})")
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_rel_err"] = rel
        row["max_abs_err"] = max(row["dx_max_abs_err"], row["dw_max_abs_err"])
        _check(row["bit_identical_rerun"],
               f"conv3x3 {shape} {dt}: a rerun changed dx or dW")
        row["per_forward"] = shapes[shape] if dt == "float32" else 0
        if dt == "float32":
            n, c, h, w = shape
            flops = 2 * 2.0 * n * h * w * c * c * 9
            nbytes = (3 * n * c * h * w + 2 * c * c * 9) * 4
            sets = [args] + [_bwd_inputs(torch, shape, dtype, gen, device)
                             for _ in range(_n_sets(nbytes) - 1)]
            row["ms"] = _graph_ms(torch, kern, sets)
            row["plain_ms"] = _graph_ms(torch, kern.plain, sets)
            row["library_ms"] = _graph_ms(torch, _cudnn_bwd(torch), sets)
            ldx, ldw = _cudnn_bwd(torch)(*args)
            row["library_dx_rel_err"] = float(
                (ldx - rdx).abs().max() / rdx.abs().max())
            row["library_dw_rel_err"] = float(
                (ldw - rdw).abs().max() / rdw.abs().max())
            t_ops = flops / FP32_FLOP_PER_S * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            row["bound_ms"] = max(t_ops, t_bytes)
            row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
            del sets
        rows.append(row)
        print(f"  conv3x3 bwd  {dt:8s} {str(shape):24s} "
              f"dx rel={row['dx_rel_err']:.2e} dW rel={row['dw_rel_err']:.2e}"
              + (f" ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                 f"cudnn={row['library_ms']:.4f} bound={row['bound_ms']:.4f}"
                 f" ({row['tflops']:.1f} TFLOP/s); cudnn rel dx="
                 f"{row['library_dx_rel_err']:.2e} "
                 f"dW={row['library_dw_rel_err']:.2e}" if "ms" in row
                 else ""), flush=True)
    return rows


def _mean_ce(torch):
    """Mean softmax cross entropy of (logits, float class labels): what
    SoftmaxCrossEntropyLoss averages, as a TrainStep loss_fn."""
    def loss_fn(out, label):
        logp = torch.log_softmax(out, dim=-1)
        return -logp.gather(1, label.long()[:, None]).mean()
    return loss_fn


class _TrainRig:
    """resnet50_v1(classes=1000) on cuda:0 from seeded Xavier weights, one
    seeded batch-32 batch, and the record/backward/Trainer.step loop."""

    def __init__(self, torch, mx):
        from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
            resnet50_v1
        self.mx = mx
        ctx = mx.gpu(0)
        gen = torch.Generator().manual_seed(SEED + 1)
        self.net = resnet50_v1(classes=1000)
        self.net.initialize(mx.init.Xavier(generator=gen), ctx=ctx)
        rng = np.random.RandomState(SEED + 1)
        self.x = mx.nd.array(rng.standard_normal((BATCH, 3, 224, 224))
                             .astype(np.float32), ctx=ctx)
        self.y = mx.nd.array(rng.randint(0, 1000, BATCH).astype(np.float32),
                             ctx=ctx)
        self.net(self.x)                          # finish deferred init
        self.params = self.net._collect_params_with_prefix()
        self.init = self.weights()
        self.loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def weights(self):
        return {k: p.data().astorch().detach().clone()
                for k, p in self.params.items()}

    def reset(self):
        """Back to the initial weights, in place."""
        for k, p in self.params.items():
            p.set_data(self.mx.nd.NDArray(self.init[k]))

    def trainer(self):
        return self.mx.gluon.Trainer(
            self.net.collect_params(), "sgd",
            {"learning_rate": LR, "momentum": MOMENTUM})

    def train(self, steps, trainer=None):
        """``steps`` steps; returns each step's mean loss."""
        mx = self.mx
        trainer = trainer or self.trainer()
        losses = []
        for _ in range(steps):
            with mx.autograd.record():
                L = self.loss(self.net(self.x), self.y)
            L.backward()
            trainer.step(BATCH)
            losses.append(float(L.asnumpy().mean()))
        return losses


def phase_train(torch, mx, kernels):
    """The training main path: 3 steps of record/backward/Trainer.step on
    resnet50_v1 fp32 batch 32 with MXTPU_FUSED_CONV_BWD=1, the same steps
    through the twins, TrainStep.run_steps (all with cuDNN's deterministic
    algorithms), then timing with its default ones."""
    os.environ["MXTPU_FUSED_CONV_BWD"] = "1"
    rig = _TrainRig(torch, mx)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        checks = _train_checks(torch, rig, kernels)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    checks["default_algorithms_rerun"] = _train_rerun_spread(rig)
    return dict(checks, **_train_timing(torch, rig))


def _trajectory_gap(init, a, b):
    """(max relative loss gap, update gap in relative L2) of two
    (losses, weights) runs from the same initial weights ``init``."""
    (la, wa), (lb, wb) = a, b
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
    num = sum(float((wa[k].double() - wb[k].double()).pow(2).sum())
              for k in init)
    den = sum(float((wb[k].double() - init[k].double()).pow(2).sum())
              for k in init)
    return loss_rel, math.sqrt(num / den)


def _train_rerun_spread(rig):
    """The same 3-step loop through the kernels, twice, with cuDNN's
    default (not deterministic) algorithms: how far the trajectory moves
    by itself."""
    runs = []
    for _ in range(2):
        rig.reset()
        runs.append((rig.train(TRAIN_STEPS), rig.weights()))
    loss_rel, update_rel = _trajectory_gap(rig.init, *runs)
    print(f"train, the kernel path twice with cuDNN's default algorithms: "
          f"losses {runs[0][0]} / {runs[1][0]}, max rel {loss_rel:.2e}; "
          f"updates differ by {update_rel:.2e} (relative L2)", flush=True)
    return {"loss_rel": loss_rel, "update_rel": update_rel}


def _train_checks(torch, rig, kernels):
    """Launch counts, gradients, the twin trajectory and TrainStep, all
    from the same initial weights."""
    from incubator_mxnet_tpu_torch import tune
    from incubator_mxnet_tpu_torch.parallel import TrainStep

    params = rig.params
    rig.reset()
    for k in kernels:
        k.launches = 0
    per_step = []
    trainer = rig.trainer()
    losses = []
    for _ in range(TRAIN_STEPS):
        before = {k.name: k.launches for k in kernels}
        losses += rig.train(1, trainer)
        per_step.append({k.name: k.launches - before[k.name]
                         for k in kernels})
    launches = {k.name: k.launches for k in kernels}
    print(f"train: losses {losses}; launches per step {per_step}",
          flush=True)
    for step in per_step:
        _check(step == PER_TRAIN_STEP,
               f"launches per training step {step}, expected "
               f"{PER_TRAIN_STEP}")
    _check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    zero = [k for k, p in params.items() if p.grad_req != "null"
            and not bool(p.grad().astorch().abs().max() > 0)]
    _check(not zero, f"all-zero gradients: {zero[:5]}")
    w_kernels = rig.weights()

    # --- the same steps through the twins --------------------------------
    saved = tune.kernels()
    try:
        for name, k in saved.items():
            tune.register_kernel(name, k.plain)
        for k in kernels:
            k.launches = 0
        rig.reset()
        plain_losses = rig.train(TRAIN_STEPS)
        _check(all(k.launches == 0 for k in kernels),
               "the twin run launched a kernel")
    finally:
        for name, k in saved.items():
            tune.register_kernel(name, k)
    w_plain = rig.weights()
    loss_rel, update_rel = _trajectory_gap(rig.init, (losses, w_kernels),
                                           (plain_losses, w_plain))
    print(f"train, kernels vs twins: losses {plain_losses}, max rel "
          f"{loss_rel:.2e}; weight updates differ by {update_rel:.2e} "
          f"(relative L2)", flush=True)
    _check(loss_rel <= TRAIN_LOSS_REL_TOL,
           f"training losses through kernels and twins differ by {loss_rel}")
    _check(update_rel <= TRAIN_UPDATE_REL_TOL,
           f"weight updates through kernels and twins differ by "
           f"{update_rel}")

    # --- TrainStep from the same weights ---------------------------------
    rig.reset()
    step = TrainStep(rig.net, _mean_ce(torch), optimizer="sgd",
                     optimizer_params={"learning_rate": LR,
                                       "momentum": MOMENTUM},
                     example_inputs=[rig.x, rig.y])
    step_losses = [float(v) for v in step.run_steps(TRAIN_STEPS, rig.x,
                                                     rig.y).asnumpy()]
    step_rel = max(abs(a - b) / abs(b) for a, b in zip(step_losses, losses))
    print(f"TrainStep.run_steps({TRAIN_STEPS}): {step_losses}, max rel "
          f"{step_rel:.2e} from the Trainer loop", flush=True)
    _check(step_rel <= TRAINSTEP_LOSS_REL_TOL,
           f"TrainStep losses differ from the Trainer loop by {step_rel}")
    del step
    return {"losses": losses, "plain_losses": plain_losses,
            "trainstep_losses": step_losses, "per_step": per_step,
            "launches": launches, "loss_rel": loss_rel,
            "update_rel": update_rel, "trainstep_rel": step_rel}


def _train_timing(torch, rig):
    """img/s of the training step with the knob on (hand backward) and off
    (cuDNN's), in turns; profiles and peak memory."""
    trainer = rig.trainer()
    img_s = {"1": [], "0": []}
    peak = {}
    for knob in ("1", "0", "0", "1"):
        os.environ["MXTPU_FUSED_CONV_BWD"] = knob
        rig.train(2, trainer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rig.train(5, trainer)
        torch.cuda.synchronize()
        img_s[knob].append(5 * BATCH / (time.perf_counter() - t0))
        peak[knob] = torch.cuda.max_memory_allocated()
    print(f"resnet50_v1 fp32 batch {BATCH} training: {img_s['1']} img/s "
          f"with the hand conv3x3 backward, {img_s['0']} img/s with "
          f"cuDNN's; peak {peak['1'] / 2 ** 20:.0f} / "
          f"{peak['0'] / 2 ** 20:.0f} MiB", flush=True)
    profiles = {}
    for knob in ("1", "0"):
        os.environ["MXTPU_FUSED_CONV_BWD"] = knob
        profiles[knob] = phase_profile(
            torch, lambda: rig.train(1, trainer),
            f"training step, knob {knob}")
    os.environ["MXTPU_FUSED_CONV_BWD"] = "1"
    return {"img_per_s": img_s, "peak_bytes": peak, "profile": profiles}


# ---------------------------------------------------------------------------
# flash attention: kernels vs twins, and the Transformer-LM flagship
# ---------------------------------------------------------------------------

def _causal_pairs(tq, tk, causal):
    """(q, kv) pairs the attention weighs: all, or those with q >= kv."""
    if not causal:
        return tq * tk
    return sum(min(i + 1, tk) for i in range(tq))


def _fa_work(name, bh, tq, tk, d, causal, itemsize):
    """(FLOPs, bytes) one call needs: 2 FLOPs per multiply-add of each
    (BH, pairs, D) product (fwd 2, dq 3, dk/dv 4), each input read once
    and each output written once (lse, dlse, delta are float32 rows)."""
    pairs = bh * _causal_pairs(tq, tk, causal)
    products = {"fa_fwd": 2, "fa_bwd_dq": 3, "fa_bwd_dkv": 4}[name]
    q_el, k_el, row = bh * tq * d, bh * tk * d, bh * tq * 4
    nbytes = {"fa_fwd": (q_el * 2 + k_el * 2) * itemsize + row,
              "fa_bwd_dq": (q_el * 4 + k_el * 2) * itemsize + 3 * row,
              "fa_bwd_dkv": (q_el * 2 + k_el * 4) * itemsize + 2 * row}[name]
    return 2.0 * products * pairs * d, nbytes


def _fa_inputs(torch, case, gen, device):
    dt, bh, tq, tk, d, causal = case
    dtype = getattr(torch, dt)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    return {"q": randn(bh, tq, d), "k": randn(bh, tk, d),
            "v": randn(bh, tk, d), "do": randn(bh, tq, d),
            "dlse": 0.1 * torch.randn((bh, tq), generator=gen,
                                      device=device)}


def _fa_library(torch, name, case, x, sm):
    """One PyTorch call beside each kernel, bf16 only: aten's flash
    attention forward (returns the logsumexp too) and its backward (dq, dk
    and dv in one call, so both backward rows carry it)."""
    dt, bh, tq, tk, d, causal = case
    if dt != "bfloat16" or tq != tk:
        return None
    aten = torch.ops.aten
    q4, k4, v4, do4 = (x[n].view(1, bh, -1, d) for n in ("q", "k", "v", "do"))
    fwd = aten._scaled_dot_product_flash_attention
    if name == "fa_fwd":
        return lambda: fwd(q4, k4, v4, 0.0, causal, False, scale=sm)
    r = fwd(q4, k4, v4, 0.0, causal, False, scale=sm)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do4, q4, k4, v4, r[0], r[1], r[2], r[3], r[4], r[5], 0.0, causal,
        r[6], r[7], scale=sm)


def phase_flash_kernels(torch, fa, device):
    """fa_fwd, fa_bwd_dq (non-zero dlse) and fa_bwd_dkv vs their twins on
    the same inputs; reruns bit-identical; times of kernel, twin and the
    library call. Rows on the flagship path carry their launches per
    step."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    head = LM_CONFIG["d_model"] // LM_CONFIG["n_heads"]
    flagship = ("bfloat16", LM_BATCH * LM_CONFIG["n_heads"],
                LM_CONFIG["max_len"], LM_CONFIG["max_len"], head, True)
    timed = [flagship, ("float32", 64, 512, 512, 64, True),
             ("float32", 64, 512, 512, 64, False),
             ("float32", 16, 256, 512, 64, False),
             ("bfloat16", 16, 256, 512, 64, False)]
    # checked, not timed: ragged last tiles (T = 200 is 3 tiles + 8 rows),
    # a head dim padded in shared memory (40 -> 64), the 128-wide
    # templates, and causal with Tq != Tk
    checked = [("bfloat16", 8, 200, 200, 40, True),
               ("bfloat16", 8, 256, 256, 128, True),
               ("float32", 8, 200, 200, 128, False),
               ("float32", 8, 128, 200, 64, True)]
    rows = []
    for case in timed + checked:
        dt, bh, tq, tk, d, causal = case
        sm = 1.0 / math.sqrt(d)
        x = _fa_inputs(torch, case, gen, device)
        q, k, v, do, dlse = x["q"], x["k"], x["v"], x["do"], x["dlse"]
        out, lse = fa.fa_fwd(q, k, v, causal, sm)
        dq, delta = fa.fa_bwd_dq(q, k, v, do, lse, out, dlse, causal, sm)
        dk, dv = fa.fa_bwd_dkv(k, v, q, do, lse, delta, causal, sm)
        reruns = (fa.fa_fwd(q, k, v, causal, sm)
                  + fa.fa_bwd_dq(q, k, v, do, lse, out, dlse, causal, sm)
                  + fa.fa_bwd_dkv(k, v, q, do, lse, delta, causal, sm))
        r_out, r_lse = fa.fa_fwd.plain(q, k, v, causal, sm)
        r_dq, r_delta = fa.fa_bwd_dq.plain(q, k, v, do, lse, out, dlse,
                                           causal, sm)
        r_dk, r_dv = fa.fa_bwd_dkv.plain(k, v, q, do, lse, delta, causal,
                                         sm)
        torch.cuda.synchronize()
        mine = (out, lse, dq, delta, dk, dv)
        identical = all(torch.equal(a, b) for a, b in zip(mine, reruns))
        _check(identical, f"flash {case}: a rerun changed an output")
        errs = {}
        for label, got, ref in (("out", out, r_out), ("dq", dq, r_dq),
                                ("delta", delta, r_delta), ("dk", dk, r_dk),
                                ("dv", dv, r_dv)):
            _check(torch.isfinite(got.float()).all().item(),
                   f"flash {case}: non-finite {label}")
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            errs[label] = (err, err / max(scale, 1e-30))
            _check(errs[label][1] <= FA_REL_TOL[dt],
                   f"flash {case}: max|{label} - twin| {err:.3e} is "
                   f"{errs[label][1]:.2e} of max|twin| {scale:.3e} "
                   f"(tol {FA_REL_TOL[dt]})")
        lse_err = float((lse - r_lse).abs().max())
        _check(lse_err <= FA_LSE_TOL[dt],
               f"flash {case}: max|lse - twin| {lse_err:.3e} "
               f"(tol {FA_LSE_TOL[dt]})")
        calls = {
            "fa_fwd": (fa.fa_fwd, (q, k, v, causal, sm), ("out",)),
            "fa_bwd_dq": (fa.fa_bwd_dq, (q, k, v, do, lse, out, dlse, causal,
                                         sm), ("dq", "delta")),
            "fa_bwd_dkv": (fa.fa_bwd_dkv, (k, v, q, do, lse, delta, causal,
                                           sm), ("dk", "dv"))}
        on_path = case == flagship
        line = [f"  flash {dt:8s} bh={bh} tq={tq} tk={tk} d={d} "
                f"causal={causal}: lse err {lse_err:.2e}, "
                + ", ".join(f"{n} rel {e[1]:.2e}" for n, e in errs.items())]
        itemsize = 2 if dt == "bfloat16" else 4
        for name, (kern, args, outs) in calls.items():
            flops, nbytes = _fa_work(name, bh, tq, tk, d, causal, itemsize)
            t_ops = flops / (BF16_FLOP_PER_S if dt == "bfloat16"
                             else FP32_FLOP_PER_S) * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            row = {"kernel": name, "shape": [bh, tq, tk, d],
                   "causal": causal, "dtype": dt,
                   "max_abs_err": max(errs[o][0] for o in outs),
                   "rel_err": max(errs[o][1] for o in outs),
                   "lse_abs_err": lse_err, "bit_identical_rerun": identical,
                   "per_forward": PER_LM_STEP[name] if on_path else 0,
                   "gflop": flops / 1e9, "bytes": nbytes,
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes
                   else "bytes"}
            rows.append(row)
            if case not in timed:
                continue
            sets = [args]
            row["ms"] = _graph_ms(torch, kern, sets, reps=10)
            row["plain_ms"] = _graph_ms(torch, kern.plain, sets, reps=3)
            lib = _fa_library(torch, name, case, x, sm)
            row["library_ms"] = (None if lib is None
                                 else _graph_ms(torch, lambda: lib(), [()],
                                                reps=10))
            row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
            line.append(f"    {name:10s} ms={row['ms']:.4f} "
                        f"plain={row['plain_ms']:.4f} library="
                        + (f"{row['library_ms']:.4f}" if lib else "none")
                        + f" bound={row['bound_ms']:.4f} ({row['bound_by']})"
                        f" {row['tflops']:.1f} TFLOP/s")
        print("\n".join(line), flush=True)
        del x, q, k, v, do, out, dq, dk, dv, reruns
        torch.cuda.empty_cache()
    return rows


def _lm_batch(vocab):
    """bench.py:337-340: seeded tokens, targets rolled by -1."""
    rng = np.random.RandomState(SEED)
    tokens = rng.randint(0, vocab, (LM_BATCH, LM_CONFIG["max_len"])) \
        .astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _lm_flops_per_step(params):
    """bench.py:356-357: 6 * (matmul + embedding params) * tokens + the
    attention term 12 * layers * B * T^2 * d_model (remat recompute not
    counted)."""
    cfg = LM_CONFIG
    n_matmul = sum(p.numel() for k, p in params.items()
                   if k.endswith(("wq", "wk", "wv", "wo", "w_in", "w_out")))
    tokens = LM_BATCH * cfg["max_len"]
    return (6 * (n_matmul + params["embed"].numel()) * tokens
            + 12 * cfg["n_layers"] * LM_BATCH * cfg["max_len"] ** 2
            * cfg["d_model"])


def phase_transformer(torch, fa, device):
    """The flagship training step through the port's entry points."""
    from incubator_mxnet_tpu_torch import tune
    from incubator_mxnet_tpu_torch.models import (TransformerConfig,
                                                  TransformerLM)
    from incubator_mxnet_tpu_torch.parallel import make_mesh

    kernels = [fa.fa_fwd, fa.fa_bwd_dq, fa.fa_bwd_dkv]
    mesh = make_mesh({"dp": 1}, devices=[device])
    model = TransformerLM(TransformerConfig(**LM_CONFIG))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    step, shard, init_opt = model.make_train_step(mesh, lr=LM_LR,
                                                  use_sp=False)
    init = shard(model.init_params(gen, device=device))
    n_params = 4 + 10 * LM_CONFIG["n_layers"]        # 124 at 12 layers
    _check(len(init) == n_params,
           f"{len(init)} parameters, expected {n_params}")
    tokens, targets = _lm_batch(LM_CONFIG["vocab_size"])
    flops = _lm_flops_per_step(init)

    # --- main path: one step, launches counted -------------------------
    for k in kernels:
        k.launches = 0
    params, opt, loss = step(init, init_opt(init), tokens, targets, 0)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    print(f"transformer step: loss {float(loss):.6f}, launches {launches}",
          flush=True)
    _check(launches == PER_LM_STEP,
           f"launches per step {launches}, expected {PER_LM_STEP}")
    _check(math.isfinite(float(loss)), f"loss {float(loss)}")

    # --- every parameter gets a gradient ---------------------------------
    leaves = {k: w.detach().requires_grad_(True) for k, w in init.items()}
    grads = torch.autograd.grad(model.loss(leaves, tokens, targets),
                                list(leaves.values()))
    zero = [k for k, g in zip(leaves, grads)
            if not bool(g.float().abs().max() > 0)]
    _check(not zero, f"all-zero gradients: {zero[:5]}")
    del leaves, grads

    # --- n_steps=3 vs three single steps --------------------------------
    singles = []
    p, o = init, init_opt(init)
    for i in range(3):
        p, o, l = step(p, o, tokens, targets, i)
        singles.append(float(l))
    multi, _, _ = model.make_train_step(mesh, lr=LM_LR, use_sp=False,
                                        n_steps=3)
    pm, _, lm = multi(init, init_opt(init), tokens, targets, 0)
    nsteps_loss_rel, nsteps_update_rel = _trajectory_gap(
        init, ([float(lm)], pm), ([singles[-1]], p))
    print(f"n_steps=3: loss {float(lm):.6f} vs single steps {singles}; "
          f"loss rel {nsteps_loss_rel:.2e}, params rel "
          f"{nsteps_update_rel:.2e}", flush=True)
    _check(nsteps_loss_rel <= LM_NSTEPS_REL_TOL
           and nsteps_update_rel <= LM_NSTEPS_REL_TOL,
           "make_train_step(n_steps=3) differs from 3 single steps")
    del p, o, pm

    # --- timing, peak memory, profile -------------------------------------
    p, o = init, init_opt(init)
    for i in range(LM_WARMUP_STEPS):
        p, o, l = step(p, o, tokens, targets, i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i in range(LM_TIMED_STEPS):
        p, o, l = step(p, o, tokens, targets, LM_WARMUP_STEPS + i)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / LM_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    tok_s = LM_BATCH * LM_CONFIG["max_len"] / step_s
    mfu = flops / step_s / BF16_FLOP_PER_S
    print(f"transformer flagship bf16 b{LM_BATCH} T{LM_CONFIG['max_len']}: "
          f"{step_s * 1e3:.2f} ms/step, {tok_s:.1f} tokens/s, MFU "
          f"{mfu:.4f} ({flops / 1e12:.2f} TFLOP/step over "
          f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s), loss {float(l):.6f}, "
          f"peak {peak / 2 ** 30:.2f} GiB", flush=True)
    state = {"p": p, "o": o, "i": LM_WARMUP_STEPS + LM_TIMED_STEPS}

    def one_step():
        state["p"], state["o"], _ = step(state["p"], state["o"], tokens,
                                         targets, state["i"])
        state["i"] += 1

    profile = phase_profile(torch, one_step, "transformer step", iters=2,
                            categories=_LM_CATEGORIES)
    del p, o, state, init

    # --- twins vs kernels, 2 layers at full width -------------------------
    twin = _lm_twin_trajectory(torch, tune, kernels, mesh)
    return {"loss_first_step": float(loss), "launches": launches,
            "single_step_losses": singles, "n_steps_loss": float(lm),
            "n_steps_loss_rel": nsteps_loss_rel,
            "n_steps_update_rel": nsteps_update_rel,
            "ms_per_step": step_s * 1e3, "tokens_per_s": tok_s, "mfu": mfu,
            "flop_per_step": flops, "peak_bytes": peak, "profile": profile,
            "twin": twin}


def _lm_twin_trajectory(torch, tune, kernels, mesh):
    from incubator_mxnet_tpu_torch.models import (TransformerConfig,
                                                  TransformerLM)
    cfg = dict(LM_CONFIG, n_layers=LM_TWIN_LAYERS)
    model = TransformerLM(TransformerConfig(**cfg))
    gen = torch.Generator(device=mesh.devices[0])
    gen.manual_seed(SEED + 1)
    step, shard, init_opt = model.make_train_step(mesh, lr=LM_LR,
                                                  use_sp=False)
    init = shard(model.init_params(gen, device=mesh.devices[0]))
    tokens, targets = _lm_batch(cfg["vocab_size"])

    def run():
        p, o, losses = init, init_opt(init), []
        for i in range(3):
            p, o, l = step(p, o, tokens, targets, i)
            losses.append(float(l))
        return losses, p

    kern_run = run()
    saved = tune.kernels()
    try:
        for name, k in saved.items():
            tune.register_kernel(name, k.plain)
        for k in kernels:
            k.launches = 0
        twin_run = run()
        _check(all(k.launches == 0 for k in kernels),
               "the twin run launched a kernel")
    finally:
        for name, k in saved.items():
            tune.register_kernel(name, k)
    loss_rel, update_rel = _trajectory_gap(init, kern_run, twin_run)
    print(f"transformer {LM_TWIN_LAYERS} layers, kernels vs twins: losses "
          f"{kern_run[0]} / {twin_run[0]}, max rel {loss_rel:.2e}; updates "
          f"differ by {update_rel:.2e} (relative L2)", flush=True)
    _check(loss_rel <= LM_LOSS_REL_TOL,
           f"losses through kernels and twins differ by {loss_rel}")
    _check(update_rel <= LM_UPDATE_REL_TOL,
           f"updates through kernels and twins differ by {update_rel}")
    return {"losses": kern_run[0], "twin_losses": twin_run[0],
            "loss_rel": loss_rel, "update_rel": update_rel}


def kernels_line(rows, launches):
    """Per kernel: ms, twin ms, bound and library ms summed over its rows
    on a main path (per batch-32 forward, or per training step), and the
    largest error of its rows in the main path's dtype."""
    out = []
    for name in ("conv_bn_relu", "bn_add_act", "bn_act", "bn_apply",
                 "conv3x3", "fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"):
        mine = [r for r in rows if r["kernel"] == name]
        timed = [r for r in mine if "ms" in r and r["per_forward"] > 0]
        path_dtype = "bfloat16" if name.startswith("fa_") else "float32"

        def per_forward(key):
            if any(r[key] is None for r in timed):
                return None
            return sum(r[key] * r["per_forward"] for r in timed)

        ops = sum(r["per_forward"] for r in timed
                  if r["bound_by"] == "operations")
        out.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine
                               if r["dtype"] == path_dtype),
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
    from incubator_mxnet_tpu_torch.parallel import conv_backward as cb
    from incubator_mxnet_tpu_torch.parallel import fused_conv as fc
    from incubator_mxnet_tpu_torch.util import getenv_str
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.parallel.flash_attention")

    report = {"card": phase_card(), "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "MXTPU_CONV_BWD_KERNEL": getenv_str("MXTPU_CONV_BWD_KERNEL")}
    report["build"] = phase_build(_cuda, (fc, cb, fa))
    device = torch.device("cuda", 0)
    shapes = resnet50_kernel_shapes(BATCH)
    for name, per in PER_FORWARD.items():
        _check(sum(shapes[name].values()) == per, f"shape table of {name}")
    bwd_shapes = conv3x3_train_shapes(shapes)
    _check(sum(bwd_shapes.values()) == PER_TRAIN_STEP["conv3x3"],
           "shape table of conv3x3")
    print("kernel checks (kernel vs plain twin on the card):", flush=True)
    report["kernels"] = phase_kernels(torch, F, fc, shapes, device)
    report["kernels"] += phase_conv_backward(torch, cb, bwd_shapes, device)
    torch.cuda.empty_cache()
    report["kernels"] += phase_flash_kernels(torch, fa, device)
    torch.cuda.empty_cache()
    report["model"] = phase_model(torch, mx, fc)
    torch.cuda.empty_cache()
    kernels = [fc.conv_bn_relu, fc.bn_add_act, fc.bn_act, fc.bn_apply,
               cb.conv3x3_bwd]
    report["train"] = phase_train(torch, mx, kernels)
    torch.cuda.empty_cache()
    report["transformer"] = phase_transformer(torch, fa, device)
    launches = {k.name: report["model"]["served_launches"].get(k.name, 0)
                + report["train"]["launches"][k.name] for k in kernels}
    launches.update(report["transformer"]["launches"])
    report["launches"] = {"serve": report["model"]["served_launches"],
                          "train": report["train"]["launches"],
                          "transformer": report["transformer"]["launches"]}
    for name, n in launches.items():
        _check(n > 0, f"{name} was never launched on the main paths")
    line = kernels_line(report["kernels"], launches)
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
