"""Structure of the PyTorch port: it imports neither jax nor the JAX
package, its kernel dispatch has no fallback from the card to the plain
twins, and it defaults to the GPU without ever falling back to the CPU."""
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "incubator_mxnet_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


def test_import_and_cpu_forward_without_jax():
    """With jax unimportable, the port imports and runs a CPU forward, and
    no module of the JAX package is ever loaded."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        import numpy as np
        import incubator_mxnet_tpu_torch as mx
        from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
        net = vision.resnet50_v1(classes=7)
        net.initialize(mx.init.Xavier(), ctx=mx.cpu())
        x = np.random.RandomState(0).standard_normal((1, 3, 32, 32))
        out = net(mx.nd.array(x.astype(np.float32), ctx=mx.cpu())).asnumpy()
        assert out.shape == (1, 7) and np.isfinite(out).all()
        loaded = [m for m in sys.modules if m == "incubator_mxnet_tpu"
                  or m.startswith("incubator_mxnet_tpu.")]
        assert not loaded, loaded
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), \
        res.stdout + res.stderr


@pytest.mark.parametrize("rel", ["parallel/fused_conv.py", "tune.py",
                                 "parallel/hand_kernel.py",
                                 "parallel/flash_attention.py",
                                 "models/transformer.py", "parallel/mesh.py"])
def test_kernel_dispatch_has_no_fallback(rel):
    """No try/except around a launch and no environment switch in the
    kernel wrappers or the dispatcher: on the card a kernel runs or the
    call raises."""
    src = open(os.path.join(PKG, rel), encoding="utf-8").read()
    tree = ast.parse(src)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert "environ" not in src and "getenv" not in src


def test_conv_backward_reads_its_knob_only_in_the_gate():
    """The conv3x3 backward wrapper has no try/except, and the one knob it
    reads (MXTPU_FUSED_CONV_BWD) is read only by ``fused_eligible``, which
    decides whether a conv takes the conv3x3 Function on the CPU and the
    card alike; nothing switches the card from the kernel to its twin."""
    src = open(os.path.join(PKG, "parallel/conv_backward.py"),
               encoding="utf-8").read()
    tree = ast.parse(src)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    assert "environ" not in src
    readers = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for n in ast.walk(fn):
                if isinstance(n, ast.Name) and n.id.startswith("getenv"):
                    readers.add(fn.name)
    assert readers == {"fused_eligible"}


def test_default_context_is_gpu_and_never_falls_back():
    assert mx.current_context() == mx.gpu(0)
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        assert mx.nd.zeros((2,)).context == mx.cpu()
    if not torch.cuda.is_available():
        with pytest.raises(mx.MXNetError, match="ctx=mx.cpu"):
            mx.nd.array([1.0, 2.0])


def test_autograd_recording_is_not_silently_ported():
    """Recording and backward are ported and really record; what is not
    ported yet (a custom autograd.Function) raises instead of silently
    doing nothing."""
    assert not mx.autograd.is_training()
    with mx.autograd.train_mode():
        assert mx.autograd.is_training()
    assert not mx.autograd.is_training()
    x = mx.nd.array([1.0, 2.0], ctx=mx.cpu())
    x.attach_grad()
    with mx.autograd.record():
        assert mx.autograd.is_recording() and mx.autograd.is_training()
        y = x * x
    assert not mx.autograd.is_recording()
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), [2.0, 4.0])
    with pytest.raises(mx.MXNetError, match="no recorded graph"):
        mx.autograd.backward([x * 2.0])
    with pytest.raises(mx.MXNetError, match="not ported"):
        mx.autograd.Function()


def test_strict_fp32_turns_tf32_off():
    assert mx.runtime.fp32_matmul_mode() == "strict"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    try:
        mx.runtime.set_fp32_matmul_mode("fast")
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        mx.runtime.set_fp32_matmul_mode("strict")
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        mx.runtime.set_fp32_matmul_mode("sloppy")


def test_kernel_sources_ship_with_the_package():
    from incubator_mxnet_tpu_torch import _cuda
    assert (_cuda.CSRC / "fused_conv.cu").is_file()
    assert (_cuda.CSRC / "conv_backward.cu").is_file()
    assert (_cuda.CSRC / "simt_gemm.cuh").is_file()
    assert (_cuda.CSRC / "flash_attention.cu").is_file()
    assert _cuda.BUILD_DIR.name == ".torch_ext"
    ignored = open(os.path.join(ROOT, ".gitignore")).read().split()
    assert ".torch_ext/" in ignored


def test_flash_backward_runs_the_backward_kernels():
    """``_Flash`` owns its gradient: its forward calls the fa_fwd wrapper
    and its backward the fa_bwd_dq and fa_bwd_dkv wrappers (through
    ``tune.tuned_call``), never ``KernelFunction``, whose backward is a
    twin's autograd and would leave the backward kernels unlaunched."""
    src = open(os.path.join(PKG, "parallel/flash_attention.py"),
               encoding="utf-8").read()
    tree = ast.parse(src)
    assert "KernelFunction" not in src
    flash = next(n for n in ast.walk(tree)
                 if isinstance(n, ast.ClassDef) and n.name == "_Flash")

    def tuned_names(fn):
        return [c.args[0].value for c in ast.walk(fn)
                if isinstance(c, ast.Call)
                and getattr(c.func, "attr", None) == "tuned_call"]

    methods = {f.name: f for f in flash.body
               if isinstance(f, ast.FunctionDef)}
    assert tuned_names(methods["forward"]) == ["fa_fwd"]
    assert tuned_names(methods["backward"]) == ["fa_bwd_dq", "fa_bwd_dkv"]
    from incubator_mxnet_tpu_torch import tune
    for name in ("fa_fwd", "fa_bwd_dq", "fa_bwd_dkv"):
        kern = tune.kernels()[name]
        # the wrapper's call is the plain dispatch, with no autograd route
        assert type(kern).__call__ is type(kern).dispatch
