"""The port stands alone, stays on the device it is given, and never
routes a CUDA tensor to a plain version.

- No file of `src/repro_torch/`, no example of `examples/torch/` and
  not `chip_smoke.py` imports JAX or the JAX package (an AST scan).
- The entry points default to the card and raise without one unless the
  caller asks for the CPU.
- A tensor on a CUDA device goes to the kernel or raises: the plain
  versions count their calls here and must see none.  Without a card a
  CUDA tensor cannot be made, so a tensor subclass reports a CUDA device.
- Importing the port changes no process-wide state.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import cuda_lib, ops, ref

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + \
        sorted((ROOT / "examples" / "torch").glob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_serving_modules():
    """The scan above reads every module of the port, the prefix cache,
    the chunked-prefill path, the MoE layer and the serving tier (pool,
    router, simulator, CLI), the modality front ends and model inputs
    and the mamba blocks, with their configs, the training path (the
    kernels' gradients, optimizers, train loop, checkpoints, CLI), the
    dry run with its graph analysis, the port's linter, and the four
    examples among them."""
    names = {p.relative_to(PORT).as_posix() for p in _port_files()
             if PORT in p.parents}
    assert {"runtime/prefix_cache.py", "runtime/engine.py",
            "runtime/kv_cache.py", "runtime/sanitizer.py",
            "core/pipeline.py", "models/transformer.py",
            "models/moe.py", "configs/olmoe_1b_7b.py",
            "cluster/pool.py", "cluster/router.py", "cluster/health.py",
            "core/simulator.py", "launch/serve.py", "models/frontend.py",
            "models/io.py", "configs/qwen2_vl_7b.py",
            "configs/starcoder2_15b.py", "configs/musicgen_large.py",
            "configs/qwen3_32b.py", "configs/llama3_405b.py",
            "models/ssm.py", "configs/falcon_mamba_7b.py",
            "configs/zamba2_1_2b.py", "kernels/autograd.py",
            "training/optimizer.py", "training/train_loop.py",
            "runtime/checkpoint.py", "data/pipeline.py",
            "launch/train.py", "launch/graph_analysis.py",
            "launch/dryrun.py", "launch/reanalyze.py",
            "analysis/config.py", "analysis/lint.py",
            "analysis/rules.py"} <= names
    examples = {p.name for p in _port_files()
                if p.parent == ROOT / "examples" / "torch"}
    assert examples == {"quickstart.py", "train_small.py", "serve_e2e.py",
                        "allocator_scheduler_demo.py"}


def test_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.api import TurboClient
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.runtime.engine import InferenceEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TurboClient.from_arch("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TurboClient.from_arch("internlm2-1.8b", replicas=2)
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve", "--replicas", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, params)
    assert InferenceEngine(cfg, params, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        init_params(cfg, device="meta")
    from repro_torch.data import TokenStream
    from repro_torch.launch import train
    from repro_torch.training import TrainConfig, Trainer, init_state
    tc = TrainConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(cfg, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenStream(cfg, 2, 8).batch(0)
    monkeypatch.setattr(sys, "argv", ["train", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main()
    assert Trainer(cfg, tc, device="cpu").device.type == "cpu"


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda(t):
    return torch.Tensor._make_subclass(_OnCuda, t)


def _calls(monkeypatch, module, names, seen=None):
    """Replace ``names`` in ``module`` with stubs that count calls into
    ``seen`` (returned)."""
    seen = {} if seen is None else seen
    for name in names:
        seen[name] = 0
        def stub(*args, _name=name, **kwargs):
            seen[_name] += 1
            return "kernel"
        monkeypatch.setattr(module, name, stub)
    return seen


PLAIN = ["rmsnorm_ref", "layernorm_ref", "flash_attention_ref",
         "flash_decode_paged_ref", "flash_decode_ref", "sample_ref",
         "softmax_ref"]


def _cases():
    x = torch.randn(4, 32)
    g = torch.ones(32)
    q = torch.randn(2, 4, 8, 128)               # the kernels' head dim
    kv = torch.randn(2, 2, 8, 128)
    pool = torch.randn(5, 4, 2, 128)
    tables = torch.ones(2, 2, dtype=torch.int32)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    logits = torch.randn(2, 100)
    rows = torch.ones(2)
    return {
        "fused_rmsnorm": (ops.fused_rmsnorm, (x, g)),
        "fused_layernorm": (ops.fused_layernorm, (x, g, g)),
        "flash_attention": (ops.flash_attention, (q, kv, kv)),
        "flash_decode_paged": (ops.flash_decode_paged,
                               (q[:, :, 0], pool, pool, tables, lens)),
        "flash_decode": (ops.flash_decode,
                         (q[:, :, 0].contiguous(), kv, kv, lens)),
        "fused_softmax": (ops.fused_softmax,
                          (x, torch.tensor([0, 5, 32, 40],
                                           dtype=torch.int32))),
        "fused_sample": (ops.fused_sample,
                         (logits, rows, torch.zeros(2, dtype=torch.int32),
                          rows, torch.randn(2, 16))),
    }


@pytest.mark.parametrize("op", sorted(_cases()))
def test_cuda_tensors_never_reach_a_plain_version(monkeypatch, op):
    plain = _calls(monkeypatch, ref, PLAIN)
    kernels = {}
    for module, name in ((ops._ln, "norm_cuda"),
                         (ops._fa, "flash_attention_cuda"),
                         (ops._fd, "flash_decode_paged_cuda"),
                         (ops._fd, "flash_decode_cuda"),
                         (ops._smp, "sample_cuda"),
                         (ops._sm, "softmax_cuda")):
        _calls(monkeypatch, module, [name], kernels)
    fn, args = _cases()[op]
    assert fn(*[_cuda(a) for a in args]) == "kernel"
    assert sum(kernels.values()) == 1 and sum(plain.values()) == 0
    fn(*args)                                   # CPU tensors: plain only
    assert sum(kernels.values()) == 1 and sum(plain.values()) == 1


@pytest.mark.parametrize("op", sorted(_cases()))
def test_cuda_tensor_raises_when_the_kernel_cannot_run(monkeypatch, op):
    """No toolkit and no card: the wrapper raises, it does not fall back
    to the plain version, and counts no launch."""
    plain = _calls(monkeypatch, ref, PLAIN)
    monkeypatch.setattr(cuda_lib, "_lib", None)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    cuda_lib.reset_launches()
    fn, args = _cases()[op]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fn(*[_cuda(a) for a in args])
    assert sum(plain.values()) == 0 and not cuda_lib.LAUNCHES


def test_mixed_devices_raise():
    x = torch.randn(4, 32)
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        ops.fused_rmsnorm(x, _cuda(torch.ones(32)))


def test_importing_the_port_changes_no_process_state():
    code = """
import json, os, sys, warnings, torch
before = (torch.get_default_dtype(), torch.get_num_threads(),
          dict(os.environ), list(sys.path), list(warnings.filters),
          torch.initial_seed(), torch.get_rng_state().sum().item())
import importlib, pkgutil, repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
after = (torch.get_default_dtype(), torch.get_num_threads(),
         dict(os.environ), list(sys.path), list(warnings.filters),
         torch.initial_seed(), torch.get_rng_state().sum().item())
print(json.dumps([str(a) == str(b) for a, b in zip(before, after)]))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == [True] * 7
