"""The port stands alone: importing it (and ``chip_smoke``) loads
neither JAX nor anything of the ``repro`` package, no source under
``src/repro_torch`` names them, and an entry point left at its default
device refuses to run where CUDA is absent instead of using the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "repro_torch",
    "repro_torch.configs",
    "repro_torch.configs.base",
    "repro_torch.configs.gemma_7b",
    "repro_torch.configs.jamba_1_5_large_398b",
    "repro_torch.configs.qwen2_vl_7b",
    "repro_torch.configs.rwkv6_3b",
    "repro_torch.core.distributed_eval",
    "repro_torch.core.distributed_norm",
    "repro_torch.core.gradient_summation",
    "repro_torch.core.graph_partitioning",
    "repro_torch.core.spatial_partitioning",
    "repro_torch.core.weight_update_sharding",
    "repro_torch.data.bucketization",
    "repro_torch.data.pipeline",
    "repro_torch.dist",
    "repro_torch.dist.compat",
    "repro_torch.dist.rules",
    "repro_torch.dist.serving",
    "repro_torch.dist.sharding",
    "repro_torch.dist.spmd",
    "repro_torch.fleet",
    "repro_torch.fleet.chaos",
    "repro_torch.fleet.fleet",
    "repro_torch.fleet.metrics",
    "repro_torch.fleet.replica",
    "repro_torch.fleet.router",
    "repro_torch.kernels.build",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.lars",
    "repro_torch.kernels.lstm_cell",
    "repro_torch.kernels.mamba",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.paged_attention",
    "repro_torch.kernels.quant",
    "repro_torch.models.gnmt",
    "repro_torch.models.layers",
    "repro_torch.models.lm",
    "repro_torch.models.maskrcnn",
    "repro_torch.models.resnet",
    "repro_torch.models.scan_utils",
    "repro_torch.models.ssd",
    "repro_torch.models.transformer_mlperf",
    "repro_torch.optim",
    "repro_torch.optim.adam",
    "repro_torch.optim.lars",
    "repro_torch.optim.precision",
    "repro_torch.optim.schedules",
    "repro_torch.optim.sgd",
    "repro_torch.serve.cache",
    "repro_torch.serve.engine",
    "repro_torch.serve.metrics",
    "repro_torch.serve.prefix",
    "repro_torch.serve.request",
    "repro_torch.serve.scenarios",
    "repro_torch.serve.scheduler",
    "repro_torch.serve.slo",
    "repro_torch.serve.speculative",
    "repro_torch.launch.gnmt",
    "repro_torch.launch.mesh",
    "repro_torch.launch.mlperf",
    "repro_torch.launch.resnet",
    "repro_torch.launch.serve",
    "repro_torch.launch.train",
    "repro_torch.train.hooks",
    "repro_torch.train.steps",
    "repro_torch.train.tracker",
    "repro_torch.train.trainer",
    "repro_torch.utils",
]


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_torch)"
    r"|from\s+repro(\.|\s+import\b))", re.M)


def test_sources_name_no_jax_or_repro_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f}: {hits}"


def test_default_device_refuses_without_cuda(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import mlperf, resnet, serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("gemma-7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_lm(cfg)
    params = lm.init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "gemma-7b", "--tokens", "1", "--batch", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mlperf.main(["--model", "maskrcnn", "--steps", "1"])


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Run where CUDA is absent, and alone in an empty directory, the
    smoke script exits non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
