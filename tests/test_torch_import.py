"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its chip smoke script refuses to run without a card or without the repo."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "gpu_fft_tpu_torch"


def _run(code, cwd=ROOT, env=None):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_import_leaves_jax_out():
    code = (
        "import sys, gpu_fft_tpu_torch, gpu_fft_tpu_torch.kernels.large, "
        "gpu_fft_tpu_torch.kernels._build, gpu_fft_tpu_torch.backends.torch_fft, "
        "gpu_fft_tpu_torch.kernels.ablation, gpu_fft_tpu_torch.utils.profiling, "
        "gpu_fft_tpu_torch.scripts.ablate_large, gpu_fft_tpu_torch.scripts.ablate_2e20_levers, "
        "gpu_fft_tpu_torch.scripts.ablate_mosaic_x6, gpu_fft_tpu_torch.kernels.engines, "
        "gpu_fft_tpu_torch.kernels.probes, gpu_fft_tpu_torch.utils.roofline, "
        "gpu_fft_tpu_torch.scripts.calibrate_latency, gpu_fft_tpu_torch.scripts.calibrate_matmul, "
        "gpu_fft_tpu_torch.scripts.calibrate_chip, gpu_fft_tpu_torch.scripts.ablate_whole_packed, "
        "gpu_fft_tpu_torch.scripts.ablate_engines, gpu_fft_tpu_torch.config, "
        "gpu_fft_tpu_torch.backends, gpu_fft_tpu_torch.tuning, gpu_fft_tpu_torch.plan, "
        "gpu_fft_tpu_torch.kernels.fused_torch, gpu_fft_tpu_torch.ops.transform, "
        "gpu_fft_tpu_torch.ops.windows, gpu_fft_tpu_torch.signal.windows, "
        "gpu_fft_tpu_torch.ops.stft, gpu_fft_tpu_torch.ops.exact, gpu_fft_tpu_torch.ops.spectral, "
        "gpu_fft_tpu_torch.ops.short_time_fft, gpu_fft_tpu_torch.ops.dsp, gpu_fft_tpu_torch.ops.filter, "
        "gpu_fft_tpu_torch.ops.design, gpu_fft_tpu_torch.ops.iir, gpu_fft_tpu_torch.ops.multirate, "
        "gpu_fft_tpu_torch.ops.czt, gpu_fft_tpu_torch.ops.dct, gpu_fft_tpu_torch.ops.fht\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'gpu_fft_tpu.')) "
        "or m == 'gpu_fft_tpu')\n"
        "print(bad)\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_module_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "gpu_fft_tpu"), f"{path} imports {name}"


def test_other_precision_modes_are_not_ported():
    env = dict(os.environ, GPU_FFT_TPU_PRECISION="high")
    proc = _run("import gpu_fft_tpu_torch", env=env)
    assert proc.returncode != 0
    assert "NotImplementedError" in proc.stderr


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize(
    "module,expected_min",
    [
        ("gpu_fft_tpu_torch.utils.signal", 4),
        ("gpu_fft_tpu_torch.ops.spectral", 1),
        ("gpu_fft_tpu_torch.ops.transform", 1),
        ("gpu_fft_tpu_torch.ops.stft", 2),
        ("gpu_fft_tpu_torch.ops.short_time_fft", 5),
        ("gpu_fft_tpu_torch.ops.dsp", 8),
        ("gpu_fft_tpu_torch.ops.filter", 6),
        ("gpu_fft_tpu_torch.ops.multirate", 1),
    ],
)
def test_doctests(module, expected_min):
    import doctest
    import importlib

    res = doctest.testmod(importlib.import_module(module), verbose=False)
    assert res.failed == 0 and res.attempted >= expected_min, res
