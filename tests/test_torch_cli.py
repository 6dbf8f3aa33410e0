"""The port's command line (``python -m gpu_fft_tpu_torch``) on the CPU: the
counterparts of ``tests/test_examples.py``'s CLI tests, each on
``--device cpu``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from gpu_fft_tpu_torch.__main__ import main

ROOT = Path(__file__).resolve().parent.parent


def test_cli_demo(capsys):
    assert main(["demo", "--device", "cpu"]) == 0
    assert main(["backends", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Dominant frequency: 15.04 Hz" in out and "[OK]" in out
    rows = [line for line in out.splitlines() if "roundtrip max error" in line]
    assert len(rows) >= 2 and all(float(r.split()[-1]) < 1e-3 for r in rows)


def test_cli_bench_rejects_bad_n(capsys):
    assert main(["bench", "-n", "100", "--device", "cpu"]) == 2
    assert "power of two" in capsys.readouterr().err


def test_cli_bench_times_only_on_a_card(capsys):
    """A time comes from a card: bench on the CPU refuses (exit 2)."""
    assert main(["bench", "-n", "4096", "--device", "cpu"]) == 2
    assert "CUDA card" in capsys.readouterr().err


def test_cli_plan(capsys):
    assert main(["plan", "-n", "1048576"]) == 0
    out = capsys.readouterr().out
    assert "staged" in out and "(128, 8192)" in out
    assert main(["plan", "-n", "100"]) == 2
    assert main(["plan", "-n", "1024"]) == 0
    out = capsys.readouterr().out
    assert "whole" in out and "whole_transform_packed" in out


def test_cli_runs_as_a_module():
    env = {k: v for k, v in os.environ.items() if k != "GPU_FFT_TPU_TORCH_DEVICE"}
    proc = subprocess.run([sys.executable, "-m", "gpu_fft_tpu_torch", "plan", "-n", "4096"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "whole_transform" in proc.stdout


def test_cli_asks_for_the_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != "GPU_FFT_TPU_TORCH_DEVICE"}
    proc = subprocess.run([sys.executable, "-m", "gpu_fft_tpu_torch", "demo"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
