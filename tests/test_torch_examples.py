"""The port's examples (``gpu_fft_tpu_torch/examples``) run end to end on
the CPU and print their gates as the JAX package's ``examples/*.py`` do.

Each ``main(device="cpu")`` prints its ``[OK]`` line (``OK`` for
``training`` and ``extensions``, ``[OK] antiderivative operator learned``
for ``fno``, as their JAX originals) and returns 0; ``simple`` finds the
reference's 15.04 Hz; ``fno`` trains its FNO1d to the JAX example's gate
and runs the FNO2d forward; ``extensions`` prints what the JAX example's
test reads, its serving step through the port's artifacts.  ``python -m``
runs one as a module.
"""

import contextlib
import io
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gpu_fft_tpu_torch.examples import NAMES

ROOT = Path(__file__).resolve().parent.parent
GATE = {"training": "OK", "fno": "[OK] antiderivative operator learned", "extensions": "OK"}


def _run(name):
    mod = importlib.import_module(f"gpu_fft_tpu_torch.examples.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(device="cpu")
    return rc, buf.getvalue()


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_its_ok_line(name):
    rc, out = _run(name)
    lines = out.splitlines()
    assert rc == 0, out
    assert lines[-1].endswith(GATE.get(name, "[OK]")), out
    assert "FAIL" not in out, out


def test_simple_finds_the_reference_frequency():
    _, out = _run("simple")
    assert "Dominant frequency: 15.04 Hz" in out
    assert out.rstrip().endswith("[OK]")


def test_backends_lists_each_backend():
    _, out = _run("backends")
    assert "TORCH " in out and "TORCH_FFT" in out
    rows = [line for line in out.splitlines() if "roundtrip max error" in line]
    assert len(rows) >= 2 and all(float(r.split()[-1]) < 1e-3 for r in rows)


def test_fno_trains_and_runs_the_2d_model():
    _, out = _run("fno")
    assert "FNO1d: 30769 parameters, modes=8 width=24 depth=3" in out
    assert "FNO2d forward: (2, 64, 64, 1) -> (2, 64, 64, 1)" in out
    assert out.rstrip().endswith("[OK] antiderivative operator learned")


def test_extensions_example():
    """``tests/test_examples.py::test_extensions_example``'s checks."""
    rc, out = _run("extensions")
    assert rc == 0
    assert "60.00 Hz (exact)" in out
    assert "(3, 17)" in out
    assert "serving artifact:" in out and "peak bin 5" in out
    assert "OK" in out and "FAIL" not in out


def test_example_runs_as_a_module():
    env = dict(os.environ, GPU_FFT_TPU_TORCH_DEVICE="cpu")
    proc = subprocess.run([sys.executable, "-m", "gpu_fft_tpu_torch.examples.simple"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Dominant frequency: 15.04 Hz" in proc.stdout


def test_example_fails_without_a_card_by_default():
    """No device given: the example asks for CUDA and stops where there is
    none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {k: v for k, v in os.environ.items() if k != "GPU_FFT_TPU_TORCH_DEVICE"}
    proc = subprocess.run([sys.executable, "-m", "gpu_fft_tpu_torch.examples.images"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "torch.cuda.is_available() is False" in proc.stderr
