"""Serving artifacts of the port (``gpu_fft_tpu_torch.utils.serving``) on the
CPU, against the live port functions and the JAX package's artifacts.

Each kind is exported with ``torch.export`` on ``device="cpu"``, written,
read back and run: its outputs equal the live ``*_device`` call bit for bit
(the same operators on the same tables) and the JAX artifact's
(``gpu_fft_tpu.utils.serving``, ``tests/test_serving.py``'s shapes) within
1e-5 * max|JAX|.  The artifact's graph holds the ``gpu_fft_tpu_torch::``
operator of the kernel the dispatch picks: K2 at 1,024, K1 at 4,096, K3 at
2^17, each run by its CPU kernel (the plain version) here.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_fft_tpu_torch.kernels import fused as K
from gpu_fft_tpu_torch.utils.serving import (
    EXPORT_KINDS,
    export_transform,
    exported_call,
    input_specs,
    load_transform,
    save_transform,
)


def _flat(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _args(exported, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape, _ in input_specs(exported)]


@pytest.mark.parametrize("kind", EXPORT_KINDS)
def test_export_roundtrips_through_serialization(kind, tmp_path):
    from gpu_fft_tpu.utils import serving as jserving

    from gpu_fft_tpu_torch.utils.serving import _builders

    b, n = 2, 256
    path = str(tmp_path / f"{kind}.pt2")
    size = save_transform(path, kind, b, n, device="cpu")
    assert size > 0
    exported = load_transform(path)
    args = _args(exported)
    got = _flat(exported_call(exported, *args))
    # The live (eager) port function on the same inputs: the same operators.
    live = _flat(_builders()[kind][0](*[torch.from_numpy(a) for a in args]))
    assert len(got) == len(live)
    for g, w in zip(got, live):
        np.testing.assert_array_equal(g, w.numpy())
    # The JAX package's artifact of the same kind and shapes.
    jpath = str(tmp_path / f"{kind}.bin")
    jserving.save_transform(jpath, kind, b, n)
    want = _flat(jserving.exported_call(jserving.load_transform(jpath), *args))
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * scale


def test_exported_fft_matches_numpy(tmp_path):
    path = str(tmp_path / "fft.pt2")
    save_transform(path, "fft", 1, 1024, device="cpu")
    exported = load_transform(path)
    x = np.random.default_rng(1).standard_normal((1, 1024)).astype(np.float32)
    yr, yi = exported_call(exported, x)
    ref = np.fft.fft(x.astype(np.float64), axis=-1)
    scale = np.abs(ref).max()
    assert np.abs(yr - ref.real).max() / scale < 5e-6
    assert np.abs(yi - ref.imag).max() / scale < 5e-6


def test_export_validates_inputs():
    with pytest.raises(ValueError):
        export_transform("nope", 1, 256, device="cpu")
    with pytest.raises(ValueError):
        export_transform("fft", 1, 1000, device="cpu")  # non-pow2
    with pytest.raises(ValueError):
        export_transform("fft", 0, 256, device="cpu")


def test_exported_call_checks_its_inputs(tmp_path):
    exported = export_transform("ifft", 1, 256, device="cpu")
    with pytest.raises(ValueError, match="2 input"):
        exported_call(exported, np.zeros((1, 256), np.float32))
    assert input_specs(exported) == [((1, 256), torch.device("cpu"))] * 2


def test_export_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        export_transform("fft", 1, 256)


@pytest.mark.parametrize("n,kernel", [(1024, "whole_transform_packed"), (4096, "whole_transform"),
                                      (1 << 17, "stage_a")])
def test_artifact_holds_the_kernel_operator(n, kernel, tmp_path):
    """The graph records the kernel's operator, not its plain version; the
    loaded artifact runs it (here its CPU kernel, counted as a plain call)."""
    path = str(tmp_path / "fft.pt2")
    save_transform(path, "fft", 1, n, device="cpu")
    exported = load_transform(path)
    targets = [str(node.target) for node in exported.graph.nodes if node.op == "call_function"]
    ours = [t for t in targets if t.startswith("gpu_fft_tpu_torch.")]
    assert ours == [f"gpu_fft_tpu_torch.{kernel}.default"], targets
    K.reset_counts()
    exported_call(exported, *_args(exported))
    assert {k: c.plain_calls for k, c in K.COUNTS.items() if c.plain_calls} == {kernel: 1}


@pytest.mark.parametrize("mode,n,kernel", [
    ("fast", 1024, "whole_transform_packed_bf16"), ("fast", 4096, "whole_transform_bf16"),
    ("fast", 1 << 17, "stage_a_bf16"), ("full", 4096, "whole_transform"), ("high", 4096, None),
    ("high", 1 << 17, None),
])
def test_artifact_holds_the_operator_of_its_mode(mode, n, kernel, tmp_path, monkeypatch):
    """The mode is traced in, as the JAX package's jit caches trace it: an
    artifact exported under "fast" holds K2F / K1F / K3F, under "full" K1,
    under "high" no kernel; it keeps running its own operator after the
    mode is set back, and its numbers are the live call's of its mode."""
    from gpu_fft_tpu_torch import config

    monkeypatch.setattr(config, "PRECISION", mode)
    path = str(tmp_path / "fft.pt2")
    save_transform(path, "fft", 1, n, device="cpu")
    x = np.random.default_rng(2).standard_normal((1, n)).astype(np.float32)
    from gpu_fft_tpu_torch.ops.transform import fft_device

    live = [t.numpy() for t in fft_device(torch.from_numpy(x), device="cpu")]
    monkeypatch.setattr(config, "PRECISION", "full")
    exported = load_transform(path)
    targets = [str(node.target) for node in exported.graph.nodes if node.op == "call_function"]
    ours = [t for t in targets if t.startswith("gpu_fft_tpu_torch.")]
    assert ours == ([f"gpu_fft_tpu_torch.{kernel}.default"] if kernel else []), targets
    K.reset_counts()
    got = exported_call(exported, x)
    assert {k: c.plain_calls for k, c in K.COUNTS.items() if c.plain_calls} == ({kernel: 1} if kernel else {})
    for g, w in zip(got, live):
        np.testing.assert_array_equal(g, w)


def test_cli_export_and_serve_check(tmp_path, capsys):
    from gpu_fft_tpu_torch.__main__ import main

    art = str(tmp_path / "a.pt2")
    assert main(["export", "--kind", "rfft", "--batch", "2", "-n", "256", "-o", art, "--device", "cpu"]) == 0
    assert main(["serve-check", art]) == 0
    out = capsys.readouterr().out
    assert "exported rfft" in out and "2 output(s)" in out and "device=cpu" in out


def test_artifact_loads_in_a_fresh_process(tmp_path):
    """A serving process needs only ``import gpu_fft_tpu_torch`` (which
    registers the operators) to read an artifact and run it."""
    import os
    import subprocess
    import sys

    path = str(tmp_path / "fft.pt2")
    save_transform(path, "fft", 1, 4096, device="cpu")
    code = ("import sys, numpy as np, torch, gpu_fft_tpu_torch as gt\n"
            "art = torch.export.load(sys.argv[1])\n"
            "yr, yi = gt.exported_call(art, np.ones((1, 4096), np.float32))\n"
            "print(float(yr[0, 0]), float(np.abs(yr[0, 1:]).max()))\n")
    env = {k: v for k, v in os.environ.items() if k != "GPU_FFT_TPU_TORCH_DEVICE"}
    proc = subprocess.run([sys.executable, "-c", code, path], cwd=Path(__file__).resolve().parent.parent, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    dc, rest = (float(v) for v in proc.stdout.split())
    assert dc == 4096.0 and rest < 1e-2
