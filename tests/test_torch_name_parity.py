"""Every top-level name of the JAX package has a counterpart in the port.

An ``ast`` walk of each ``gpu_fft_tpu/`` module (nothing is imported, so
the port's side never loads jax): every function, class and assigned name
at module level must be defined or imported at the top of the port's
module of the same path, under the same name or the port's spelling of
it (``_jnp`` dropped or made ``_torch``, ``xla_`` made ``torch_``), or
stand in :data:`JAX_ONLY` with the reason it needs no port.  A later gap
fails here.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "gpu_fft_tpu"
PORT = ROOT / "gpu_fft_tpu_torch"
# Modules the port renamed for torch.
RENAMED = {
    "backends/pallas.py": "backends/torch.py",
    "backends/xla.py": "backends/torch_fft.py",
    "kernels/fused_jnp.py": "kernels/fused_torch.py",
}
_PALLAS_BODY = "a Pallas kernel body or BlockSpec helper; the port's kernels are CUDA in csrc/"
# (module, name) -> why the name stays in the JAX package.
JAX_ONLY = {
    ("config.py", "enable_compilation_cache"): "the persistent XLA compilation cache; torch has no such cache",
    ("ops/stft.py", "frame_signal_unordered"): "a TPU lane-layout framing; the port's unfold view is free",
    ("ops/stft.py", "_MAX_SLICES"): "the slice budget of frame_signal_unordered",
    ("parallel/mesh.py", "_shard_map"): "jax.shard_map's wrapper; the port's layer is DTensor placements",
    ("parallel/distributed.py", "_distributed"): "the shard_map body of distributed_fft; the port uses DTensors",
    ("tuning.py", "_V5E"): "the TPU v5e row; the port's rows are h100 and cpu-approx with its gate values",
    ("backends/pallas.py", "_forward_real"): "renamed backends/torch.py, which dispatches to transform_any",
    ("backends/pallas.py", "_inverse"): "renamed backends/torch.py, which dispatches to transform_any",
    ("backends/xla.py", "_forward"): "renamed backends/torch_fft.py, on torch.fft",
    ("backends/xla.py", "_inverse"): "renamed backends/torch_fft.py, on torch.fft",
    ("compat.py", "_combine"): "packs split-complex into a jnp complex array; torch.complex does it",
    ("compat.py", "_conj_in"): "jnp conjugation of the input; the port conjugates tensors in place of it",
    ("ops/dct.py", "_dct_along_axes"): "the jnp permutation-matmul DCT core; the port's DCT permutes by slices",
    ("ops/dct.py", "_flat_rev_pow2"): "a TPU lane-friendly reversal; torch.flip is one copy",
    ("kernels/fused_jnp.py", "_dot"): "jnp.dot at the mode's precision; the port's products are _mm / _contract",
    ("kernels/fused_jnp.py", "_prec"): "the mode's lax.Precision; the port reads config.matmul_precision",
    ("kernels/large.py", "_STAGE_A_TABLE_KEYS"): "the custom_jvp seam around the Pallas stage A; the port "
                                                 "has autograd Functions (_StagedTransform, _StageAFold)",
    ("kernels/large.py", "_stage_a_ad"): "the same seam",
    ("kernels/large.py", "_stage_a_core"): "the same seam",
    ("kernels/large.py", "_stage_a_core_jvp"): "the same seam",
    ("plan.py", "deinterleave_matrix"): "the TPU's 0/1 permutation matmul for the even / odd split; the "
                                        "port's packed forward slices x[0::2] / x[1::2]",
    ("plan.py", "STAGE_A_N1"): "the v5e stage-A digit, read by nothing; the live value is the tuning row's "
                               "stage_a_n1",
    ("utils/roofline.py", "_pack_applies"): "a wrapper of plan.rfft_pack_applies, called directly",
    ("utils/roofline.py", "_fused_split"): "a wrapper of plan.fused_split, which the port calls directly",
    ("utils/roofline.py", "_half_applies"): "a wrapper of plan.half_spectrum_applies, called directly",
    ("utils/roofline.py", "_stage_a_n1"): "a wrapper of plan._stage_a_n1, called directly",
    ("utils/roofline.py", "_whole_applies"): "a wrapper of plan.whole_kernel_applies, called directly",
    **{("kernels/fused.py", name): _PALLAS_BODY for name in (
        "_ROW_TABLES", "_cmatmul", "_cmul", "_const_spec", "_dot", "_dot_nt", "_interpret",
        "_stage_a_complex_kernel", "_stage_a_complex_kernel_full", "_stage_a_real_kernel",
        "_stage_a_real_kernel_full", "_tw_block", "_vmem_spec", "_whole_complex_kernel",
        "_whole_packed_complex_kernel", "_whole_packed_real_kernel", "_whole_real_kernel", "_whole_stage2")},
}
MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _defined(path: Path) -> set:
    """Functions, classes and assigned names at the top of a module."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _available(path: Path) -> set:
    """What a module defines or imports at its top."""
    out = _defined(path)
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def _spellings(name: str) -> set:
    return {name, name.replace("_jnp", ""), name.replace("_jnp", "_torch"), name.replace("xla_", "torch_")}


@pytest.mark.parametrize("module", MODULES)
def test_every_jax_name_has_a_counterpart(module):
    port = PORT / RENAMED.get(module, module)
    assert port.is_file(), f"the port has no {port.relative_to(ROOT)}"
    have = _available(port)
    missing = sorted(n for n in _defined(JAX_PKG / module)
                     if (module, n) not in JAX_ONLY and not _spellings(n) & have)
    assert not missing, f"{module}: no counterpart in the port for {missing}"


def test_jax_only_names_exist_and_stay_out_of_the_port():
    """Each entry names a JAX name that is there, with a reason, and that the
    port does not define (else the entry is stale)."""
    for (module, name), why in JAX_ONLY.items():
        assert name in _defined(JAX_PKG / module), (module, name)
        assert why
        assert name not in _defined(PORT / RENAMED.get(module, module)), (module, name)
