"""Build and load the Hopper kernels (``csrc/*.cu``) with nvcc and ctypes.

Each ``.cu`` source compiles to an object in its own nvcc process, all
started together, and the objects link into one shared library with a plain
C interface, ``gpu_fft_tpu_torch/_build/libgft_<hash>.so``, named by a hash
of the sources and flags so a changed source rebuilds.  The build runs at the
first kernel launch in a process (never at import); a failed build raises
with nvcc's output.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # xr, xi, f1r, f1i, twr, twi, f2r, f2i, yr, yi,
    # batch, n1, cluster, threads, smem_bytes, stream
    "gft_whole_split": [_P] * 10 + [_I] * 5 + [_P],
    # xr, xi, packed, yr, yi, batch, n1, cluster, threads, smem_bytes, stream
    "gft_whole_packed": [_P] * 5 + [_I] * 5 + [_P],
    # xr, xi, f1r, f1i, two_r, two_i, twi_r, twi_i, yr, yi,
    # batch, n1, n2, ct, rows, ncols, width, threads, smem_bytes, stream
    "gft_stage_a": [_P] * 10 + [_I] * 9 + [_P],
    # xr, xi, f1r, f1i, twr, twi, yr, yi,
    # batch, n1, n2, rows, ncols, width, threads, smem_bytes, stream
    "gft_stage_a_full": [_P] * 8 + [_I] * 8 + [_P],
    # xr, xi, f1r, f1i, f2r, f2i, twr, twi, yr, yi,
    # batch, n1, m1, rows, cluster, threads, smem_bytes, scale, stream
    "gft_stage_b": [_P] * 10 + [_I] * 7 + [_F, _P],
    # x, f_stack, twr, twi, yr, yi, n1, n2, bn, stream
    "gft_stage_a_manual": [_P] * 6 + [_I] * 3 + [_P],
    # xr, xi, img1, img2, twr, twi, yr, yi,
    # batch, n1, packed, cluster, threads, smem_bytes, stream
    "gft_whole_bf16": [_P] * 8 + [_I] * 6 + [_P],
    # xr, xi, img, two_r, two_i, twi_r, twi_i, yr, yi,
    # batch, n1, n2, ct, rows, ncols, wgs, grid, stream
    "gft_stage_a_bf16": [_P] * 9 + [_I] * 8 + [_P],
    # xr, xi, img, twr, twi, yr, yi, batch, n1, n2, rows, ncols, wgs, grid, stream
    "gft_stage_a_bf16_full": [_P] * 7 + [_I] * 7 + [_P],
    # x, f_t, yr, yi, batch, n1, n2, stream
    "gft_stage_a_dot_f32": [_P] * 4 + [_I] * 3 + [_P],
    # x, f_img, yr, yi, batch, n1, n2, parts, wgs, grid, stream
    "gft_stage_a_dot_bf16": [_P] * 4 + [_I] * 6 + [_P],
    # x, f_img, twr, twi, yr, yi, n1, n2, wgs, grid, stream
    "gft_stage_a_manual_bf16": [_P] * 6 + [_I] * 4 + [_P],
    # x, f1r, f1i, twr, twi, f2r, f2s, f2d, yr, yi,
    # batch, n1, n2, cluster, threads, smem_bytes, stream
    "gft_fused_lm": [_P] * 10 + [_I] * 6 + [_P],
    # x, o, stream
    "gft_copy_min": [_P] * 3,
    # x, t0 .. t7, o, k, stream
    "gft_operand_probe": [_P] * 10 + [_I, _P],
}


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of the nvcc run; 0.0 when the library existed
    log: str  # nvcc's output (ptxas register / spill report)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgft_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build() -> BuildInfo:
    """Compile the kernels unless the library for these sources exists: one
    nvcc per source, all in parallel, then one link."""
    out = library_path()
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sorted(CSRC.glob("*.cu"))]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / (o.stem + ".cu"))] for o in objs]
        procs = [
            subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for c in cmds
        ]
        logs = [p.communicate()[0] for p in procs]
        for c, p, log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{log}")
        lib = Path(tmp) / out.name
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(lib),
                *(str(o) for o in objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n{proc.stdout}")
        os.replace(lib, out)
    return BuildInfo(out, time.perf_counter() - t0, "".join(logs) + proc.stdout)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), argtypes declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gft_error_string.argtypes = [ctypes.c_int]
    lib.gft_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = library().gft_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})")
