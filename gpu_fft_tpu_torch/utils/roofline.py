"""Roofline accounting: FLOPs, bytes and the least time per configuration.

Counterpart of ``gpu_fft_tpu/utils/roofline.py``, with its names.  For a
(B, n, kind) configuration, :func:`transform_cost` counts the FLOPs of each
matmul stage (with its contraction size K), the elementwise FLOPs and the
bytes of input and output; :func:`roofline_row` turns them into the least
time on a :class:`ChipSpec`,

    sol = max(t_bytes, t_matmul, t_elementwise[, t_latency]),

and names the wall that sets it (``bound``).  The stages mirror the port's
dispatch (``kernels/large.py:transform_any``, ``inverse_real``), so the
cost is that of the plan that runs.  Every kind of the JAX package is
costed, the ``*_batch`` / ``*_sequential`` / ``fft_batchsize`` kinds as
aliases of ``fft``, ``ifft`` and ``roundtrip`` (the same work).

* ``CHIPS`` holds ``h100`` and ``cpu-approx`` (order-of-magnitude figures so
  that the accounting stays defined in the CPU tests).
* The ``h100`` rates are NVIDIA's published figures for the H100 SXM at
  700 W: 3,350 GB/s of HBM (``hbm_gbps``), 989 TFLOP/s dense bf16 on the
  tensor cores (``bf16_tflops``), 67 TFLOP/s fp32 outside the tensor cores
  (``vpu_tflops``).  No L2 wall is charged: its stream rate is not measured.
* ``kernel_call_us`` (JAX: ``pallas_call_us``) is S5's chained step time,
  the least a launch costs on the card, measured on an H100 80GB HBM3 at a
  700 W power limit by ``python -m gpu_fft_tpu_torch.scripts.calibrate_latency``:
  the median over three separate runs (``PERF.md`` gives them and their
  spread).  Every kernel of a step is charged it, so ``t_latency =
  kernel_call_us * n_kernels``: a lower bound, since a chained tiny kernel
  reads 0.96 to 1.35 us per kernel at one to eight kernels a step, between
  and within runs, at an unchanged SM clock.
* ``EFF_PASSES`` keeps the JAX package's unit: a matmul stage of F FLOPs
  with contraction K costs ``F * eff_passes(K) / bf16_peak``, so an fp32
  SGEMM at an effective R TFLOP/s reads 989 / R passes (989 / 67 = 14.8 at
  the fp32 peak).  ``h100`` holds the per-K rates of bare fp32
  ``torch.matmul`` chains with TF32 off, measured on the same card
  (``python -m gpu_fft_tpu_torch.scripts.calibrate_matmul``).  A bare
  SGEMM bounds a stage that cuBLAS runs; a hand-written kernel that keeps
  its operands on chip can beat it, so against such a kernel the matmul
  wall is not a lower bound.

The kernels of a step are counted by :func:`compiled_stats` (and
:func:`count_kernels`), from a ``torch.profiler`` trace of the step on the
card.  :data:`CALIBRATED_CHIPS` names the rows whose launch floor and
``EFF_PASSES`` were measured by the port's own calibration scripts; a
``roofline_row`` says whether its chip is one.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass

import torch

from .. import plan as _plan

__all__ = [
    "CALIBRATED_CHIPS",
    "CHIPS",
    "ChipSpec",
    "EFF_PASSES",
    "OWN_KERNELS",
    "chip_calibrated",
    "compiled_stats",
    "count_kernels",
    "detect_chip",
    "eff_passes",
    "irfft_stages",
    "roofline_row",
    "transform_cost",
    "transform_flops",
    "transform_stages",
]


@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float  # device-memory stream rate, GB/s
    bf16_tflops: float  # dense bf16 peak, TFLOP/s: the unit of EFF_PASSES
    vpu_tflops: float  # fp32 peak outside the tensor cores, TFLOP/s (elementwise work)
    kernel_call_us: float | None = None  # chained step of one launch (None: not measured)


CHIPS = {
    "h100": ChipSpec("h100", 3350.0, 989.0, 67.0, kernel_call_us=0.9709),
    "cpu-approx": ChipSpec("cpu-approx", 50.0, 1.0, 0.1),
}

#: Effective bf16 passes per fp32 matmul stage, by contraction class K:
#: 989 / (11.65, 19.54, 26.58, 32.76, 36.81) TFLOP/s of a bare SGEMM.
EFF_PASSES = {
    "h100": {32: 84.869, 64: 50.623, 128: 37.214, 256: 30.185, 512: 26.87},
}
_EFF_DEFAULT = EFF_PASSES["h100"]

#: Chips whose launch floor (``calibrate_latency``) and ``EFF_PASSES``
#: (``calibrate_matmul``) were measured on the card by the port's own
#: scripts (PERF.md records the runs): the H100 80GB HBM3 at 700 W.
CALIBRATED_CHIPS = frozenset({"h100"})

#: The ``__global__`` functions of ``csrc/``: a profiled kernel whose name
#: holds one of these is one of the port's own.
OWN_KERNELS = (
    "copy_min_kernel",
    "dense_f32_kernel",
    "operand_probe_kernel",
    "stage_a_dot_wgmma_kernel",
    "stage_a_radix_kernel",
    "stage_b_kernel",
    "whole_bf16_kernel",
    "whole_kernel",
)
_OWN = re.compile(r"\b(" + "|".join(OWN_KERNELS) + r")\b")


def chip_calibrated(chip: ChipSpec) -> bool:
    """Whether ``chip``'s figures were measured on it (:data:`CALIBRATED_CHIPS`)."""
    return chip.name in CALIBRATED_CHIPS


def eff_passes(chip_name: str, k: int) -> float:
    """Effective passes for a contraction of size k (nearest class)."""
    table = EFF_PASSES.get(chip_name, _EFF_DEFAULT)
    key = min(table, key=lambda c: abs(c - k) / c)
    return table[key]


def detect_chip() -> ChipSpec:
    """``h100`` on an H100, else ``cpu-approx`` (the tuning table's rule)."""
    if torch.cuda.is_available() and "H100" in torch.cuda.get_device_name(0):
        return CHIPS["h100"]
    return CHIPS["cpu-approx"]


def _own_launches() -> dict:
    from ..kernels import ablation, engines, fused, probes

    return {k: c.launches for m in (fused, ablation, engines, probes) for k, c in m.COUNTS.items()}


def compiled_stats(step, x0) -> dict:
    """Kernels that one ``step(x0)`` launches on the card (eager torch has no
    compiled module to read).

    The port's own kernels (JAX: ``n_pallas``) are counted by their wrappers'
    launch counters: a ``torch.profiler`` trace does not always hold the
    launches made through the ctypes library.  Every other CUDA kernel
    (copies and memsets excluded) is counted from a trace of three steps.
    ``n_kernels`` is their sum, the unit of the launch floor;
    ``own_kernels`` the launches per wrapper; ``kernel_names`` the other
    kernels of one step in launch order; ``fingerprint`` a sha256 prefix of
    both, equal for two runs of the same launches.  One warm call runs
    first (kernel build, plan upload).  Raises for a tensor that is not on a
    CUDA device.
    """
    if not isinstance(x0, torch.Tensor) or x0.device.type != "cuda":
        where = x0.device if isinstance(x0, torch.Tensor) else type(x0).__name__
        raise ValueError(f"compiled_stats counts kernels on a CUDA card; x0 is on {where}")
    from torch.profiler import ProfilerActivity, profile

    reps = 3
    step(x0)
    torch.cuda.synchronize(x0.device)
    for _ in range(3):  # a trace that holds no device event is taken again
        before = _own_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                step(x0)
            torch.cuda.synchronize(x0.device)
        after = _own_launches()
        events = [
            e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))
        ]
        if events:
            break
    else:
        raise RuntimeError("compiled_stats: the profiler recorded no CUDA kernel")
    own = {k: (after[k] - before[k]) // reps for k in after if after[k] > before[k]}
    other = [e.name for e in sorted(events, key=lambda e: e.time_range.start) if not _OWN.search(e.name)]
    per_step = round(len(other) / reps)
    names = other[len(other) - per_step:]
    key = "\n".join(names + [f"{k}:{v}" for k, v in sorted(own.items())])
    return {
        "n_kernels": per_step + sum(own.values()),
        "n_own_kernels": sum(own.values()),
        "own_kernels": own,
        "kernel_names": names,
        "fingerprint": hashlib.sha256(key.encode()).hexdigest()[:16],
    }


def count_kernels(step, x0) -> int:
    """Kernels one ``step(x0)`` launches on the card (:func:`compiled_stats`)."""
    return compiled_stats(step, x0)["n_kernels"]


def transform_stages(b: int, n: int, real_input: bool):
    """Per-matmul-stage (flops, contraction) list and elementwise flops of
    the port's dispatch, on its route (``plan.route``): the whole kernel
    band, direct, half-spectrum, the fused split, and staged.  A real
    matmul (m, k) @ (k, j) counts 2*m*k*j, a complex one 3 real products
    (Karatsuba), a complex elementwise multiply 6 flops.  A packed real
    input (``packed_real``) is the n/2-point complex transform's stages
    plus the recombination, charged 8 flops per element.
    """
    r = _plan.route(b, n, real_input=real_input)
    if r.path == "packed_real":
        stages, elem = transform_stages(b, n // 2, real_input=False)
        return stages, elem + 8.0 * b * n
    p = 2 if real_input else 3  # real products of a first contraction (3: Karatsuba)
    if r.path == "whole":
        # K1/K2: n2 = 128, stage 1 contracts n1 = n/128, stage 2 the 128
        # columns (3), one twiddle.
        n1 = r.split[0]
        return [(p * 2.0 * b * n * n1, n1), (3 * 2.0 * b * n * 128, 128)], 6.0 * b * n
    if r.path == "direct":
        return [(p * 2.0 * b * n * n, n)], 0.0 if real_input else 7.0 * b * n
    n1, n2 = r.split
    half = r.layout == "half-spectrum"
    if r.path == "fourstep" and half:
        # fused_fft_half: full first stage, then only h = n1/2 + 1 k1
        # rows; the mirror epilogue charged ~2 flops/elem.
        frac = (n1 // 2 + 1) / n1
        stages = [(2 * 2.0 * b * n * n1, n1), (3 * 2.0 * b * n * n2 * frac, n2)]
        return stages, (6.0 + 5.0) * b * n * frac + 2.0 * b * n
    # A real input's half path computes stage_a_real_rows(n1) k1 rows of
    # stage A; a complex first stage adds 5 flops an element.
    frac_a = _plan.stage_a_real_rows(n1) / n1 if half else 1.0
    stages = [(p * 2.0 * b * n * n1 * frac_a, n1)]
    elem = 6.0 * b * n * frac_a + (0.0 if real_input else 5.0 * b * n)
    if r.path == "fourstep":
        stages.append((3 * 2.0 * b * n * n2, n2))
        return stages, elem + 5.0 * b * n
    s2, e2 = transform_stages(b * n1, n2, real_input=False)
    if half:
        # stage_b_half: h = n1/2 + 1 rows of stage B, plus the mirror.
        frac = (n1 // 2 + 1) / n1
        s2 = [(f * frac, k) for f, k in s2]
        e2 = e2 * frac + 2.0 * b * n
    return stages + s2, elem + e2


def irfft_stages(b: int, n: int):
    """Stage list of the real-OUTPUT inverse (``kernels/large.py:
    inverse_real``), on its route: the fused Hermitian fold
    (``irfft_fold``), stage A on the first ceil((n2/2 + 1) / ct) column
    tiles plus the per-row stage-B fold (``irfft_fold_staged``), else the
    full complex inverse.  Returns (stages, elem_flops, read_fraction): the
    fold reads only its kept fraction of the input spectrum, and the byte
    charge follows it.
    """
    r = _plan.route(b, n, real_output=True)
    if r.path == "irfft_fold":
        n1, n2 = r.split
        h1 = n1 // 2 + 1
        stages = [
            # Stage 1: Karatsuba complex contraction of k2 over h1 columns.
            (3 * 2.0 * b * h1 * n2 * n2, n2),
            # Stage 2: two real contractions over n1/2, natural order out.
            (2 * 2.0 * b * n * (n1 // 2), n1 // 2),
        ]
        elem = 6.0 * b * h1 * n2 + 2.0 * b * n  # twiddle + Nyquist broadcast
        return stages, elem, h1 / n1
    if r.path == "irfft_fold_staged":
        n1, n2 = r.split
        ct = _plan.stage_a_col_tile(n1, n2)
        w = -(-(n2 // 2 + 1) // ct) * ct  # stage-A columns computed
        p, q = n2 // 128, 128
        h = q // 2 + 1
        stages = [
            # Half-column complex stage A (Karatsuba).
            (3 * 2.0 * b * n1 * n1 * w, n1),
            # Per-row stage-B fold: complex stage 1 over h of the q minor columns.
            (3 * 2.0 * b * n1 * h * p * p, p),
            # Real stage 2 contracting q/2.
            (2 * 2.0 * b * n * (q // 2), q // 2),
        ]
        # Stage-A twiddle, the fold input's flips, the row twiddle.
        elem = 6.0 * b * n1 * w + 2.0 * b * n + 6.0 * b * n1 * h * p
        return stages, elem, w / n2
    stages, elem = transform_stages(b, n, real_input=False)
    return stages, elem, 1.0


def transform_flops(b: int, n: int, real_input: bool) -> float:
    """All FLOPs (matmul and elementwise) of one planned transform."""
    stages, elem = transform_stages(b, n, real_input)
    return sum(f for f, _ in stages) + elem


def transform_cost(b: int, n: int, kind: str = "fft") -> dict:
    """FLOPs, least bytes and per-stage classes of one configuration.

    ``kind``: fft (real in, split-complex out), ifft (complex in and out),
    roundtrip (fft + ifft), their aliases fft_batch, fft_sequential,
    fft_batchsize, ifft_batch, ifft_sequential, roundtrip_batch and
    roundtrip_sequential (the same work, run as one batch or row by row),
    irfft (Hermitian spectrum in, real out,
    :func:`irfft_stages`), and the analysis kinds: welch ((b, n) =
    (segments, nperseg): the segments' forward transform; the O(bn) window
    and mean are left out, so the bound stays a lower bound), grad_fft (the
    spectrum power's gradient: the forward and its transpose, a full
    complex transform, charged as a roundtrip), stft_roundtrip ((frames,
    frame_size): the forward frames and the one-sided inverse), fft_exact
    (any n: the mixed four-step's two products, else Bluestein's two
    complex m-point transforms), and the filtering kinds: hilbert (a
    roundtrip), dct_roundtrip (a real forward and the irfft charge),
    resample (down to n/2 and back) and oaconvolve / fftfilt ((blocks,
    block length): a real forward and a complex inverse), and the 2-D
    kinds: fft2 ((H, W): the real row pass and the complex column pass) and
    conv2d ((m1, m2), one padded image: the one-sided forward, the product
    and the one-sided inverse; the kernel's spectrum is not charged).  Any other kind raises
    ``ValueError``.
    """
    f32 = 4

    def parts(*specs):
        stages: list = []
        elem = 0.0
        for bb, nn, real in specs:
            s, e = transform_stages(bb, nn, real)
            stages += s
            elem += e
        return stages, elem

    if kind in ("fft", "fft_batch", "fft_sequential", "fft_batchsize", "welch"):
        stages, elem = parts((b, n, True))
        bytes_ = b * n * f32 * (1 + 2)  # read x, write (re, im)
    elif kind in ("ifft", "ifft_batch", "ifft_sequential"):
        stages, elem = transform_stages(b, n, False)
        elem += 2.0 * b * n  # 1/N scale
        bytes_ = b * n * f32 * (2 + 2)
    elif kind in ("roundtrip", "roundtrip_batch", "roundtrip_sequential", "grad_fft", "hilbert"):
        # hilbert: the forward, the gain mask, the full complex inverse
        # (the analytic signal is complex).
        stages, elem = parts((b, n, True), (b, n, False))
        elem += 2.0 * b * n
        bytes_ = b * n * f32 * (1 + 2)
    elif kind == "dct_roundtrip":
        # Orthonormal dct + idct (ops/dct.py): Makhoul's forward is a real
        # transform at n and a rotation; DCT-III's inverse is the real-output
        # inverse (the irfft charge).  The permutation is data movement and
        # is not charged, so the bound stays a lower bound.
        stages, elem = parts((b, n, True))
        s2, e2, _ = irfft_stages(b, n)
        stages += s2
        elem += e2 + 4.0 * b * n  # pre/post rotations
        bytes_ = b * n * f32 * (1 + 2)
    elif kind == "resample":
        # resample(resample(x, n/2), n), down then back up: real forwards at
        # n and n/2, real-output inverses at n/2 and n (pow2 targets ride
        # inverse_real); the spectrum surgery is O(bn).
        mid = n // 2
        stages, elem = parts((b, n, True), (b, mid, True))
        for target in (mid, n):
            s2, e2, _ = irfft_stages(b, target)
            stages += s2
            elem += e2
        elem += 4.0 * b * n
        bytes_ = b * n * f32 * (1 + 1)
    elif kind in ("oaconvolve", "fftfilt"):
        # Overlap-add FIR, (b, n) = (blocks, block length m): forward real
        # blocks, the spectrum product, the complex inverse and 1/m.
        stages, elem = parts((b, n, True), (b, n, False))
        elem += 8.0 * b * n
        bytes_ = b * n * f32 * (1 + 1)  # real blocks in, real blocks out
    elif kind == "conv2d":
        # (b, n) = the padded (m1, m2).  Forward: real rows, then complex
        # columns over the n//2 + 1 surviving bins; inverse: the columns over
        # the half spectrum, then the rows' real-output inverse (at direct
        # sizes two real products contracting hw against the folded tables).
        hw = n // 2 + 1
        stages, elem = parts((b, n, True), (hw, b, False), (hw, b, False))
        if _plan.route(b, n, real_output=True, one_sided=True).path.startswith("irfft_direct"):
            stages.append((2 * 2.0 * b * n * hw, hw))
        else:
            s2, e2 = parts((b, n, False))
            stages += s2
            elem += e2
        elem += 8.0 * b * hw
        bytes_ = b * n * f32 * (1 + 1)
    elif kind == "fft2":
        # (b, n) = (H, W): the real row pass and the complex column pass.
        stages, elem = parts((b, n, True), (n, b, False))
        bytes_ = b * n * f32 * (1 + 2)
    elif kind == "irfft":
        # The 1/n scale lives in the tables at the fold sizes: no extra pass.
        stages, elem, read_frac = irfft_stages(b, n)
        bytes_ = b * n * f32 * (2.0 * read_frac + 1)
    elif kind == "stft_roundtrip":
        # The inverse leg is inverse_real_half: at direct frame sizes two
        # real products against the folded tables (K = n/2 with the
        # Nyquist broadcast on the irfft_direct_k128 route, else h = n/2 + 1
        # deep), above them the full roundtrip's charge.
        inverse = _plan.route(b, n, real_output=True, one_sided=True).path
        if inverse.startswith("irfft_direct"):
            stages, elem = parts((b, n, True))
            if inverse == "irfft_direct_k128":
                stages.append((2 * 2.0 * b * n * (n // 2), n // 2))
            else:
                stages.append((2 * 2.0 * b * n * (n // 2 + 1), n // 2 + 1))
            elem += 4.0 * b * n  # window, overlap-add, WOLA division
        else:
            stages, elem = parts((b, n, True), (b, n, False))
            elem += 2.0 * b * n
        bytes_ = b * n * f32 * (1 + 2)
    elif kind == "fft_exact":
        from ..ops.exact import mixed_split

        sp = mixed_split(n)
        if sp is not None:
            n1, n2 = sp
            stages = [(2 * 2.0 * b * n * n1, n1), (3 * 2.0 * b * n * n2, n2)]
            elem = 6.0 * b * n  # twiddle
        else:
            m = 1
            while m < 2 * n - 1:
                m *= 2
            stages, elem = parts((b, m, False), (b, m, False))
            elem += 3 * 6.0 * b * n  # the three chirp products
        bytes_ = b * n * f32 * (1 + 2)
    else:
        raise ValueError(f"unknown config kind {kind!r}")
    return {
        "flops": sum(f for f, _ in stages) + elem,
        "bytes": bytes_,
        "stages": stages,
        "elem_flops": elem,
    }


def roofline_row(
    b: int,
    n: int,
    kind: str,
    measured_s: float,
    chip: ChipSpec | None = None,
    n_kernels: int | None = None,
    precision_passes: int | None = None,
) -> dict:
    """The least time of a measured configuration and its share of it.

    ``t_matmul`` charges each matmul stage its effective passes
    (:data:`EFF_PASSES`) at the bf16 peak; ``t_bytes`` the least bytes at
    the HBM rate; ``t_elementwise`` the elementwise flops at the fp32 peak.
    ``precision_passes`` (JAX: the same argument) charges the matmul stages
    of a reduced-precision mode instead: 3 for bf16x3 ("high"), 1 for
    bf16x1 ("fast"), each stage's flops times the passes at the bf16
    tensor-core peak; None keeps the calibrated fp32 model.
    Given ``n_kernels`` (:func:`compiled_stats`) and a chip with a measured
    launch floor, ``t_latency = kernel_call_us * n_kernels``.  ``sol`` is
    the largest wall, ``bound`` its name: ``hbm``, ``matmul``,
    ``elementwise`` or ``latency``; ``calibrated`` whether the chip's
    figures were measured on it (:func:`chip_calibrated`).
    """
    chip = chip or detect_chip()
    cost = transform_cost(b, n, kind)
    walls = {
        "hbm": cost["bytes"] / (chip.hbm_gbps * 1e9),
        "matmul": sum(f * (eff_passes(chip.name, k) if precision_passes is None else precision_passes)
                      for f, k in cost["stages"]) / (chip.bf16_tflops * 1e12),
        "elementwise": cost["elem_flops"] / (chip.vpu_tflops * 1e12),
    }
    if n_kernels is not None and chip.kernel_call_us is not None:
        walls["latency"] = chip.kernel_call_us * n_kernels * 1e-6
    bound = max(walls, key=walls.get)
    sol = walls[bound]
    row = {
        "flops": cost["flops"],
        "bytes": cost["bytes"],
        "sol_us": sol * 1e6,
        "pct_sol": 100.0 * sol / measured_s if measured_s > 0 else 0.0,
        "bound": bound,
        "walls_us": {k: v * 1e6 for k, v in walls.items()},
        "chip": chip.name,
        "calibrated": chip_calibrated(chip),
    }
    if precision_passes is not None:
        row["precision_passes"] = precision_passes
    if n_kernels is not None:
        row["n_kernels"] = n_kernels
        if "latency" in walls:
            row["t_latency_us"] = walls["latency"] * 1e6
    return row
