"""K3F / K3LF's image, launch rule and limits without a card.

The kernel (``csrc/stage_a_bf16.cu`` on ``csrc/dot_bf16.cuh``) keeps F1
resident in shared memory as ``kernels/fused.py:stage_a_bf16_image`` lays it
out, and walks the column tiles of all B signals in persistent blocks, each
holding ``wgs`` 64-row groups, as ``stage_a_bf16_geometry`` picks.  These pin
the image against a numpy model of what each warpgroup reads, the kernel's
arithmetic (emulated from the image) against the plain version, the launch
rule on every shape that the dispatch, the harnesses and the tests pass, the
wrapper's limits, and that the image is built once per plan.
"""

import numpy as np
import pytest
import torch

from gpu_fft_tpu_torch import plan as P
from gpu_fft_tpu_torch.kernels import ablation as A
from gpu_fft_tpu_torch.kernels import fused as K
from gpu_fft_tpu_torch.kernels.tables import dft_matrix_ext
from gpu_fft_tpu_torch.scripts import ablate_large

SMEM_LIMIT = 232_448  # an H100 block's opt-in shared memory, static barriers included


def _tables(n1: int, sign: int = -1) -> dict:
    return dict(zip(("f1r", "f1i", "f1s", "f1d"), (torch.from_numpy(np.asarray(t, np.float32))
                                                   for t in dft_matrix_ext(n1, sign))))


def _bf16(a: torch.Tensor) -> np.ndarray:
    return a.to(torch.bfloat16).float().numpy()


def _model_image(t: dict) -> np.ndarray:
    """What each warpgroup's bulk copies bring in, as float32: run g < R =
    ceil(n1 / 32) holds real input's 64 stacked rows, row r the Fr (r < 32)
    or Fi row 32 g + r % 32; run R + 3 g + p holds part p of (Fr, Fd, Fs),
    row r the row 64 g + r; depth a of a row in chunk a // 64 at the 16-byte
    word ((a % 64) // 8) ^ (r % 8), element a % 8; rows past n1 zero."""
    fr, fi, fs, fd = (_bf16(t[k]) for k in ("f1r", "f1i", "f1s", "f1d"))
    n1 = fr.shape[0]
    chunks, real = -(-n1 // 64), -(-n1 // 32)
    out = np.zeros((real + 3 * chunks, chunks, 64, 64), np.float32)
    a = np.arange(n1)
    for run in range(out.shape[0]):
        for r in range(64):
            if run < real:
                k1, src = 32 * run + r % 32, (fr if r < 32 else fi)
            else:
                g, p = divmod(run - real, 3)
                k1, src = 64 * g + r, (fr, fd, fs)[p]
            if k1 < n1:
                out[run, a // 64, r, ((a % 64) // 8 ^ r % 8) * 8 + a % 8] = src[k1]
    return out


def _unswizzle(img: torch.Tensor) -> torch.Tensor:
    """(runs, 64, depth) fp32 from the image: word j of row r sits at j ^ (r % 8)."""
    runs, chunks = img.shape[:2]
    t = img.float().reshape(runs, chunks, 64, 8, 8)
    word = torch.arange(8).reshape(1, 8)
    r = torch.arange(64).reshape(64, 1)
    idx = (word ^ (r % 8)).reshape(1, 1, 64, 8, 1).expand_as(t)
    return torch.gather(t, 3, idx).permute(0, 2, 1, 3, 4).reshape(runs, 64, chunks * 64)


@pytest.mark.parametrize("n1", [16, 48, 64, 128, 256, 320, 512])
def test_image_is_what_each_warpgroup_reads(n1):
    t = _tables(n1)
    img = K.stage_a_bf16_image(t)
    assert img.dtype == torch.bfloat16 and tuple(img.shape) == K.stage_a_bf16_image_shape(n1)
    np.testing.assert_array_equal(img.float().numpy(), _model_image(t))


@pytest.mark.parametrize("n1", [32, 128, 256])
def test_real_groups_are_s2fs_image(n1):
    """Real input reads S2's stacking: the image's first runs are S2F's
    ``f_img`` (K3LF at B = 1, all rows, computes S2F's function)."""
    plan = P.on_device(ablate_large.make_plan, n1 * 64, n1, -1, device="cpu")
    f_img = A.manual_tables(plan)["f_img"]
    img = K.stage_a_bf16_image(plan)
    assert torch.equal(img[: 2 * n1 // 64], f_img[:, 0])


def _emulate(xr, xi, plan: dict, n1: int, n2: int, ct: int, rows: int, ncols: int):
    """The kernel's arithmetic in plain torch, read from the image: per 64-row
    group the products of its parts with x's bf16 operands in fp32, Re / Im
    taken from the rows the kernel stages (real: the pair's rows r and r + 32;
    complex: Kara3's P0 - P2, P0 + P1), the first ``rows`` rows and ``ncols``
    columns, times the twiddle in fp32."""
    f = _unswizzle(K.stage_a_bf16_image(plan))[:, :, :n1]
    bf = lambda v: v[..., :ncols].to(torch.bfloat16).float()  # noqa: E731
    if xi is None:
        p = torch.einsum("gra,bac->bgrc", f[: -(-rows // 32)], bf(xr))
        pr, pi = p[:, :, :32].flatten(1, 2), p[:, :, 32:].flatten(1, 2)
    else:
        base, groups = -(-n1 // 32), -(-rows // 64)
        parts = f[base: base + 3 * groups].reshape(groups, 3, 64, n1)
        p0, p1, p2 = (torch.einsum("gra,bac->bgrc", parts[:, q], op).flatten(1, 2)
                      for q, op in enumerate((bf(xr + xi), bf(xr), bf(xi))))
        pr, pi = p0 - p2, p0 + p1
    twr, twi = K._stage_a_twiddle(K._sliced_tables(plan, rows, ncols, ct))
    pr, pi = pr[:, :rows], pi[:, :rows]
    return pr * twr - pi * twi, pr * twi + pi * twr


@pytest.mark.parametrize("n,layout,complex_,ct,tiles,rows,b", [
    (1 << 17, "factored", False, 512, None, 72, 2), (1 << 17, "factored", True, 512, None, None, 2),
    (1 << 17, "factored", True, 32, 3, None, 1), (1 << 17, "factored", False, 32, 3, 72, 1),
    (48 * 64, "legacy", False, 64, None, None, 1), (48 * 64, "legacy", True, 64, None, 40, 1),
    (16 * 64, "legacy", True, 64, None, None, 3), (256 * 64, "legacy", False, 64, None, 136, 1),
])
def test_the_kernels_arithmetic_from_the_image_is_the_plain_version(n, layout, complex_, ct, tiles, rows, b):
    if layout == "factored":
        plan = P.on_device(P.get_stage_a_plan, n, 1 if complex_ else -1, ct, device="cpu")
    else:
        plan = P.on_device(ablate_large.make_plan, n, n // 64, 1 if complex_ else -1, device="cpu")
    n1, n2 = plan["n1"], plan["n2"]
    rng = np.random.default_rng(n1 + b)
    xr = torch.from_numpy(rng.standard_normal((b, n1, n2)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((b, n1, n2)).astype(np.float32)) if complex_ else None
    r, ncols = K._stage_a_extent(n1, n2, plan, ct, tiles, rows)
    want = K.stage_a_bf16_plain(xr, xi, n1, n2, plan, ct, tiles, rows)
    got = _emulate(xr, xi, plan, n1, n2, ct, r, ncols)
    scale = max(float(w.abs().max()) for w in want)
    assert max(float((g - w).abs().max()) for g, w in zip(got, want)) <= 1e-5 * scale


def _path_shapes() -> list[tuple]:
    """(B, n1, n2, rows, ncols, complex) of every K3F / K3LF launch the
    dispatch, the harnesses, chip_smoke.py and the tests make."""
    shapes = set()
    for n in (1 << 17, 1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22, 1 << 23, 1 << 24):
        n1 = P._stage_a_n1(n)
        n2 = n // n1
        for b in (1, 2, 3, 128, 512 if n == 1 << 17 else 1):
            shapes.add((b, n1, n2, P.stage_a_real_rows(n1), n2, False))
            shapes.add((b, n1, n2, n1, n2, True))
            for ct in (512, 1024, 2048):
                if ct <= n2:
                    shapes.add((b, n1, n2, n1, -(-(n2 // 2 + 1) // ct) * ct, True))
        shapes.add((1, n1, n2, n1, 96, True))  # ct = 32, three tiles: half a 64-column tile masked
        shapes.add((1, n1, n2, P.stage_a_real_rows(n1), 96, False))
    for n, n1s in ablate_large.SWEEPS.items():
        for n1 in n1s:
            n2 = n // n1
            shapes |= {(1, n1, n2, r, n2, c) for r in (n1, P.stage_a_real_rows(n1)) for c in (False, True)}
            shapes |= {(1, n1, n2, n1, P.stage_a_col_tile(n1, n2), c) for c in (False, True)}
    for n1 in (16, 32, 48, 64, 80, 96, 192, 320, 384, 448, 512):
        shapes |= {(1, n1, 4096, r, 4096, c) for r in (8, n1) for c in (False, True)}
    return sorted(shapes)


@pytest.mark.parametrize("b,n1,n2,rows,ncols,complex_", _path_shapes())
def test_rule_fits_and_covers_every_output_once(b, n1, n2, rows, ncols, complex_):
    shapes = K.stage_a_bf16_launch_shapes(b, n1, n2, rows, ncols, complex_)
    assert shapes[0] == K.stage_a_bf16_geometry(b, n1, n2, rows, ncols, complex_)
    groups = K.stage_a_bf16_groups(rows, complex_)
    image_groups = -(-n1 // (64 if complex_ else 32))
    assert groups <= image_groups  # a launch copies only runs the image holds
    col_tiles = -(-ncols // 64)
    for wgs, row_blocks, grid in shapes:
        assert wgs in K._STAGE_A_BF16_WGS[complex_]
        assert K.stage_a_bf16_smem_bytes(n1, wgs, complex_) <= K.SMEM_MAX <= SMEM_LIMIT - 16
        assert row_blocks == -(-groups // wgs) and grid % row_blocks == 0 and grid >= row_blocks
        cover = K.stage_a_bf16_cover(b, n1, n2, rows, ncols, complex_, (wgs, row_blocks, grid))
        assert len(cover) == grid
        per_rb = grid // row_blocks
        k1s = [list(cover[rb * per_rb][1]) for rb in range(row_blocks)]
        assert sum(k1s, []) == list(range(rows))  # the row blocks split the rows
        for rb in range(row_blocks):
            blocks = cover[rb * per_rb: (rb + 1) * per_rb]
            assert all(list(blk[1]) == k1s[rb] for blk in blocks)
            tiles = sorted(t for blk in blocks for t in blk[2])
            assert tiles == [(tb, tc * 64) for tb in range(b) for tc in range(col_tiles)]  # each tile once
    # the kept columns: whole tiles, the last one masked at ncols (a multiple of 32)
    assert sorted({c for c0 in range(0, col_tiles * 64, 64) for c in range(c0, c0 + 64) if c < ncols}) \
        == list(range(ncols))
    if n1 <= 128:
        assert shapes[0][1] == 1  # one row block: x read once
    assert K.stage_a_bf16_streamed(n1, shapes[0][0], complex_) == (complex_ and n1 > 320)


def test_rule_at_the_main_path_shapes():
    """2^20 / 2^22 (n1 = 128): real rows = 72 is three groups on one block of
    three warpgroups, complex all rows two on one of two; 2^24 (n1 = 256):
    real rows = 136 is five groups, two row blocks of three; complex four,
    four row blocks of one; one block an SM, at most the column tiles."""
    assert K.stage_a_bf16_geometry(1, 128, 8192, 72, 8192, False) == (3, 1, 128)
    assert K.stage_a_bf16_geometry(1, 128, 32768, 72, 32768, False) == (3, 1, 132)
    assert K.stage_a_bf16_geometry(1, 128, 8192, 128, 8192, True) == (2, 1, 128)
    assert K.stage_a_bf16_geometry(1, 256, 65536, 136, 65536, False) == (3, 2, 132)
    assert K.stage_a_bf16_geometry(1, 256, 65536, 256, 65536, True) == (1, 4, 132)
    assert K.stage_a_bf16_geometry(512, 128, 1024, 72, 1024, False, sms=114) == (3, 1, 114)


_META = {"f1r": None, "f1i": None, "f1s": None, "f1d": None, "twr": None, "twi": None}


@pytest.mark.parametrize("b,n1,n2,col_tile,tiles,rows,factored,match", [
    (0, 16, 64, 64, None, None, False, "B >= 1"),
    (1, 24, 64, 64, None, None, False, "n1 a multiple of 16"),
    (1, 528, 64, 64, None, None, False, r"n1 a multiple of 16 in \[16, 512\]"),
    (1, 16, 48, 16, None, None, False, "kept columns a multiple of 32"),
    (1, 16, 128, 16, 1, None, False, "kept columns a multiple of 32"),
    (1, 16, 97, 32, None, None, False, "n2 even"),
    (1, 16, 1056, 33, None, None, True, "factored ct even"),
])
def test_wrapper_refuses_before_the_device(b, n1, n2, col_tile, tiles, rows, factored, match):
    """A shape outside the kernel's limits raises ValueError on a non-CPU
    tensor before the device is looked at (meta tensors), counting nothing;
    the rule refuses it too."""
    tables = dict(_META)
    if factored:
        tables = {**{k: None for k in ("f1r", "f1i", "f1s", "f1d", "two_r", "two_i", "twi_r", "twi_i")},
                  "ct": col_tile}
    K.reset_counts()
    with pytest.raises(ValueError, match=match):
        K.stage_a_bf16(torch.empty(b, n1, n2, device="meta"), None, n1, n2, tables, col_tile, tiles, rows)
    assert all(c.launches == 0 and c.plain_calls == 0 for c in K.COUNTS.values())
    if not factored:
        r, ncols = K._stage_a_extent(n1, n2, tables, col_tile, tiles, rows)
        with pytest.raises(ValueError, match=match):
            K.stage_a_bf16_launch_shapes(b, n1, n2, r, ncols, False)


def test_image_is_built_once_per_plan(monkeypatch):
    built = []
    real = K.stage_a_bf16_image
    monkeypatch.setattr(K, "stage_a_bf16_image", lambda plan: built.append(plan["n1"]) or real(plan))
    fresh = lambda t: {k: v.clone() if torch.is_tensor(v) else v for k, v in t.items()}  # noqa: E731
    plan = fresh(P.on_device(P.get_stage_a_plan, 1 << 17, -1, None, device="cpu"))
    legacy = fresh(P.on_device(ablate_large.make_plan, 1 << 17, 64, 1, device="cpu"))
    (one,) = K.bf16_images(plan)
    assert K.bf16_images(plan)[0] is one and K.bf16_images(dict(plan))[0] is one
    (two,) = K.bf16_images(legacy)
    assert K.bf16_images(legacy)[0] is two
    assert built == [128, 64]  # one build a plan; a second call builds nothing
