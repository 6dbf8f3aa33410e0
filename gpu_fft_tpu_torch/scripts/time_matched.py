"""Device time of the matched filter's own kernels (``kernels/matched.py``)
beside the plain torch passes they replace, and their bytes bound.

    python gpu_fft_tpu_torch/scripts/time_matched.py

For each (T, N) of :data:`SHAPES` (T = 1, 8, 64 templates; N = 2^17, 2^20,
2^22) it makes the input of :func:`make_input` on the card, in the
benchmark cell's proportions (:func:`layout`), and times, by the profiler's
device time (every kernel of a call, median of 5 profiles;
``time_stage_a.kernel_ms``): the correlation (``matched_correlate``) and its
plain passes, the SNR epilogue (``matched_snr``, two launches) and its plain
passes, and a whole ``matched_filter_device`` call.  Each kernel is printed
beside its bytes bound at 3.35 TB/s (:func:`bytes_moved`).  Inputs stay in
L2 from call to call where they fit (T = 1).  One JSON line is appended to
``time_matched.jsonl`` where ``time_stage_a.append_record`` writes.

:func:`layout`, :func:`bytes_moved` and :func:`make_input` are the one copy
of the cell's shape that ``chip_smoke.py`` and
``tests/test_torch_matched_filter.py`` read too; the kernels are held
against their plain versions there, not here.  Run this as a file, not with
``-m``: :func:`main` imports its timing helpers from ``time_stage_a.py``
beside it (inside the function, so that the package can import this module).
"""

from __future__ import annotations

SHAPES = tuple((t, n) for n in (1 << 17, 1 << 20, 1 << 22) for t in (1, 8, 64))
HBM_BYTES_PER_S = 3.35e12


def layout(n: int) -> tuple[int, int, int]:
    """(kmin, start, stop) at N = ``n`` in the cell's proportions: kmin =
    5N/512, the window [9N/32, 31N/32) (2^20: 10,240 and [294,912,
    1,015,808))."""
    return 5 * n // 512, 9 * n // 32, 31 * n // 32


def bytes_moved(t: int, n: int) -> tuple[int, int]:
    """The bytes bound of the correlation (the templates' band and s̃, S
    there read once, the (T, N) buffer written once) and of the SNR epilogue
    (the inverse over the window read once, ρ written once) at the cell's
    layout."""
    kmin, start, stop = layout(n)
    band, length = n // 2 - kmin, stop - start
    return 4 * (2 * t * band + 3 * band + 2 * t * n), 4 * 4 * t * length


def make_input(t: int, n: int, dev, seed: int):
    """(T + 2, 2, N/2 + 1) fp32 as the benchmark lays it out: row 0 the
    data's spectrum s̃, row 1 its PSD (positive), the T templates after.  The
    templates are passed as the strided views ``x[2:, 0]``, ``x[2:, 1]``;
    with h = N/2 + 1 odd every other row starts 8 bytes off a 16-byte
    boundary."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(t + 2, 2, n // 2 + 1, device=dev, generator=g)
    x[1, 0] = x[1, 0].abs() + 0.5
    return x


def time_one(t: int, n: int, dev, seed: int) -> dict:
    from time_stage_a import kernel_ms  # this script's sibling

    import gpu_fft_tpu_torch as gt
    from gpu_fft_tpu_torch.kernels import matched as M

    x = make_input(t, n, dev, seed)
    kmin, start, stop = layout(n)
    args = (x[2:, 0], x[2:, 1], x[0, 0], x[0, 1], x[1, 0], kmin)
    qr, qi, parts = M.matched_correlate(*args)
    pparts = M.matched_correlate_plain(*args)[2]
    yr, yi = gt.ifft_device(qr, qi)
    del qr, qi
    corr_bound, snr_bound = (b / HBM_BYTES_PER_S * 1e3 for b in bytes_moved(t, n))
    win = (0.5, start, stop)
    row = {"shape": [t, n], "kmin": kmin, "start": start, "stop": stop, "correlate_bound_ms": corr_bound,
           "snr_bound_ms": snr_bound,
           "correlate_ms": kernel_ms(lambda: M.matched_correlate(*args)),
           "correlate_plain_ms": kernel_ms(lambda: M.matched_correlate_plain(*args), calls=10, profiles=3),
           "snr_ms": kernel_ms(lambda: M.matched_snr(yr, yi, parts, *win)),
           "snr_plain_ms": kernel_ms(lambda: M.matched_snr_plain(yr, yi, pparts, *win), calls=10, profiles=3)}
    del yr, yi
    row["call_ms"] = kernel_ms(lambda: gt.matched_filter_device(
        *args[:5], delta_f=0.5, kmin=kmin, valid=(start, stop)), calls=10, profiles=3)
    row["correlate_pct_of_bound"] = 100.0 * corr_bound / row["correlate_ms"]
    row["snr_pct_of_bound"] = 100.0 * snr_bound / row["snr_ms"]
    print(f"  T={t:3d} N={n:8d}: correlate {row['correlate_ms']:.5f} ms ({row['correlate_pct_of_bound']:.1f}% of "
          f"{corr_bound:.5f}; plain {row['correlate_plain_ms']:.4f}), snr + peak {row['snr_ms']:.5f} ms "
          f"({row['snr_pct_of_bound']:.1f}% of {snr_bound:.5f}; plain {row['snr_plain_ms']:.4f}), "
          f"whole call {row['call_ms']:.4f} ms", flush=True)
    return row


def main() -> None:
    from time_stage_a import append_record, card_line, open_tree  # this script's sibling

    open_tree(".")
    import torch

    from gpu_fft_tpu_torch.config import apply_precision

    apply_precision()
    dev = torch.device("cuda")
    card = card_line()
    print(f"time_matched on {card}", flush=True)
    append_record("time_matched.jsonl", {"card": card, "rows": [time_one(t, n, dev, t + n) for t, n in SHAPES]})


if __name__ == "__main__":
    main()
