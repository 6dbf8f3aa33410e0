"""tools/readings.py for the matched-filter cell, whose op tools/faults.py
does not know yet.  Every reading is readings.py's own, but for the
half-batch fault, which here filters the first half of the templates and
repeats their SNR in the place of the second half's.

    python3 portbench/tools/readings_matched_filter.py \
        --workload pycbc.matched_filter_t64_n2e20 --seeds 3 --controls 3 --seconds 2
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench.tools import faults, readings  # noqa: E402

_half_batch = faults.half_batch


def half_batch(kind, op, x):
    """faults.half_batch, and for the matched filter: the op on the data's
    rows (s̃, S) and the first half of the templates, the SNR of those
    templates repeated for the rest."""
    if kind != "matched_filter":
        return _half_batch(kind, op, x)
    t = x.shape[0] - 2
    half = (t + 1) // 2
    yr, yi = op(x[: 2 + half].contiguous())
    rest = t - half
    return torch.cat([yr, yr[:rest]]), torch.cat([yi, yi[:rest]])


def main(argv=None) -> int:
    faults.half_batch = half_batch  # readings.py looks it up on the module at each call
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
