"""``gpu_fft_tpu_torch.signal.windows``: drop-in for ``scipy.signal.windows``.

Re-exports the f64 windows of :mod:`gpu_fft_tpu_torch.ops.windows`, which
live under ``ops`` so that the estimators in ``ops.stft`` use them without a
circular import.  Usage matches scipy::

    from gpu_fft_tpu_torch.signal import windows
    w = windows.dpss(512, 2.5)
"""

from ..ops.windows import *  # noqa: F401,F403
from ..ops.windows import __all__  # noqa: F401
