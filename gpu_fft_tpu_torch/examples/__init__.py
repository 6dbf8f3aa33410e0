"""The reference workload and the library tours, on the port.

Each module mirrors one of the JAX package's ``examples/*.py`` and prints
what it prints, with the same ``[OK]`` / ``[FAIL]`` gates; ``main(device=None)``
runs on ``device`` (default ``"cuda"``) and returns 0 when every gate holds.
Run one with ``python -m gpu_fft_tpu_torch.examples.<name>``:

* ``simple`` — the reference's demo: sine -> fft -> PSD -> dominant
  frequency -> ifft, the roundtrip within 5*log2(N)*eps;
* ``backends`` — a roundtrip through every available backend (TORCH,
  TORCH_FFT, and NATIVE where ``make -C native`` has built it);
* ``analysis`` — Welch, coherence, STFT masking, the Hilbert envelope,
  resampling and DCT compaction on a noisy AM tone;
* ``training`` — FIR taps learned by gradient descent through
  ``rfft_device`` with ``torch.autograd``;
* ``images`` — Fourier-domain image filters between ``fft2_device`` and
  ``ifft2_device``;
* ``filtering`` — FIR/IIR design and filtering, overlap-add, multirate, a
  2-D convolution and peak picking;
* ``fno`` — a 1-D Fourier Neural Operator learns the antiderivative
  operator (80 Adam steps), then a 2-D FNO runs one forward pass;
* ``extensions`` — the exact-length transform, fft2, the scipy namespaces,
  FFTLog, ShortTimeFFT, and an ``rfft`` served from a ``torch.export``
  artifact (the JAX example's ``OK`` gate).
"""

NAMES = ("simple", "backends", "analysis", "training", "images", "filtering", "fno", "extensions")
