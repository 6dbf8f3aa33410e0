"""``gpu_fft_tpu_torch.signal``: the package of the scipy.signal-style
namespace.  Only :mod:`.windows` is ported; the namespace proper (complex
outputs under scipy's names) is ROADMAP item 11."""
