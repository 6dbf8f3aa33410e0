"""The benchmark of gpu_fft_tpu_torch on one CUDA card; see run.py."""
