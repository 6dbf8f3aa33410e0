"""Measurement harnesses of the port, run on the card as modules:

    python -m gpu_fft_tpu_torch.scripts.ablate_large
    python -m gpu_fft_tpu_torch.scripts.ablate_2e20_levers
    python -m gpu_fft_tpu_torch.scripts.ablate_mosaic_x6
    python -m gpu_fft_tpu_torch.scripts.calibrate_latency
    python -m gpu_fft_tpu_torch.scripts.calibrate_matmul
    python -m gpu_fft_tpu_torch.scripts.calibrate_chip
    python -m gpu_fft_tpu_torch.scripts.ablate_whole_packed
    python -m gpu_fft_tpu_torch.scripts.ablate_engines

Each is the counterpart of the JAX package's script of the same name under
``scripts/`` and writes its JSON under ``chiprun_out/`` (``--quick`` runs
fewer rounds and repetitions).  The calibration scripts print the figures of
``utils/roofline.CHIPS["h100"]`` and ``EFF_PASSES["h100"]`` that they
measure, and a ``tuning.ChipTuning`` entry (``calibrate_chip``).
"""
