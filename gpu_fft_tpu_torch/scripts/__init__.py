"""Measurement harnesses of the port, run on the card as modules:

    python -m gpu_fft_tpu_torch.scripts.ablate_large
    python -m gpu_fft_tpu_torch.scripts.ablate_2e20_levers
    python -m gpu_fft_tpu_torch.scripts.ablate_mosaic_x6

Each is the counterpart of the JAX package's script of the same name under
``scripts/`` and writes its JSON under ``chiprun_out/`` (``--quick`` runs
fewer rounds and repetitions).
"""
