"""Multi-card scaling over a ``torch.distributed`` device mesh.

Port of ``gpu_fft_tpu/parallel``: a ``DeviceMesh`` with named dimensions
takes the place of ``jax.sharding.Mesh``, DTensors the place of sharded
``jax.Array``s, and the collectives run on each mesh axis's process group
(NCCL on the card).

* ``mesh.py``        — batch ("data-parallel") sharding with no collective,
                       and the sharded Welch (one all-reduce), overlap-add
                       (one neighbour exchange) and IIR filter (one
                       all-gather of the block states);
* ``distributed.py`` — one transform larger than a card: the four-step
                       with the transpose as an all-to-all
                       ("sequence-parallel" axis);
* ``pencil.py``      — 2-D pencil and 3-D slab decompositions.

Run under ``torchrun --nproc_per_node=<cards>`` with
``init_process_group("nccl")`` and :func:`default_mesh`, or over gloo on
the CPU with ``default_mesh(device="cpu")``.
"""

from .distributed import distributed_fft, distributed_ifft
from .mesh import (
    default_mesh,
    fft2_batch_sharded,
    fft_batch_sharded,
    ifft_batch_sharded,
    lfilter_sharded,
    oaconvolve_sharded,
    welch_sharded,
)
from .pencil import fft2_sharded, fftn_sharded, ifft2_sharded, ifftn_sharded

__all__ = [
    "default_mesh",
    "fft_batch_sharded",
    "fft2_batch_sharded",
    "ifft_batch_sharded",
    "lfilter_sharded",
    "oaconvolve_sharded",
    "welch_sharded",
    "distributed_fft",
    "distributed_ifft",
    "fft2_sharded",
    "ifft2_sharded",
    "fftn_sharded",
    "ifftn_sharded",
]
