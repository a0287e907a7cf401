"""havac_tpu_torch — the SSV homology-search engine on PyTorch and CUDA.

The port of `havac_tpu` (JAX on a TPU) to one NVIDIA Hopper GPU: the same
`Havac` API and the same hits, with the SSV sweep as a hand-written CUDA
kernel (`csrc/ssv_sweep.cu`) and its plain PyTorch version for CPU tensors.
The host code (FASTA/HMM parsing, score reprojection, hit resolution,
validation, the native core) is the port's own copy of the JAX package's,
under the same relative paths; the port imports nothing of `havac_tpu`.

    from havac_tpu_torch import Havac
    hv = Havac(p_value=0.02, device="cuda")
    hv.load_phmm("models.hmm")
    hv.load_sequence("db.fasta")
    hv.run()                      # or hv.run_async(); hv.wait()
    hits = hv.hits()
"""

from havac_tpu_torch.scoring.reprojection import (
    gumbel_inverse_survival,
    project_scores_for_threshold256,
    threshold256_scale_factor,
)
from havac_tpu_torch.engine import Havac, HavacRunState, HavacUsageError

__version__ = "0.1.0"

__all__ = [
    "Havac",
    "HavacRunState",
    "HavacUsageError",
    "gumbel_inverse_survival",
    "threshold256_scale_factor",
    "project_scores_for_threshold256",
]
