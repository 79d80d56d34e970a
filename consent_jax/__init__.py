"""consent_jax — long-read self-correction and assembly polishing on GPUs.

A from-scratch JAX/XLA reimplementation, with one CUDA kernel, of the
capabilities of
morispi/CONSENT (reference layout: CONSENT-correct / CONSENT-polish bash
drivers over a multithreaded C++ core).  The pipeline:

  overlaps (PAF)  ->  alignment piles  ->  windows  ->  batched consensus
  (device)        ->  DBG polish       ->  stitch   ->  corrected FASTA

Design stance (accelerator-first, not a port):
  * windows are batched into fixed-shape int8 tensors and consensus is
    computed by a batched ends-free affine-gap alignment + realign-vote
    scheme (replacing the reference's SPOA partial-order alignment,
    reference: src/correctionMSA.cpp + BMEAN submodule),
  * k-mer counts live in dense 4^k tables on device (replacing
    robin_hood hash maps, reference: src/robin_hood.h),
  * parallelism is jax.sharding over a device mesh (replacing the CTPL
    thread pool, reference: CTPL/ctpl_stl.h).
"""

__version__ = "0.1.0"

from consent_jax.config import ConsentConfig, correct_preset, polish_preset

__all__ = [
    "ConsentConfig",
    "correct_preset",
    "polish_preset",
    "__version__",
]
