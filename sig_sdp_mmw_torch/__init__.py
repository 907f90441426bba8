"""sig_sdp_mmw_torch — the PyTorch/CUDA port of sig_sdp_mmw_tpu.

Same subpackages, module and function names as :mod:`sig_sdp_mmw_tpu`, so
each ported function sits where its JAX counterpart does; the JAX package
stays the reference the port is tested against.  Ported so far: the
block-sparse large-graph pipeline (``experiments/e2e_large.py``), whose S̃
and S̃ᵀ matvecs run through a hand-written CUDA kernel
(``ops/kernels/csrc/bsr_spmm_flat.cu``) on the card.  This package imports
torch and never jax.
"""

__version__ = "0.1.0"
