"""sig_sdp_mmw_torch — the PyTorch/CUDA port of sig_sdp_mmw_tpu.

Same subpackages, module and function names as :mod:`sig_sdp_mmw_tpu`, so
each ported function sits where its JAX counterpart does; the JAX package
stays the reference the port is tested against.  Ported so far: the
block-sparse pipelines at 100k links (``experiments/e2e_large.py``, with
the device rounding of the sparse state, the ELL heuristics and the
speculative search of ``parallel/batch.py``) and at a million
(``experiments/million_link_e2e.py``), whose SpMMs run through
hand-written CUDA kernels (``ops/kernels/csrc/``) on the card, and the
dense journal-scale path (``env/env.py`` → ``core/problem.py`` →
``models/mmw.py`` → ``models/rounding.py`` → ``models/search.py``, entry
point ``experiments/sim_mmw_time.py``) in plain PyTorch.  This package
imports torch and never jax.
"""

__version__ = "0.1.0"
