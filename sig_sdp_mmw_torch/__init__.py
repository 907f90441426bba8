"""sig_sdp_mmw_torch — the PyTorch/CUDA port of sig_sdp_mmw_tpu.

Same subpackages, module and function names as :mod:`sig_sdp_mmw_tpu`, so
each ported function sits where its JAX counterpart does; the JAX package
stays the reference the port is tested against.  Every module and public
name of the JAX package has its counterpart here
(``tests/test_torch_slice.py::test_port_has_every_public_name``): the
block-sparse pipelines at 100k links (``experiments/e2e_large.py``) and at
a million (``experiments/million_link_e2e.py``), whose SpMMs run through
hand-written CUDA kernels (``ops/kernels/csrc/``) on the card in place of
the three Pallas kernels, the dense journal-scale path (``env/env.py`` →
``core/problem.py`` → ``models/mmw.py`` → ``models/rounding.py`` →
``models/search.py``), the journal's comparison methods and scripts with
their figures (``experiments/plot_results.py``), and the multi-device
layer (``parallel/``), all in plain PyTorch around the kernels.  This package
imports torch and never jax.
"""

__version__ = "0.1.0"

from sig_sdp_mmw_torch.core.problem import SigState, state_from_arrays  # noqa: F401
