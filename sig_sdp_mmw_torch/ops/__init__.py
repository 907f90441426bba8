"""Sparse operators: block-sparse SpMM, ELL gathers, batched Lanczos."""

from sig_sdp_mmw_torch.ops.expm import lanczos_expm_multiply, taylor_expm_multiply  # noqa: F401
from sig_sdp_mmw_torch.ops.lanczos import lanczos_extreme_eigs  # noqa: F401
from sig_sdp_mmw_torch.ops.rsvd import randomized_symmetric_lowrank  # noqa: F401
