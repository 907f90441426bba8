"""Solvers: dense MMW and its rounding, sparse MMW, rounding and
verification, binary search over Z."""

from sig_sdp_mmw_torch.models.base import SDPSolverBase  # noqa: F401
from sig_sdp_mmw_torch.models.mmw import MMW, mmw_solve  # noqa: F401
from sig_sdp_mmw_torch.models.rounding import (  # noqa: F401
    rounding,
    rounding_one_attempt,
    verify_assignment,
)
from sig_sdp_mmw_torch.models.search import BinarySearchRelaxation  # noqa: F401
