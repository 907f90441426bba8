"""Solvers: dense MMW and its rounding, sparse MMW, rounding and
verification, binary search over Z, and the journal's comparison methods
(the ADMM oracle, LRP, the Rand/Spectral baselines, the greedy
heuristics)."""

from sig_sdp_mmw_torch.models.base import SDPSolverBase  # noqa: F401
from sig_sdp_mmw_torch.models.mmw import MMW, mmw_solve  # noqa: F401
from sig_sdp_mmw_torch.models.rounding import (  # noqa: F401
    rounding,
    rounding_one_attempt,
    verify_assignment,
)
from sig_sdp_mmw_torch.models.search import BinarySearchRelaxation  # noqa: F401
from sig_sdp_mmw_torch.models.baselines import RandSDPSolver, SpectralSDPSolver  # noqa: F401
from sig_sdp_mmw_torch.models.admm import ADMMSDPSolver  # noqa: F401
from sig_sdp_mmw_torch.models.lrp import LRPSolver  # noqa: F401
from sig_sdp_mmw_torch.models.heuristics import MAX_GAIN, MAX_ASSO, MAX_RAND  # noqa: F401
