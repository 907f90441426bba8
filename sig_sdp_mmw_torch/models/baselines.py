"""Non-MMW relaxation baselines: a random factor and spectral partitioning.

Port of :mod:`sig_sdp_mmw_tpu.models.baselines` (reference
``sim_src/alg/sdp_solver.py``):

* :class:`RandSDPSolver`     — row-normalized Gaussian factor (``:109-114``);
  call n draws ``sdp_rand_factor`` from stream n of ``seed`` (JAX:
  ``fold_in(PRNGKey(seed), n)``);
* :class:`SpectralSDPSolver` — top-Z Laplacian eigenvectors of the
  symmetrized gain graph, row-normalized (``:165-185``), ARPACK ``eigsh``
  replaced by subspace (orthogonal) iteration from the draws'
  ``spectral_start`` (JAX: ``PRNGKey(seed)``, the same on every call).
"""

from __future__ import annotations

import numpy as np
import torch

from sig_sdp_mmw_torch.core.problem import SigState
from sig_sdp_mmw_torch.models.base import SDPSolverBase
from sig_sdp_mmw_torch.utils.draws import TorchDraws
from sig_sdp_mmw_torch.utils.stats import StatsObject


def _row_normalized(gX, mask):
    """Unit rows for the valid users, zero rows for the padding."""
    gX = gX / torch.clamp(torch.linalg.norm(gX, dim=1, keepdim=True),
                          min=1e-30)
    return torch.where(mask[:, None], gX, 0.0)


def rand_factor(state: SigState, Z: int, rank_radio: int, draws):
    """[Kp, Z * rank_radio] Gaussian factor, masked and row-normalized."""
    gX = draws.sdp_rand_factor((state.Kp, Z * rank_radio),
                               state.S.dtype).to(state.S.device)
    return _row_normalized(gX, state.mask)


class RandSDPSolver(SDPSolverBase, StatsObject):
    def __init__(self, nit: int = 100, rank_radio: int = 2, alpha: float = 1.0,
                 seed: int = 0):
        SDPSolverBase.__init__(self, nit=nit, rank_radio=rank_radio, alpha=alpha)
        self.seed = seed
        self._n = 0

    def run_with_state(self, bs_iteration: int, Z: int, state: SigState):
        self._n += 1
        draws = TorchDraws(self.seed, state.mask.device, stream=self._n)
        return True, rand_factor(state, int(Z), self.rank_radio, draws)


def _subspace_topk(A, draws, k: int, iters: int = 30):
    """Top-k eigenvectors (largest magnitude) via orthogonal iteration, then
    Rayleigh–Ritz.  (vectors [n, k], Ritz values [k])."""
    n = A.shape[0]
    Q = torch.linalg.qr(draws.spectral_start((n, k), A.dtype).to(A.device))[0]
    for _ in range(iters):
        Q = torch.linalg.qr(A @ Q)[0]
    B = Q.T @ (A @ Q)
    w, V = torch.linalg.eigh(0.5 * (B + B.T))
    order = torch.argsort(-torch.abs(w), stable=True)
    return Q @ V[:, order], w[order]


def laplacian(state: SigState):
    """Laplacian of the symmetrized gain graph (zero diagonal)."""
    eye = torch.eye(state.Kp, dtype=torch.bool, device=state.S.device)
    Ssym = torch.where(eye, 0.0, state.S + state.S.T)
    return torch.diag(torch.sum(Ssym, dim=1)) - Ssym


class SpectralSDPSolver(SDPSolverBase, StatsObject):
    def __init__(self, nit: int = 100, rank_radio: int = 2, alpha: float = 1.0,
                 seed: int = 0):
        SDPSolverBase.__init__(self, nit=nit, rank_radio=rank_radio, alpha=alpha)
        self.seed = seed

    def run_with_state(self, bs_iteration: int, Z: int, state: SigState):
        ps_tic = self._get_tic()
        Lap = laplacian(state)
        tim = self._get_tim(ps_tic, sync=Lap)
        self._add_np_log("spectral_problem_setup", bs_iteration,
                         np.array([Z, state.K, tim]))

        tic = self._get_tic()
        vecs, _ = _subspace_topk(Lap, TorchDraws(self.seed, state.mask.device),
                                 k=int(Z))
        gX = _row_normalized(vecs, state.mask)
        tim = self._get_tim(tic, sync=gX)
        self._add_np_log("spectral_solve", bs_iteration,
                         np.array([Z, state.K, tim]))
        return True, gX
