"""The dense SIG-SDP problem state, in PyTorch.

Port of :mod:`sig_sdp_mmw_tpu.core.problem`: the reference's ``state =
(S_gain csr, Q_asso csr, h_max)`` tuple becomes a padded, mask-aware dense
container of tensors on one device:

* ``S``      [Kp, Kp] — interference gain matrix; ``S[k, j]`` is the
  received-power ratio of user ``k`` at the AP associated with user ``j``;
  the diagonal is the user's own-AP gain;
* ``Q``      [Kp, Kp] 0/1 — association cliques (``Q[i, j] = 1`` iff users
  i≠j share an AP); zero diagonal;
* ``h_max``  [Kp] — per-user interference budget ``diag(S)/min_sinr - 1``;
* ``mask``   [Kp] bool — valid users; padded rows and columns are all zero.

The binary search's degree bounds are read from the host arrays when the
state is built and kept with it, so a search on the card never copies the
[Kp, Kp] matrices back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from sig_sdp_mmw_torch.utils.tensors import TensorFields, as_tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _bounds_from_arrays(S, Q, mask) -> Tuple[int, int]:
    """(lb, ub) from host arrays: lb = max association degree + 1; ub = max
    off-diagonal degree of the pattern of S + Sᵀ over valid users, + 2 (the
    reference's csr ``setdiag(0)`` keeps an explicit stored zero on the
    diagonal, so its per-row count includes it)."""
    lb = int((Q != 0).sum(axis=1).max()) + 1
    Ssym = (S != 0) | (S.T != 0)
    np.fill_diagonal(Ssym, False)
    Ssym = Ssym & mask[None, :] & mask[:, None]
    ub = int(Ssym.sum(axis=1).max()) + 2
    return lb, ub


@dataclasses.dataclass(frozen=True)
class SigState(TensorFields):
    S: torch.Tensor       # [Kp, Kp]
    Q: torch.Tensor       # [Kp, Kp]
    h_max: torch.Tensor   # [Kp]
    mask: torch.Tensor    # [Kp] bool
    K: int
    # Degree bounds computed on the host at build time (-1 = absent).
    lb_cache: int = -1
    ub_cache: int = -1

    @property
    def Kp(self) -> int:
        return self.S.shape[-1]

    def degree_bounds(self) -> Tuple[int, int]:
        """(lb, ub) for the binary search over Z (reference
        ``binary_search_relaxation.set_bounds``)."""
        if self.lb_cache >= 0 and self.ub_cache >= 0:
            return self.lb_cache, self.ub_cache
        return _bounds_from_arrays(_np(self.S), _np(self.Q), _np(self.mask))

    def asso_lower_bound(self) -> int:
        """lb = max association degree + 1."""
        return self.degree_bounds()[0]


def state_from_arrays(S, Q, h_max, pad_to: Optional[int] = None,
                      dtype=torch.float32, device="cpu") -> SigState:
    """A :class:`SigState` from dense [K, K] arrays (numpy or tensors),
    padded to ``pad_to`` (default: the next multiple of 8) and placed on
    ``device``."""
    S = _np(S)
    K = S.shape[0]
    Kp = pad_to if pad_to is not None else _round_up(K, 8)
    if Kp < K:
        raise ValueError(f"pad_to={Kp} < K={K}")

    def pad2(a):
        out = np.zeros((Kp, Kp), dtype=np.float64)
        out[:K, :K] = _np(a)
        return out

    Sp = torch.from_numpy(pad2(S)).to(dtype)
    Qp = torch.from_numpy(pad2(Q)).to(dtype)
    hm = np.zeros((Kp,), dtype=np.float64)
    hm[:K] = _np(h_max)
    mask = np.zeros((Kp,), dtype=bool)
    mask[:K] = True
    # The bounds of the arrays as stored (after the cast to ``dtype``).
    lb, ub = _bounds_from_arrays(_np(Sp), _np(Qp), mask)
    return SigState(S=Sp, Q=Qp, h_max=torch.from_numpy(hm).to(dtype),
                    mask=torch.from_numpy(mask), K=K,
                    lb_cache=lb, ub_cache=ub).to(device)


def state_from_scipy(state_tuple, pad_to: Optional[int] = None,
                     dtype=torch.float32, device="cpu") -> SigState:
    """Interop: consume the reference's ``(S_csr, Q_csr, h_max)`` tuple."""
    S_csr, Q_csr, h_max = state_tuple
    return state_from_arrays(S_csr.toarray(), Q_csr.toarray(), h_max,
                             pad_to=pad_to, dtype=dtype, device=device)


def state_to_scipy(state: SigState):
    """Interop: produce the reference's ``(S_csr, Q_csr, h_max)`` tuple."""
    import scipy.sparse

    K = state.K
    S = _np(state.S).astype(np.float64)[:K, :K]
    Q = _np(state.Q).astype(np.float64)[:K, :K]
    h = _np(state.h_max).astype(np.float64)[:K]
    return (scipy.sparse.csr_matrix(S), scipy.sparse.csr_matrix(Q), h)


def from_jax_arrays(arrays: Mapping, device="cpu") -> SigState:
    """SigState from the fields of a JAX ``sig_sdp_mmw_tpu.core.problem.
    SigState`` given as numpy arrays (``S``, ``Q``, ``h_max``, ``mask``,
    and ``K`` as an int); the bounds are computed from those arrays."""
    lb, ub = _bounds_from_arrays(np.asarray(arrays["S"]),
                                 np.asarray(arrays["Q"]),
                                 np.asarray(arrays["mask"]))
    return SigState(S=as_tensor(arrays["S"]), Q=as_tensor(arrays["Q"]),
                    h_max=as_tensor(arrays["h_max"]),
                    mask=as_tensor(arrays["mask"]), K=int(arrays["K"]),
                    lb_cache=lb, ub_cache=ub).to(device)
