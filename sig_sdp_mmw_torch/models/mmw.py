"""Dense MMW solver: so far only the Krylov-dimension default that the sparse
solver shares (port of :func:`sig_sdp_mmw_tpu.models.mmw.mmw_default_lanczos_m`).
The dense ``mmw_solve`` belongs to the dense slice."""

from __future__ import annotations

import math


def mmw_default_lanczos_m(eta: float, nit: int) -> int:
    """Krylov dimension default for the MMW Gibbs sketch.

    The worst-case bound ``||L_accu/2|| <= eta*nit`` is loose in practice;
    the reference measured the final max-violation unchanged from m=8 to
    m=48, so the default keeps a sqrt safety margin above a floor of 8.
    Override ``lanczos_m`` explicitly for other (eta, nit) regimes.
    """
    return min(48, max(8, int(math.ceil(8 + 0.6 * math.sqrt(eta * nit)))))
