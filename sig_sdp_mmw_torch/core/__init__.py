"""Problem state containers: the dense SigState and its MMW operands, the
sparse ELL state."""

from sig_sdp_mmw_torch.core.problem import (  # noqa: F401
    SigState,
    state_from_arrays,
    state_from_scipy,
    state_to_scipy,
)
from sig_sdp_mmw_torch.core.preprocess import (  # noqa: F401
    MMWOperands,
    build_mmw_operands,
)
