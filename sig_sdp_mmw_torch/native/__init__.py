"""Native (C++) host-side components shared with the JAX package
(``csrc/sig_native.cpp``), bound with ctypes."""

from sig_sdp_mmw_torch.native.builder import (  # noqa: F401
    build_state_csr_native,
    greedy_round_native,
    native_available,
    native_num_threads,
)
