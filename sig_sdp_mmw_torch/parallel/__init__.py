"""Batched scenario solves and speculative probe searches (port of
:mod:`sig_sdp_mmw_tpu.parallel`).  ``mesh.py`` and ``distributed.py`` are a
later slice."""

from sig_sdp_mmw_torch.parallel.batch import (  # noqa: F401
    ParallelProbeSearch,
    ParallelProbeSearchEll,
    solve_scenarios_batched,
    stack_states,
)
