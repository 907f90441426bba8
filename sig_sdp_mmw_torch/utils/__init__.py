"""Timers and metric tables, random draws, tensor containers, native builds."""

from sig_sdp_mmw_torch.utils.stats import StatsObject, STATS_OBJECT  # noqa: F401
from sig_sdp_mmw_torch.utils.logging import (  # noqa: F401
    CsvWriter,
    CSV_WRITER_OBJECT,
    get_log_path_for_sim_script,
    GET_LOG_PATH_FOR_SIM_SCRIPT,
)
from sig_sdp_mmw_torch.utils.profiling import (  # noqa: F401
    GLOBAL_PROF_ENABLER,
    annotate,
    device_trace,
    profile,
)
from sig_sdp_mmw_torch.utils.checkpoint import SweepCheckpoint  # noqa: F401
