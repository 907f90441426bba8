"""Multi-process meshes, batched scenario solves and speculative probe
searches (port of :mod:`sig_sdp_mmw_tpu.parallel`): the (batch, graph) mesh
over ``torch.distributed`` ranks (``mesh.py``), process-group setup and a
launcher (``distributed.py``), and the batched solves and searches
(``batch.py``)."""

from sig_sdp_mmw_torch.parallel.mesh import make_mesh  # noqa: F401
from sig_sdp_mmw_torch.parallel.distributed import (  # noqa: F401
    init_distributed,
    make_global_mesh,
)
from sig_sdp_mmw_torch.parallel.batch import (  # noqa: F401
    ParallelProbeSearch,
    ParallelProbeSearchEll,
    solve_scenarios_batched,
    stack_states,
)
