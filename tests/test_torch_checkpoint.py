"""SweepCheckpoint in the port (a copy of sig_sdp_mmw_tpu.utils.checkpoint):
its ledger semantics against the JAX package's class, and the resume of the
ported sim_all_bler sweep (the port of tests/test_experiments.py::
test_sim_all_bler_resumes)."""

import os
import time

from sig_sdp_mmw_tpu.utils.checkpoint import SweepCheckpoint as JCheckpoint
from sig_sdp_mmw_torch.experiments import sim_all_bler
from sig_sdp_mmw_torch.utils.checkpoint import SweepCheckpoint
from torch_jax_parity import one_torch_thread  # noqa: F401  (autouse)


def test_checkpoint_ledger_matches_jax(tmp_path):
    for cls, sub in ((SweepCheckpoint, "port"), (JCheckpoint, "jax")):
        out = str(tmp_path / sub)
        ck = cls(out)
        assert not ck.done("cell5", 0)
        ck.mark("cell5", 0)
        ck.mark("cell5", 2)
        assert ck.done("cell5", 0) and not ck.done("cell5", 1)
        ck.close()
        with open(os.path.join(out, "checkpoint.jsonl"), "a") as f:
            f.write("not json\n{\"item\": \"x\"}\n")
        ck = cls(out)                       # a resumed run
        assert ck.done("cell5", 2) and ck.done("cell5", "0")
        assert not ck.done("x", 0)
        ck.close()
    with open(tmp_path / "port" / "checkpoint.jsonl") as f:
        port = f.read()
    with open(tmp_path / "jax" / "checkpoint.jsonl") as f:
        assert port == f.read()


def test_sim_all_bler_resumes(tmp_path):
    """Re-running the sweep with the same --out skips completed items."""
    out = str(tmp_path / "bler_resume")
    argv = ["--smoke", "--device", "cpu", "--cells", "3", "--out", out]
    sim_all_bler.main(argv)
    with open(os.path.join(out, "mmw-3-75")) as f:
        first = f.read()
    t0 = time.time()
    sim_all_bler.main(argv)
    assert time.time() - t0 < 5.0   # everything skipped via the checkpoint
    with open(os.path.join(out, "mmw-3-75")) as f:
        assert f.read() == first    # no second row
