"""Top-level entry points of the port (counterpart of ``__graft_entry__.py``):
a single-device forward step and a multi-process dryrun.

``entry()`` returns the MMW solve on a tiny synthetic state with its
example arguments; ``dryrun_multichip(n)`` starts n ranks
(:func:`sig_sdp_mmw_torch.parallel.distributed.launch`), lays them out as a
(batch, graph) mesh and runs one batched dense solve with rounding and one
graph-sharded block-sparse probe on tiny real instances.

    python -m sig_sdp_mmw_torch.entry [--n 4] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def _tiny_state(K=24, Kp=32, seed=0, dtype=None, device="cpu"):
    """A small synthetic interference graph with the real structure
    (association cliques, sparse asymmetric gains, budgets from the
    diagonal): the JAX entry's state, array for array."""
    import torch

    from sig_sdp_mmw_torch.core.problem import state_from_arrays

    rng = np.random.default_rng(seed)
    n_ap = 6
    asso = rng.integers(0, n_ap, size=K)
    Q = (asso[:, None] == asso[None, :]).astype(np.float64)
    np.fill_diagonal(Q, 0.0)
    S = rng.random((K, K)) * (rng.random((K, K)) < 0.2)
    np.fill_diagonal(S, 2.0 + rng.random(K))
    h_max = np.diag(S) / 1.85 - 1.0
    return state_from_arrays(S, Q, h_max, pad_to=Kp,
                             dtype=dtype or torch.float32, device=device)


def entry(device="cuda"):
    """(fn, example_args): the MMW forward step (nit=4, D_pad 16,
    lanczos_m 8) on one device; ``fn(state, Z, draws) -> (X_half,
    ub_final)``."""
    from sig_sdp_mmw_torch.models.mmw import mmw_solve
    from sig_sdp_mmw_torch.utils.draws import TorchDraws
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    state = _tiny_state(device=device)

    def fn(state, Z, draws):
        out = mmw_solve(state, Z, nit=4, eta=0.05, D_pad=16, rank_pad=16,
                        draws=draws, lanczos_m=8)
        return out.X_half, out.ub_final

    return fn, (state, 5.0, TorchDraws(0, device))


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the batched solve and rounding over an n-rank (batch, graph)
    mesh and one graph-sharded block-sparse probe, on tiny real instances
    (``LargeEnv(6, 75e-4, seed=i)``, Kp 128, nit 30, lanczos_m 10).

    The ranks join over NCCL when every rank can have a card of its own,
    else over gloo (the CPU, or ranks sharing a card).  Checks that
    every instance rounds to remainder 0 and verifies, that the sparse
    probe reaches remainder 0 within 10 attempts, and that every rank
    returned the same bits; prints one ``dryrun_multichip OK`` line and
    returns rank 0's record with ``launches_per_rank``."""
    import torch

    from sig_sdp_mmw_torch.parallel.distributed import launch
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    dev = resolve_device(device)
    backend = ("nccl" if dev.type == "cuda"
               and n_devices <= torch.cuda.device_count() else "gloo")
    recs = launch("sig_sdp_mmw_torch.entry:_dryrun_rank", n_devices,
                  (dev.type,), backend=backend, device=dev.type)
    r0 = recs[0]
    for r, rec in enumerate(recs):
        for k in ("X_half", "ub", "z_vecs", "sparse_X_half"):
            if not np.array_equal(rec[k], r0[k]):
                raise AssertionError(f"rank {r}'s {k} differs from rank 0's")
    rems, verified = r0["rems"], r0["verified"]
    if any(rems) or not all(verified):
        raise AssertionError(f"dryrun solve not feasible: rems={rems} "
                             f"verified={verified}")
    if r0["sparse_rem"] != 0:
        raise AssertionError(f"sparse probe not feasible: "
                             f"rem={r0['sparse_rem']}")
    out = dict(r0, backend=backend, device=dev.type,
               launches_per_rank=[rec["launches"] for rec in recs])
    print(f"dryrun_multichip OK: mesh={r0['mesh']} Kp={r0['Kp']} "
          f"Z={r0['Z']} ub={r0['ub']} rem={np.asarray(rems)} "
          f"verified={verified} sparse_ub={r0['sparse_ub']:.3f} "
          f"sparse_rem={r0['sparse_rem']} "
          f"collective_mb_per_solve={r0['collective_bytes'] / 1e6:.2f} "
          f"device={dev.type} backend={backend}", flush=True)
    return out


def _dryrun_rank(device_type: str) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    import torch

    from sig_sdp_mmw_torch.core.ell import ell_from_scipy
    from sig_sdp_mmw_torch.core.problem import state_from_arrays
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr
    from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_torch.models.rounding import (_rounding_batch,
                                                   verify_assignment)
    from sig_sdp_mmw_torch.models.rounding_ell import _rounding_single_ell
    from sig_sdp_mmw_torch.ops import bcsr as tb
    from sig_sdp_mmw_torch.parallel import (make_mesh,
                                            solve_scenarios_batched,
                                            stack_states)
    from sig_sdp_mmw_torch.parallel.distributed import local_device
    from sig_sdp_mmw_torch.utils.draws import TorchDraws
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(local_device(device_type))
    mesh = make_mesh()
    B = mesh.shape["batch"]
    Kp = 128                      # divisible by every graph-axis size here

    # Real generated instances (tiny cells of the production generator),
    # so the dryrun proves a feasible solve, not only execution.
    raw = [generate_large_state_csr(6, 75e-4, seed=i) for i in range(B)]
    Z = max(int(np.diff(Q.indptr).max()) + 3 for _, Q, _ in raw)
    states = stack_states([
        state_from_arrays(S.toarray(), Q.toarray(), h, pad_to=Kp,
                          device=device) for S, Q, h in raw])
    draws = TorchDraws(0, device)
    out = solve_scenarios_batched(states, float(Z), nit=30, eta=0.05,
                                  D_pad=16, rank_pad=16, draws=draws,
                                  mesh=mesh, lanczos_m=10)

    # Rounding of every instance (each rank rounds them all: the solve's
    # outputs are already on every rank).
    z_vecs, rems, verified = [], [], []
    for b, (S, Q, h) in enumerate(raw):
        st = state_from_arrays(S.toarray(), Q.toarray(), h, pad_to=Kp,
                               device=device)
        z, rem = _rounding_batch(st, out.X_half[b], Z,
                                 draws.scenario_round(b, B), 16, 10)
        z_vecs.append(z.cpu().numpy())
        rems.append(int(rem))
        verified.append(bool(verify_assignment(st, z_vecs[-1])[0]))

    # Sparse block-native probe over the graph axis: this rank's block-rows
    # of the (8, 8) block operands, every product followed by an
    # all-gather.
    S, Q, h = raw[0]
    ell = ell_from_scipy(S, Q, h, pad_rows_to=Kp, device=device)
    graph = mesh.axis("graph")
    ops = tb.shard_rows(tb.bcsr_operands_from_state(
        S, Q, block=(8, 8), pad_rows_to=Kp), graph.index,
        graph.size).to(device)
    sp = mmw_solve_ell(ell, float(Z), nit=30, eta=0.05, D_pad=16,
                       rank_pad=16, draws=draws, lanczos_m=10, bcsr=ops,
                       graph=graph)
    rem_sp = -1
    for a in range(10):
        z_sp, rem_sp = _rounding_single_ell(ell, sp.X_half, Z,
                                            draws.ell_attempt(a), Z_pad=16)
        rem_sp = int(rem_sp)
        if rem_sp == 0:
            break
    return dict(
        mesh=dict(mesh.shape), coords=dict(mesh.coords), Kp=Kp, Z=Z,
        X_half=out.X_half.cpu().numpy(), ub=out.ub_final.cpu().numpy(),
        z_vecs=np.stack(z_vecs), rems=rems, verified=verified,
        sparse_X_half=sp.X_half.cpu().numpy(),
        sparse_ub=float(sp.ub_final), sparse_rem=rem_sp,
        collective_bytes=graph.gathered_bytes,
        operand_devices=sorted(ops.tensor_devices()),
        launches={"bsr_spmm_flat": tb.bsr_spmm_flat.launches,
                  "bcsr_spmm": tb.bcsr_spmm.launches,
                  "bsr_spmm_vres": tb.bsr_spmm_vres.launches})


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    fn, args = entry(a.device)
    X_half, ub = fn(*args)
    print("entry OK:", list(X_half.shape), float(ub),
          torch.isfinite(X_half).all().item())
    dryrun_multichip(a.n, device=a.device)


if __name__ == "__main__":
    main()
