"""The graph-sharded block-sparse solve at a representative scale
(counterpart of ``tools/sharded_large.py``).

The O(nnz) block operands are split by block-rows over ``graph`` ranks
(:func:`sig_sdp_mmw_torch.ops.bcsr.shard_rows`); each rank holds its rows
of S̃, S̃ᵀ and Q and of the averaged Gram, and every operator apply is its
rows' product followed by one all-gather
(:func:`sig_sdp_mmw_torch.models.mmw_ell.mmw_solve_ell` with ``graph``).
What this checks, at the tool's defaults (cell 100, K=30,000, nit 30,
eta 0.05, 128x128 blocks, rows padded to a multiple of block x graph):

* bytes per rank of every operand it holds, and their balance;
* the sharded answer against the same solve in one process: ``equal``
  when |Δub| and max|ΔX_half| are both below 1e-3 (the tool's test), with
  each column of the factor signed as the one-process factor's: a column
  is an eigenvector of the averaged primal, whose sign the eigensolver
  picks, and the card's (cuSOLVER) flips some of them on inputs that
  differ in the last bits.  The raw max|ΔX_half| and the max|Δ(X Xᵀ)| are
  recorded beside it;
* the native greedy rounding of the sharded factor, its remainder and the
  independent CSR verification.

Layouts (``--layout``, any number, one process group for all):
``f32_ell``, float32 block-ELL S̃ (the tool's ``bcsr_operands_from_state``
default; kernel #3 on the card); ``bf16_flat``, bfloat16 blocks with the
stored transpose and flat block-CSR twins at group 8 (the 100k path's
layout; kernel #1 for S̃/S̃ᵀ, #3 for Q).

    python -m sig_sdp_mmw_torch.experiments.sharded_large --graph 2 \\
        --layout f32_ell --layout bf16_flat --out sharded.json

The ranks are processes of one ``torch.distributed`` group on this host
(``--backend``: default NCCL when each rank can have a card, else gloo,
which ranks sharing one card need).  The JSON is written only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

GRAM_ROW_CHUNK = 2048     # rows of X Xᵀ formed at a time by factor_differences

LAYOUTS = {
    "f32_ell": dict(dtype="float32"),
    "bf16_flat": dict(dtype="bfloat16", store_transpose=True, flat_group=8),
}


def layout_operands(S, Q, block: int, nr: int, layout: str):
    """The whole block operands of ``layout`` (on the CPU), rows padded to
    ``nr``."""

    from sig_sdp_mmw_torch.ops.bcsr import bcsr_operands_from_state

    kw = dict(LAYOUTS[layout])
    kw["dtype"] = getattr(torch, kw["dtype"])
    return bcsr_operands_from_state(S, Q, block=block, pad_rows_to=nr, **kw)


def _nbytes(obj) -> int:
    """Bytes of every tensor of a container (nested containers included)."""
    import dataclasses

    import torch

    total = 0
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
        elif dataclasses.is_dataclass(v):
            total += _nbytes(v)
    return total


def _solve(ell, ops, Z, nit, eta, D_pad, device, graph=None):
    import torch

    from sig_sdp_mmw_torch.models.mmw_ell import mmw_solve_ell
    from sig_sdp_mmw_torch.utils.draws import TorchDraws
    from sig_sdp_mmw_torch.utils.tensors import cuda_sync

    cuda_sync(ell.mask)
    t0 = time.time()
    out = mmw_solve_ell(ell, Z, nit=nit, eta=eta, D_pad=D_pad,
                        rank_pad=D_pad, draws=TorchDraws(0, device), bcsr=ops,
                        graph=graph)
    cuda_sync(out.X_half)
    return out, time.time() - t0


def trace_summary(prof, wall_s: float) -> dict:
    """From a :func:`sig_sdp_mmw_torch.utils.profiling.device_trace` of a
    sharded solve: device time of the kernels and of the memory copies
    (a gloo all-gather moves a CUDA tensor through the host, so its device
    time is the copies), and host time inside the ``graph.all_gather``
    spans against the solve's wall time."""
    kernel_us = copy_us = spmm_us = gather_us = 0.0
    for e in prof.events():
        dev = str(getattr(e, "device_type", ""))
        us = e.time_range.elapsed_us()
        if e.name.startswith("graph."):    # the spans (and their device
            if e.name == "graph.all_gather" and "CPU" in dev:  # twins)
                gather_us += us
            continue
        if "CUDA" not in dev:
            continue
        if "memcpy" in e.name.lower() or "memset" in e.name.lower():
            copy_us += us
        else:
            kernel_us += us
            if "spmm" in e.name.lower():
                spmm_us += us
    dev_us = kernel_us + copy_us
    return dict(kernels_ms=kernel_us / 1e3, spmm_kernels_ms=spmm_us / 1e3,
                copies_ms=copy_us / 1e3,
                copy_share_of_device=copy_us / dev_us if dev_us else None,
                gather_host_ms=gather_us / 1e3,
                gather_share_of_wall=gather_us / 1e6 / wall_s)


def factor_differences(X, X1) -> dict:
    """How far the factor ``X`` is from ``X1`` ([K, r] tensors on one
    device): max|ΔX|; the same after each column of X takes the sign that
    agrees with X1's (a factor's columns are eigenvectors, each fixed only
    up to sign); and max|Δ(X Xᵀ)|, which no choice of basis in an
    eigenspace moves, in chunks of rows."""
    X, X1 = X.double(), X1.double()
    s = torch.sign(torch.sum(X * X1, dim=0))
    aligned = X * torch.where(s == 0, 1.0, s)[None, :]
    dgram = 0.0
    for i in range(0, X.shape[0], GRAM_ROW_CHUNK):
        d = X[i:i + GRAM_ROW_CHUNK] @ X.T - X1[i:i + GRAM_ROW_CHUNK] @ X1.T
        dgram = max(dgram, float(d.abs().max()))
    cols = torch.amax((X - X1).abs(), dim=0)
    return dict(max_abs_dX_half=float(cols.max()),
                max_abs_dX_half_sign_aligned=float(
                    (aligned - X1).abs().max()),
                max_abs_dGram=dgram,
                columns_above_1e_3=[
                    (int(c), float(cols[c]), float(X1[:, c].norm()))
                    for c in torch.nonzero(cols > 1e-3).flatten()])


def _rank(S, Q, h, Z: float, D_pad: int, nr: int, block: int, nit: int,
          eta: float, layouts: Sequence[str], device_type: str,
          trace_dir: Optional[str]) -> dict:
    """One rank: its shard of each layout's operands, the sharded solve."""
    import torch

    from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_torch.ops import bcsr as tb
    from sig_sdp_mmw_torch.parallel import make_mesh
    from sig_sdp_mmw_torch.parallel.distributed import local_device
    from sig_sdp_mmw_torch.utils.profiling import device_trace
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(local_device(device_type))
    mesh = make_mesh(batch_size=1)
    ell = ell_slim_from_csr(S, Q, h, pad_rows_to=nr, device=device)
    rec = {"rank": mesh.rank, "shape": dict(mesh.shape)}
    for layout in layouts:
        graph = mesh.axis("graph")
        ops = tb.shard_rows(layout_operands(S, Q, block, nr, layout),
                            graph.index, graph.size).to(device)
        for fn in (tb.bsr_spmm_flat, tb.bcsr_spmm, tb.bsr_spmm_vres):
            fn.launches = 0
        trace = None
        if trace_dir and layout == layouts[-1] and mesh.rank == 0:
            with device_trace(trace_dir) as prof:
                out, sec = _solve(ell, ops, Z, nit, eta, D_pad, device, graph)
            trace = trace_summary(prof, sec)
        else:
            out, sec = _solve(ell, ops, Z, nit, eta, D_pad, device, graph)
        rec[layout] = dict(
            X_half=out.X_half.float().cpu().numpy(),
            ub=float(out.ub_final), solve_s=sec,
            rows=list(graph.rows(nr // block)),
            bytes=_nbytes(ops) + _nbytes(ell),
            gathered_bytes=graph.gathered_bytes, gathers=graph.gathers,
            operand_devices=sorted(ops.tensor_devices()),
            launches={"bsr_spmm_flat": tb.bsr_spmm_flat.launches,
                      "bcsr_spmm": tb.bcsr_spmm.launches,
                      "bsr_spmm_vres": tb.bsr_spmm_vres.launches},
            trace=trace)
        del ops
    return rec


def main(cell: int = 100, rho: float = 75e-4, seed: int = 0, nit: int = 30,
         eta: float = 0.05, block: int = 128, graph: int = 2,
         layouts: Sequence[str] = ("f32_ell",), device: str = "cuda",
         backend: Optional[str] = None, out: Optional[str] = None,
         trace_dir: Optional[str] = None) -> dict:
    """Sharded solve over ``graph`` ranks against the one-process solve, per
    layout; returns the record (and writes it to ``out`` when given).
    ``trace_dir``: rank 0 records a device trace of the last layout's
    sharded solve there (``trace`` in that layout's record)."""
    import torch

    from sig_sdp_mmw_torch.core.ell import ell_slim_from_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.models.rounding_ell import (rounding_native_csr,
                                                       verify_assignment_csr)
    from sig_sdp_mmw_torch.parallel.distributed import launch
    from sig_sdp_mmw_torch.utils.draws import TorchDraws
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    dev = resolve_device(device)
    for layout in layouts:
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {sorted(LAYOUTS)}, "
                             f"got {layout!r}")
    if backend is None:
        backend = ("nccl" if dev.type == "cuda"
                   and graph <= torch.cuda.device_count() else "gloo")
    rec = {"config": dict(cell=cell, rho=rho, seed=seed, nit=nit, eta=eta,
                          block=block, graph_axis=graph, layouts=list(layouts),
                          device=dev.type, backend=backend),
           "phases_s": {}}
    if dev.type == "cuda":
        rec["device"] = torch.cuda.get_device_name(dev)

    t0 = time.time()
    S, Q, h = LargeEnv(cell, rho, seed=seed).generate_state_csr()
    K = S.shape[0]
    unit = block * graph          # every rank gets the same block-rows
    nr = -(-K // unit) * unit
    lb = int(np.diff(Q.indptr).max()) + 1
    Z = float(lb + 4)
    D_pad = ((int(Z) * 2 + 15) // 16) * 16
    rec.update(K=K, nnz_S=int(S.nnz), Z=Z, D_pad=D_pad, rows_padded=nr)
    rec["phases_s"]["generate"] = time.time() - t0

    t0 = time.time()
    ranks = launch("sig_sdp_mmw_torch.experiments.sharded_large:_rank",
                   graph, (S, Q, h, Z, D_pad, nr, block, nit, eta,
                           tuple(layouts), dev.type, trace_dir),
                   backend=backend, device=dev.type, timeout_s=900.0)
    rec["phases_s"]["sharded_ranks"] = time.time() - t0

    ell = ell_slim_from_csr(S, Q, h, pad_rows_to=nr, device=dev)
    for layout in layouts:
        t0 = time.time()
        ops = layout_operands(S, Q, block, nr, layout).to(dev)
        build_s = time.time() - t0
        out1, single_s = _solve(ell, ops, Z, nit, eta, D_pad, dev)
        del ops
        r0 = ranks[0][layout]
        X_sh = r0["X_half"]
        ub_sh, ub_1 = r0["ub"], float(out1.ub_final)
        diff = factor_differences(torch.from_numpy(X_sh).to(dev),
                                  out1.X_half.float())
        dX = diff["max_abs_dX_half"]
        per_rank = [r[layout]["bytes"] for r in ranks]
        t0 = time.time()
        z_vec, _, rem = rounding_native_csr(
            int(Z), torch.from_numpy(X_sh).to(dev), S, Q, h,
            TorchDraws(7, dev), nattempt=3)
        ok, ni, na = verify_assignment_csr(S, Q, h, z_vec)
        round_s = time.time() - t0
        lr = dict(
            ub_sharded=ub_sh, ub_single=ub_1, **diff,
            equal=bool(abs(ub_sh - ub_1) < 1e-3
                       and diff["max_abs_dX_half_sign_aligned"] < 1e-3),
            bit_equal_single=bool(ub_sh == ub_1 and np.array_equal(
                X_sh, out1.X_half.float().cpu().numpy())),
            ranks_bit_equal=all(np.array_equal(r[layout]["X_half"], X_sh)
                                and r[layout]["ub"] == ub_sh for r in ranks),
            bytes_per_rank_mb=[b / 2**20 for b in per_rank],
            balance=min(per_rank) / max(per_rank),
            rows_per_rank=[r[layout]["rows"] for r in ranks],
            solve_sharded_s=[r[layout]["solve_s"] for r in ranks],
            solve_single_s=single_s, build_single_s=build_s,
            collective_mb_per_solve=r0["gathered_bytes"] / 1e6,
            collective_mb_per_iteration=r0["gathered_bytes"] / 1e6 / nit,
            gathers_per_solve=r0["gathers"],
            launches_per_rank=[r[layout]["launches"] for r in ranks],
            operand_devices=sorted({d for r in ranks
                                    for d in r[layout]["operand_devices"]}),
            rounding_rem=int(rem),
            verified=dict(ok=bool(ok), interf=int(ni), asso=int(na)),
            rounding_s=round_s, trace=r0["trace"])
        rec[layout] = lr
        print(f"[sharded_large] {layout}: K={K} graph={graph} "
              f"ub sharded {ub_sh:.6f} single {ub_1:.6f} dX {dX:.2e} "
              f"(signs aligned {diff['max_abs_dX_half_sign_aligned']:.2e}, "
              f"Gram {diff['max_abs_dGram']:.2e}) "
              f"equal={lr['equal']} rem={rem} verified={ok} MB/rank "
              f"{[round(b, 1) for b in lr['bytes_per_rank_mb']]} balance "
              f"{lr['balance']:.3f}", flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def cli(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", type=int, default=100)
    ap.add_argument("--rho", type=float, default=75e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nit", type=int, default=30)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--graph", type=int, default=2)
    ap.add_argument("--layout", action="append", choices=sorted(LAYOUTS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"))
    ap.add_argument("--trace-dir")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    return main(a.cell, a.rho, a.seed, a.nit, block=a.block, graph=a.graph,
                layouts=tuple(a.layout or ["f32_ell"]), device=a.device,
                backend=a.backend, out=a.out, trace_dir=a.trace_dir)


if __name__ == "__main__":
    cli()
