"""SpMM microbenchmark on the card (counterpart of
``tools/bench_flat_spmm.py``): the three block-sparse SpMM contracts on one
operand, S̃ of the K=100,467 instance (cell 183, Hilbert order), D=48.

* ``ell``: the block-ELL kernel (:func:`sig_sdp_mmw_torch.ops.bcsr.
  bcsr_spmm`) on 128x128 bfloat16 blocks, the baseline;
* ``flat_G{G}``: the flat block-CSR kernel (:func:`bsr_spmm_flat`);
* ``vres_G{G}``: the flat block-CSR kernel with V resident in L2
  (:func:`bsr_spmm_vres`), for G in ``groups``.

Every kernel run is checked against its plain PyTorch version on the same
inputs (to ``REL_TOL`` of max|out|; a disagreement raises) and reports the
stored block MB, its time and the plain version's (CUDA events, median of 3
rounds of ``iters`` launches), the effective GB/s over the stored block
bytes, its bound (:func:`bound`: the bytes the product needs over the
card's memory rate, or its operations over the peak rate, whichever is
larger) with the share of it reached, and its relative error against the
ELL result.  Needs a CUDA device.  Returns the record; writes it as JSON
only to ``out_path``.

The bound counts only what these inputs need (:func:`bytes_needed`): the
real blocks, not the padding slots, V read once in float32 and the output
written once in float32.  :func:`library_spmm` is the yardstick PyTorch
call for the same product (``torch.sparse_bsr_tensor(...) @ V`` on the real
blocks, or ``torch.sparse_csr_tensor(...) @ V`` on their entries where the
BSR product refuses the block shape); the port never calls it.

:func:`shapes` (``--shapes``) times one kernel call per case of
``SHAPE_CASES`` on S̃ of the same instance: each case checks two launches
bitwise equal and the kernel against its plain version, and prints one JSON
line with its time, bound and share, and the V bytes the tile gathers.  It
uses only wrapper functions that predate the short-block tile, so this file
also times an older checkout, for an A/B of two trees in one call:

    python -m sig_sdp_mmw_torch.experiments.bench_flat_spmm --out bench.json
    python -m sig_sdp_mmw_torch.experiments.bench_flat_spmm --shapes \
        --out shapes.json
    (cd OLD && PYTHONPATH=. python /path/to/bench_flat_spmm.py --shapes)
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics

import numpy as np
import torch

print = functools.partial(print, flush=True)

# Kernel vs plain: the same (block-dtype-rounded) products summed in float32
# in different orders.
REL_TOL = 1e-5


def time_ms(fn, iters: int, rounds: int = 3) -> float:
    """Median over ``rounds`` of the mean time of ``iters`` back-to-back
    launches of ``fn``, by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def check(name: str, out: torch.Tensor, ref: torch.Tensor) -> dict:
    """Max |out - ref| against REL_TOL * max|ref|; raises on a miss."""
    err = float((out - ref).abs().max())
    tol = REL_TOL * float(ref.abs().max())
    if not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version: max|diff| {err:.3e} > {tol:.3e}")
    return dict(max_abs_err=err, tol=tol)


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): device
# memory, and the arithmetic each block dtype runs on (bf16 tensor cores;
# float32 FMA on the CUDA cores, no TF32).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def real_slots(mat) -> torch.Tensor:
    """Bool mask over the stored slots of ``mat`` that hold a real block:
    [Kbr, maxblk] for a BlockEll, [nsteps*G] for a FlatBsr.

    The packers place a row's real blocks first in ascending column-block
    order and pad with zero blocks at column-block 0, so a slot after the
    row's first is real exactly when its column-block is not 0, and the
    first slot is real when its block is not all zero (an empty row's)."""
    from sig_sdp_mmw_torch.ops.bcsr import BlockEll

    mask = mat.bcols != 0
    if isinstance(mat, BlockEll):
        mask[:, 0] = mat.blocks[:, :, 0, :].reshape(mat.Kb, -1).ne(0).any(1)
    else:
        first = mat.row_ptr[:-1].long()
        mask[first * mat.G] = mat.blocks[first, :, :mat.Bc].reshape(
            first.shape[0], -1).ne(0).any(1)
    return mask


def _block_shape(mat):
    return (mat.Brow, mat.B) if hasattr(mat, "Brow") else (mat.Br, mat.Bc)


def bytes_needed(mat, D: int) -> int:
    """Device-memory bytes ``mat @ V`` needs for a [ncols, D] float32 V:
    each real block once (in its stored dtype), V read once and the float32
    [nrows, D] output written once."""
    Br, Bc = _block_shape(mat)
    nblk = int(real_slots(mat).sum())
    return (nblk * Br * Bc * mat.blocks.element_size()
            + (mat.ncols + mat.nrows) * D * 4)


def v_gather_bytes(mat, D: int) -> int:
    """Bytes of V a tile gathers for ``mat @ V`` when it reads the
    [Bc, D] slice of V in the block dtype once for each real block: from L2
    (or L1) rather than device memory on a banded operand, so not part of
    :func:`bound`; what a short block pays beyond its own bytes."""
    Bc = _block_shape(mat)[1]
    return int(real_slots(mat).sum()) * Bc * D * mat.blocks.element_size()


def block_height_bytes(csr, heights=(8, 16, 32, 64, 128),
                       itemsize=2) -> dict:
    """Real-block bytes of a [Br, 128]-blocked operand of the scipy matrix
    ``csr``, for each block height Br: one block per distinct (row // Br,
    column // 128) pair of its entries."""
    coo = csr.tocoo()
    col = coo.col.astype(np.int64) // 128
    ncb = int(col.max(initial=0)) + 1
    return {Br: int(np.unique(coo.row.astype(np.int64) // Br * ncb + col
                              ).size) * Br * 128 * itemsize
            for Br in heights}


def bound(mat, D: int) -> dict:
    """The least time the card could take for ``mat @ V``: the larger of
    :func:`bytes_needed` over the memory rate and the real blocks' multiply-
    adds (2 flop each) over the block dtype's peak rate."""
    Br, Bc = _block_shape(mat)
    nbytes = bytes_needed(mat, D)
    flop = 2 * int(real_slots(mat).sum()) * Br * Bc * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flop / PEAK_FLOPS[mat.blocks.dtype] * 1e3
    return dict(bytes_needed=nbytes, flop=flop, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def library_operand(mat, dtype) -> torch.Tensor:
    """``mat`` as a ``torch.sparse_bsr_tensor`` of its real blocks only (the
    padding slots' repeated column-block 0 is no valid BSR), in ``dtype``."""
    from sig_sdp_mmw_torch.ops.bcsr import BlockEll

    mask = real_slots(mat)
    if isinstance(mat, BlockEll):
        vals = mat.blocks.permute(0, 2, 1, 3)[mask]
        counts = mask.sum(1)
    else:
        vals = mat.blocks.reshape(mat.nsteps, mat.Br, mat.G, mat.Bc).permute(
            0, 2, 1, 3).reshape(-1, mat.Br, mat.Bc)[mask]
        counts = torch.bincount(mat.brows.long().repeat_interleave(mat.G)[mask],
                                minlength=mat.Kbr)
    crow = torch.zeros(counts.shape[0] + 1, dtype=torch.int32,
                       device=mask.device)
    crow[1:] = torch.cumsum(counts, 0)
    return torch.sparse_bsr_tensor(crow, mat.bcols[mask].int(), vals.to(dtype),
                                   size=(mat.nrows, mat.ncols))


def library_csr_operand(mat, dtype) -> torch.Tensor:
    """``mat`` as a ``torch.sparse_csr_tensor`` of every entry of its real
    blocks, the zeros inside a block included (a CSR matrix with the
    block's dense pattern), in ``dtype``: the operand of the yardstick for
    block shapes the BSR product refuses."""
    from sig_sdp_mmw_torch.ops.bcsr import BlockEll

    mask = real_slots(mat)
    Br, Bc = _block_shape(mat)
    dev = mask.device
    if isinstance(mat, BlockEll):
        vals = mat.blocks.permute(0, 2, 1, 3)[mask]
        brow = torch.nonzero(mask)[:, 0]
        Kbr = mat.Kb
    else:
        vals = mat.blocks.reshape(mat.nsteps, mat.Br, mat.G, mat.Bc).permute(
            0, 2, 1, 3).reshape(-1, mat.Br, mat.Bc)[mask]
        brow = mat.brows.long().repeat_interleave(mat.G)[mask]
        Kbr = mat.Kbr
    bcol = mat.bcols[mask].long()
    # Real blocks are in (block-row, column-block) order: entry (b, i, k)
    # of block b, the t-th of its block-row, lies at row brow*Br + i after
    # the row's first t blocks.
    counts = torch.bincount(brow, minlength=Kbr)
    start = torch.cumsum(counts, 0) - counts
    t = torch.arange(brow.shape[0], device=dev) - start[brow]
    i = torch.arange(Br, device=dev)
    k = torch.arange(Bc, device=dev)
    pos = ((start[brow] * Br * Bc + t * Bc)[:, None, None]
           + i[None, :, None] * (counts[brow] * Bc)[:, None, None]
           + k[None, None, :]).reshape(-1)
    nnz = pos.shape[0]
    itype = torch.int32 if nnz < 2 ** 31 else torch.int64
    values = torch.empty(nnz, dtype=dtype, device=dev)
    values[pos] = vals.reshape(-1).to(dtype)
    cols = torch.empty(nnz, dtype=itype, device=dev)
    cols[pos] = (bcol[:, None, None] * Bc + k[None, None, :]).expand(
        -1, Br, -1).reshape(-1).to(itype)
    del pos, vals
    crow = torch.zeros(mat.nrows + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum((counts * Bc).repeat_interleave(Br), 0)
    return torch.sparse_csr_tensor(crow.to(itype), cols, values,
                                   size=(mat.nrows, mat.ncols))


def library_spmm(mat, V: torch.Tensor, iters: int) -> dict:
    """Time of the yardstick PyTorch call for ``mat @ V``: the BSR tensor of
    the real blocks times V (``library_call`` "bsr"), in the block dtype of
    ``mat`` when PyTorch runs that on the card, else in float32; where
    PyTorch refuses the BSR product in both (blocks that are not square),
    the CSR tensor of the real blocks' entries times V ("csr", cuSPARSE's
    SpMM), in the same order of dtypes.  With the dtype used, the kernels
    the profiler saw, and why each call and dtype was refused.
    ``library_ms`` is None when none runs."""
    from sig_sdp_mmw_torch.experiments.profile_iteration import profile

    rec = {"library_ms": None, "library_dtype": None, "library_call": None,
           "library_kernels": [], "library_refused": {}}
    for call, build in (("bsr", library_operand),
                        ("csr", library_csr_operand)):
        for dt in dict.fromkeys((mat.blocks.dtype, torch.float32)):
            try:
                A = build(mat, dt)
                Vl = V.to(dt)
                fn = lambda: A @ Vl   # noqa: E731
                fn()
                torch.cuda.synchronize()
            except (RuntimeError, NotImplementedError) as e:
                rec["library_refused"][f"{call} {dt}"] = \
                    str(e).splitlines()[0][:200]
                A = Vl = None
                torch.cuda.empty_cache()
                continue
            rec.update(library_ms=time_ms(fn, iters), library_dtype=str(dt),
                       library_call=call,
                       library_kernels=[e["name"]
                                        for e in profile(fn, 3)["top"]])
            del A, Vl
            torch.cuda.empty_cache()
            return rec
    return rec


def spmm_pair(kind: str):
    """The kernel wrapper for ``kind`` ("flat", "vres" or "ell") and the
    plain version it is held to."""
    from sig_sdp_mmw_torch.ops import bcsr as tb

    return {"flat": (tb.bsr_spmm_flat, tb.bsr_spmm_flat_reference),
            "vres": (tb.bsr_spmm_vres, tb.bsr_spmm_flat_reference),
            "ell": (tb.bcsr_spmm, tb.bcsr_spmm_reference)}[kind]


def shape_operand(kind: str, csr, block, dtype=torch.bfloat16, group=8,
                  device="cuda"):
    """The scipy CSR matrix ``csr`` as the operand of ``kind``'s kernel at
    ``block`` (int or (Br, Bc)): block-ELL for "ell", else flat block-CSR
    with ``group`` slots per step."""
    from sig_sdp_mmw_torch.ops import bcsr as tb

    if kind == "ell":
        return tb.bcsr_from_csr(csr, block=block, dtype=dtype, device=device)
    return tb.bsr_flat_from_csr(csr, block=block, group=group, dtype=dtype,
                                device=device)


# (kernel, block shape, D, block dtype) for :func:`shapes`: the 128x128
# main-path cases (the ring tile; the V-resident kernel's TMA path), the
# float32 FMA tiles, and the short-block tile's bf16 shapes.
SHAPE_CASES = (
    ("flat", 128, 48, "bfloat16"), ("flat", 128, 128, "bfloat16"),
    ("ell", 128, 48, "bfloat16"), ("vres", 128, 48, "bfloat16"),
    ("vres", 128, 128, "bfloat16"),
    ("flat", 128, 32, "float32"), ("ell", 128, 48, "float32"),
    ("flat", (8, 128), 48, "float32"),
    ("flat", (8, 128), 48, "bfloat16"), ("flat", (8, 128), 128, "bfloat16"),
    ("flat", (16, 128), 48, "bfloat16"), ("flat", 32, 48, "bfloat16"),
    ("flat", 8, 48, "bfloat16"), ("ell", (8, 128), 48, "bfloat16"),
    ("ell", (16, 128), 48, "bfloat16"), ("ell", 16, 48, "bfloat16"),
    ("ell", 32, 48, "bfloat16"), ("vres", (8, 128), 48, "bfloat16"))


def shapes(cases=SHAPE_CASES, cell=183, iters=20, out_path=None):
    """Time each case of ``cases`` on S̃ of ``cell`` (G=8 for the flat
    kernels) after checking it (two launches bitwise equal, within
    ``REL_TOL`` of the plain version); one JSON line per case.  Needs a
    CUDA device; writes the record as JSON only to ``out_path``."""
    from sig_sdp_mmw_torch.core.ell import build_st_csr
    from sig_sdp_mmw_torch.env.large import LargeEnv

    if not torch.cuda.is_available():
        raise RuntimeError("bench_flat_spmm measures on a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    S, Q, _ = LargeEnv(cell, 75e-4, seed=0).generate_state_csr()
    St = build_st_csr(S, Q)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"device": torch.cuda.get_device_name(0), "cell": cell,
           "cases": []}
    for kind, block, D, dname in cases:
        mat = shape_operand(kind, St, block, getattr(torch, dname))
        fn, plain = spmm_pair(kind)
        V = torch.randn((mat.nrows, D), generator=gen, device="cuda")
        Br, Bc = _block_shape(mat)
        name = f"{kind} {Br}x{Bc} {dname} D={D}"
        got = fn(mat, V)
        if not torch.equal(got, fn(mat, V)):
            raise AssertionError(f"{name}: two launches differ")
        res = check(name, got, plain(mat, V))
        del got
        ms = time_ms(lambda: fn(mat, V), iters)
        rec = {"case": name, "ms": ms, "max_abs_err": res["max_abs_err"],
               **bound(mat, D), "v_gather_bytes": v_gather_bytes(mat, D)}
        rec["share"] = rec["bound_ms"] / ms
        print(json.dumps(rec))
        out["cases"].append(rec)
        del mat, V
        torch.cuda.empty_cache()
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    return out


def main(cell=183, D=48, iters=30, groups=(4, 8, 16, 32), out_path=None,
         device="cuda"):
    from sig_sdp_mmw_torch.core.ell import build_st_csr
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr
    from sig_sdp_mmw_torch.ops.bcsr import (bcsr_from_csr, bcsr_spmm,
                                            bcsr_spmm_reference,
                                            bsr_flat_from_csr, bsr_spmm_flat,
                                            bsr_spmm_flat_reference,
                                            bsr_spmm_vres)
    from sig_sdp_mmw_torch.utils.tensors import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise RuntimeError(f"bench_flat_spmm measures on a CUDA device, "
                           f"not {device}")
    out = {"device": torch.cuda.get_device_name(device), "D": D,
           "cell": cell, "runs": []}
    rng = np.random.default_rng(0)

    S, Q, _ = generate_large_state_csr(cell, 75e-4, seed=0, order="hilbert")
    St = build_st_csr(S, Q)
    K = St.shape[0]
    Kp = ((K + 127) // 128) * 128
    out["K"] = K
    V = torch.from_numpy(rng.standard_normal((Kp, D)).astype(np.float32)
                         ).to(device)

    ell = bcsr_from_csr(St, block=128, pad_rows_to=Kp, dtype=torch.bfloat16,
                        device=device)
    r_ell = bcsr_spmm(ell, V)
    ell_bytes = ell.blocks.numel() * 2
    t = time_ms(lambda: bcsr_spmm(ell, V), iters)
    rec = {"impl": "ell", "maxblk": int(ell.bcols.shape[1]),
           "stored_mb": ell_bytes / 1e6, "ms": t,
           "plain_ms": time_ms(lambda: bcsr_spmm_reference(ell, V), iters),
           "eff_gbps": ell_bytes / t / 1e6, **bound(ell, D),
           **check("ell", r_ell, bcsr_spmm_reference(ell, V))}
    rec["share"] = rec["bound_ms"] / t
    print(rec)
    out["runs"].append(rec)
    del ell
    ref_scale = float(r_ell.abs().max())

    for G in groups:
        flat = bsr_flat_from_csr(St, block=128, group=G, pad_rows_to=Kp,
                                 dtype=torch.bfloat16, device=device)
        want = bsr_spmm_flat_reference(flat, V)
        plain_ms = time_ms(lambda: bsr_spmm_flat_reference(flat, V), iters)
        fbytes = flat.blocks.numel() * 2
        fbound = bound(flat, D)
        for name, fn in (("flat", bsr_spmm_flat), ("vres", bsr_spmm_vres)):
            r = fn(flat, V)
            t = time_ms(lambda: fn(flat, V), iters)
            rec = {"impl": f"{name}_G{G}", "nsteps": flat.nsteps,
                   "stored_mb": fbytes / 1e6, "ms": t, "plain_ms": plain_ms,
                   "eff_gbps": fbytes / t / 1e6, **fbound,
                   "share": fbound["bound_ms"] / t,
                   "rel_err_vs_ell":
                       float((r - r_ell).abs().max()) / max(ref_scale, 1e-9),
                   **check(f"{name}_G{G}", r, want)}
            print(rec)
            out["runs"].append(rec)
        del flat
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {out_path}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", type=int, default=183)
    ap.add_argument("--D", type=int, default=48)
    ap.add_argument("--iters", type=int, default=None,
                    help="launches per round (30; 20 with --shapes)")
    ap.add_argument("--groups", type=int, nargs="+", default=[4, 8, 16, 32])
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--shapes", action="store_true",
                    help="time SHAPE_CASES instead")
    a = ap.parse_args()
    if a.shapes:
        shapes(cell=a.cell, iters=a.iters or 20, out_path=a.out)
    else:
        main(a.cell, a.D, a.iters or 30, tuple(a.groups), out_path=a.out)
