"""The Lanczos steps' kernels (``ops/kernels/csrc/lanczos_step.cu``) on the
card against the plain version (:func:`lanczos_tridiag_reference`) on the
same card and inputs: alpha, beta, beta0, the basis Q and the combined F
within 1e-5 of their largest magnitude (the sums taken in another order),
the breakdown guard exactly, the split form with bfloat16 and float32
blocks, two runs bit for bit, and whole solves of both solvers.

This file imports no jax, so it runs on a CUDA machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lanczos_cuda.py -m cuda
"""

import contextlib

import pytest
import torch

from sig_sdp_mmw_torch.ops import bcsr as tb
from sig_sdp_mmw_torch.ops import expm

REL = 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _gen(seed):
    return torch.Generator("cuda").manual_seed(seed)


def _symmetric_operator(K, dtype, seed=0):
    """A symmetric [K, K] operator with a spread spectrum: dense and random
    up to 4,096 rows, a banded one (a diagonal ramp and neighbour couplings)
    above."""
    if K <= 4096:
        B = torch.randn((K, K), dtype=dtype, device="cuda",
                        generator=_gen(seed)) / K ** 0.5
        A = 0.5 * (B + B.T)
        return lambda V: A @ V
    d = torch.linspace(-2.0, 2.0, K, dtype=dtype, device="cuda")
    return lambda V: (d[:, None] * V + 0.3 * (torch.roll(V, 1, 0)
                                              + torch.roll(V, -1, 0)))


def _close(name, got, want, rel=REL):
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * max(scale, 1e-30), (name, err, scale)


def _both(op, V, m, reorth=True):
    n0 = expm.lanczos_tridiag.launches
    s0 = dict(expm.lanczos_tridiag.route_steps)
    got = expm.lanczos_tridiag(op, V, m, reorth=reorth)
    torch.cuda.synchronize()
    assert expm.lanczos_tridiag.launches == n0 + 2 + m * (
        3 if reorth else 2) + m - 1
    assert expm.lanczos_tridiag.route_steps == {
        "kernel": s0["kernel"] + m, "plain": s0["plain"]}
    want = expm.lanczos_tridiag_reference(op, V, m, reorth=reorth)
    return got, want


def _check_all(got, want):
    (Qk, ak, bk, b0k), (Qr, ar, br, b0r) = got, want
    assert Qk.shape == Qr.shape and Qk.is_contiguous()
    _close("beta0", b0k, b0r)
    _close("alphas", ak, ar)
    _close("betas", bk, br)
    _close("Q", Qk, Qr)
    m, D = ak.shape
    coeff = torch.randn((D, m), dtype=Qk.dtype, device="cuda",
                        generator=_gen(5))
    Fk = expm.lanczos_combine(Qk, coeff)
    assert Fk.is_contiguous()
    _close("F", Fk, expm.lanczos_combine_reference(Qr, coeff))


@pytest.mark.cuda
@pytest.mark.parametrize("K,D,m,dt", [
    (304, 32, 10, "float32"), (20480, 128, 10, "float32"),
    (4096, 1, 32, "float32"), (4096, 20, 10, "float32"),
    (304, 32, 10, "float64"), (4096, 1, 32, "float64")])
def test_kernel_matches_plain(K, D, m, dt):
    """The generic form (the dense solver's; the scale folded into the
    first pass) at the dense cell's shape, the 100k sketch's width, the
    gap log's D=1 and a D that is no multiple of 8."""
    _need_card()
    dtype = getattr(torch, dt)
    op = expm.LanczosOperator(_symmetric_operator(K, dtype), 0.5)
    V = torch.randn((K, D), dtype=dtype, device="cuda", generator=_gen(1))
    _check_all(*_both(op, V, m))


@pytest.mark.cuda
def test_kernel_without_reorthogonalisation():
    _need_card()
    op = _symmetric_operator(304, torch.float32)
    V = torch.randn((304, 32), device="cuda", generator=_gen(2))
    _check_all(*_both(op, V, 8, reorth=False))


@pytest.mark.cuda
def test_breakdown_guard_and_zero_columns():
    """Columns 0-3 zero (the sketch's masked columns) and columns 4-7 unit
    vectors of a decoupled diagonal part (an exact invariant subspace):
    beta0 or beta_0 exactly 0, and those columns of every later slot 0, as
    in the plain version; the other columns as above."""
    _need_card()
    K, D, m = 2048, 16, 10
    A = torch.randn((K, K), device="cuda", generator=_gen(3)) / K ** 0.5
    A = 0.5 * (A + A.T)
    A[:64, :] = 0.0
    A[:, :64] = 0.0
    A[:64, :64] = torch.diag(torch.linspace(0.5, 1.5, 64, device="cuda"))
    V = torch.randn((K, D), device="cuda", generator=_gen(4))
    V[:, :4] = 0.0
    V[:, 4:8] = 0.0
    for c in range(4, 8):
        V[3 * c, c] = 1.0
    got, want = _both(lambda X: A @ X, V, m)
    Qk, ak, bk, b0k = got
    assert torch.equal(b0k[:4], torch.zeros(4, device="cuda"))
    assert torch.equal(bk[:, :8], torch.zeros((m, 8), device="cuda"))
    assert torch.equal(Qk[1:, :, :8], torch.zeros((m - 1, K, 8),
                                                  device="cuda"))
    assert torch.equal(ak[:, :4], torch.zeros((m, 4), device="cuda"))
    assert torch.equal(ak[0, 4:8], want[1][0, 4:8])
    _check_all(got, want)


def _split_operator(dt, K, seed=6):
    """The block-sparse solver's split operator on the cell-10 network's
    operands (flat S̃ and S̃ᵀ, block-ELL Q) in ``dt`` blocks, with random
    d, h and Q values."""
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr

    S, Q, _ = generate_large_state_csr(10, 75e-4, seed=2)
    ops = tb.bcsr_operands_from_state(S, Q, block=128, dtype=dt,
                                      store_transpose=True, flat_group=8,
                                      device="cuda")
    g = _gen(seed)
    nrows = ops.s_blocks.ncols
    Kbr, maxblkQ = ops.q_bcols.shape
    flat = torch.zeros(Kbr * 128 * maxblkQ * 128, dtype=dt, device="cuda")
    ev = torch.randn((int(ops.q_eidx.max()) + 1,), device="cuda",
                     generator=g)
    flat[ops.q_pos] = ev[ops.q_eidx].to(dt)
    qm = tb.BlockEll(bcols=ops.q_bcols,
                     blocks=flat.reshape(Kbr, 128, maxblkQ, 128),
                     nrows=Kbr * 128, ncols=nrows)
    d = torch.randn((K,), device="cuda", generator=g)
    h = torch.rand((K,), device="cuda", generator=g)
    return expm.SplitOperator(
        d=d, h=h, products=(lambda Vp: tb.bcsr_spmm(qm, Vp),
                            lambda Vp: tb.bsr_spmm_flat(ops.s_flat, Vp),
                            lambda Vp: tb.bsr_spmm_flat(ops.st_flat, Vp)),
        nrows=nrows, operand_dtype=dt, scale=0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_split_form_matches_generic_form_and_plain(dt):
    """The split form (the block-sparse solver's) against the generic form
    of the same operator (its plain call as the product): bit for bit, the
    first pass adding the parts in L_apply's order and the last writing the
    operands the SpMM wrappers' cast would make (no cast left in them for
    bfloat16), padded rows zero.  Float32 blocks also against the plain
    version to 1e-5; with bfloat16 blocks the plain version's basis rounds
    to other bfloat16 operands wherever its float32 sums differ in the last
    bit, so only the generic form is held to it."""
    _need_card()
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr

    K = generate_large_state_csr(10, 75e-4, seed=2)[0].shape[0]
    op = _split_operator(getattr(torch, dt), K)
    assert op.nrows > K
    V = torch.randn((K, 48), device="cuda", generator=_gen(7))
    n0 = tb.bsr_spmm_flat.launches
    got, want = _both(op, V, 10)
    assert tb.bsr_spmm_flat.launches >= n0 + 2 * 10
    generic = expm.lanczos_tridiag(expm.LanczosOperator(op), V, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, generic))
    if dt == "float32":
        _check_all(got, want)


@pytest.mark.cuda
def test_two_runs_are_bit_identical():
    _need_card()
    from sig_sdp_mmw_torch.env.large import generate_large_state_csr

    K = generate_large_state_csr(10, 75e-4, seed=2)[0].shape[0]
    op = _split_operator(torch.bfloat16, K)
    V = torch.randn((K, 128), device="cuda", generator=_gen(8))
    a = expm.lanczos_expm_multiply(op, V, 10, small_method="taylor_ss",
                                   norm_bound=7.5)
    b = expm.lanczos_expm_multiply(op, V, 10, small_method="taylor_ss",
                                   norm_bound=7.5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    x = expm.lanczos_tridiag(op, V, 10)
    y = expm.lanczos_tridiag(op, V, 10)
    assert all(torch.equal(s, t) for s, t in zip(x, y))


@contextlib.contextmanager
def _plain_lanczos(monkeypatch):
    """The solvers' Lanczos steps and combination through the plain
    versions, on the card."""
    with monkeypatch.context() as mp:
        mp.setattr(expm, "lanczos_tridiag", expm.lanczos_tridiag_reference)
        mp.setattr(expm, "lanczos_combine", expm.lanczos_combine_reference)
        yield


@pytest.mark.cuda
def test_block_sparse_solve_matches_plain(monkeypatch):
    """mmw_solve_ell at cell 24 (128x128 blocks, flat S̃): with float32
    blocks the binary search's Z_fin and a solve's ub_final there as with
    the plain steps; with bfloat16 blocks (the main path's) the ub_final of
    a solve at that Z.  A bfloat16 search's Z_fin is not compared: where
    the two versions' float32 sums differ in the last bit, their bases round
    to other bfloat16 operands, and the rounding of a probe at the margin
    follows such differences."""
    _need_card()
    from sig_sdp_mmw_torch.env.large import LargeEnv
    from sig_sdp_mmw_torch.models.mmw_ell import MMWEll
    from sig_sdp_mmw_torch.models.search import BinarySearchRelaxation

    env = LargeEnv(24, 75e-4, seed=0)
    S, Q, h = env.generate_state_csr()
    ell = env.generate_ell(device="cuda")

    def solver(dt):
        alg = MMWEll(nit=150, eta=0.05, use_bcsr=True, nattempt=10)
        alg.prepare(ell, S, Q, h_max=h, block=128, dtype=dt,
                    store_transpose=True, flat_group=8)
        return alg

    def search():
        alg = solver(torch.float32)
        bs = BinarySearchRelaxation()
        bs.feasibility_check_alg = alg
        z, Z, rem = bs.run(ell)
        alg.run_with_state(0, Z, ell)
        return Z, rem, float(alg.last_output.ub_final)

    def solve(Z):
        alg = solver(torch.bfloat16)
        alg.run_with_state(0, Z, ell)
        return float(alg.last_output.ub_final)

    s0 = expm.lanczos_tridiag.route_steps["plain"]
    kernel = search()
    kernel_bf16 = solve(kernel[0])
    assert expm.lanczos_tridiag.route_steps["plain"] == s0
    with _plain_lanczos(monkeypatch):
        plain = search()
        plain_bf16 = solve(kernel[0])
    assert kernel[0] == plain[0] and kernel[1] == plain[1] == 0
    assert abs(kernel[2] - plain[2]) <= 1e-5, (kernel, plain)
    assert abs(kernel_bf16 - plain_bf16) <= 1e-5, (kernel_bf16, plain_bf16)


@pytest.mark.cuda
def test_dense_solve_matches_plain(monkeypatch):
    """mmw_solve at K=300 (the sig300 cell's network, seed 7): Z_fin and a
    solve's ub_final as with the plain steps."""
    _need_card()
    from sig_sdp_mmw_torch.env import WirelessEnv
    from sig_sdp_mmw_torch.models import MMW, BinarySearchRelaxation

    st = WirelessEnv(cell_size=10, sta_density_per_1m2=0.0075, seed=7,
                     device="cuda").generate_S_Q_hmax()

    def run():
        alg = MMW(nit=150, eta=0.04)
        bs = BinarySearchRelaxation()
        bs.feasibility_check_alg = alg
        z, Z, rem = bs.run(st)
        alg.run_with_state(0, Z, st)
        return Z, rem, float(alg.last_output.ub_final)

    kernel = run()
    with _plain_lanczos(monkeypatch):
        plain = run()
    assert kernel[0] == plain[0] and kernel[1] == plain[1] == 0
    assert abs(kernel[2] - plain[2]) <= 1e-5, (kernel, plain)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take():
    _need_card()
    V = torch.zeros((64, 8), dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="float32 or float64"):
        expm.lanczos_tridiag(lambda X: X, V, 4)
    with pytest.raises(ValueError, match="no kernel for K"):
        expm.lanczos_tridiag(lambda X: X, torch.zeros((64, 257),
                                                      device="cuda"), 4)


def test_route_names_the_device():
    assert expm.lanczos_route("cpu") == "plain"
    assert expm.lanczos_route(torch.device("cuda", 0)) == "kernel"


def test_spmm_wrappers_take_the_steps_bfloat16_operands():
    """The SpMM kernels' wrappers take a bfloat16 V with bfloat16 blocks
    (the split form's operands, already rounded) and still refuse it with
    float32 blocks."""
    import scipy.sparse

    A = scipy.sparse.random(256, 256, density=0.05, random_state=0,
                            format="csr")
    Vb = torch.zeros((256, 16), dtype=torch.bfloat16)
    for dt, ok in ((torch.bfloat16, True), (torch.float32, False)):
        flat = tb.bsr_flat_from_csr(A, block=128, group=2, dtype=dt)
        ell = tb.bcsr_from_csr(A, block=128, dtype=dt)
        for why in (tb.flat_kernel_unsupported(flat, Vb),
                    tb.ell_kernel_unsupported(ell, Vb)):
            assert (why is None) == ok, why
