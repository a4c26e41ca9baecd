"""Port parity: the full-chunk pass ``chunk_agg`` and the round-slab pass
``round_stats`` (the last two TPU kernels' counterparts).

* The port's plain versions (``repro_torch.kernels.ref.chunk_agg_ref`` and
  ``round_stats_ref``) against the JAX package's oracles on the same numpy
  inputs: the count lane equal (it counts rows), the three sum lanes within
  ``2·R·2^-24`` relative plus the few ulps by which the two evaluate a
  linear expression in another order (float32 sums of at most R
  non-negative terms in another order: the recursive-summation bound).
* Dispatch: a CPU tensor takes the plain version and launches nothing; the
  CUDA wrappers refuse CPU tensors rather than falling back.
* On the card (marked ``cuda``; skipped without one): each kernel against
  its plain version, and ``chunk_agg``'s totals against float64 sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.formats import AsciiFixedFormat
from repro.data.generator import make_synthetic_zipf
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.chunk_agg import chunk_agg_cuda
from repro_torch.kernels.round_stats import round_stats_cuda


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every test worker collects
    # the same tests whether or not it sees a card
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def _plan(q, c, seed):
    """Q linear plans with non-negative coefficients (so every summed term
    is non-negative) and range bounds off the data's value grid."""
    rng = np.random.default_rng(seed)
    coeffs = np.abs(rng.normal(size=(q, c))).astype(np.float32)
    coeffs[rng.random((q, c)) < 0.4] = 0.0
    coeffs[0] = 0.0                                   # a COUNT-like plan
    lo = np.full((q, c), -np.inf, np.float32)
    hi = np.full((q, c), np.inf, np.float32)
    for k in range(1, q):
        col = k % c
        lo[k, col] = np.float32(1.00005e7 * (k % 3))
        hi[k, col] = np.float32(lo[k, col] + 5.00005e7)
    return coeffs, lo, hi


def _rows(lead, r, c, seed):
    vals = make_synthetic_zipf(lead * r, c, seed=seed)
    return AsciiFixedFormat(c).encode(vals).reshape(lead, r, -1)


def _assert_lanes(got, want, r, what):
    assert got.shape == want.shape
    assert np.array_equal(got[..., 0], want[..., 0]), f"{what}: count lane"
    np.testing.assert_allclose(got[..., 1:], want[..., 1:],
                               rtol=(2 * r + 32) * 2.0 ** -24, atol=0,
                               err_msg=what)


@pytest.mark.parametrize("n,m,c,q", [(5, 37, 4, 3), (3, 256, 16, 8),
                                     (2, 300, 6, 1)])
def test_chunk_agg_plain_version_matches_reference(n, m, c, q):
    raw = _rows(n, m, c, seed=n)
    coeffs, lo, hi = _plan(q, c, seed=m)
    sizes = np.asarray([m, m // 2, 1, 0, m + 5][:n], np.int32)
    want = np.asarray(jref.chunk_agg_ref(
        jnp.asarray(raw), c, jnp.asarray(coeffs), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(sizes)))
    got = ops.chunk_agg(torch.as_tensor(raw), sizes, coeffs, lo, hi).numpy()
    _assert_lanes(got, want, m, "chunk_agg")
    assert np.array_equal(got[:, 0, 0], np.minimum(sizes, m))


@pytest.mark.parametrize("w,b,c,q", [(4, 64, 16, 8), (3, 8, 4, 2),
                                     (1, 257, 6, 5)])
def test_round_stats_plain_version_matches_reference(w, b, c, q):
    slab = _rows(w, b, c, seed=b)
    coeffs, lo, hi = _plan(q, c, seed=w)
    b_eff = np.asarray([b, b - 3, 0, b // 2][:w], np.int32)
    want = np.asarray(jref.round_stats_ref(
        jnp.asarray(slab), c, jnp.asarray(coeffs), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(b_eff)))
    got = ops.round_stats(torch.as_tensor(slab), b_eff, coeffs, lo,
                          hi).numpy()
    _assert_lanes(got, want, b, "round_stats")
    assert np.array_equal(got[:, :, 0], np.broadcast_to(b_eff[:, None],
                                                        (w, q)))


def test_cpu_tensors_launch_nothing_and_wrappers_refuse_them():
    raw = torch.as_tensor(_rows(2, 16, 4, seed=1))
    coeffs, lo, hi = (torch.as_tensor(a) for a in _plan(2, 4, seed=2))
    sizes = torch.tensor([16, 9], dtype=torch.int32)
    before = (chunk_agg_cuda.launches, round_stats_cuda.launches)
    a = ops.chunk_agg(raw, sizes, coeffs, lo, hi)
    b = ops.round_stats(raw, sizes, coeffs, lo, hi)
    # the two passes are one function of (rows, valid counts, plan)
    assert torch.equal(a, b)
    assert torch.equal(a, tref.chunk_agg_ref(raw, 4, coeffs, lo, hi, sizes))
    assert (chunk_agg_cuda.launches, round_stats_cuda.launches) == before
    for fn in (chunk_agg_cuda, round_stats_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(raw, sizes, coeffs, lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["chunk_agg", "round_stats"])
@pytest.mark.parametrize("r", [8, 300, 4096])
def test_kernels_match_plain_versions_on_the_card(cuda_device, kernel, r):
    lead, c, q = 4, 16, 8
    vals = make_synthetic_zipf(lead * r, c, seed=r)
    raw = torch.as_tensor(AsciiFixedFormat(c).encode(vals).reshape(
        lead, r, -1), device=cuda_device)
    plan = [torch.as_tensor(a, device=cuda_device) for a in _plan(q, c, r)]
    valid = torch.tensor([r, r - 3, 0, r // 2], dtype=torch.int32,
                         device=cuda_device)
    fn = chunk_agg_cuda if kernel == "chunk_agg" else round_stats_cuda
    plain = tref.chunk_agg_ref if kernel == "chunk_agg" else \
        tref.round_stats_ref
    before = fn.launches
    got = fn(raw, valid, *plan)
    want = plain(raw, c, *plan, valid)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.array_equal(got[..., 0], want[..., 0])
    # the kernel parses by int32 Horner (a few ulp from the plain per-digit
    # sums) and sums rows in blocks: see chip_smoke.py for the derivation
    np.testing.assert_allclose(got[..., 1:], want[..., 1:],
                               rtol=(2 * r + 16) * 2.0 ** -24, atol=0)
    # against float64 sums of the same rows: each sum carries the parse's
    # and the linear expression's rounding and the blocks' summation order
    if kernel == "chunk_agg":
        coeffs, lo, hi = (a.cpu().numpy().astype(np.float64) for a in plan)
        v = vals.reshape(lead, r, c)
        ok = np.arange(r)[None, :] < valid.cpu().numpy()[:, None]
        p = np.all((v[:, :, None] >= lo) & (v[:, :, None] < hi), -1) & \
            ok[..., None]
        x = np.einsum("lrc,qc->lrq", v, coeffs) * p
        exact = x.sum(1)
        np.testing.assert_allclose(got[..., 1], exact,
                                   rtol=(r // 256 + 64) * 2.0 ** -24)
        assert np.array_equal(got[..., 3], p.sum(1))
