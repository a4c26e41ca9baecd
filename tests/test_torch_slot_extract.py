"""Port parity: the fused round extraction ``slot_extract``.

* The port's plain version (``repro_torch.kernels.ref.slot_extract_ref``)
  against the JAX package's oracle (``repro.kernels.ref.slot_extract_ref``)
  on the same numpy inputs, over fairness weights, gated-off slots, COUNT
  slots and ``return_cols``.  The decoded window must be equal bit for bit
  (both decode with one fused multiply-add per digit, in digit order) and
  the m lane exactly; the three sum lanes are float32 sums of at most B
  non-negative terms taken in another order, so they agree within the
  recursive-summation bound ``2·B·2^-24`` relative.
* Dispatch: a CPU tensor takes the plain version and launches nothing; the
  CUDA wrapper refuses CPU tensors rather than falling back.
* On the card (marked ``cuda``; skipped without one): the hand-written
  kernel against the plain version.
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
from repro_torch.kernels.slot_extract import slot_extract_cuda
from repro_torch.sampling.permutation import chunk_seed, permutation_window_dyn


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every test worker collects
    # the same tests whether or not it sees a card
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def _case(c=16, s=8, w=4, b=64, n=6, m=512, seed=0):
    """Packed store, window rows and an S-slot plan with non-negative
    coefficients (so every summed term is non-negative)."""
    rng = np.random.default_rng(seed)
    vals = make_synthetic_zipf(n * m, c, seed=seed)
    packed = AsciiFixedFormat(c).encode(vals).reshape(n, m, -1)
    jw = rng.choice(n, size=w, replace=False).astype(np.int32)
    sizes = np.full(n, m, np.int64)
    seeds = chunk_seed(seed, torch.as_tensor(jw.astype(np.int64)))
    idx = permutation_window_dyn(
        seeds, torch.as_tensor(rng.integers(0, m, w)), b,
        torch.as_tensor(sizes[jw]), m).numpy().astype(np.int32)
    b_eff = np.asarray([b, b - 3, b // 2, 0][:w], np.int32)
    coeffs = np.abs(rng.normal(size=(s, c))).astype(np.float32)
    coeffs[rng.random((s, c)) < 0.5] = 0.0
    lo = np.full((s, c), -np.inf, np.float32)
    hi = np.full((s, c), np.inf, np.float32)
    for k in range(s):
        col = k % c
        lo[k, col] = np.float32(1.00005e7 * (k % 3))
        hi[k, col] = np.float32(lo[k, col] + 6.00005e7)
    is_count = (np.arange(s) % 3 == 1).astype(np.float32)
    gate = np.ones(s, np.float32)
    gate[[2, 5][: s // 4]] = 0.0
    weights = np.asarray([1.0, 0.5, 0.3, 0.77, 1.0, 0.1, 0.9, 1.0][:s],
                         np.float32)
    return packed, jw, idx, b_eff, coeffs, lo, hi, is_count, gate, weights


def _torch(args, device="cpu"):
    return [torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in args]


@pytest.mark.parametrize("return_cols", [False, True])
@pytest.mark.parametrize("b,unit_weights", [(8, False), (64, False),
                                             (256, True)])
def test_plain_version_matches_reference_oracle(b, unit_weights, return_cols):
    case = list(_case(b=b, seed=b))
    if unit_weights:
        case[-1] = np.ones_like(case[-1])
    packed, jw, idx, b_eff, coeffs, lo, hi, isc, gate, wts = case
    j_stats, j_cols = jref.slot_extract_ref(
        jnp.asarray(packed), jnp.asarray(jw), jnp.asarray(idx),
        jnp.asarray(b_eff), jnp.asarray(coeffs), jnp.asarray(lo),
        jnp.asarray(hi), jnp.asarray(isc), jnp.asarray(gate),
        num_cols=coeffs.shape[1], return_cols=return_cols,
        weights=jnp.asarray(wts))
    t_stats, t_cols = tref.slot_extract_ref(
        *_torch(case[:9]), num_cols=coeffs.shape[1],
        return_cols=return_cols, weights=torch.as_tensor(wts))
    got, want = t_stats.numpy(), np.asarray(j_stats)
    assert got.shape == want.shape == (4, 8, 4)
    assert np.array_equal(got[..., 0], want[..., 0])          # m lane
    np.testing.assert_allclose(got[..., 1:], want[..., 1:],
                               rtol=2 * b * 2.0 ** -24, atol=0)
    if return_cols:
        assert np.array_equal(t_cols.numpy(), np.asarray(j_cols))
    else:
        assert t_cols is None and j_cols is None


def test_slot_budgets_keep_the_f32_op_order():
    b_eff = torch.tensor([0, 1, 7, 4096, 1000], dtype=torch.int32)
    w = torch.tensor([1.0, 0.3, 0.77, 0.1, 1e-7], dtype=torch.float32)
    got = tref.slot_budgets(b_eff, w).numpy()
    want = np.minimum(np.ceil(w.numpy()[:, None]
                              * b_eff.numpy()[None, :].astype(np.float32)
                              ).astype(np.int32), b_eff.numpy()[None, :])
    assert np.array_equal(got, want)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    case = _case(b=32, seed=4)
    before = slot_extract_cuda.launches
    stats, cols = ops.slot_extract(*_torch(case[:9]), weights=case[9],
                                   return_cols=True)
    want, want_cols = tref.slot_extract_ref(
        *_torch(case[:9]), num_cols=16, return_cols=True,
        weights=torch.as_tensor(case[9]))
    assert torch.equal(stats, want) and torch.equal(cols, want_cols)
    assert slot_extract_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    case = _case(b=8, seed=5)
    with pytest.raises(ValueError, match="CUDA"):
        slot_extract_cuda(*_torch(case))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [8, 64, 4096])
def test_kernel_matches_plain_version_on_the_card(cuda_device, b):
    case = _case(b=b, m=max(4096, b), seed=b)
    args = _torch(case, cuda_device)
    before = slot_extract_cuda.launches
    got, got_cols = slot_extract_cuda(*args, return_cols=True)
    want, want_cols = tref.slot_extract_ref(
        *args[:9], num_cols=16, return_cols=True, weights=args[9])
    torch.cuda.synchronize()
    assert slot_extract_cuda.launches == before + 1
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.array_equal(got[..., 0], want[..., 0])
    # the kernel parses by int32 Horner (a few ulp from the plain per-digit
    # sums) and sums rows in blocks: see chip_smoke.py for the derivation
    np.testing.assert_allclose(got[..., 1:], want[..., 1:],
                               rtol=(2 * b + 16) * 2.0 ** -24, atol=0)
    wc = want_cols.cpu().numpy()
    assert (np.abs(got_cols.cpu().numpy() - wc)
            <= 2.0 ** -21 * np.abs(wc) + 1e-6).all()
