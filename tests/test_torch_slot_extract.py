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
* The launch geometry the wrapper computes for the kernel (tiles, block
  size, scratch, tile counters), on the CPU.
* On the card (marked ``cuda``; skipped without one): the hand-written
  kernel against the plain version at the window widths that reach every
  case of its geometry (a partial warp, one and more warps, one and two
  tiles, the engine's ``budget_max`` and beyond), and three launches on the
  same inputs giving the same bits.
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
from repro_torch.kernels.slot_extract import (
    TILE_ROWS,
    _check_packed,
    scratch_lanes,
    slot_extract_cuda,
    tile_counters,
    tile_count,
    tile_scratch,
)

# window widths that reach every case of the kernels' geometry: a partial
# warp, one warp, a warp and a bit, two warps, one tile, two tiles, the
# engine's budget_max (4096) and twice it
EDGE_B = [1, 8, 31, 33, 64, 256, 257, 4096, 8192]
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
    b_eff = np.asarray([b, max(b - 3, 0), b // 2, 0][:w], np.int32)
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


@pytest.mark.parametrize("b,tiles", [(1, 1), (8, 1), (255, 1), (256, 1),
                                     (257, 2), (4096, 16), (8192, 32),
                                     (8193, 33)])
def test_tile_count(b, tiles):
    assert tile_count(b) == tiles
    # every window position has a tile, and a tile never holds more
    assert tiles * TILE_ROWS >= b > (tiles - 1) * TILE_ROWS


def test_tile_count_refuses_an_empty_window():
    with pytest.raises(ValueError, match="at least one"):
        tile_count(0)


@pytest.mark.parametrize("s,g,h,lanes", [(8, 0, 0, 32), (8, 0, 128, 32),
                                         (4, 9, 128, 4 * 4 + 4 * 9 * 4
                                          + 4 * 3 * 128),
                                         (1, 1, 2, 16)])  # 14 padded
def test_scratch_lanes(s, g, h, lanes):
    assert scratch_lanes(s, g, h) == lanes


@pytest.mark.parametrize("b", EDGE_B)
def test_scratch_only_past_one_tile(b):
    scratch = tile_scratch(4, b, scratch_lanes(8), torch.device("cpu"))
    tiles = tile_count(b)
    if tiles == 1:
        assert scratch is None
    else:
        assert scratch.shape == (4, tiles, 32)
        assert scratch.dtype == torch.float32


def test_tile_counters_are_zero_shared_per_stream_and_grow():
    dev = torch.device("cpu")
    first = tile_counters(4, dev, stream=-101)
    assert first.dtype == torch.int32 and not first.any()
    assert first.numel() >= 4
    assert tile_counters(3, dev, stream=-101) is first
    assert tile_counters(4, dev, stream=-102) is not first
    grown = tile_counters(first.numel() + 1, dev, stream=-101)
    assert grown.numel() > first.numel() and not grown.any()
    assert tile_counters(4, dev, stream=-101) is grown


def test_packed_must_be_16_byte_aligned():
    flat = torch.zeros(1 + 2 * 4 * 64, dtype=torch.uint8)
    ok = flat[:-1].view(2, 4, 64)
    assert _check_packed(ok, ok.device) == (2, 4, 64)
    shifted = flat[1:].view(2, 4, 64)
    with pytest.raises(ValueError, match="16-byte"):
        _check_packed(shifted, shifted.device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(b, 16) for b in EDGE_B]
                         # widths compiled without the row in registers; 20
                         # columns stage a tile's words in two batches
                         + [(8, 5), (257, 5), (8, 20), (257, 20),
                            (4096, 20)])
def test_kernel_matches_plain_version_on_the_card(cuda_device, b, c):
    case = _case(c=c, b=b, m=max(4096, b), seed=b)
    args = _torch(case, cuda_device)
    before = slot_extract_cuda.launches
    got, got_cols = slot_extract_cuda(*args, return_cols=True)
    want, want_cols = tref.slot_extract_ref(
        *args[:9], num_cols=c, return_cols=True, weights=args[9])
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


@pytest.mark.cuda
@pytest.mark.parametrize("b", [257, 8192])
def test_repeated_launches_give_the_same_bits_on_the_card(cuda_device, b):
    # more than one tile: each worker's last block folds the tiles and
    # resets its counter; a counter left set would change the next result
    args = _torch(_case(b=b, m=max(4096, b), seed=b + 1), cuda_device)
    runs = [slot_extract_cuda(*args, return_cols=True) for _ in range(3)]
    torch.cuda.synchronize()
    for stats, cols in runs[1:]:
        assert torch.equal(stats.view(torch.int32),
                           runs[0][0].view(torch.int32))
        assert torch.equal(cols.view(torch.int32),
                           runs[0][1].view(torch.int32))
