"""Port parity: the streaming-residency kernels ``slot_extract_stream``,
``slot_eval_decoded`` and ``extract_parse``, and the build's source hash.

* The port's plain versions against the JAX package's oracles
  (``repro.kernels.ref``) and ``repro.kernels.ops(backend="ref")`` on the
  same numpy inputs.  Decoded values and cache rows are equal bit for bit
  (both decode with one fused multiply-add per digit, in digit order) and
  the m lane exactly; the three sum lanes are float32 sums of at most B
  non-negative terms in another order: within ``2·B·2^-24`` relative.
* Inside the port, on the CPU: the slab path equals the packed path over
  the same rows, the decoded path fed by ``extract_parse`` equals the raw
  slab path, and a mixed pair with complementary budgets equals the single
  kernel — all bit for bit.
* Dispatch: CPU tensors take the plain versions and launch nothing; the
  CUDA wrappers refuse CPU tensors, a slab that is not 16-byte aligned and
  malformed inputs; the outputs are ``torch.empty`` with a tile scratch
  only past one tile.
* On the card (marked ``cuda``, skipped without one): each kernel against
  its plain version at B from 1 to 8,192 and C in {4, 5, 16, 20}, the
  three equalities above, bitwise, three launches on the same inputs with
  the same bits, and cache rows off the window at +0.0 in a buffer taken
  from a freed NaN block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.formats import AsciiFixedFormat
from repro.data.generator import make_synthetic_zipf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.extract_parse import extract_parse_cuda
from repro_torch.kernels.slot_extract import slot_extract_cuda
from repro_torch.kernels.slot_extract import TILE_ROWS, tile_count
from repro_torch.kernels.slot_extract_stream import (
    check_inputs,
    outputs,
    slot_eval_decoded_cuda,
    slot_extract_stream_cuda,
)
from repro_torch.sampling.permutation import chunk_seed, permutation_window_dyn


@pytest.fixture
def cuda_device():
    # decided here, per test, never at import: every test worker collects
    # the same tests whether or not it sees a card
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


def _case(c=16, s=8, w=4, b=64, n=6, m=512, seed=0):
    """Packed store, the per-worker slab of chunks ``jw`` (rows padded to
    ``m + 64`` with zeros), window rows, scan positions and an S-slot plan
    with non-negative coefficients."""
    rng = np.random.default_rng(seed)
    vals = make_synthetic_zipf(n * m, c, seed=seed)
    packed = AsciiFixedFormat(c).encode(vals).reshape(n, m, -1)
    jw = rng.choice(n, size=w, replace=False).astype(np.int32)
    slab = np.zeros((w, m + 64, packed.shape[2]), np.uint8)
    slab[:, :m] = packed[jw]
    seeds = chunk_seed(seed, torch.as_tensor(jw.astype(np.int64)))
    idx = permutation_window_dyn(
        seeds, torch.as_tensor(rng.integers(0, m, w)), b,
        torch.full((w,), m), m).numpy().astype(np.int32)
    b_eff = np.maximum([b, b - 3, b // 2, 0][:w], 0).astype(np.int32)
    m_before = np.asarray([0, 5, 100, 7][:w], np.int32)
    coeffs = np.abs(rng.normal(size=(s, c))).astype(np.float32)
    coeffs[rng.random((s, c)) < 0.5] = 0.0
    lo = np.full((s, c), -np.inf, np.float32)
    hi = np.full((s, c), np.inf, np.float32)
    for k in range(s):
        col = k % c
        lo[k, col] = np.float32(1.00005e7 * (k % 3))
        hi[k, col] = np.float32(lo[k, col] + 6.00005e7)
    plan = dict(coeffs=coeffs, lo=lo, hi=hi,
                is_count=(np.arange(s) % 3 == 1).astype(np.float32),
                gate=np.asarray([1, 1, 0, 1, 1, 0, 1, 1][:s], np.float32),
                weights=np.asarray([1.0, 0.5, 0.3, 0.77, 1.0, 0.1, 0.9,
                                    1.0][:s], np.float32))
    return dict(packed=packed, jw=jw, slab=slab, idx=idx, b_eff=b_eff,
                m_before=m_before, plan=plan)


def _t(a, device="cpu"):
    return torch.tensor(np.asarray(a), device=device)


def _plan_args(plan, mod=None, device="cpu"):
    keys = ("coeffs", "lo", "hi", "is_count", "gate")
    conv = (lambda a: jnp.asarray(a)) if mod == "jax" else (
        lambda a: _t(a, device))
    return [conv(plan[k]) for k in keys], conv(plan["weights"])


def _assert_stats_close(got, want, b):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got[..., 0], want[..., 0])            # m lane
    np.testing.assert_allclose(got[..., 1:], want[..., 1:],
                               rtol=2 * b * 2.0 ** -24, atol=0)


@pytest.mark.parametrize("cache_cap", [0, 24])
@pytest.mark.parametrize("b", [8, 64, 256])
def test_stream_plain_version_matches_reference(b, cache_cap):
    case = _case(b=b, seed=b)
    jplan, jw8 = _plan_args(case["plan"], "jax")
    want = jops.slot_extract_stream(
        jnp.asarray(case["slab"]), jnp.asarray(case["idx"]),
        jnp.asarray(case["b_eff"]), *jplan, backend="ref", weights=jw8,
        cache_cap=cache_cap, m_before=jnp.asarray(case["m_before"]))
    tplan, tw8 = _plan_args(case["plan"])
    got = ops.slot_extract_stream(
        _t(case["slab"]), _t(case["idx"]), _t(case["b_eff"]), *tplan,
        weights=tw8, cache_cap=cache_cap, m_before=_t(case["m_before"]))
    if cache_cap:
        (got, got_rows), (want, want_rows) = got, want
        assert np.array_equal(got_rows.numpy(), np.asarray(want_rows))
        assert got_rows.shape == (4, cache_cap, 16)
    _assert_stats_close(got.numpy(), want, b)


@pytest.mark.parametrize("cache_cap", [0, 24])
@pytest.mark.parametrize("b", [8, 64, 256])
def test_decoded_plain_version_matches_reference(b, cache_cap):
    case = _case(b=b, seed=b + 1)
    w, r, rec = case["slab"].shape
    dec = np.asarray(jref.parse_ascii_ref(
        jnp.asarray(case["slab"].reshape(w * r, rec)), 16)).reshape(w, r, 16)
    jplan, jw8 = _plan_args(case["plan"], "jax")
    want = jops.slot_eval_decoded(
        jnp.asarray(dec), jnp.asarray(case["idx"]),
        jnp.asarray(case["b_eff"]), *jplan, backend="ref", weights=jw8,
        cache_cap=cache_cap, m_before=jnp.asarray(case["m_before"]))
    tplan, tw8 = _plan_args(case["plan"])
    got = ops.slot_eval_decoded(
        _t(dec), _t(case["idx"]), _t(case["b_eff"]), *tplan, weights=tw8,
        cache_cap=cache_cap, m_before=_t(case["m_before"]))
    if cache_cap:
        (got, got_rows), (want, want_rows) = got, want
        assert np.array_equal(got_rows.numpy(), np.asarray(want_rows))
    _assert_stats_close(got.numpy(), want, b)
    direct = tref.slot_eval_decoded_ref(_t(dec), _t(case["idx"]),
                                        _t(case["b_eff"]), *tplan,
                                        weights=tw8)
    assert torch.equal(direct, got)


def test_cache_row_helpers_match_reference():
    case = _case(b=32, seed=9)
    cols = np.random.default_rng(9).random((4, 32, 16)).astype(np.float32)
    for cap in (1, 16, 200):
        want = jref.window_cache_rows_ref(
            jnp.asarray(cols), jnp.asarray(case["b_eff"]),
            jnp.asarray(case["m_before"]), cap)
        got = tref.window_cache_rows_ref(_t(cols), _t(case["b_eff"]),
                                         _t(case["m_before"]), cap)
        assert np.array_equal(got.numpy(), np.asarray(want))
    want = jref.stream_cache_rows_ref(
        jnp.asarray(case["slab"]), jnp.asarray(case["idx"]),
        jnp.asarray(case["b_eff"]), jnp.asarray(case["m_before"]), 64, 16)
    got = tref.stream_cache_rows_ref(_t(case["slab"]), _t(case["idx"]),
                                     _t(case["b_eff"]), _t(case["m_before"]),
                                     64, 16)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_extract_parse_plain_version_matches_reference():
    raw = _case(b=8, seed=11)["packed"].reshape(-1, 256)
    want = np.asarray(jops.extract_parse(jnp.asarray(raw), 16, backend="ref"))
    got = ops.extract_parse(_t(raw), 16)
    assert got.dtype == torch.float32 and got.shape == (raw.shape[0], 16)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tref.parse_ascii_ref(_t(raw), 16).numpy(), want)


def _kernel_args(case, device="cpu", decoded=False):
    """(source, idx, b_eff, coeffs, lo, hi, is_count, gate, weights,
    m_before) of a case on ``device``: the raw slab, or its plain parse."""
    plan, wts = _plan_args(case["plan"], device=device)
    slab = _t(case["slab"], device)
    if decoded:
        w, r, rec = slab.shape
        slab = tref.parse_ascii_ref(slab.reshape(w * r, rec),
                                    rec // 16).reshape(w, r, rec // 16)
    return (slab, _t(case["idx"], device), _t(case["b_eff"], device), *plan,
            wts, _t(case["m_before"], device))


@pytest.mark.parametrize("cache_cap", [0, 128])
@pytest.mark.parametrize("b", [1, 8, 256, 257, 4096, 8192])
def test_outputs_are_empty_with_scratch_only_past_one_tile(b, cache_cap):
    stats, cache, scratch = outputs(4, b, 8, 5, cache_cap, torch.device("cpu"))
    assert stats.shape == (4, 8, 4) and stats.dtype == torch.float32
    if cache_cap:
        assert cache.shape == (4, cache_cap, 5)
        assert cache.dtype == torch.float32
    else:
        assert cache is None
    if b <= TILE_ROWS:
        assert scratch is None
    else:
        assert scratch.shape == (4, tile_count(b), 32)


@pytest.mark.parametrize("decoded", [False, True])
def test_check_inputs_shapes(decoded):
    case = _case(c=5, b=33, seed=6)
    assert check_inputs(decoded, *_kernel_args(case, decoded=decoded)[:-1],
                        24, _t(case["m_before"])) == (4, 576, 33, 8, 5)


@pytest.mark.parametrize("decoded", [False, True])
def test_slab_must_be_16_byte_aligned(decoded):
    case = _case(c=4, b=8, seed=7)
    src, *rest = _kernel_args(case, decoded=decoded)
    flat = torch.zeros(src.numel() + 16, dtype=src.dtype)
    step = 16 // src.element_size()
    ok = flat[:src.numel()].view(src.shape)
    assert check_inputs(decoded, ok, *rest[:-1], 0, rest[-1])[0] == 4
    shifted = flat[step // 2 or 1:][:src.numel()].view(src.shape)
    with pytest.raises(ValueError, match="16-byte"):
        check_inputs(decoded, shifted, *rest[:-1], 0, rest[-1])


@pytest.mark.parametrize("fault", ["width", "workers", "cap", "m_before",
                                   "idx_dtype"])
@pytest.mark.parametrize("decoded", [False, True])
def test_check_inputs_refuses_malformed_inputs(decoded, fault):
    case = _case(c=4, b=8, seed=8)
    src, idx, b_eff, *plan, wts, mb = _kernel_args(case, decoded=decoded)
    cap = 16
    if fault == "width":
        src = src[..., :-1].contiguous()
    elif fault == "workers":
        src = src[:3].contiguous()
    elif fault == "cap":
        cap = -1
    elif fault == "m_before":
        mb = mb[:3].contiguous()
    else:
        idx = idx.to(torch.int64)
    with pytest.raises((ValueError, TypeError)):
        check_inputs(decoded, src, idx, b_eff, *plan, wts, cap, mb)


def _port_equalities(device):
    """The three equalities the port's paths must hold bit for bit, on
    ``device``: slab == packed over the same rows, decoded (fed by
    extract_parse) == raw slab, mixed pair == single kernel.  Returns the
    number of cases checked."""
    n = 0
    for b in (8, 64, 4096):
        case = _case(b=b, m=max(512, b), seed=b + 2)
        plan, wts = _plan_args(case["plan"], device=device)
        idx, b_eff = _t(case["idx"], device), _t(case["b_eff"], device)
        mb = _t(case["m_before"], device)
        slab = _t(case["slab"], device)
        packed, _ = ops.slot_extract(_t(case["packed"], device),
                                     _t(case["jw"], device), idx, b_eff,
                                     *plan, weights=wts)
        raw, raw_rows = ops.slot_extract_stream(
            slab, idx, b_eff, *plan, weights=wts, cache_cap=128, m_before=mb)
        assert torch.equal(raw, packed), f"B={b}: stream != packed"
        w, r, rec = slab.shape
        dec = ops.extract_parse(slab.reshape(w * r, rec), 16).reshape(w, r,
                                                                      16)
        dstats, dec_rows = ops.slot_eval_decoded(
            dec, idx, b_eff, *plan, weights=wts, cache_cap=128, m_before=mb)
        assert torch.equal(dstats, raw), f"B={b}: decoded != raw"
        assert torch.equal(dec_rows, raw_rows), f"B={b}: cache rows"
        is_dec = torch.tensor([True, False, True, False], device=device)
        b_raw = torch.where(is_dec, torch.zeros_like(b_eff), b_eff)
        r1, rows1 = ops.slot_extract_stream(slab, idx, b_raw, *plan,
                                            weights=wts, cache_cap=128,
                                            m_before=mb)
        r2, rows2 = ops.slot_eval_decoded(dec, idx, b_eff - b_raw, *plan,
                                          weights=wts, cache_cap=128,
                                          m_before=mb)
        assert torch.equal(r1 + r2, raw), f"B={b}: mixed != single"
        assert torch.equal(rows1 + rows2, raw_rows)
        n += 1
    return n


def test_paths_agree_bitwise_on_the_cpu():
    assert _port_equalities("cpu") == 3


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    case = _case(b=16, seed=4)
    plan, wts = _plan_args(case["plan"])
    counts = (slot_extract_stream_cuda.launches,
              slot_eval_decoded_cuda.launches, extract_parse_cuda.launches)
    ops.slot_extract_stream(_t(case["slab"]), _t(case["idx"]),
                            _t(case["b_eff"]), *plan, weights=wts)
    ops.slot_eval_decoded(torch.zeros((4, 8, 16)), _t(case["idx"]) % 8,
                          _t(case["b_eff"]), *plan, weights=wts)
    ops.extract_parse(_t(case["packed"][0]), 16)
    assert counts == (slot_extract_stream_cuda.launches,
                      slot_eval_decoded_cuda.launches,
                      extract_parse_cuda.launches)


def test_cuda_wrappers_refuse_cpu_tensors():
    case = _case(b=8, seed=5)
    plan, wts = _plan_args(case["plan"])
    args = (_t(case["idx"]), _t(case["b_eff"]), *plan, wts,
            _t(case["m_before"]))
    with pytest.raises(ValueError, match="CUDA"):
        slot_extract_stream_cuda(_t(case["slab"]), *args)
    with pytest.raises(ValueError, match="CUDA"):
        slot_eval_decoded_cuda(torch.zeros((4, 8, 16)), *args)
    with pytest.raises(ValueError, match="CUDA"):
        extract_parse_cuda(_t(case["packed"][0]), 16)


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """Editing a header a source includes must rename (and so rebuild) the
    source's library; editing an unrelated file must not."""
    (tmp_path / "common.cuh").write_text("#pragma once\nint a = 1;\n")
    (tmp_path / "other.cuh").write_text("int b = 1;\n")
    (tmp_path / "k.cu").write_text('#include "common.cuh"\nint main();\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    first = _build._target("k")
    (tmp_path / "other.cuh").write_text("int b = 2;\n")
    assert _build._target("k") == first
    (tmp_path / "common.cuh").write_text("#pragma once\nint a = 2;\n")
    assert _build._target("k") != first
    assert _build.sources() == ["k"]
    (tmp_path / "k.cu").write_text('#include "missing.cuh"\n')
    with pytest.raises(FileNotFoundError, match="missing"):
        _build._target("k")


def test_package_kernels_include_the_shared_header():
    # the packed and slab kernels reach slot_common.cuh through slot_tile.cuh,
    # the rows kernels through rows_tile.cuh (which takes slot_tile.cuh's
    # copy and layout helpers)
    tile = {"slot_tile.cuh"}
    rows = {"rows_tile.cuh", "slot_tile.cuh"}
    for name, more in (("slot_extract", tile), ("slot_extract_grouped", tile),
                       ("slot_extract_stream", tile),
                       ("extract_parse", set()), ("chunk_agg", rows),
                       ("round_stats", rows)):
        files: dict = {}
        _build._closure(_build.CSRC / f"{name}.cu", files)
        assert {p.name for p in files} == {f"{name}.cu", "slot_common.cuh",
                                           *more}


def _off_window(b, b_eff, m_before, cap):
    """(W, cap) True where a cache row holds no window position."""
    k = np.arange(cap)[None, :] - np.asarray(m_before)[:, None]
    live = np.minimum(np.asarray(b_eff), b)[:, None]
    return (k < 0) | (k >= live)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 5, 16, 20])
@pytest.mark.parametrize("b", [1, 8, 257, 4096, 8192])
def test_kernels_match_plain_versions_on_the_card(cuda_device, b, c):
    # C = 4 and 16 run with the row in registers, 5 and 20 from shared
    # memory; 5 and 20 floats are not a whole number of 16-byte words
    before = (slot_extract_stream_cuda.launches,
              slot_eval_decoded_cuda.launches, extract_parse_cuda.launches)
    case = _case(c=c, b=b, m=max(512, b), seed=b + c)
    args = _kernel_args(case, cuda_device)
    cpu = _kernel_args(case)
    got, rows = slot_extract_stream_cuda(*args, cache_cap=128)
    want = tref.slot_extract_stream_ref(*cpu[:-2], num_cols=c,
                                        weights=cpu[-2])
    want_rows = tref.stream_cache_rows_ref(cpu[0], cpu[1], cpu[2], cpu[-1],
                                           128, c)
    slab = args[0]
    w, r, rec = slab.shape
    dec = extract_parse_cuda(slab.reshape(w * r, rec), c).reshape(w, r, c)
    dstats, drows = slot_eval_decoded_cuda(dec, *args[1:], cache_cap=128)
    dec_cpu = dec.cpu()
    dwant = tref.slot_eval_decoded_ref(dec_cpu, *cpu[1:-2], weights=cpu[-2])
    dwant_rows = tref.window_cache_rows_ref(
        tref.gather_window(dec_cpu, cpu[1]), cpu[2], cpu[-1], 128)
    torch.cuda.synchronize()
    assert (slot_extract_stream_cuda.launches,
            slot_eval_decoded_cuda.launches,
            extract_parse_cuda.launches) == tuple(n + 1 for n in before)
    # int32 Horner parse (within a few ulp of the plain per-digit sums)
    # and block-order row sums: chip_smoke.py derives both bounds
    rtol = (2 * b + 16) * 2.0 ** -24
    for g, wnt in ((got, want), (dstats, dwant)):
        g, wnt = g.cpu().numpy(), wnt.numpy()
        assert np.array_equal(g[..., 0], wnt[..., 0])
        np.testing.assert_allclose(g[..., 1:], wnt[..., 1:], rtol=rtol,
                                   atol=0)
    wr = want_rows.numpy()
    assert (np.abs(rows.cpu().numpy() - wr)
            <= 2.0 ** -21 * np.abs(wr) + 1e-6).all()
    assert np.array_equal(drows.cpu().numpy(), dwant_rows.numpy())
    # decoded == raw slab, bit for bit, stats and cache rows
    assert torch.equal(dstats, got) and torch.equal(drows, rows)
    plain = tref.parse_ascii_ref(slab.reshape(-1, rec).cpu(), c).numpy()
    assert (np.abs(dec_cpu.reshape(-1, c).numpy() - plain)
            <= 2.0 ** -21 * np.abs(plain) + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("decoded", [False, True])
@pytest.mark.parametrize("b", [8, 257, 8192])
def test_repeated_launches_give_the_same_bits_on_the_card(cuda_device, b,
                                                          decoded):
    # more than one tile: each worker's last block folds the tiles and
    # resets its counter; a counter left set would change the next result
    case = _case(b=b, m=max(512, b), seed=b + 3)
    args = _kernel_args(case, cuda_device, decoded=decoded)
    fn = slot_eval_decoded_cuda if decoded else slot_extract_stream_cuda
    runs = [fn(*args, cache_cap=128) for _ in range(3)]
    torch.cuda.synchronize()
    for stats, rows in runs[1:]:
        assert torch.equal(stats.view(torch.int32),
                           runs[0][0].view(torch.int32))
        assert torch.equal(rows.view(torch.int32),
                           runs[0][1].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("decoded", [False, True])
@pytest.mark.parametrize("b", [8, 257])
def test_cache_rows_off_the_window_are_zero_in_a_dirty_buffer(
        cuda_device, monkeypatch, b, decoded):
    case = _case(b=b, m=max(512, b), seed=b + 4)
    args = _kernel_args(case, cuda_device, decoded=decoded)
    fn = slot_eval_decoded_cuda if decoded else slot_extract_stream_cuda
    # the wrapper's torch.empty hands out NaN-filled memory, as a reused
    # block of the caching allocator may hold: every cache row the kernel
    # leaves unwritten would show
    empty = torch.empty

    def dirty(*shape, **kw):
        t = empty(*shape, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    monkeypatch.setattr(torch, "empty", dirty)
    stats, rows = fn(*args, cache_cap=128)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert not torch.isnan(stats).any()
    bits = rows.view(torch.int32).cpu().numpy()
    off = _off_window(b, case["b_eff"], case["m_before"], 128)
    assert off.any() and (~off).any()
    assert (bits[off] == 0).all()
    assert not np.isnan(rows.cpu().numpy()).any()


@pytest.mark.cuda
def test_paths_agree_bitwise_on_the_card(cuda_device):
    launches = slot_extract_cuda.launches
    assert _port_equalities(cuda_device) == 3
    torch.cuda.synchronize()
    assert slot_extract_cuda.launches == launches + 3
    assert slot_eval_decoded_cuda.launches > 0
