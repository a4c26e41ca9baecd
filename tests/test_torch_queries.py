"""Port parity: the query plane — ``linear_plan`` (including the nextafter
lowering of ``Cmp`` at threshold values), ``encode_slot``, the slot table
writes and ``slot_evaluate``, and ``compile_queries`` — against the JAX
package on the same numpy inputs.

Plans and evaluator outputs must be equal: the port sums a linear
expression in the order the reference's float32 contraction takes on the
CPU (one fused multiply-add per column for ``Linear``; four interleaved
chains for the slot table when C is a multiple of 4).  The one tolerance is
the slot's z-score, which ``torch.special.ndtri`` and jax's ``ndtri`` may
round one float32 ulp apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queries as jq
from repro.data.formats import AsciiFixedFormat
from repro.data.generator import make_synthetic_zipf
from repro_torch.core import queries as tq


def _query_pairs(c):
    coef = tuple(1.0 / (k + 1) for k in range(c))
    out = []
    for agg, expr, pred, having, eps in [
        ("sum", ("Linear", coef), None, None, 0.05),
        ("count", None, [("Range", 0, 0.0, 4e7)], None, 0.08),
        ("sum", ("Linear", coef), [("Range", 0, 0.0, 6e7)], ("<", 1e12), 0.05),
        ("avg", ("Column", 2), [("Range", 1, 1e6, 9e7),
                                ("Cmp", 3, "<=", 5e7)], None, 0.04),
        ("sum", ("Column", 0), [("Cmp", 0, ">", 2.5e7),
                                ("Cmp", 1, ">=", 0.0)], (">=", 3.0), 0.1),
        ("count", None, [("Cmp", 2, "==", 0.0)], None, 0.2),
    ]:
        pair = []
        for mod in (jq, tq):
            kw = dict(agg=agg, epsilon=eps, name=f"{agg}-{len(out)}")
            if expr is not None:
                kw["expr"] = getattr(mod, expr[0])(expr[1])
            if pred is not None:
                kw["pred"] = mod.And(tuple(getattr(mod, p[0])(*p[1:])
                                           for p in pred))
            if having is not None:
                kw["having"] = mod.Having(*having)
            pair.append(mod.Query(**kw))
        out.append(tuple(pair))
    return out


def test_linear_plan_matches_including_cmp_lowering():
    pairs = _query_pairs(8)
    jp = jq.linear_plan([p[0] for p in pairs], 8)
    tp = tq.linear_plan([p[1] for p in pairs], 8)
    for f in ("coeffs", "lo", "hi"):
        assert np.array_equal(getattr(tp, f), getattr(jp, f)), f


@pytest.mark.parametrize("op", ["<", "<=", ">", ">=", "=="])
@pytest.mark.parametrize("v", [0.0, -0.0, 1.5, 4e7, -3.25, 1e-30, 16777217.0])
def test_cmp_lowering_at_threshold_values(op, v):
    jplan = jq.linear_plan([jq.Query("count", pred=jq.Cmp(0, op, v))], 2)
    tplan = tq.linear_plan([tq.Query("count", pred=tq.Cmp(0, op, v))], 2)
    assert np.array_equal(tplan.lo, jplan.lo)
    assert np.array_equal(tplan.hi, jplan.hi)
    # the lowered range decides exactly like the comparison on f32 values
    # (denormal neighbours of 0 excepted: the lowering treats them as 0, the
    # flush-to-zero view of the reference's devices)
    f32 = np.float32(v)
    tiny = np.finfo(np.float32).tiny
    probe = np.asarray([np.nextafter(f32, np.float32(-np.inf)), f32,
                        np.nextafter(f32, np.float32(np.inf))], np.float32)
    probe = np.where((probe != 0) & (np.abs(probe) < tiny),
                     np.copysign(tiny, probe), probe).astype(np.float32)
    direct = tq.Cmp(0, op, v)(torch.as_tensor(probe)[:, None]).numpy()
    ranged = (probe >= tplan.lo[0, 0]) & (probe < tplan.hi[0, 0])
    assert np.array_equal(direct, ranged)


def test_unencodable_queries_raise():
    for mod in (jq, tq):
        with pytest.raises(ValueError):
            mod.linear_plan([mod.Query("sum", expr=mod.SquaredDiff(0, 1))], 2)
        with pytest.raises(ValueError):
            mod.linear_plan([mod.Query("count", pred=mod.Cmp(0, "!=", 1.0))],
                            2)
    for mod in (jq, tq):
        with pytest.raises(TypeError):
            mod.Query("sum", group_by=object())


def test_encode_slot_rows_match():
    for jqq, tqq in _query_pairs(8):
        jr = jq.encode_slot(jqq, 8, plan="holistic")
        tr = tq.encode_slot(tqq, 8, plan="holistic")
        for k, v in tr.items():
            if k == "z":
                np.testing.assert_allclose(v, jr[k], rtol=2 ** -22)
            else:
                assert np.array_equal(np.asarray(v), np.asarray(jr[k])), k


@pytest.mark.parametrize("c", [8, 16])
def test_slot_evaluate_matches_bit_for_bit(c):
    vals = make_synthetic_zipf(1024, c, seed=c)
    raw = AsciiFixedFormat(c).encode(vals)
    cols = np.array(jax.vmap(AsciiFixedFormat(c).decode_ref)(
        jnp.asarray(raw.reshape(4, 256, -1))))
    jt = jq.empty_slot_table(8, c)
    tt = tq.empty_slot_table(8, c, device="cpu")
    for s, (jqq, tqq) in enumerate(_query_pairs(c)):
        jt = jq.slot_table_set(jt, s, jq.encode_slot(jqq, c))
        tt = tq.slot_table_set(tt, s, tq.encode_slot(tqq, c))
    jt = jq.slot_table_clear(jt, 2)
    tt = tq.slot_table_clear(tt, 2)
    for f in tq.SlotTable._fields:
        if f == "z":
            continue
        assert np.array_equal(getattr(tt, f).numpy(),
                              np.asarray(getattr(jt, f))), f
    jx, jpr = jax.jit(jq.slot_evaluate)(jt, jnp.asarray(cols))
    tx, tpr = tq.slot_evaluate(tt, torch.as_tensor(cols))
    assert tx.shape == (8, 4, 256)
    assert np.array_equal(tpr.numpy(), np.asarray(jpr))
    assert np.array_equal(tx.numpy(), np.asarray(jx))


def test_compile_queries_matches_the_engines_evaluation():
    vals = make_synthetic_zipf(512, 16, seed=1)
    cols = np.array(AsciiFixedFormat(16).decode_ref(
        jnp.asarray(AsciiFixedFormat(16).encode(vals)))).reshape(4, 128, 16)
    pairs = _query_pairs(16)
    jev = jq.compile_queries([p[0] for p in pairs])
    tx, tpr = tq.compile_queries([p[1] for p in pairs])(torch.as_tensor(cols))
    # bit for bit against the evaluation as the reference's round runs it
    # (jitted, mapped over workers) ...
    jx, jpr = jax.jit(jax.vmap(jev, in_axes=0, out_axes=1))(
        jnp.asarray(cols))
    assert tx.shape == (6, 4, 128)
    assert np.array_equal(tpr.numpy(), np.asarray(jpr))
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    # ... and to float32 rounding against an eager call, whose matrix-vector
    # product sums the columns in another order
    ex, epr = jev(jnp.asarray(cols.reshape(-1, 16)))
    assert np.array_equal(tpr.numpy().reshape(6, -1), np.asarray(epr))
    np.testing.assert_allclose(tx.numpy().reshape(6, -1), np.asarray(ex),
                               rtol=4 * 2 ** -24)
