"""Three-term roofline of one rank's step, priced with the H100's constants
(counterpart of ``repro.roofline.analysis``, which prices a compiled HLO
module with the TPU's).

    compute_s    = Σ_dtype matmul_FLOPs_per_rank[dtype] / peak[dtype]
    memory_s     = HBM_bytes_per_rank / HBM_bw
    collective_s = Σ_collectives transported_bytes / bw(the group's link)

The terms come from :mod:`repro_torch.roofline.dispatch_walk` (the ops
one rank dispatches), not from a compiled module: bf16 and fp16 products
are priced at the tensor cores' dense peak, every other dtype at the
float32 peak outside them (the port keeps TF32 off).  Transported bytes
follow the reference's ring conventions, with ``g`` the group size the
collective names:

    all-reduce      2 · size · (g-1)/g        (reduce-scatter + all-gather)
    all-gather      size_out · (g-1)/g
    reduce-scatter  size_out · (g-1)           (input = g × output)
    all-to-all      size · (g-1)/g
    collective-permute  size

A group is charged at the slowest link it spans: NVLink when all its
ranks lie in one node (``hw.node_size`` consecutive ranks), the node's
inter-node link otherwise.  Under the production mesh's rank order
(``launch/mesh.py``: ``model`` innermost) a ``model`` group of 16 spans
two nodes of 8, and a ``data`` group strides across 16 nodes.

MODEL_FLOPS uses 6·N·D for training and 2·N·D for serving (N = real —
unpadded — parameter count, N_active for MoE), so ``useful_flops_ratio``
charges head/vocab padding, remat recompute and dispatch overhead.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.roofline.hw import H100_SXM, HWSpec

_TENSOR_CORE_DTYPES = ("torch.bfloat16", "torch.float16")


def transported_bytes(kind: str, nbytes: float, g: int) -> float:
    """One rank's transported bytes of one collective (module doc)."""
    frac = (g - 1) / max(g, 1)
    if kind == "all-reduce":
        return 2.0 * nbytes * frac
    if kind in ("all-gather", "all-to-all"):
        return nbytes * frac
    if kind == "reduce-scatter":
        return float(nbytes * (g - 1))
    if kind == "collective-permute":
        return float(nbytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_bytes(records) -> dict:
    """Transported bytes per rank by collective kind, ``count`` and
    ``total`` (the reference's keys), over ``dispatch_walk.Collective``
    records (or anything with ``kind``, ``nbytes`` and ``group_size``)."""
    out = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0, "count": 0}
    for c in records:
        out[c.kind] += transported_bytes(c.kind, c.nbytes, c.group_size)
        out["count"] += 1
    out["total"] = sum(v for k, v in out.items()
                       if k not in ("count", "total"))
    return out


def link_bw(ranks, hw: HWSpec = H100_SXM) -> float:
    """The bandwidth a group of global ``ranks`` runs at: NVLink within a
    node, the inter-node link across nodes."""
    nodes = {r // hw.node_size for r in ranks}
    return hw.nvlink_bw if len(nodes) <= 1 else hw.inter_node_bw


def collective_seconds(records, hw: HWSpec = H100_SXM) -> tuple:
    """``(seconds, {"nvlink": bytes, "inter_node": bytes})``: each
    collective's transported bytes over its group's link."""
    secs, by_link = 0.0, {"nvlink": 0.0, "inter_node": 0.0}
    for c in records:
        vol = transported_bytes(c.kind, c.nbytes, c.group_size)
        bw = link_bw(c.ranks, hw)
        secs += vol / bw
        by_link["nvlink" if bw == hw.nvlink_bw else "inter_node"] += vol
    return secs, by_link


def model_flops(arch: str, shape, n_chips: int,
                cfg=None) -> Optional[float]:
    """6·N·D (train) / 2·N·D (serve) with the *real* parameter count of
    ``cfg`` (the architecture's published config unless given); ``shape``
    is a name of ``SHAPES`` or a ``ShapeSpec``."""
    from repro_torch.configs.base import active_param_count
    from repro_torch.configs.registry import SHAPES, ShapeSpec, get_config

    cfg = cfg or get_config(arch)
    spec = shape if isinstance(shape, ShapeSpec) else SHAPES[shape]
    n = active_param_count(cfg)
    tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1)
    factor = 6.0 if spec.kind == "train" else 2.0
    return factor * n * tokens


def analyze_step(walk: dict, arch: str, shape, n_chips: int,
                 hw: HWSpec = H100_SXM, cfg=None) -> dict:
    """The reference's ``"roofline"`` dict for one rank's ``walk``
    (``DispatchWalk.summary()``), under ``analyze_lowered``'s keys.
    ``hlo_flops_per_chip`` holds the walk's matmul FLOPs and
    ``hlo_bytes_per_chip`` its HBM bytes; ``hlo_flops_raw_per_chip``
    (XLA:CPU's cost model) and ``dot_unresolved`` (unparsed loop trip
    counts) have no eager meaning and hold ``None``."""
    flops = float(walk["matmul_flops"])
    compute_s = sum(
        f / (hw.peak_flops_bf16 if dt in _TENSOR_CORE_DTYPES
             else hw.peak_flops_f32)
        for dt, f in walk["flops_by_dtype"].items())
    memory_s = walk["hbm_bytes"] / hw.hbm_bw
    collective_s, by_link = collective_seconds(walk["collectives"], hw)
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(arch, shape, n_chips, cfg)
    bound_s = max(terms.values())
    detail = dict(walk["collective"], count=walk["collective_count"])
    detail.update({f"{k}_bytes": v for k, v in by_link.items()})
    return {
        "roofline": {
            **{k: float(v) for k, v in terms.items()},
            "dominant": dominant,
            "bound_s": bound_s,
            "collective_detail": {k: float(v) for k, v in detail.items()},
            "model_flops": mf,
            "hlo_flops_per_chip": flops,
            "hlo_flops_raw_per_chip": None,
            "dot_count": walk["dot_count"],
            "dot_unresolved": None,
            "hlo_bytes_per_chip": float(walk["hbm_bytes"]),
            "useful_flops_ratio": (mf / (flops * n_chips)
                                   if (mf and flops) else None),
            # the useful model FLOPs' share of the dominant term
            "roofline_fraction": (
                (mf / n_chips / hw.peak_flops_bf16) / bound_s
                if (mf and bound_s > 0) else None),
        }
    }
