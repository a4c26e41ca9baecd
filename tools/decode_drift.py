"""Decode against forward at float32, in the JAX package and in the port on
the same weights, at an architecture's full width and a cut depth, on the
CPU.

The reference's model oracle (``tests/test_models.py``) holds a teacher-
forced decode to the full-sequence forward within rtol = atol = 2e-3 at a
reduced config.  This script measures the same quantity at full width for
both packages: the reference draws its weights from ``--seed``, the port
carries them (``load_reference_params``), and each model is cut to every
depth of ``--depths`` (the first layers and the shared-attention sites
among them), so that both readings share their weights at every depth.

For each depth it prints one JSON line: the oracle's ratio (max of |decode
- forward| / (2e-3 · (1 + |forward|)), <= 1 passes) and max |decode -
forward| of each package, max |logit|, and the port's forward and decode
against the reference's.  ``--reduced`` takes the config's reduced widths
instead, for a deep cut that the CPU can hold.  ``--profile`` then reads
where decode and forward part, at the deepest cut: the residual stream
entering each norm of the model (each Mamba layer's, each shared site's
two, the final one), max |decode - forward| / max |forward| in each
package, the reference run op by op (``jax.disable_jit``) so that its
norms can be read.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/decode_drift.py \\
        --arch zamba2-1.2b --depths 6,12

Memory is about 8 bytes a parameter of the deepest cut (float32 weights
in both packages), so a full-width run is cut in depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_config
from repro.models import build_model as j_build
from repro.models import layers as j_layers
from repro_torch.configs import get_config as t_config
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as t_layers
from repro_torch.models.convert import load_reference_params

TOL = 2e-3


def cut(params, cfg, depth: int):
    """The reference tree of the model's first ``depth`` layers."""
    out = dict(params)
    out["layers"] = jax.tree.map(lambda a: a[:depth], params["layers"])
    if "site_proj" in params:
        sites = len(range(cfg.shared_attn_every - 1, depth,
                          cfg.shared_attn_every))
        out["site_proj"] = params["site_proj"][:sites]
    return out


def oracle(full: np.ndarray, dec: np.ndarray) -> tuple:
    d = np.abs(dec.astype(np.float64) - full)
    return (float((d / (TOL * (1 + np.abs(full)))).max()), float(d.max()))


def j_run(jm, params, toks: np.ndarray):
    full = np.asarray(jm.forward(params, jnp.asarray(toks)))
    step = jax.jit(jm.decode_step)
    cache = jm.init_cache(toks.shape[0], 64, dtype=jnp.float32)
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = step(params, cache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.full((toks.shape[0],), t, jnp.int32))
        outs.append(np.asarray(logits[:, 0]))
    return full, np.stack(outs, 1)


@torch.no_grad()
def t_run(tm, toks: np.ndarray):
    tt = torch.as_tensor(toks)
    full = tm.forward(tt).numpy()
    cache = tm.init_cache(toks.shape[0], 64, dtype=torch.float32)
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = tm.decode_step(cache, tt[:, t:t + 1], torch.full(
            (toks.shape[0],), t, dtype=torch.int32))
        outs.append(logits[:, 0].numpy())
    return full, np.stack(outs, 1)


class NormInputs:
    """Inside ``with``: the input of every call of ``module.rms_norm``, in
    order (float64 numpy)."""

    def __init__(self, module):
        self.module, self.calls = module, []

    def __enter__(self):
        real = self.real = self.module.rms_norm

        def spy(x, w, *a, **k):
            self.calls.append(np.asarray(
                x.detach() if isinstance(x, torch.Tensor) else x, np.float64))
            return real(x, w, *a, **k)

        self.module.rms_norm = spy
        return self.calls

    def __exit__(self, *exc):
        self.module.rms_norm = self.real


def gaps(run, module) -> list:
    """max |decode - forward| / max |forward| of each norm's input, from
    ``run(record) -> None``, which calls ``record("forward")`` before the
    forward and ``record("decode")`` before each decode step."""
    seen = {"forward": [], "decode": []}
    with NormInputs(module) as calls:
        def record(kind):
            seen[kind].append(len(calls))
        run(record)
        ends = seen["forward"][1:] + seen["decode"] + [len(calls)]
    fwd = calls[seen["forward"][0]:ends[0]]
    steps = [calls[a:b] for a, b in zip(seen["decode"], ends[1:])]
    out = []
    for i, f in enumerate(fwd):
        d = np.concatenate([st[i] for st in steps], 1)
        out.append(float(np.abs(d - f).max() / np.abs(f).max()))
    return out


def profile(jm, params, tm, toks: np.ndarray) -> dict:
    def j_rec(record):
        with jax.disable_jit():
            record("forward")
            jm.forward(params, jnp.asarray(toks))
            cache = jm.init_cache(toks.shape[0], 64, dtype=jnp.float32)
            for t in range(toks.shape[1]):
                record("decode")
                _, cache = jm.decode_step(
                    params, cache, jnp.asarray(toks[:, t:t + 1]),
                    jnp.full((toks.shape[0],), t, jnp.int32))

    @torch.no_grad()
    def t_rec(record):
        tt = torch.as_tensor(toks)
        record("forward")
        tm.forward(tt)
        cache = tm.init_cache(toks.shape[0], 64, dtype=torch.float32)
        for t in range(toks.shape[1]):
            record("decode")
            _, cache = tm.decode_step(cache, tt[:, t:t + 1], torch.full(
                (toks.shape[0],), t, dtype=torch.int32))

    return {"reference_gaps": gaps(j_rec, j_layers),
            "port_gaps": gaps(t_rec, t_layers)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--depths", default="6,12")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced widths (shared_attn_every "
                         "kept at the full config's)")
    ap.add_argument("--profile", action="store_true",
                    help="each norm's input, decode against forward, at "
                         "the deepest cut")
    args = ap.parse_args(argv)
    depths = sorted(int(d) for d in args.depths.split(","))
    every = j_config(args.arch).shared_attn_every
    jc = dataclasses.replace(j_config(args.arch, reduced=args.reduced),
                             num_layers=depths[-1], shared_attn_every=every,
                             compute_dtype="float32", remat=False)
    params, _ = j_build(jc).init(jax.random.PRNGKey(args.seed))
    toks = np.random.default_rng(args.seed + 1).integers(
        0, jc.vocab_size, (args.batch, args.seq)).astype(np.int32)
    for depth in depths:
        jcd = dataclasses.replace(jc, num_layers=depth)
        pd = cut(params, jc, depth)
        jfull, jdec = j_run(j_build(jcd), pd, toks)
        tcd = dataclasses.replace(t_config(args.arch, reduced=args.reduced),
                                  num_layers=depth, shared_attn_every=every,
                                  compute_dtype="float32")
        tm = t_build(tcd, device="meta")
        tm.to_empty(device="cpu")
        load_reference_params(tm, jax.tree.map(np.asarray, pd))
        tfull, tdec = t_run(tm, toks)
        extra = (profile(j_build(jcd), pd, tm, toks)
                 if args.profile and depth == depths[-1] else {})
        del tm
        jr, jd = oracle(jfull, jdec)
        tr, td = oracle(tfull, tdec)
        print(json.dumps(dict(
            arch=args.arch, d_model=jc.d_model, depth=depth,
            shape=[args.batch, args.seq], seed=args.seed,
            max_abs_logit=float(np.abs(jfull).max()),
            reference_ratio=jr, reference_max_diff=jd,
            port_ratio=tr, port_max_diff=td,
            port_vs_reference_forward=float(np.abs(tfull - jfull).max()),
            port_vs_reference_decode=float(np.abs(tdec - jdec).max()),
            **extra)), flush=True)


if __name__ == "__main__":
    main()
