"""XLA's memory analysis of the reference's step beside the port's walk of
the same step, on the CPU.

The reference's dry run reads ``compiled.memory_analysis()``: argument,
output and temporary bytes and the peak of XLA's buffer assignment.  The
port's dry run counts live bytes at the dispatcher
(``roofline/dispatch_walk.py``).  This script compiles the reference's
loss and gradient of a reduced architecture (as
``tests/test_torch_roofline.py`` does for its FLOP and memory tests),
walks the port's same step on the meta device, and prints one JSON line
with both sets of numbers.  XLA fuses ops and reuses buffers by its own
schedule, so the two peaks are read side by side, not held to each
other; ``output_size_in_bytes`` also counts the result tuple's index
table, 8 bytes a result.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/xla_memory.py \\
        --arch smollm-135m --batch 2 --seq 64
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import torch


def reference(arch: str, b: int, s: int) -> dict:
    from repro.configs.registry import get_config
    from repro.models import build_model

    model = build_model(get_config(arch, reduced=True))
    params = jax.eval_shape(lambda k: model.init(k)[0],
                            jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((b, s), jnp.int32)
    mem = jax.jit(jax.value_and_grad(lambda p, bt: model.loss(p, bt))).lower(
        params, {"tokens": toks, "labels": toks}).compile().memory_analysis()
    return {k: getattr(mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "peak_memory_in_bytes")}


def port(arch: str, b: int, s: int, granule: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.convert import tree_from_module
    from repro_torch.models.model_zoo import build_model
    from repro_torch.roofline.dispatch_walk import DispatchWalk
    from repro_torch.train.train_step import value_and_grad

    model = build_model(get_config(arch, reduced=True), device="meta")
    params = tree_from_module(model)
    batch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    with DispatchWalk(hold=(params, batch), granule=granule) as w:
        value_and_grad(model.loss_fn, params, batch)
    return w.memory()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--granule", type=int, default=1)
    a = ap.parse_args(argv)
    print(json.dumps({"arch": a.arch, "batch": a.batch, "seq": a.seq,
                      "xla": reference(a.arch, a.batch, a.seq),
                      "port": port(a.arch, a.batch, a.seq, a.granule)}))


if __name__ == "__main__":
    main()
