"""Batched serving demo: continuous batching over any decode-capable arch.

    python -m repro_torch.examples.serve_batched [--arch zamba2-1.2b] [--device cpu]

Runs reduced-config batched decode with slot refill: exercises the KV-cache
ring buffers (SWA), SSM states (hybrid) and matrix memories (xLSTM) through
the same engine.
"""

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    eng = ServeEngine(cfg, batch_slots=3, max_len=128, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8)
                    .astype(np.int32), max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    steps = eng.run()
    dt = time.perf_counter() - t0
    report = {
        "arch": args.arch, "family": cfg.family,
        "requests": len(reqs), "decode_steps": steps,
        "all_done": all(r.done for r in reqs),
        "tok_per_s": round(sum(len(r.out_tokens) for r in reqs) / dt, 1),
    }
    print(json.dumps(report, indent=1))
    for r in reqs[:3]:
        print(f"req {r.rid}: {list(r.prompt[:4])}... -> {r.out_tokens}")
    return {"report": report, "requests": reqs}


if __name__ == "__main__":
    main()
