"""Serving entry point (counterpart of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen3-0.6b --reduced \
        --requests 8 --max-new 16 [--device cpu]

Runs on the CUDA device unless ``--device`` names another; prints the
reference's JSON summary.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.family == "encdec":
        raise SystemExit("enc-dec serving requires audio features; use the "
                         "decode cells (launch/steps.py) for whisper")
    eng = ServeEngine(cfg, batch_slots=args.slots, max_len=args.max_len,
                      seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for i in range(args.requests):
        req = Request(rid=i,
                      prompt=rng.integers(0, cfg.vocab_size,
                                          args.prompt_len).astype(np.int32),
                      max_new=args.max_new)
        reqs.append(req)
        eng.submit(req)
    t0 = time.perf_counter()
    steps = eng.run()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in reqs)
    print(json.dumps({
        "requests": len(reqs), "decode_steps": steps,
        "new_tokens": total_new, "wall_s": round(dt, 2),
        "tok_per_s": round(total_new / max(dt, 1e-9), 1),
        "all_done": all(r.done for r in reqs),
        "sample_output": [int(t) for t in reqs[0].out_tokens[:8]],
    }, indent=1))


if __name__ == "__main__":
    main()
