"""End-to-end example: train a smollm-family model with OLA-gated ingest.

    python -m repro_torch.examples.train_with_verification [--full] [--device cpu]

Every corpus segment's raw metadata table passes the paper's verification
battery (sampled, early-terminated) before any training work is spent;
poisoned segments are rejected from their raw bytes alone.  ``--full`` uses
the real smollm-135m config (30 layers at its published widths, for the
card; the default reduced config trains a few hundred steps on the CPU).
Weights start from torch's generator, so the losses are not the JAX
example's; the gate's decisions are.
"""

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.data.corpus import SyntheticCorpus
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m", reduced=not args.full)
    tcfg = TrainerConfig(steps_per_segment=args.steps // 6 or 1, batch=4,
                         seq_len=128, max_steps=args.steps,
                         ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, tcfg, device=args.device)
    corpus = SyntheticCorpus(vocab=cfg.vocab_size, num_segments=8,
                             docs_per_segment=128, doc_len=128,
                             poison_every=3, seed=0)
    result = trainer.run(corpus)
    result.pop("state")

    print(json.dumps(result, indent=1))
    print("\ningest gate log:")
    for e in trainer.log:
        if e["event"] == "gate":
            verdict = "ADMIT" if e["admitted"] else f"REJECT({e['failed']})"
            print(f"  segment {e['segment']}: {verdict:18s} "
                  f"sampled {100 * e['tuples_ratio']:.1f}% of metadata")
    losses = [e["loss"] for e in trainer.log if e["event"] == "step"]
    if losses:
        k = max(len(losses) // 8, 1)
        print("\nloss curve:", " ".join(f"{x:.3f}" for x in losses[::k]))
    return {"result": result, "log": trainer.log}


if __name__ == "__main__":
    main()
