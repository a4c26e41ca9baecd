"""Training entry point (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch smollm-135m --steps 200 \
        --batch 8 --seq 256 [--reduced] [--ckpt-dir ckpts/run0] \
        [--device cpu]

Runs on the CUDA device unless ``--device`` names another.  The loop is
the OLA-gated segment trainer (``repro_torch.train.trainer``): every corpus
segment passes the paper's verification battery before consuming training
FLOPs.  Prints the trainer's result and its gate decisions as JSON, as the
reference's does.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--segments", type=int, default=6)
    ap.add_argument("--docs-per-segment", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a device failure at this step (FT demo)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.data.corpus import SyntheticCorpus
    from repro_torch.distributed.fault import FailureInjector
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch, reduced=args.reduced)
    tcfg = TrainerConfig(
        steps_per_segment=max(args.steps // args.segments, 1),
        batch=args.batch, seq_len=args.seq, ckpt_dir=args.ckpt_dir,
        max_steps=args.steps, seed=args.seed)
    injector = (FailureInjector(fail_at_steps=(args.fail_at,), kill_devices=0)
                if args.fail_at else None)
    corpus = SyntheticCorpus(vocab=cfg.vocab_size,
                             num_segments=args.segments,
                             docs_per_segment=args.docs_per_segment,
                             doc_len=max(args.seq // 2, 64), seed=args.seed)
    trainer = Trainer(cfg, tcfg, injector=injector, device=args.device)
    result = trainer.run(corpus)
    result.pop("state")
    print(json.dumps(result, indent=1))
    gates = [e for e in trainer.log if e["event"] == "gate"]
    print("gate decisions:", json.dumps(gates, indent=1))


if __name__ == "__main__":
    main()
