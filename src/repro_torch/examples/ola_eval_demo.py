"""Beyond-paper: ε-accurate model evaluation with early termination.

    python -m repro_torch.examples.ola_eval_demo [--device cpu]

Evaluates a (reduced) LM's per-token loss over many validation shards with
the bi-level estimator: shards are chunks, examples are tuples, and the
eval stops as soon as the mean loss is pinned to ±2% — typically after a
small fraction of the eval set.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.ola_ml.eval_ola import ola_eval


def per_example_loss(model, toks: torch.Tensor) -> torch.Tensor:
    """Mean next-token loss of each example (B, S+1) -> (B,), the
    log-softmax over the padded vocabulary, as the reference's demo."""
    logits, _ = model.forward(toks[:, :-1])
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.take_along_dim(logp, toks[:, 1:, None].long(), dim=-1)[..., 0]
    return -ll.mean(dim=-1)


def eval_shards(cfg, seq: int = 64, num_shards: int = 24, seed: int = 0):
    """The demo's validation shards: ``num_shards`` of 64–128 examples of
    ``seq + 1`` random token ids."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (rng.integers(64, 128), seq + 1))
            .astype(np.int32) for _ in range(num_shards)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config("smollm-135m", reduced=True)
    model = build_model(cfg, device=args.device, seed=0)
    dev = model.embedding.device

    def loss_of(ex):
        return per_example_loss(model, torch.as_tensor(ex, device=dev))

    shards = eval_shards(cfg)
    res = ola_eval(loss_of, shards, epsilon=0.02, batch=32, seed=1,
                   device=dev)
    total = sum(len(s) for s in shards)
    print(f"estimate      : {res.estimate:.4f}  [{res.lo:.4f}, {res.hi:.4f}]")
    print(f"error ratio   : {res.error_ratio:.4f} (target 0.02)")
    print(f"examples used : {res.examples_used}/{total} "
          f"({100 * res.examples_used / total:.1f}%) across "
          f"{res.shards_used} shards")
    # exhaustive reference
    full = float(torch.cat([loss_of(s) for s in shards]).double().mean())
    print(f"exhaustive    : {full:.4f} "
          f"(bias {100 * abs(res.estimate - full) / full:.2f}%)")
    return {"result": res, "exhaustive": full, "total": total}


if __name__ == "__main__":
    main()
