"""Cross-silo LLM fine-tuning + MA-Echo aggregation on the PyTorch/CUDA
port (the port of ``examples/llm_finetune_aggregate.py``).

Two silos fine-tune the same qwen2-0.5b checkpoint (random weights from
a seeded generator) on different synthetic token distributions (AdamW
1e-3, 60 steps of 8×64 tokens); the server aggregates with layer-wise
projection matrices captured by the feature probe — including the diag
token-support rule on the embedding — and the perplexity of each silo,
FedAvg and MA-Echo is printed on both domains.

  PYTHONPATH=src python examples/llm_finetune_aggregate_torch.py --device cpu
  PYTHONPATH=src python examples/llm_finetune_aggregate_torch.py --full   # on the GPU

The default is the reduced smoke config; ``--full`` runs the published
config (24 layers, d_model 896, vocab 151 936).  Both run
``attn_backend="oracle"`` (the flash-attention kernel B21 has no
backward).  At full width the stacked transformer leaves aggregate through the hand-written
CUDA kernels B10/B13/B16 and B12/B15/B18 and the embedding through
B3/B6/B9.
"""
import argparse
import math

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.aggregators import fedavg
from repro_torch.core.maecho import MAEchoConfig
from repro_torch.data.synthetic import lm_token_batches
from repro_torch.fl.llm_adapter import aggregate_llm, build_projections
from repro_torch.models.zoo import get_model
from repro_torch.optim.optimizers import adamw
from repro_torch.utils.device import resolve_device


def to_device(batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def finetune(model, params, vocab, dev, *, seed, steps=60, batch=8, seq=64):
    opt = adamw(1e-3)
    state = opt.init(params)
    step_fn = model.make_train_step(opt)
    for t, b in enumerate(lm_token_batches(vocab, batch, seq, steps, seed=seed)):
        params, state, loss = step_fn(params, state, to_device(b, dev), t)
    return params, float(loss)


@torch.no_grad()
def ppl(model, params, vocab, dev, seed, n=5):
    tot = sum(float(model.loss_fn(params, to_device(b, dev)))
              for b in lm_token_batches(vocab, 8, 64, n, seed=seed))
    return math.exp(tot / n)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--full", action="store_true",
                    help="the published qwen2-0.5b config instead of the smoke one")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    # the fine-tune runs the plain attention: B21 has no backward
    cfg = (get_config if args.full else get_smoke_config)("qwen2-0.5b").replace(
        attn_backend="oracle")
    model = get_model(cfg)
    base = model.init_params(0, device=dev)

    # two silos: different token "domains" (different markov seeds)
    silos, projs = [], []
    for i, dom in enumerate((101, 202)):
        p, loss = finetune(model, base, cfg.vocab, dev, seed=dom)
        print(f"silo {i}: final local loss {loss:.3f}")
        probe = list(lm_token_batches(cfg.vocab, 8, 64, 2, seed=dom))
        silos.append(p)
        projs.append(build_projections(cfg, p, probe))

    candidates = {
        "fedavg": fedavg(silos),
        "maecho": aggregate_llm(cfg, silos, projs,
                                MAEchoConfig(tau=15, eta=0.5, mu=20.0), device=dev),
    }
    print(f"{'model':10s} {'ppl@dom0':>9s} {'ppl@dom1':>9s}")
    for i, p in enumerate(silos):
        print(f"silo{i:<6d} {ppl(model, p, cfg.vocab, dev, 101):9.2f} "
              f"{ppl(model, p, cfg.vocab, dev, 202):9.2f}")
    for name, p in candidates.items():
        print(f"{name:10s} {ppl(model, p, cfg.vocab, dev, 101):9.2f} "
              f"{ppl(model, p, cfg.vocab, dev, 202):9.2f}")


if __name__ == "__main__":
    main()
