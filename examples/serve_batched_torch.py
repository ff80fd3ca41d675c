"""Batched serving of an MA-Echo-aggregated model on the PyTorch/CUDA port
(the port of ``examples/serve_batched.py``).

End-to-end: two silos fine-tune, the server aggregates one-shot, and
the aggregate is served with the batched prefill + decode loop — the
"deployment" path of the framework.

  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
  PYTHONPATH=src python examples/serve_batched_torch.py --full   # on the GPU

The reference example serves ``llama3-8b``'s smoke config; that
architecture is not ported (ROADMAP item A9), so this twin uses
``qwen2-0.5b``'s (the dense family both share).  ``--full`` runs the
published Qwen2-0.5B config (24 layers, d_model 896, vocab 151 936,
bf16 compute) and serves 8 requests × prompt 512 × gen 64, where the
prefill runs the flash-attention kernel B21 and every decode step the
decode-attention kernel B22.  The fine-tune runs
``attn_backend="oracle"``: B21 has no backward, as the reference's
kernel has none.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.maecho import MAEchoConfig
from repro_torch.data.synthetic import lm_token_batches
from repro_torch.fl.llm_adapter import aggregate_llm, build_projections
from repro_torch.launch.serve import run_fixed
from repro_torch.models.zoo import get_model
from repro_torch.optim.optimizers import adamw
from repro_torch.utils.device import resolve_device


def to_device(batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain PyTorch "
                         "versions of the kernels)")
    ap.add_argument("--full", action="store_true",
                    help="the published qwen2-0.5b config instead of the smoke one")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = get_config("qwen2-0.5b") if args.full else get_smoke_config("qwen2-0.5b")
    train_cfg = cfg.replace(attn_backend="oracle")
    model = get_model(train_cfg)
    base = model.init_params(0, device=dev)

    silos, projs = [], []
    for dom in (7, 13):
        opt = adamw(1e-3)
        params, state = base, opt.init(base)
        step = model.make_train_step(opt)
        for t, b in enumerate(lm_token_batches(cfg.vocab, 4, 32, 20, seed=dom)):
            params, state, _ = step(params, state, to_device(b, dev), t)
        probe = list(lm_token_batches(cfg.vocab, 4, 32, 2, seed=dom))
        silos.append(params)
        projs.append(build_projections(train_cfg, params, probe))

    global_params = aggregate_llm(train_cfg, silos, projs,
                                  MAEchoConfig(tau=10, eta=0.5, mu=20.0), device=dev)
    print("aggregated; serving batched requests…")

    B, P, GEN = (8, 512, 64) if args.full else (4, 16, 12)
    prompts = torch.from_numpy(
        np.random.RandomState(0).randint(0, cfg.vocab, (B, P)).astype(np.int32)).to(dev)
    gen, stats = run_fixed(cfg, get_model(cfg), global_params, prompts, GEN)
    print(f"prefill {stats['t_prefill']:.3f}s; decode {stats['t_decode']:.3f}s "
          f"({stats['tok_s']:.1f} tok/s), window {stats['window']}")
    for i in range(B):
        print(f"req{i}: prompt={prompts[i, :6].tolist()}… gen={gen[i, :12].tolist()}")


if __name__ == "__main__":
    main()
