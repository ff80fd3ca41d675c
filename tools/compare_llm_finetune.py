#!/usr/bin/env python3
"""The first steps of the LLM example's silo fine-tune in the reference
(``repro``, JAX) and in the port (``repro_torch``), from the same
weights: loss and global gradient norm per step, side by side.

    PYTHONPATH=src python tools/compare_llm_finetune.py [--layers 2] [--steps 5]
        [--domain 202] [--out build/compare_llm_finetune]

Qwen2-0.5B at its published width (d_model 896, d_ff 4864, vocab
151 936, bf16 compute, 2 microbatches, remat), ``attn_backend="oracle"``,
AdamW 1e-3, batches of 8 x 64 tokens from ``lm_token_batches(seed=
domain)`` — the recipe of ``chip_smoke.py``'s LLM path — with the depth
cut to ``--layers``.  Each side runs on the CPU in a process of its own,
so the port's process imports no JAX: the reference draws the weights
(``init_params(PRNGKey(0))``) and pickles them with its per-step numbers
under ``--out``; the port loads them through ``repro_torch.interop`` and
repeats the steps.  Each step takes the gradients from the model's own
train step (driven with an optimizer that hands them back), records the
loss and the global norm of the gradients, then applies AdamW.
"""
from __future__ import annotations

import argparse
import math
import pathlib
import pickle
import subprocess
import sys
import time

ARCH = "qwen2-0.5b"


def _ref_side(args, out: pathlib.Path) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.data.synthetic import lm_token_batches
    from repro.models.zoo import get_model
    from repro.optim import Optimizer, adamw

    cfg = get_config(ARCH).replace(n_layers=args.layers, attn_backend="oracle")
    model = get_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    with open(out / "init.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
    grad_step = jax.jit(model.make_train_step(Optimizer(lambda p: {},
                                                        lambda g, s, p, t: (g, s))))
    opt = adamw(args.lr)
    update = jax.jit(opt.update)
    state = opt.init(params)
    rows = []
    for t, b in enumerate(lm_token_batches(cfg.vocab, 8, 64, args.steps, seed=args.domain)):
        t0 = time.perf_counter()
        grads, _, loss = grad_step(params, {}, b, jnp.int32(t))
        gn = math.sqrt(sum(float(jnp.sum(jnp.square(g.astype(jnp.float32))))
                           for g in jax.tree_util.tree_leaves(grads)))
        params, state = update(grads, state, params, jnp.int32(t))
        rows.append((float(loss), gn, time.perf_counter() - t0))
        print(f"[ref] step {t}: loss {rows[-1][0]:.6f}, grad norm {gn:.6f}", flush=True)
    with open(out / "ref.pkl", "wb") as f:
        pickle.dump(rows, f)


def _port_side(args, out: pathlib.Path) -> None:
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_token_batches
    from repro_torch.models.zoo import get_model
    from repro_torch.optim.optimizers import Optimizer, adamw
    from repro_torch.utils import trees

    cfg = get_config(ARCH).replace(n_layers=args.layers, attn_backend="oracle")
    model = get_model(cfg)
    with open(out / "init.pkl", "rb") as f:
        params = interop.params_from_numpy(pickle.load(f), device="cpu")
    grad_step = model.make_train_step(Optimizer(lambda p: {}, lambda g, s, p, t: (g, s)))
    opt = adamw(args.lr)
    state = opt.init(params)
    rows = []
    for t, b in enumerate(lm_token_batches(cfg.vocab, 8, 64, args.steps, seed=args.domain)):
        t0 = time.perf_counter()
        grads, _, loss = grad_step(params, {}, {k: torch.from_numpy(v) for k, v in b.items()},
                                   t)
        gn = math.sqrt(sum(float((g.float() ** 2).sum()) for _, g in trees.tree_paths(grads)))
        params, state = opt.update(grads, state, params, t)
        rows.append((float(loss), gn, time.perf_counter() - t0))
        print(f"[port] step {t}: loss {rows[-1][0]:.6f}, grad norm {gn:.6f}", flush=True)
    with open(out / "port.pkl", "wb") as f:
        pickle.dump(rows, f)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--domain", type=int, default=202)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default="build/compare_llm_finetune")
    ap.add_argument("--side", choices=("ref", "port"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.side == "ref":
        return _ref_side(args, out)
    if args.side == "port":
        return _port_side(args, out)
    for side in ("ref", "port"):
        subprocess.run([sys.executable, *sys.argv, "--side", side], check=True)
    with open(out / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(out / "port.pkl", "rb") as f:
        port = pickle.load(f)
    print(f"Qwen2-0.5B width, {args.layers} layers, domain {args.domain}, AdamW {args.lr}:")
    print("step | loss ref | loss port | |dloss| | grad norm ref | grad norm port | rel dnorm "
          "| s/step ref | s/step port")
    for t, ((lr_, gr, sr), (lp, gp, sp)) in enumerate(zip(ref, port, strict=True)):
        print(f"{t} | {lr_:.6f} | {lp:.6f} | {abs(lr_ - lp):.2e} | {gr:.6f} | {gp:.6f} | "
              f"{abs(gr - gp) / gr:.2e} | {sr:.2f} | {sp:.2f}")


if __name__ == "__main__":
    main()
