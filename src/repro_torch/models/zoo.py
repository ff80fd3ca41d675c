"""Uniform model API (the port of ``repro.models.zoo``) for the dense
family; the other families (MoE, SSM, hybrid, encoder-decoder, VLM)
raise ``NotImplementedError`` naming ROADMAP item A9, and prefill,
decode and the serve step wait for A10.

``get_model(cfg)`` returns a :class:`ModelAPI` with

  init_params(seed, device)         -> params pytree (device None: CUDA)
  forward(params, batch)            -> logits
  loss_fn(params, batch)            -> scalar
  input_specs(shape)                -> the batch's inputs as meta tensors
  make_train_step(optimizer)        -> an autograd train step
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import dense
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.utils import trees
from repro_torch.utils.device import resolve_device

_FAMILY = {"dense": dense}


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    mod: Any

    def init_params(self, seed=0, device=None):
        """Weights from ``seed`` — an int, drawn by a generator on
        ``device`` (``None`` means CUDA), or a ``torch.Generator``, whose
        device they land on."""
        gen = (seed if isinstance(seed, torch.Generator) else
               torch.Generator(device=resolve_device(device)).manual_seed(int(seed)))
        return self.mod.init_params(self.cfg, gen)

    def forward(self, params, batch):
        return self.mod.forward(self.cfg, params, batch)

    def loss_fn(self, params, batch):
        return self.mod.loss_fn(self.cfg, params, batch)

    def input_specs(self, shape: InputShape) -> dict:
        """Meta-device stand-ins (shape and dtype, no storage) for a
        train or prefill batch of ``shape``."""
        if shape.kind not in ("train", "prefill"):
            raise NotImplementedError(
                f"{shape.kind!r} inputs need decode, which is not ported yet "
                f"(ROADMAP item A10)")
        B, S = shape.global_batch, shape.seq_len
        spec = torch.empty((B, S), dtype=torch.int32, device="meta")
        return {"tokens": spec, "labels": spec.clone()}

    def make_train_step(self, optimizer) -> Callable:
        """``train_step(params, opt_state, batch, step) -> (params,
        opt_state, loss)``: one autograd step, with the gradients of
        ``cfg.microbatches`` equal slices of the batch summed in fp32 and
        averaged, then ``optimizer.update``.  ``batch`` holds tensors on
        the parameters' device."""
        n_micro = self.cfg.microbatches

        def train_step(params, opt_state, batch, step):
            leaves, treedef = trees.tree_flatten(params)
            leaves = [p.detach().requires_grad_(True) for p in leaves]
            params = trees.tree_unflatten(treedef, leaves)
            micro = ([batch] if n_micro <= 1 else
                     [{k: v.chunk(n_micro, 0)[j] for k, v in batch.items()}
                      for j in range(n_micro)])
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = torch.zeros((), device=leaves[0].device)
            for mb in micro:
                lm = self.loss_fn(params, mb)
                for acc, g in zip(grads, torch.autograd.grad(lm, leaves)):
                    acc += g.float()
                loss += lm.detach()
            grads = trees.tree_unflatten(treedef, [g / len(micro) for g in grads])
            params = trees.tree_unflatten(treedef, [p.detach() for p in leaves])
            params, opt_state = optimizer.update(grads, opt_state, params, step)
            return params, opt_state, loss / len(micro)

        return train_step


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP item A9)")
    return ModelAPI(cfg, _FAMILY[cfg.family])
