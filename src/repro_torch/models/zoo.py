"""Uniform model API (the port of ``repro.models.zoo``) for the dense
family; the other families (MoE, SSM, hybrid, encoder-decoder, VLM)
raise ``NotImplementedError`` naming ROADMAP item A9.

``get_model(cfg)`` returns a :class:`ModelAPI` with

  init_params(seed, device)         -> params pytree (device None: CUDA)
  forward(params, batch)            -> logits
  loss_fn(params, batch)            -> scalar
  prefill(params, batch)            -> (last logits, decode cache)
  init_cache(batch, window, device) -> zero decode cache (device None: CUDA)
  decode_step(params, cache, token, position, w_live=)
                                    -> (logits, cache written in place)
  input_specs(shape)                -> the inputs as meta tensors
  make_train_step(optimizer)        -> an autograd train step
  make_serve_step()                 -> a greedy one-token serve step
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

    def prefill(self, params, batch):
        """(last_logits, decode_cache) over the full prompt."""
        return self.mod.prefill(self.cfg, params, batch)

    def init_cache(self, batch: int, window: int, device=None):
        return self.mod.init_cache(self.cfg, batch, window, resolve_device(device))

    def decode_step(self, params, cache, token, position, *, w_live: int | None = None):
        """One token per row; the cache is written in place.  ``w_live``
        is the serving loop's bucketed bound on written ring-buffer
        slots (the cropped decode path)."""
        return self.mod.decode_step(self.cfg, params, cache, token, position, w_live=w_live)

    def cache_specs(self, batch: int, window: int) -> dict:
        """The decode cache as meta tensors (shape and dtype, no storage)."""
        return self.mod.init_cache(self.cfg, batch, window, torch.device("meta"))

    def input_specs(self, shape: InputShape) -> dict:
        """Meta-device stand-ins (shape and dtype, no storage) for every
        input of ``shape``: a train or prefill batch, or one decode step
        (a token per row against a cache of ``decode_window(shape)``
        slots)."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind in ("train", "prefill"):
            spec = torch.empty((B, S), dtype=torch.int32, device="meta")
            return {"tokens": spec, "labels": spec.clone()}
        return {"token": torch.empty((B, 1), dtype=torch.int32, device="meta"),
                "position": torch.empty((), dtype=torch.int32, device="meta"),
                "cache": self.cache_specs(B, self.decode_window(shape))}

    def decode_window(self, shape: InputShape) -> int:
        """KV window for a decode shape: the full sequence up to 64k,
        the sliding ``cfg.window`` beyond."""
        return self.cfg.window if shape.seq_len > 65536 else shape.seq_len

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

    def make_serve_step(self, keep_logits: list | None = None) -> Callable:
        """``serve_step(params, cache, token, position, w_live=None) ->
        (next_token (B, 1) int32, cache)``: one greedy decode step.
        When ``keep_logits`` is a list, each step appends its last
        logits (B, V) to it (for diagnosing a token mismatch)."""
        def serve_step(params, cache, token, position, w_live=None):
            logits, cache = self.decode_step(params, cache, token, position, w_live=w_live)
            if keep_logits is not None:
                keep_logits.append(logits[:, -1])
            return logits[:, -1].argmax(-1)[:, None].to(torch.int32), cache
        return serve_step


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP item A9)")
    return ModelAPI(cfg, _FAMILY[cfg.family])
