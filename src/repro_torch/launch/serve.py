"""Batched serving driver (the port of ``repro.launch.serve``): prefill
plus greedy decode with a request queue, for the dense family.

Two loops share one serve step:

* **fixed batch** (default): prefill all requests at once, decode in
  lockstep — the throughput script.

      PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \\
          --prompt-len 64 --gen 32

* **continuous batching** (``--arrival``): a pool of ``--slots`` decode
  slots; queued prompts are admitted into freed slots mid-decode (a
  batch-1 prefill written into the slot's cache rows), each slot with
  its own position, remaining budget and EOS.  One serve step runs over
  the whole slot batch with a vector of per-slot positions.

      PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \\
          --slots 4 --arrival-every 3 --arrival --check-parity --attn-backend kernel

``--no-smoke`` serves the published config (Qwen2-0.5B: bf16 compute,
the flash kernel B21 on every prefill layer and the decode kernel B22
on every decode layer and step on the card); ``--device cpu`` runs the
plain PyTorch versions of the kernels.

The serving window rounds up to the kernel block so decode attention
stays on the kernel, and both loops pass the bucketed live-window bound
(``w_live``) so a mostly-empty ring buffer is read only up to its live
slots.  Rows of the decode path are independent, so the two loops emit
the same tokens per request (``--check-parity``).  Only the dense family
is ported; the other slot families (vlm, moe) raise naming ROADMAP item
A9.  The decode cache is written in place.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.ops import DEFAULT_BLOCK
from repro_torch.models.zoo import get_model
from repro_torch.utils.device import resolve_device

# families with a dense-style {"k", "v"} ring-buffer cache (layer axis
# first, batch axis 1) — the ones the slot loop can admit into
SLOT_FAMILIES = ("dense", "vlm", "moe")


def round_window(n: int, mult: int = DEFAULT_BLOCK) -> int:
    """Smallest multiple of ``mult`` ≥ n (the kernel-eligible window)."""
    return max(mult, -(-int(n) // mult) * mult)


def live_bucket(n_live: int, window: int) -> int:
    """Power-of-two bucket (floor 2×block) covering ``n_live`` slots,
    capped at the window: the decode path's crop of the cache read."""
    b = 2 * DEFAULT_BLOCK
    while b < n_live:
        b *= 2
    return min(b, window)


def pad_kv_to_window(cache, window: int, axis: int = 2):
    """Zero-pad the ring-buffer K/V leaves of a prefill cache to the
    serving window.  Only ``"k"``/``"v"`` leaves pad; nested dicts
    recurse; other leaves keep their shapes.  Padded slots are invalid
    under the position-derived mask until decode writes them."""
    out = {}
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            out[name] = pad_kv_to_window(leaf, window, axis)
        elif name in ("k", "v") and leaf.shape[axis] < window:
            shape = list(leaf.shape)
            shape[axis] = window
            padded = leaf.new_zeros(shape)
            padded.narrow(axis, 0, leaf.shape[axis]).copy_(leaf)
            out[name] = padded
        else:
            out[name] = leaf
    return out


def _prefill_batch(cfg, prompts, gen: int):
    """(batch dict, pos0, window) for one prefill of ``prompts``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"serving the {cfg.family!r} family is not ported yet "
                                  f"(ROADMAP item A9)")
    P = prompts.shape[1]
    return {"tokens": prompts}, P, round_window(P + gen)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def run_fixed(cfg, model, params, prompts, gen: int, *, keep_logits: bool = False):
    """Lockstep fixed-batch serving of ``prompts`` (B, P) on their
    device.  Returns ``(tokens (B, gen), stats)``; with ``keep_logits``
    ``stats["logits"]`` holds each step's last logits (B, V)."""
    B = prompts.shape[0]
    batch, pos0, window = _prefill_batch(cfg, prompts, gen)
    dev = prompts.device

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch)
    cache = pad_kv_to_window(cache, window)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    kept = [logits[:, -1]] if keep_logits else None
    serve_step = model.make_serve_step(kept)
    token = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    out_tokens = [token]
    t0 = time.perf_counter()
    for t in range(gen - 1):
        pos = pos0 + t
        token, cache = serve_step(params, cache, token, pos, w_live=live_bucket(pos + 1, window))
        out_tokens.append(token)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    stats = {"t_prefill": t_prefill, "t_decode": t_decode,
             "tok_s": B * (gen - 1) / max(t_decode, 1e-9), "window": window}
    if keep_logits:
        stats["logits"] = kept
    return torch.cat(out_tokens, 1), stats


@torch.no_grad()
def run_arrival(cfg, model, params, prompts, gen: int, slots: int,
                arrival_every: int = 1, eos_id: int | None = None, *,
                keep_logits: bool = False):
    """Continuous batching: admit queued prompts into freed slots
    mid-decode.

    Request r arrives at decode step ``r * arrival_every``; a free slot
    prefills it (batch 1) and its K/V rows are written into the slot
    batch's cache.  Every decode step runs ONE serve step over all
    ``slots`` rows with per-slot positions; slots whose request finished
    idle harmlessly until re-admission overwrites their rows.  Returns
    ``(outputs: list[list[int]] per request, stats)``; with
    ``keep_logits`` ``stats["logits"][r]`` holds request r's logits (V,)
    per emitted token."""
    if cfg.family not in SLOT_FAMILIES:
        raise ValueError(f"continuous batching needs a dense-style KV cache; "
                         f"family {cfg.family!r} is not in {SLOT_FAMILIES}")
    R = prompts.shape[0]
    _, pos0_req, window = _prefill_batch(cfg, prompts[:1], gen)
    dev = prompts.device

    kept = [] if keep_logits else None
    serve_step = model.make_serve_step(kept)
    cache = model.init_cache(slots, window, device=dev)
    token = torch.zeros((slots, 1), dtype=torch.int32, device=dev)
    positions = np.zeros(slots, np.int64)
    rid_of = [-1] * slots
    remaining = [0] * slots
    outputs: list[list[int]] = [[] for _ in range(R)]
    logits_of: list[list] = [[] for _ in range(R)]
    next_req, step, decode_steps = 0, 0, 0

    _sync(dev)
    t0 = time.perf_counter()
    while next_req < R or any(remaining):
        for s in range(slots):
            if remaining[s] == 0 and next_req < R and next_req * arrival_every <= step:
                r, next_req = next_req, next_req + 1
                batch, _, _ = _prefill_batch(cfg, prompts[r:r + 1], gen)
                logits, pc = model.prefill(params, batch)
                pc = pad_kv_to_window(pc, window)
                for name in ("k", "v"):
                    cache[name][:, s] = pc[name][:, 0]
                first = int(logits[0, -1].argmax())
                outputs[r].append(first)
                logits_of[r].append(logits[0, -1])
                token[s, 0] = first
                positions[s] = pos0_req
                rid_of[s], remaining[s] = r, gen - 1
                if eos_id is not None and first == eos_id:
                    remaining[s] = 0
        if not any(remaining):
            step += 1
            continue
        wl = live_bucket(int(positions.max()) + 1, window)
        token, cache = serve_step(params, cache, token, torch.as_tensor(positions, device=dev),
                                  w_live=wl)
        tok_host = token[:, 0].cpu().numpy()
        for s in range(slots):
            if remaining[s] > 0:
                outputs[rid_of[s]].append(int(tok_host[s]))
                if keep_logits:
                    logits_of[rid_of[s]].append(kept[-1][s])
                positions[s] += 1
                remaining[s] -= 1
                if eos_id is not None and tok_host[s] == eos_id:
                    remaining[s] = 0
        step += 1
        decode_steps += 1
    _sync(dev)
    t_total = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outputs)
    stats = {"t_total": t_total, "decode_steps": decode_steps,
             "tok_s": n_tok / max(t_total, 1e-9), "window": window}
    if keep_logits:
        stats["logits"] = logits_of
    return outputs, stats


def first_mismatch(a, b, logits_a, logits_b):
    """The first token where the per-request token lists ``a`` and ``b``
    differ, as ``(request, step, top-2 gap of a's logits there, max
    |logits_a − logits_b| over that step)``, or ``None``.  ``logits_*[r][t]``
    are the (V,) logits request r's token t came from (``keep_logits``).
    The prefixes agree up to that step, so its logits came from the
    same context in both runs."""
    for r, (x, y) in enumerate(zip(a, b)):
        for t, (u, w) in enumerate(zip(x, y)):
            if u != w:
                la, lb = logits_a[r][t].float(), logits_b[r][t].float()
                top = la.topk(2).values
                return r, t, (top[0] - top[1]).item(), (la - lb).abs().max().item()
    return None


def per_request(step_logits: list) -> list:
    """``run_fixed``'s kept logits, one (B, V) per step, as one list of
    (V,) per request."""
    return [[x[i] for x in step_logits] for i in range(step_logits[0].shape[0])]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain PyTorch "
                         "versions of the kernels)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="the reduced smoke config (--no-smoke: the published one)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-backend", default=None, choices=("auto", "kernel", "oracle"),
                    help="override ModelConfig.attn_backend")
    ap.add_argument("--arrival", action="store_true",
                    help="continuous batching: admit requests mid-decode")
    ap.add_argument("--slots", type=int, default=4, help="decode slots for --arrival")
    ap.add_argument("--arrival-every", type=int, default=1,
                    help="request r arrives at decode step r*this")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--check-parity", action="store_true",
                    help="with --arrival: assert per-request tokens match the "
                         "fixed-batch run (exact for the dense family)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn_backend is not None:
        cfg = cfg.replace(attn_backend=args.attn_backend)
    dev = resolve_device(args.device)
    model = get_model(cfg)
    params = model.init_params(args.seed, device=dev)

    R, P = args.requests, args.prompt_len
    rng = np.random.RandomState(args.seed)
    prompts = torch.from_numpy(rng.randint(0, cfg.vocab, size=(R, P)).astype(np.int32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    if args.arrival:
        slots = min(args.slots, R)
        outs, stats = run_arrival(cfg, model, params, prompts, args.gen, slots=slots,
                                  arrival_every=args.arrival_every, eos_id=args.eos_id,
                                  keep_logits=args.check_parity)
        print(f"arch={cfg.name} requests={R} prompt={P} gen={args.gen} slots={slots} "
              f"window={stats['window']} arrival_every={args.arrival_every} device={dev}")
        print(f"continuous batching: {stats['decode_steps']} decode steps, "
              f"{stats['t_total']:.2f}s ({stats['tok_s']:.1f} tok/s aggregate)")
        print("sample:", outs[0][:16])
        if args.check_parity:
            fixed, fs = run_fixed(cfg, model, params, prompts, args.gen, keep_logits=True)
            m = first_mismatch(fixed.tolist(), outs, per_request(fs["logits"]),
                               stats["logits"])
            print("parity vs fixed batch: " + ("OK" if m is None else
                  "MISMATCH at request {}, step {}: top-2 logit gap {:.3e}, that step's "
                  "logits max |d| {:.3e}".format(*m)))
            if m is not None:
                raise SystemExit(1)
    else:
        gen, stats = run_fixed(cfg, model, params, prompts, args.gen)
        print(f"arch={cfg.name} requests={R} prompt={P} gen={args.gen} "
              f"window={stats['window']} device={dev}")
        print(f"prefill {stats['t_prefill']:.2f}s; decode {stats['t_decode']:.2f}s "
              f"({stats['tok_s']:.1f} tok/s aggregate)")
        print("sample:", gen[0, :16].tolist())
    if dev.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")


if __name__ == "__main__":
    main()
