"""Time the serving prefill of one checkout of the port on one GPU, to
compare two checkouts in one call: run it once per checkout, in turns
(parent, change, change, parent), each in its own process.

    python tools/compare_prefill.py --src path/to/src [--label name] [--runs 7]

Qwen2-0.5B at full width with random weights from ``--seed``, 8 requests
x prompt 512, bf16, ``attn_backend="auto"`` (B21 on every layer): the
kernels are built first, then ``launch.serve.run_fixed(..., gen=1)``
runs ``--runs`` times (the prefill alone: host clock around it, ending
in ``torch.cuda.synchronize()``, i.e. the batch's time to first token),
and one more run under ``torch.profiler`` gives the device time of B21
and of every kernel.  Prints one JSON line, with the card's name and
power limit.
"""
import argparse
import json
import pathlib
import statistics
import subprocess
import sys


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src", help="the checkout's src directory")
    ap.add_argument("--label", default="")
    ap.add_argument("--runs", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import run_fixed
    from repro_torch.models.zoo import get_model

    if not torch.cuda.is_available():
        sys.exit("compare_prefill: needs a GPU")
    build.build_all(("flash_attention", "decode_attention"))
    cfg = get_config("qwen2-0.5b")
    model = get_model(cfg)
    params = model.init_params(args.seed, device=torch.device("cuda"))
    prompts = torch.from_numpy(np.random.RandomState(args.seed).randint(
        0, cfg.vocab, (8, 512)).astype(np.int32)).cuda()
    ms = [1e3 * run_fixed(cfg, model, params, prompts, 1)[1]["t_prefill"]
          for _ in range(args.runs + 1)][1:]          # the first run warms up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_fixed(cfg, model, params, prompts, 1)
        torch.cuda.synchronize()
    events = [(ev.key, ev.device_time_total / 1e3, ev.count) for ev in prof.key_averages()]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "label": args.label, "src": args.src, "device": smi,
        "prefill_ms": ms, "median_ms": statistics.median(ms), "min_ms": min(ms),
        "profiled_device_ms": sum(t for _, t, _ in events),
        "profiled_b21_ms": sum(t for k, t, _ in events if "flash_attention" in k),
        "b21_launches": sum(c for k, _, c in events if "flash_attention" in k)}))


if __name__ == "__main__":
    main()
