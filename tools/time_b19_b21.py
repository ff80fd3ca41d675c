"""Time B19 (the chunk-pair cross-Gram) and B21 (flash attention) alone
on one GPU, beside the PyTorch call that computes the same function.

    python3 tools/time_b19_b21.py

Builds the two kernels, then from CUDA-graph replays (chip_smoke's
``graph_ms``): B21 at Qwen2-0.5B's prefill (8, 512, 14/2 heads of 64),
causal, in bf16 and fp32, beside ``scaled_dot_product_attention``; B19
at the chunk shapes (ca, cb, D) below beside ``torch.mm(Ra, Rb.T)``
(TF32 off), with its byte bound and its error against a float64
product.  Then ``torch.profiler`` splits B19's device time between its
partial and reduce launches at two skinny shapes.  Ends with the card's
name and power limit.
"""
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SHAPES = ((1, 1, 896 * 151936), (1, 64, 313600), (64, 64, 313600), (16, 16, 313600),
          (37, 64, 60001), (4, 64, 313600), (3, 16, 313600))


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.maecho_gram import maecho_gram_cross

    if not torch.cuda.is_available():
        sys.exit("time_b19_b21: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(("flash_attention", "maecho_gram_cross"))
    g = torch.Generator(device="cuda").manual_seed(0)
    F = torch.nn.functional
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(8, 512, h, 64, device="cuda", generator=g).to(dt)
                   for h in (14, 2, 2))
        e = (flash_attention(q, k, v).float()
             - ref.flash_attention_ref(q, k, v).float()).abs().max().item()
        ms = cs.graph_ms(torch, lambda: flash_attention(q, k, v), 20)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sd = cs.graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20)
        print(f"B21 {dt} (8,512,14/2,64) causal: {ms:.4f} ms, sdpa {sd:.4f} ms, err {e:.3e}")
    for ca, cb, D in SHAPES:
        Ra = torch.randn(ca, D, device="cuda", generator=g)
        Rb = torch.randn(cb, D, device="cuda", generator=g)
        G64 = Ra.double() @ Rb.double().T
        e = ((maecho_gram_cross(Ra, Rb).double() - G64).abs().max() / G64.abs().max()).item()
        reps = 3 if D > 10 ** 6 else 20
        ms = cs.graph_ms(torch, lambda: maecho_gram_cross(Ra, Rb), reps)
        mm = cs.graph_ms(torch, lambda: torch.mm(Ra, Rb.T), reps)
        b = 4.0 * (ca + cb) * D / cs.HBM_BYTES * 1e3
        print(f"B19 ({ca},{cb},{D}): {ms:.4f} ms, torch.mm {mm:.4f} ms, byte bound {b:.4f}, "
              f"rel err f64 {e:.2e}")
        del Ra, Rb, G64
    for ca, cb, D in ((1, 64, 313600), (1, 1, 896 * 151936)):
        Ra = torch.randn(ca, D, device="cuda", generator=g)
        Rb = torch.randn(cb, D, device="cuda", generator=g)
        maecho_gram_cross(Ra, Rb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                maecho_gram_cross(Ra, Rb)
            torch.cuda.synchronize()
        print(f"profile ({ca},{cb},{D})")
        for ev in prof.key_averages():
            print(f"  {ev.key[:60]}: {ev.device_time_total / ev.count:.2f} us x {ev.count}")
        del Ra, Rb
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
