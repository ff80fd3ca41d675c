"""Time chosen hand-written kernels of one checkout of the port on one
GPU, beside their plain versions and, where one exists, the PyTorch call
that computes the same function; to compare two checkouts in one call,
run it once per checkout, in turns (parent, change, change, parent),
each in its own process.

    python3 tools/time_kernels.py --kernels B16,B22 [--src path/to/src] [--label name] [--profile]

Kernels (ids of PERF.md §6) and the shapes of the main paths they run at:
B1/B4 at the paper MLP's W0 (400 x 784) and W1 (200 x 400) and the CNN's
fc0 (256 x 1024), N = 4, and at W0 with N = 64 (beside ``torch.bmm(W - V,
P)``, TF32 off), B7 and B3 at those three leaves; the factored B2, B5 and
B8 (the kernel alone, on the compressed residual) at the three leaves
with k = 78, B2 also at W0 with N = 64 (beside ``torch.bmm(A, UT)``,
their product alone); B11 (k = 89) and B12 at Qwen2-0.5B's wq; B14 and
B17 (the kernel alone) at wq and w_gate, k = 89, N = 2 (beside
``torch.bmm(A, UT)`` over N·L); B10/B13/B16 at Qwen2-0.5B's wq (24 x 896 x 896) and w_gate
(24 x 4864 x 896), N = 2, dense rank-in/2 projectors (each beside
``torch.bmm(D, P)``, their product alone, TF32 off); B19 at the chunk
shapes (ca, cb, D) beside ``torch.mm(Ra, Rb.T)``; B21 at the serving
prefill (8, 512, 14/2 heads of 64), causal, bf16 and fp32, and B22 at
the serving decode (8, W = 640, 2 kv heads, group 7, 64) filled to 576
and at W = 4096 filled to 4000, bf16, both beside
``scaled_dot_product_attention``.  Device times from CUDA-graph replays;
the kernels are built from ``--src`` first.  B1/B4, B2, B10/B13/B16 and
B17 rows carry the kernel's and the plain version's max error against
the function in float64 (``f64_err``, ``plain_f64_err``, beside
``f64_max``).  Each row carries the sha256 of the kernel's output; each
kernel's inputs come from ``--seed`` alone (not from the kernels listed
before it), so two checkouts' outputs can be compared bit for bit.
With ``--profile`` each row also carries ``kernel_us``, the device µs a
call of each CUDA kernel the kernel's wrapper launches, by name, from
``torch.profiler``.  Prints one JSON line, with the card's name and power
limit.
"""
import hashlib
import argparse
import json
import pathlib
import subprocess
import sys


def graph_ms(torch, fn, reps: int) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured into one CUDA
    graph, replayed between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_us(torch, fn, reps: int) -> dict:
    """Device µs a call of each CUDA kernel that ``fn()`` launches, by
    kernel name (``torch.profiler`` over ``reps`` calls after a warm-up
    call)."""
    import collections
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"\w+_kernel", e.name)
            per[m.group(0) if m else e.name[:60]] += e.time_range.elapsed_us() / reps
    return {k: round(v, 3) for k, v in per.items()}


def stacked_cases(torch, gen, which):
    """B10 / B13 / B16 at wq and w_gate: (name, kernel fn, plain fn,
    library fn or None, reps, float64 witness fn)."""
    from repro_torch.kernels import maecho_gram, maecho_update, maecho_v_update, ref

    for label, L, out_d, in_d, N in (("wq", 24, 896, 896, 2), ("w_gate", 24, 4864, 896, 2)):
        W = torch.randn(L, out_d, in_d, device="cuda", generator=gen) * 0.1
        V = W + torch.randn(N, L, out_d, in_d, device="cuda", generator=gen) * 0.05
        U = torch.linalg.qr(torch.randn(N, L, in_d, in_d // 2, device="cuda", generator=gen))[0]
        P = (U @ U.transpose(-1, -2)).contiguous()
        del U
        a = torch.softmax(torch.randn(L, N, device="cuda", generator=gen), -1).contiguous()
        tag = f"{label} (L={L}, {out_d}x{in_d}, N={N})"
        D = (W[None] - V).reshape(N * L, out_d, in_d)
        Pf = P.reshape(N * L, in_d, in_d)

        def witness():          # the function in float64
            R = torch.bmm(D.double(), Pf.double()).reshape(N, L, out_d, in_d)
            if which == "B10":
                return torch.einsum("iloc,jloc->lij", R, R)
            if which == "B13":
                return W.double() - torch.einsum("ln,nloi->loi", a.double(), R)
            return V.double() + (W[None] - V).double() - 20 / 21 * R

        if which == "B10":
            yield (tag, lambda: maecho_gram.maecho_gram_stacked(W, V, P),
                   lambda: ref.maecho_gram_stacked_ref(W, V, P), lambda: torch.bmm(D, Pf), 3,
                   witness)
        elif which == "B13":
            yield (tag, lambda: maecho_update.maecho_update_stacked(W, V, P, a, 0.5),
                   lambda: ref.maecho_update_stacked_ref(W, V, P, a, 0.5),
                   lambda: torch.bmm(D, Pf), 3, witness)
        else:
            yield (tag, lambda: maecho_v_update.maecho_v_update_stacked(W, V, P, 20 / 21),
                   lambda: ref.maecho_v_update_stacked_ref(W, V, P, 20 / 21),
                   lambda: torch.bmm(D, Pf), 3, witness)
        del W, V, P, D, Pf


def dense_cases(torch, gen, which):
    """B1 / B4 (and B7, B3: unstacked kernels that still run the SIMT
    templates) at the paper MLP's W0 (400 x 784) and W1 (200 x 400) and
    the CNN's fc0 (256 x 1024), N = 4, and B1 / B4 at W0 with N = 64,
    with dense rank-in/2 projectors: (name, kernel fn, plain fn, library
    fn or None, reps[, float64 witness fn]).  B1/B4/B7 beside
    ``torch.bmm(W - V, P)``, TF32 off."""
    from repro_torch.kernels import maecho_gram, maecho_update, maecho_v_update, ref

    shapes = (("W0", 400, 784, 4), ("W1", 200, 400, 4), ("fc0", 256, 1024, 4))
    if which in ("B1", "B4"):
        shapes += (("W0", 400, 784, 64),)
    for label, out_d, in_d, N in shapes:
        W = torch.randn(out_d, in_d, device="cuda", generator=gen) * 0.1
        V = W + torch.randn(N, out_d, in_d, device="cuda", generator=gen) * 0.05
        U = torch.linalg.qr(torch.randn(N, in_d, in_d // 2, device="cuda", generator=gen))[0]
        P = (U @ U.transpose(-1, -2)).contiguous()
        a = torch.softmax(torch.randn(N, device="cuda", generator=gen), 0)
        tag = f"{label} ({out_d}x{in_d}, N={N})"
        D = W[None] - V
        reps = 3 if N > 4 else 20

        def witness():          # the function in float64
            R = D.double() @ P.double()
            Rf = R.reshape(N, -1)
            return Rf @ Rf.T if which == "B1" else \
                W.double() - torch.einsum("n,noi->oi", a.double(), R)

        if which == "B1":
            yield (tag, lambda: maecho_gram.maecho_gram(W, V, P),
                   lambda: ref.maecho_gram_ref(W, V, P), lambda: torch.bmm(D, P), reps,
                   witness)
        elif which == "B4":
            yield (tag, lambda: maecho_update.maecho_update(W, V, P, a, 0.5),
                   lambda: ref.maecho_update_ref_any(W, V, P, a, 0.5),
                   lambda: torch.bmm(D, P), reps, witness)
        elif which == "B7":
            yield (tag, lambda: maecho_v_update.maecho_v_update(W, V, P, 20 / 21),
                   lambda: ref.maecho_v_update_ref(W, V, P, 20 / 21),
                   lambda: torch.bmm(D, P), reps)
        else:                   # B3
            p = torch.rand(N, in_d, device="cuda", generator=gen)
            yield (tag, lambda: maecho_gram.maecho_gram_diag(W, V, p),
                   lambda: ref.maecho_gram_diag_ref(W, V, p), None, reps)
        del W, V, P, D


def factored_cases(torch, gen, which):
    """B2 / B5 / B8 (the kernel alone, on the compressed residual B of W'
    and Uᵀ, here with W' = W so B = A) at the paper MLP's W0 and W1 and
    the CNN's fc0, N = 4, k = 78, and B2 at W0 with N = 64: each beside
    ``torch.bmm(A, UT)``, their product alone, TF32 off; B2 with its
    float64 witness."""
    from repro_torch.kernels import maecho_gram, maecho_update, maecho_v_update, ref

    k = 78
    shapes = (("W0", 400, 784, 4), ("W1", 200, 400, 4), ("fc0", 256, 1024, 4))
    if which == "B2":
        shapes += (("W0", 400, 784, 64),)
    for label, out_d, in_d, N in shapes:
        W = torch.randn(out_d, in_d, device="cuda", generator=gen) * 0.1
        V = W + torch.randn(N, out_d, in_d, device="cuda", generator=gen) * 0.05
        U = torch.linalg.qr(torch.randn(N, in_d, k, device="cuda", generator=gen))[0]
        s = torch.rand(N, k, device="cuda", generator=gen) * 0.9 + 0.1
        a = torch.softmax(torch.randn(N, device="cuda", generator=gen), 0)
        A = maecho_gram.compressed_residual(W, V, U, s)
        UT = U.transpose(1, 2).contiguous()
        tag = f"{label} ({out_d}x{in_d}, N={N}) k={k}"
        reps = 3 if N > 4 else 20

        def witness():          # B2's Gram in float64
            R = (A.double() @ UT.double()).reshape(N, -1)
            return R @ R.T

        if which == "B2":
            yield (tag, lambda: maecho_gram.maecho_gram_left(A, UT),
                   lambda: ref.maecho_gram_left_ref(A, UT), lambda: torch.bmm(A, UT), reps,
                   witness)
        elif which == "B5":
            yield (tag, lambda: maecho_update.maecho_update_left(W, A, UT, a, 0.5),
                   lambda: ref.maecho_update_left_ref(W, A, UT, a, 0.5),
                   lambda: torch.bmm(A, UT), reps)
        else:                   # B8
            yield (tag, lambda: maecho_v_update.maecho_v_update_left(A, UT, W, V, 20 / 21),
                   lambda: ref.maecho_v_update_left_ref(A, UT, W, V, 20 / 21),
                   lambda: torch.bmm(A, UT), reps)
        del W, V, U, A, UT


def stacked_left_cases(torch, gen, which):
    """B14 and B17 (the kernel alone, on the compressed residual B of W'
    and Uᵀ, here with W' = W so B = A) at Qwen2-0.5B's wq (24 x 896 x 896)
    and w_gate (24 x 4864 x 896), N = 2, k = 89, each beside
    ``torch.bmm(A, UT)`` over N·L, their product alone, TF32 off; B17
    with its float64 witness."""
    from repro_torch.kernels import maecho_gram, maecho_update, maecho_v_update, ref

    k = 89
    for label, L, out_d, in_d, N in (("wq", 24, 896, 896, 2), ("w_gate", 24, 4864, 896, 2)):
        W = torch.randn(L, out_d, in_d, device="cuda", generator=gen) * 0.1
        V = W + torch.randn(N, L, out_d, in_d, device="cuda", generator=gen) * 0.05
        U = torch.linalg.qr(torch.randn(N, L, in_d, k, device="cuda", generator=gen))[0]
        s = torch.rand(N, L, k, device="cuda", generator=gen) * 0.9 + 0.1
        a = torch.softmax(torch.randn(L, N, device="cuda", generator=gen), -1).contiguous()
        A = maecho_gram.compressed_residual(W, V, U, s)
        UT = U.transpose(-1, -2).contiguous()
        Af, UTf = A.reshape(N * L, out_d, k), UT.reshape(N * L, k, in_d)
        tag = f"{label} (L={L}, {out_d}x{in_d}, N={N}) k={k}"

        def witness():          # B17 in float64
            return V.double() + (W[None] - V).double() - 20 / 21 * (A.double() @ UT.double())

        if which == "B14":
            yield (tag, lambda: maecho_update.maecho_update_left_stacked(W, A, UT, a, 0.5),
                   lambda: ref.maecho_update_left_stacked_ref(W, A, UT, a, 0.5),
                   lambda: torch.bmm(Af, UTf), 3)
        else:                   # B17
            yield (tag, lambda: maecho_v_update.maecho_v_update_left_stacked(A, UT, W, V, 20 / 21),
                   lambda: ref.maecho_v_update_left_stacked_ref(A, UT, W, V, 20 / 21),
                   lambda: torch.bmm(Af, UTf), 3, witness)
        del W, V, U, A, UT, Af, UTf


def stacked_simt_cases(torch, gen, which):
    """B11 (factored, k = 89) and B12 (diagonal), the stacked Grams that
    still run the SIMT templates, at Qwen2-0.5B's wq (24 x 896 x 896),
    N = 2; B11 beside ``torch.bmm(A, UT)``."""
    from repro_torch.kernels import maecho_gram, ref

    L, out_d, in_d, N, k = 24, 896, 896, 2, 89
    W = torch.randn(L, out_d, in_d, device="cuda", generator=gen) * 0.1
    V = W + torch.randn(N, L, out_d, in_d, device="cuda", generator=gen) * 0.05
    tag = f"wq (L={L}, {out_d}x{in_d}, N={N})"
    if which == "B11":
        U = torch.linalg.qr(torch.randn(N, L, in_d, k, device="cuda", generator=gen))[0]
        s = torch.rand(N, L, k, device="cuda", generator=gen) * 0.9 + 0.1
        A = maecho_gram.compressed_residual(W, V, U, s)
        UT = U.transpose(-1, -2).contiguous()
        Af, UTf = A.reshape(N * L, out_d, k), UT.reshape(N * L, k, in_d)
        yield (f"{tag} k={k}", lambda: maecho_gram.maecho_gram_left_stacked(A, UT),
               lambda: ref.maecho_gram_left_stacked_ref(A, UT), lambda: torch.bmm(Af, UTf), 5)
    else:
        p = torch.rand(N, L, in_d, device="cuda", generator=gen)
        yield (tag, lambda: maecho_gram.maecho_gram_diag_stacked(W, V, p),
               lambda: ref.maecho_gram_diag_stacked_ref(W, V, p), None, 5)


def cross_cases(torch, gen):
    from repro_torch.kernels import maecho_gram, ref

    for ca, cb, D in ((1, 1, 896 * 151936), (1, 64, 313600), (64, 64, 313600),
                      (16, 16, 313600), (37, 64, 60001)):
        Ra = torch.randn(ca, D, device="cuda", generator=gen)
        Rb = torch.randn(cb, D, device="cuda", generator=gen)
        yield (f"({ca}, {cb}, {D})", lambda: maecho_gram.maecho_gram_cross(Ra, Rb),
               lambda: ref.maecho_gram_cross_ref(Ra, Rb), lambda: torch.mm(Ra, Rb.T),
               3 if D > 10 ** 6 else 20)


def flash_cases(torch, gen):
    from repro_torch.kernels import flash_attention, ref

    F = torch.nn.functional
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(8, 512, h, 64, device="cuda", generator=gen).to(dt)
                   for h in (14, 2, 2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        yield (f"(8, 512, 14/2, 64) causal {dt}",
               lambda: flash_attention.flash_attention(q, k, v),
               lambda: ref.flash_attention_ref(q, k, v),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True), 20)


def decode_cases(torch, gen):
    from repro_torch.kernels import decode_attention, ref

    F = torch.nn.functional
    for W, fill in ((640, 576), (4096, 4000)):
        q = torch.randn(8, 1, 14, 64, device="cuda", generator=gen).bfloat16()
        kc, vc = (torch.randn(8, W, 2, 64, device="cuda", generator=gen).bfloat16()
                  for _ in range(2))
        idx = torch.arange(W, device="cuda")
        last = (fill - 1) - torch.remainder(fill - 1 - idx, W)
        mask = ((last >= 0) & (last > fill - 1 - W)).expand(8, W)
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        am = mask[:, None, None, :]
        yield (f"(8, {W}, 2, group 7, 64) fill {fill} bf16",
               lambda: decode_attention.decode_attention(q, kc, vc, mask),
               lambda: ref.decode_attention_ref(q, kc, vc, mask),
               lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                                      enable_gqa=True), 50)


CASES = {"B1": ("maecho_gram", lambda t, g: dense_cases(t, g, "B1")),
         "B2": ("maecho_gram_left", lambda t, g: factored_cases(t, g, "B2")),
         "B3": ("maecho_gram_diag", lambda t, g: dense_cases(t, g, "B3")),
         "B4": ("maecho_update", lambda t, g: dense_cases(t, g, "B4")),
         "B5": ("maecho_update_left", lambda t, g: factored_cases(t, g, "B5")),
         "B7": ("maecho_v_update", lambda t, g: dense_cases(t, g, "B7")),
         "B8": ("maecho_v_update_factored", lambda t, g: factored_cases(t, g, "B8")),
         "B10": ("maecho_gram_stacked", lambda t, g: stacked_cases(t, g, "B10")),
         "B11": ("maecho_gram_left_stacked", lambda t, g: stacked_simt_cases(t, g, "B11")),
         "B12": ("maecho_gram_diag_stacked", lambda t, g: stacked_simt_cases(t, g, "B12")),
         "B13": ("maecho_update_stacked", lambda t, g: stacked_cases(t, g, "B13")),
         "B14": ("maecho_update_left_stacked", lambda t, g: stacked_left_cases(t, g, "B14")),
         "B16": ("maecho_v_update_stacked", lambda t, g: stacked_cases(t, g, "B16")),
         "B17": ("maecho_v_update_factored_stacked",
                 lambda t, g: stacked_left_cases(t, g, "B17")),
         "B19": ("maecho_gram_cross", cross_cases),
         "B21": ("flash_attention", flash_cases),
         "B22": ("decode_attention", decode_cases)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", default="B16,B22",
                    help="comma-separated ids, of " + ",".join(CASES))
    ap.add_argument("--src", default="src", help="the checkout's src directory")
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="add each row's device µs by CUDA kernel (torch.profiler)")
    args = ap.parse_args()
    ids = [k.strip() for k in args.kernels.split(",") if k.strip()]
    unknown = [k for k in ids if k not in CASES]
    if unknown:
        sys.exit(f"time_kernels: unknown kernel ids {unknown}, know {sorted(CASES)}")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("time_kernels: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(tuple(dict.fromkeys(CASES[k][0] for k in ids)))
    rows = []
    for kid in ids:     # each kernel's inputs from its own stream: digests compare across lists
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        for tag, k_fn, p_fn, lib_fn, reps, *witness in CASES[kid][1](torch, gen):
            got, want = k_fn(), p_fn()
            err = (got.float() - want.float()).abs().max().item()
            digest = hashlib.sha256(got.contiguous().cpu().numpy().tobytes()).hexdigest()
            if witness:         # kernel's and plain version's max error against float64
                w64 = witness[0]()
                f64 = {"f64_err": (got.double() - w64).abs().max().item(),
                       "plain_f64_err": (want.double() - w64).abs().max().item(),
                       "f64_max": w64.abs().max().item()}
                del w64
            else:
                f64 = {}
            rows.append({"kernel": kid, "case": tag, "max_abs_err": err, "out_sha256": digest,
                         **f64,
                         "ms": graph_ms(torch, k_fn, reps),
                         "plain_ms": graph_ms(torch, p_fn, reps),
                         "library_ms": graph_ms(torch, lib_fn, reps) if lib_fn else None,
                         **({"kernel_us": profile_us(torch, k_fn, reps)} if args.profile
                            else {})})
            print(f"[time_kernels] {args.label} {kid} {tag}: {rows[-1]}", file=sys.stderr)
            del got, want
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"label": args.label, "src": args.src, "device": smi, "rows": rows}))


if __name__ == "__main__":
    main()
