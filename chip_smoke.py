#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and hold each against
   its plain PyTorch version on the card: the dense-projector kernels
   B1 (Gram), B4 (Eq. 7) and B7 (Eq. 11) at both paper-MLP kernel
   leaves (N = 4) and a multi-tile ragged shape (1000 x 1100, N = 8);
   the factored-projector kernels B2, B5 and B8 at both leaves with
   rank k ∈ {78, 196} and on the ragged shape with k = 150.  B7 and B8
   run with the row-norm off and on.  Each kernel and its plain
   version are timed at the MLP's leaves with CUDA events around a
   CUDA graph of 50 calls (device time; at these small shapes a
   back-to-back loop of wrapper calls would measure the host).  B8 is
   timed as its kernel alone, on the compressed residual B and Uᵀ, and
   as its wrapper, which forms B with a torch GEMM first.  The
   diagonal-projector kernels B3 (Gram), B6 (Eq. 7) and B9 (Eq. 11)
   run at both leaves (N = 4) and on the ragged shape with a
   non-uniform diagonal in [0, 1], B9 with the row-norm off and on.
2. The dense main path, through the user entry points: the full-width
   paper MLP on a 4-client Dirichlet(0.05) split of the synthetic
   MNIST, local training, projector estimation, FedAvg, and one-shot
   MA-Echo on ``backend="kernel"`` (τ = 30).  B1/B4/B7 must launch 60
   times each (2 kernel leaves × τ) and no other kernel, MA-Echo must
   beat both the best client and FedAvg by 0.05 test accuracy, and a
   τ = 5 kernel aggregate must match a τ = 5 ``backend="oracle"``
   aggregate to 1e-3.
3. The factored path (paper Table 6): the same clients' projectors
   factored on the card by ``factor_projection_tree(p, 78)``, then the
   same aggregates.  B2/B5/B8 must launch 60 times each and no other
   kernel (no silent dense restore), factored MA-Echo must beat the
   best client and FedAvg by 0.05, and the τ = 5 kernel and oracle
   aggregates must agree to 1e-3.
4. The scalar-projector path: ``maecho_aggregate(projections=None,
   backend="kernel")`` on the same clients at τ = 5 (the default
   scalar rule, broadcast to diagonals on W0/W1).  B3/B6/B9 must launch
   10 times each (2 × τ) and no other kernel, and the aggregate must
   match the τ = 5 oracle aggregate to 1e-3.  Its accuracy is printed,
   not checked (the scalar rule is a consensus pull; the paper claims
   nothing for it).
5. The paper CNN (conv 32-64-64, fc 1024-256-128-10) at full width on
   the synthetic CIFAR-10, 4 clients, Dirichlet(0.05), the MLP's local
   recipe, the clients' dense projectors (conv ones on the im2col
   patches).  B1/B4/B7 must launch 60 times each on fc0 and fc1 in the
   τ = 30 aggregate (the convs and fc2 are below one tile and run the
   oracle) and no other kernel, and the τ = 5 kernel and oracle
   aggregates must agree to 1e-3.  The clients', FedAvg's and
   MA-Echo's accuracies are printed, not checked.
6. The stacked kernels (one launch for every layer of a scan-stacked
   leaf) against their plain versions: B10 (Gram), B13 (Eq. 7), B16
   (Eq. 11) with dense projectors and B12/B15/B18 with diagonal ones, on
   a ragged leaf (L = 3, 200 x 300, N = 5; B16/B18 with the row-norm off
   and on) and at Qwen2-0.5B's full-width leaves (L = 24, N = 2): wq
   (896 x 896) and w_gate (4864 x 896 in the kernel layout) for the dense
   kernels, wo (896 x 896) and w_down (896 x 4864) for the diagonal ones,
   each timed with its plain version from CUDA-graph replays (fewer
   calls per graph where one call takes milliseconds).
7. The cross-silo LLM path (``examples/llm_finetune_aggregate_torch.py``
   at full width): Qwen2-0.5B (arXiv:2407.10671; 24 layers, d_model 896,
   vocab 151 936, random weights from a seeded generator,
   ``attn_backend="oracle"``), two silos fine-tuned with AdamW 1e-3 for
   60 steps of 8 x 64 tokens on the token domains 101 and 202, their
   projectors from two probe batches each, and ``aggregate_llm(...,
   backend="kernel")`` at τ = 15, timed, with its peak device memory.
   B10/B13/B16 must launch 5·τ times (wq, wk, wv, w_gate, w_up),
   B12/B15/B18 2·τ (wo, w_down on the scalar rule), B3/B6/B9 τ (the
   embedding's token-support diagonal) and no other kernel; the τ = 5
   kernel and oracle aggregates must agree to 1e-3 on every leaf, every
   output leaf must be finite, and the perplexities of both silos,
   FedAvg and MA-Echo on both domains (printed) must be finite.

Added with the stacked factored kernels and the Gram kernels' client
blocking (run right after phase 6, in this order, except 10 and 11,
which follow phase 7):

8. B11 (Gram), B14 (Eq. 7) and B17 (Eq. 11) for factored projectors of
   a stacked leaf against their plain versions on a ragged leaf (L = 3,
   200 x 300, k = 40, N = 5; B17 with the row-norm off and on) and at
   Qwen2-0.5B's wq (24 x 896 x 896) and w_gate (24 x 4864 x 896) with
   k = 89 and N = 2, timed there from CUDA-graph replays (B17 as its
   kernel alone and as its wrapper).
9. Past 54 clients: B1, B2, B3, B10, B11 and B12 against their plain
   versions and a float64 Gram at N = 55, 64 and 128 on a W0-sized leaf
   (400 x 784; L = 2 for the stacked ones; rank 78), each bitwise
   reproducible, timed at
   N = 4, 55, 64 and 128; B1-B3 at N = 4 printed beside run Q's (PERF.md
   §6); the largest workspace printed.  Then a dense-projector aggregate
   of 64 synthetic clients at the paper MLP's shapes: B1/B4/B7 launch
   2·τ times at τ = 5, and kernel and oracle agree to 1e-3.
10. The LLM path's silos with every dense (24, 896, 896) projector
   factored layer by layer at k = 89 (``factor_projection``):
   ``aggregate_llm`` at τ = 15 (timed, peak memory), B11/B14/B17 5·τ
   times, B12/B15/B18 2·τ, B3/B6/B9 τ, no other kernel (B10/B13/B16
   never), kernel vs oracle at τ = 5 within 1e-3, finite perplexities.
11. The reference's ``bench_stacked_agg`` factored case (N = 4, one
   (L, 512, 512) leaf, k = 32, τ = 2) at L = 2 and 16: kernel vs oracle
   within 1e-3, and each of B11/B14/B17 launched once per outer
   iteration, whatever L is.

Added with client chunking (``MAEchoConfig.client_chunk``), B19 and B20
(12 and 13 right after phase 9, 14 after them, 15 right after 10):

12. B19 (the chunk-pair cross-Gram) against its plain version and a
   float64 product at (ca, cb, D) = (64, 64, 400·784), (64, 64,
   4864·896), (37, 64, 60 001), (1, 64, 313 600), the LLM embedding's
   chunk-1 pair (1, 1, 896·151 936) and (16, 16, 400·784), bitwise
   reproducible and exactly symmetric on a diagonal block; B20 (the
   block-RLS downdate) at (d, b) = (512, 64), (784, 128) and (896, 128)
   against its plain version and float64 within 1e-3.  Both timed from
   CUDA-graph replays with their plain versions, B19 beside
   ``torch.mm(Ra, Rb.T)`` and B20 beside the two-call chain
   ``torch.addmm(Q, U @ A, U.T, alpha=-1)``.  Then the dense phase's
   first 2048 training inputs (row-normalised, as
   ``compute_projections`` feeds W0) through ``ops.block_rls_update``
   block by block: B20 launches once per 128-row block, no other kernel,
   and the projector equals ``null_projector_from_features`` to 1e-3.
13. The reference's ``bench_largeN_agg`` grid: one factored leaf
   (256 x 256, rank 16), N ∈ {8, 64, 128, 512}, one Gram + apply at a
   uniform α, chunked at 64 through B19 against the unchunked plain
   route (G within 1e-5·max|G|, W' and V' within 1e-3), each with its
   device memory peak above inputs and outputs: the chunked peak at
   N = 512 at most 1.25x its N = 128 peak (O(chunk)), the unchunked one
   at least 3x (O(N)); N = 4096 at 32 x 32 (rank 8), chunked only; the
   QP at N = 512 (200 iterations) and 4096 (30) with a tenth of the
   clients masked out, timed, with its memory peak above G, α within
   1e-5 of the same solve on the CPU and exactly 0 where masked out.
14. 256 synthetic clients at the paper MLP's shapes with factored rank-78
   projectors: ``maecho_aggregate(backend="kernel")`` at
   ``client_chunk=64``, τ = 2 (timed, QP share, peak memory): B19
   launches τ · 2 leaves · 10 chunk pairs = 40 times and no other
   kernel; within 1e-3 of the unchunked kernel aggregate (B2/B5/B8 4
   times each, blocked Grams at N = 256) and of the oracle.  Then phase 9's 64
   dense-projector clients at ``client_chunk=16``, τ = 2: B19 40 times,
   within 1e-3 of the oracle.
15. The LLM silos with phase 10's factored projectors through
   ``aggregate_llm`` at ``client_chunk=1``, τ = 2: the stacked leaves
   chunk through torch products (no kernel), the embedding's (896 x
   151 936, diagonal) three chunk pairs through B19, 6 launches in all;
   within 1e-3 of the unchunked kernel aggregate at τ = 2; peak memory
   beside phase 10's.

Added with serving (after phase 15, once the LLM silos are freed; phase
7's fine-tune, on ``attn_backend="oracle"``, must launch no kernel):

16. Serving phase 7's dense kernel aggregate at Qwen2-0.5B's full width
   (``repro_torch.launch.serve``).  B21 (flash attention) against its
   plain version at (B = 8, S = 512, 14/2 heads of 64), causal, in bf16
   and fp32 and at a ragged S = 200; B22 (decode attention) at (B = 8,
   W = 640, 2 kv heads, group 7, D = 64) filled to 576, wrapped with an
   empty row (zeros), and on a ``w_live`` view of a 1024-slot cache;
   both bitwise reproducible, timed in bf16 from CUDA-graph replays
   beside their plain versions and ``scaled_dot_product_attention``
   (timed only), B21 in fp32 too (its SIMT body; own ``[kernels]``
   line).  Then ``run_fixed`` on 8 requests x prompt 512 x gen 64
   with ``attn_backend="auto"`` (bf16; window ``round_window(576)`` =
   640): B21 24 launches, B22 24 x 63, no other kernel; prefill time
   (beside run 18d's), decode tokens/s and peak memory printed.  At fp32 compute the kernel
   and oracle backends emit identical tokens, prefill logits within
   1e-3.  Continuous batching at the reference ``serve.py`` defaults
   (8 requests, 4 slots, arrival every 3 steps, prompt 64, gen 32,
   ``"kernel"``, fp32): B21 24 x 8, B22 24 per decode step, tokens per
   request identical to ``run_fixed``'s (on a mismatch: the first one's
   request, step and top-2 logit gap, and that step's logits within
   1e-3).

Added with B22 as one cluster launch and B16, then B10 and B13, on
3xTF32 ``wgmma``: right after the build, the SASS of the libraries of
B10, B13 and B16 (``cuobjdump -sass``) must hold TF32 ``HGMMA``
instructions; phase 6 holds B10, B13 and B16 bitwise reproducible and
prints ``torch.bmm(D, P)`` (TF32 off, the product alone) beside each of
them at wq and w_gate; phase 16 checks that one B22 call is one kernel
(``torch.profiler``) and prints B22's share of the ``[profile]`` decode
window.  Every fp32 kernel bound by its products is bounded at a third of
the TF32 rate (``FP32_TOL_FLOPS``: three TF32 products keep fp32
accuracy), with the fp32 SIMT figure printed beside it; the elementwise
diagonal kernels stay at the fp32 SIMT rate.

Added with B1 and B4 on 3xTF32 ``wgmma`` (the depth split across the
card): the ``[sass]`` check covers B1's and B4's libraries too; phase 1
prints B1's and B4's error against float64 beside their plain versions'
at W0, W1 and the ragged 1000 x 1100 (N = 8) and times B1 and B4 at the
CNN's fc0 (256 x 1024, N = 4) beside ``torch.bmm(W - V, P)``; phase 9
prints B1's kernels (no client cap: the fused fix-up and pair sums up to 8
clients, B19's contraction above), time and workspace at N = 4, 55, 64
and 128.

Added with B2 and B17 on 3xTF32 ``wgmma`` (the left form of the stage:
Aᵢ·UTᵢ, depth k): the ``[sass]`` check covers their libraries too; right
after it, a process of its own (``--kernel-names``, so that no
``torch.profiler`` session runs in this one before phase 16) lists the
kernels of one B2 call at W0 (k = 78) with N = 4 and 64 and of one B17
call (L = 3, 200 x 300, k = 40, N = 5, norm off and on): B2 must run B1's
kernels by its route and none of the SIMT Gram's, B17 its tf32 kernel
(and the norm pass) and not the SIMT ``v_update_kernel`` (``[names]``
lines); phase 9 prints B2's route, time and workspace at N = 4, 55, 64
and 128, and phase 14 B2's workspace at the unchunked N = 256.

It prints each phase's time, the QP's and the kernels' time inside a
kernel aggregate of each path (CUDA events around each call), a
``{"kernels": [...]}`` JSON line, the card's name and power limit, and
as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import gc
import json
import math
import pathlib
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

FP32_FLOPS = 67e12      # H100 SXM fp32 peak outside the tensor cores
BF16_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
TF32_FLOPS = 495e12     # H100 SXM dense TF32 tensor-core peak
# fastest rate of fp32 products that meets the fp32 tolerances: each product
# as three TF32 products (3xTF32: hi.hi + hi.lo + lo.hi, as B16 runs), so a
# third of the TF32 rate.  Elementwise fp32 work (the diagonal kernels)
# stays at FP32_FLOPS.
FP32_TOL_FLOPS = TF32_FLOPS / 3
HBM_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth
# fastest exact rate of bf16 attention (B21, B22): q.k^T, half the flops, is
# bf16 x bf16, exact on the tensor cores with fp32 accumulation; p.v takes p in
# fp32, exact as three bf16 terms, so at a third of that rate: 2 flops / BF16
ATTN_BF16_FLOPS = BF16_FLOPS / 2
TAU = 30               # the accuracy aggregates
TAU_CHECK = 5          # kernel-vs-oracle comparisons and the scalar path
RANK = 78               # table6_svd.py's "factored0.1": int(0.1 * 784)
GRAM_RTOL = 1e-5        # |G - G_plain| <= GRAM_RTOL * max|G_plain| (fp32 sum order)
APPLY_ATOL = 1e-4       # Eq. 7 / Eq. 11 outputs, as the reference's kernel tests
AGG_ATOL = 1e-3         # kernel vs oracle aggregate, as the reference's tests
MARGIN = 0.05           # accuracy margin pinned by tests/test_paper_fidelity.py
DENSE = ("maecho_gram", "maecho_update", "maecho_v_update")                 # B1 B4 B7
FACTORED = ("maecho_gram_left", "maecho_update_left", "maecho_v_update_factored")  # B2 B5 B8
DIAG = ("maecho_gram_diag", "maecho_update_diag", "maecho_v_update_diag")  # B3 B6 B9
STACKED = ("maecho_gram_stacked", "maecho_update_stacked",
           "maecho_v_update_stacked")                                      # B10 B13 B16
TF32 = DENSE[:2] + STACKED + ("maecho_gram_left", "maecho_v_update_factored_stacked")
# on 3xTF32 wgmma: B1 B4 B10 B13 B16, and B2 B17 on the left form
# B1's kernels: up to 8 clients the share kernel, then each tile's fix-up
# and pair sums in one pass; above, the fix-up and B19's contraction.
# Printed, not profiled here: every torch.profiler session before phase 16
# risks its B22 check seeing no device events (the card tests check names)
B1_ROUTES = {True: ("splitk_tf32_kernel", "gram_tile_pairs_kernel", "gram_pairs_reduce_kernel"),
             False: ("splitk_tf32_kernel", "splitk_fixup_kernel", "gram_cross_partial_kernel",
                     "gram_cross_reduce_kernel")}
# B2 runs B1's kernels by B1's rule, B17 its tf32 kernel (and the norm
# pass); neither may run the SIMT bodies they replaced
SIMT_GRAM = ("gram_partial_kernel", "gram_blocked_partial_kernel")
B17_NAMES = ("v_update_left_tf32_kernel", "v_norm_kernel")
STACKED_DIAG = ("maecho_gram_diag_stacked", "maecho_update_diag_stacked",
                "maecho_v_update_diag_stacked")                            # B12 B15 B18
STACKED_LEFT = ("maecho_gram_left_stacked", "maecho_update_left_stacked",
                "maecho_v_update_factored_stacked")                        # B11 B14 B17
CROSS = ("maecho_gram_cross",)    # B19
DOWNDATE = ("rank_downdate",)     # B20
ATTN = ("flash_attention", "decode_attention")   # B21 B22 (serving)
KERNELS = (DENSE + FACTORED + DIAG + STACKED + STACKED_DIAG + STACKED_LEFT + CROSS + DOWNDATE
           + ATTN)
GRAMS = ("maecho_gram", "maecho_gram_left", "maecho_gram_diag", "maecho_gram_stacked",
         "maecho_gram_left_stacked", "maecho_gram_diag_stacked")   # B1 B2 B3 B10 B11 B12
MANY_CLIENTS = (55, 64, 128)   # past the 54 clients one Gram CTA parks
CHUNK = 64              # bench_largeN_agg.py's chunk, and the full-width path's
LLM_TAU = 15            # the example's MAEchoConfig(tau=15, eta=0.5, mu=20)
LLM_RANK = 89           # table6_svd.py's "factored0.1" at d_model: int(0.1 * 896)
# serving (phase 16): the fixed batch, and the reference serve.py's
# continuous-batching defaults
SERVE_B, SERVE_PROMPT, SERVE_GEN = 8, 512, 64
ARRIVAL = dict(requests=8, slots=4, arrival_every=3, prompt=64, gen=32)
LOGIT_ATOL = 1e-3       # kernel vs oracle prefill logits at fp32 compute
# the fixed batch's prefill in run 18d, first and second run (PERF.md §5;
# H100 80GB HBM3, 700 W), before B21 ran on the bf16 tensor cores
RUN_18D_PREFILL_MS = (42.314, 26.947)
# B1/B2 (k = 78)/B3 at W0, N = 4, in run Q (PERF.md §6; H100 80GB HBM3, 700 W)
RUN_Q_MS = {"maecho_gram": 0.3078, "maecho_gram_left": 0.0426, "maecho_gram_diag": 0.0225}
REPLACES = {"maecho_gram": "src/repro/kernels/maecho_gram.py:131",
            "maecho_update": "src/repro/kernels/maecho_update.py:76",
            "maecho_v_update": "src/repro/kernels/maecho_v_update.py:107",
            "maecho_gram_left": "src/repro/kernels/maecho_gram.py:194",
            "maecho_update_left": "src/repro/kernels/maecho_update.py:141",
            "maecho_v_update_factored": "src/repro/kernels/maecho_v_update.py:146",
            "maecho_gram_diag": "src/repro/kernels/maecho_gram.py:396",
            "maecho_update_diag": "src/repro/kernels/maecho_update.py:293",
            "maecho_v_update_diag": "src/repro/kernels/maecho_v_update.py:315",
            "maecho_gram_stacked": "src/repro/kernels/maecho_gram.py:299",
            "maecho_update_stacked": "src/repro/kernels/maecho_update.py:177",
            "maecho_v_update_stacked": "src/repro/kernels/maecho_v_update.py:186",
            "maecho_gram_diag_stacked": "src/repro/kernels/maecho_gram.py:368",
            "maecho_update_diag_stacked": "src/repro/kernels/maecho_update.py:252",
            "maecho_v_update_diag_stacked": "src/repro/kernels/maecho_v_update.py:271",
            "maecho_gram_left_stacked": "src/repro/kernels/maecho_gram.py:337",
            "maecho_update_left_stacked": "src/repro/kernels/maecho_update.py:217",
            "maecho_v_update_factored_stacked": "src/repro/kernels/maecho_v_update.py:233",
            "maecho_gram_cross": "src/repro/kernels/maecho_gram.py:242",
            "rank_downdate": "src/repro/kernels/rank_update.py:48",
            "flash_attention": "src/repro/kernels/flash_attention.py:103",
            "decode_attention": "src/repro/kernels/decode_attention.py:189"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def graph_ms(torch, fn, reps: int) -> float:
    """Device time of one ``fn()``: ``reps`` calls captured into one CUDA
    graph, replayed between two events, so no host work sits between
    the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_tf32_sass(build) -> None:
    """B1, B4, B10, B13, B16, B2 and B17 run 3xTF32 on the tensor cores:
    the SASS of each one's library must hold TF32 HGMMA (wgmma)
    instructions."""
    for name in TF32:
        lib = build.library_path(name)
        sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
        hgmma = [line.split(";")[0].strip() for line in sass.splitlines()
                 if "HGMMA" in line and "TF32" in line]
        print(f"[sass] {name} ({lib.name}): {len(hgmma)} TF32 HGMMA "
              f"instructions; first: {hgmma[0] if hgmma else None}")
        check(bool(hgmma), f"{name}'s SASS holds no TF32 HGMMA instruction")


def kernel_names(torch, fn) -> list:
    """Names of the CUDA kernels one ``fn()`` launches (``torch.profiler``,
    after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def left_kernel_names_main() -> None:
    """``chip_smoke.py --kernel-names``, run by :func:`check_left_kernel_names`
    in a process of its own: print as one JSON line the CUDA kernels
    (``torch.profiler``) of one B2 call at W0 (k = 78) with N = 4 and 64
    and of one B17 call (L = 3, 200 x 300, k = 40, N = 5) with the
    row-norm off and on."""
    import torch

    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import maecho_gram, maecho_v_update

    kern = SimpleNamespace(compressed_residual=maecho_gram.compressed_residual)
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for N in (4, 64):
        *_, A, UT = factored_inputs(torch, kern, gen, 400, 784, RANK, N)
        out[f"maecho_gram_left N={N}"] = kernel_names(
            torch, lambda: maecho_gram.maecho_gram_left(A, UT))
    L, N, k = 3, 5, 40
    W = torch.randn(L, 200, 300, device="cuda", generator=gen) * 0.1
    V = W + torch.randn(N, L, 200, 300, device="cuda", generator=gen) * 0.05
    U = torch.linalg.qr(torch.randn(N, L, 300, k, device="cuda", generator=gen))[0]
    s = torch.rand(N, L, k, device="cuda", generator=gen) * 0.9 + 0.1
    B = maecho_gram.compressed_residual(W, V, U, s)
    UT = U.transpose(-1, -2).contiguous()
    for norm in (False, True):
        out[f"maecho_v_update_left_stacked norm={norm}"] = kernel_names(
            torch, lambda: maecho_v_update.maecho_v_update_left_stacked(B, UT, W, V, 20 / 21,
                                                                        norm))
    print(json.dumps(out))


def check_left_kernel_names() -> None:
    """B2 and B17 left the SIMT templates: one B2 call runs B1's kernels by
    B1's rule (the fused pass up to 8 clients, B19's contraction above)
    and no SIMT Gram kernel, one B17 call its tf32 kernel (plus the norm
    pass) and not ``v_update_kernel``.  The names come from a process of
    its own (:func:`left_kernel_names_main`)."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--kernel-names"],
                         capture_output=True, text=True)
    check(res.returncode == 0, f"the kernel-name process failed:\n{res.stderr[-3000:]}")
    for key, got in json.loads(res.stdout.strip().splitlines()[-1]).items():
        print(f"[names] {key}: {got}")
        if key.startswith("maecho_gram_left"):
            want = B1_ROUTES[int(key.split("N=")[1]) <= 8]
            check(len(got) == len(want) and all(w in g for w, g in zip(want, got))
                  and not any(k in g for g in got for k in SIMT_GRAM),
                  f"{key} ran {got}, expected {list(want)}")
        else:
            want = B17_NAMES[:1 + key.endswith("True")]
            check(len(got) == len(want) and all(w in g for w, g in zip(want, got))
                  and not any("v_update_kernel" in g for g in got),
                  f"{key} ran {got}, expected {list(want)}")


def time_cases(torch, label: str, cases: dict, timings: dict, reps: int = 50) -> None:
    """Time each ``name: (kernel fn, plain fn, flops, bytes[, rate])`` of
    one leaf and record ``timings[(name, label)] = (ms, plain ms, bound
    ms, bound by)``, device times from CUDA graphs of ``reps`` calls.
    ``rate`` is the fastest operation rate that meets the case's
    tolerances (``FP32_TOL_FLOPS`` unless given; then the bound at the
    fp32 SIMT rate is printed beside it)."""
    for name, (k_fn, p_fn, flops, nbytes, *rate) in cases.items():
        ms, plain = graph_ms(torch, k_fn, reps), graph_ms(torch, p_fn, reps)
        b, by = bound_ms(flops, nbytes, *rate)
        timings[(name, label)] = (ms, plain, b, by)
        simt = ("" if rate else
                f"; at the fp32 SIMT rate {bound_ms(flops, nbytes, FP32_FLOPS)[0]:.4f} ms")
        print(f"[kernels] {label} {name}: {ms:.4f} ms, plain {plain:.4f} ms "
              f"({reps} calls per graph), bound {b:.4f} ms ({by}: "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB{simt})")


def bound_ms(flops: float, nbytes: float, rate: float = FP32_TOL_FLOPS) -> tuple:
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gram_left_flops(N: int, out_d: int, in_d: int, k: int) -> float:
    """Least operations of one (N, N) Gram of Rᵢ = Aᵢ·UTᵢ, A (N, out, k),
    UT (N, k, in): the cheaper of forming every Rᵢ and contracting the
    pairs, or the k x k cross-Gram identity ⟨Rᵢ, Rⱼ⟩ = Σ (AᵢᵀAⱼ) ⊙
    (UTᵢ·UTⱼᵀ), 2·k²·(out + in) + 2·k² a pair (i <= j), which never forms
    R.  The kernels (B2, B11) form R tile by tile, so at k << in their
    bound is the identity's."""
    pairs = N * (N + 1) / 2
    form_r = 2.0 * N * out_d * in_d * k + 2.0 * pairs * out_d * in_d
    cross = pairs * (2.0 * k * k * (out_d + in_d) + 2.0 * k * k)
    return min(form_r, cross)


def downdate_flops(d: int, b: int) -> float:
    """Least operations of Q − U·A·Uᵀ with A (b, b) symmetric: T = U·A,
    then only the upper triangle of T·Uᵀ (the product is symmetric), then
    the subtraction.  B20 computes both triangles."""
    return 2.0 * d * b * b + d * (d + 1.0) * b + d * d


def layer_inputs(torch, gen, out_d, in_d, N):
    """Random leaf with rank-in/2 orthogonal projectors, like a trained
    client's: W, V, P, alpha on the card."""
    W = torch.randn(out_d, in_d, device="cuda", generator=gen) * 0.1
    V = W + torch.randn(N, out_d, in_d, device="cuda", generator=gen) * 0.05
    U = torch.linalg.qr(torch.randn(N, in_d, in_d // 2, device="cuda",
                                    generator=gen))[0]
    P = (U @ U.transpose(1, 2)).contiguous()
    alpha = torch.softmax(torch.randn(N, device="cuda", generator=gen), 0)
    return W, V, P, alpha


def phase_kernels(torch, kern, ref):
    """Kernel vs plain on the card; returns per-kernel records at W0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    frac, eta = 20.0 / 21.0, 0.5
    err = {"maecho_gram": 0.0, "maecho_update": 0.0, "maecho_v_update": 0.0}
    for label, out_d, in_d, N in (("W0", 400, 784, 4), ("W1", 200, 400, 4),
                                  ("ragged", 1000, 1100, 8)):
        W, V, P, alpha = layer_inputs(torch, gen, out_d, in_d, N)
        dense_f64_errors(torch, kern, ref, label, W, V, P, alpha, eta)
        G, Gr = kern.maecho_gram(W, V, P), ref.maecho_gram_ref(W, V, P)
        e = (G - Gr).abs().max().item()
        tol = GRAM_RTOL * Gr.abs().max().item()
        print(f"[kernels] {label} ({out_d}x{in_d}, N={N}) maecho_gram "
              f"max_abs_err {e:.3e} tol {tol:.3e}")
        check(e <= tol, f"maecho_gram disagrees at {label}")
        err["maecho_gram"] = max(err["maecho_gram"], e)
        Wn = kern.maecho_update(W, V, P, alpha, eta)
        e = (Wn - ref.maecho_update_ref_any(W, V, P, alpha, eta)).abs().max().item()
        print(f"[kernels] {label} maecho_update max_abs_err {e:.3e} tol {APPLY_ATOL:.0e}")
        check(e <= APPLY_ATOL, f"maecho_update disagrees at {label}")
        err["maecho_update"] = max(err["maecho_update"], e)
        for norm in (False, True):
            Vn = kern.maecho_v_update(Wn, V, P, frac, norm)
            e = (Vn - ref.maecho_v_update_ref(Wn, V, P, frac, norm)).abs().max().item()
            print(f"[kernels] {label} maecho_v_update norm={norm} "
                  f"max_abs_err {e:.3e} tol {APPLY_ATOL:.0e}")
            check(e <= APPLY_ATOL, f"maecho_v_update (norm={norm}) disagrees at {label}")
            check((Vn - V).abs().max().item() > 0, "maecho_v_update left V unchanged")
            err["maecho_v_update"] = max(err["maecho_v_update"], e)
    torch.cuda.synchronize()

    timings = {}
    for label, out_d, in_d, N in (("W0", 400, 784, 4), ("W1", 200, 400, 4),
                                  ("fc0", 256, 1024, 4)):
        W, V, P, alpha = layer_inputs(torch, gen, out_d, in_d, N)
        Wn = kern.maecho_update(W, V, P, alpha, eta)
        OI, II = out_d * in_d, in_d * in_d
        gemm = 2.0 * N * out_d * II
        cases = {
            "maecho_gram": (lambda: kern.maecho_gram(W, V, P),
                            lambda: ref.maecho_gram_ref(W, V, P),
                            gemm + N * OI + N * (N + 1) * OI,
                            4.0 * (OI + N * OI + N * II + N * N)),
            "maecho_update": (lambda: kern.maecho_update(W, V, P, alpha, eta),
                              lambda: ref.maecho_update_ref_any(W, V, P, alpha, eta),
                              gemm + N * OI + 2.0 * N * OI + 2.0 * OI,
                              4.0 * (2 * OI + N * OI + N * II + N)),
            "maecho_v_update": (lambda: kern.maecho_v_update(Wn, V, P, frac),
                                lambda: ref.maecho_v_update_ref(Wn, V, P, frac),
                                gemm + 4.0 * N * OI,
                                4.0 * (OI + 2 * N * OI + N * II)),
        }
        if label == "fc0":      # the CNN's fc0: B1 and B4 only
            del cases["maecho_v_update"]
        time_cases(torch, label, cases, timings)
        product_alone(torch, label, "B1/B4/B7", "torch.bmm(W - V, P)",
                      lambda D=(W[None] - V): torch.bmm(D, P), 50)
    return err, timings


def dense_f64_errors(torch, kern, ref, label, W, V, P, alpha, eta) -> None:
    """Print B1's and B4's max error against the function in float64,
    beside their plain versions' (B1 and B4 run 3xTF32 on the tensor
    cores)."""
    R = (W[None] - V).double() @ P.double()
    Rf = R.reshape(R.shape[0], -1)
    G64 = Rf @ Rf.T
    W64 = W.double() + eta * (-2.0 * torch.einsum("n,noi->oi", alpha.double(), R))
    for name, got, plain, want in (
            ("maecho_gram", kern.maecho_gram(W, V, P), ref.maecho_gram_ref(W, V, P), G64),
            ("maecho_update", kern.maecho_update(W, V, P, alpha, eta),
             ref.maecho_update_ref_any(W, V, P, alpha, eta), W64)):
        print(f"[kernels] {label} ({W.shape[0]}x{W.shape[1]}, N={V.shape[0]}) {name} "
              f"against float64: kernel {(got.double() - want).abs().max().item():.3e}, "
              f"plain {(plain.double() - want).abs().max().item():.3e}, "
              f"max {want.abs().max().item():.3e}")
    del R, Rf, G64, W64


def product_alone(torch, label: str, ids: str, call: str, fn, reps: int) -> None:
    """Print the device time of the one PyTorch call that computes the
    kernels' main product alone (TF32 off), their yardstick in PERF.md."""
    print(f"[kernels] {label} {ids}: the product alone, {call} (TF32 off), "
          f"{graph_ms(torch, fn, reps):.4f} ms")


def factored_inputs(torch, kern, gen, out_d, in_d, k, N):
    """Random leaf with rank-k orthonormal factored projectors: W, V, U,
    s, alpha and the compressed residual A with Uᵀ, on the card."""
    W = torch.randn(out_d, in_d, device="cuda", generator=gen) * 0.1
    V = W + torch.randn(N, out_d, in_d, device="cuda", generator=gen) * 0.05
    U = torch.linalg.qr(torch.randn(N, in_d, k, device="cuda",
                                    generator=gen))[0].contiguous()
    s = torch.rand(N, k, device="cuda", generator=gen) * 0.9 + 0.1
    alpha = torch.softmax(torch.randn(N, device="cuda", generator=gen), 0)
    A = kern.compressed_residual(W, V, U, s)
    return W, V, U, s, alpha, A, U.transpose(1, 2).contiguous()


def phase_factored_kernels(torch, kern, ref):
    """B2/B5/B8 vs plain on the card; returns (errors, timings) keyed
    like :func:`phase_kernels`' with the leaf label carrying the rank."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    frac, eta = 20.0 / 21.0, 0.5
    err = {"maecho_gram_left": 0.0, "maecho_update_left": 0.0,
           "maecho_v_update_factored": 0.0}
    for label, out_d, in_d, k, N in (("W0", 400, 784, 78, 4), ("W0", 400, 784, 196, 4),
                                     ("W1", 200, 400, 78, 4), ("W1", 200, 400, 196, 4),
                                     ("ragged", 1000, 1100, 150, 8)):
        W, V, U, s, alpha, A, UT = factored_inputs(torch, kern, gen, out_d, in_d, k, N)
        tag = f"{label} ({out_d}x{in_d}, N={N}, k={k})"
        G, Gr = kern.maecho_gram_left(A, UT), ref.maecho_gram_left_ref(A, UT)
        e = (G - Gr).abs().max().item()
        tol = GRAM_RTOL * Gr.abs().max().item()
        print(f"[kernels] {tag} maecho_gram_left max_abs_err {e:.3e} tol {tol:.3e}")
        check(e <= tol, f"maecho_gram_left disagrees at {tag}")
        err["maecho_gram_left"] = max(err["maecho_gram_left"], e)
        Wn = kern.maecho_update_left(W, A, UT, alpha, eta)
        e = (Wn - ref.maecho_update_left_ref(W, A, UT, alpha, eta)).abs().max().item()
        print(f"[kernels] {tag} maecho_update_left max_abs_err {e:.3e} tol {APPLY_ATOL:.0e}")
        check(e <= APPLY_ATOL, f"maecho_update_left disagrees at {tag}")
        err["maecho_update_left"] = max(err["maecho_update_left"], e)
        for norm in (False, True):
            Vn = kern.maecho_v_update_factored(Wn, V, U, s, frac, norm)
            e = (Vn - ref.maecho_v_update_factored_ref(Wn, V, U, s, frac, norm)
                 ).abs().max().item()
            print(f"[kernels] {tag} maecho_v_update_factored norm={norm} "
                  f"max_abs_err {e:.3e} tol {APPLY_ATOL:.0e}")
            check(e <= APPLY_ATOL,
                  f"maecho_v_update_factored (norm={norm}) disagrees at {tag}")
            check((Vn - V).abs().max().item() > 0,
                  "maecho_v_update_factored left V unchanged")
            err["maecho_v_update_factored"] = max(err["maecho_v_update_factored"], e)
    torch.cuda.synchronize()

    # Bounds count each input read once, each output written once, and
    # the least operations each function needs (B2: gram_left_flops).
    # B2, B5 and the B8 kernel take
    # the reference's pallas_call operands: (A, Uᵀ), (W, A, Uᵀ, α) and
    # (B, Uᵀ, W', V); with the row-norm off V cancels from the B8 kernel's
    # function (V + (W' − V) − frac·B·Uᵀ = W' − frac·B·Uᵀ), so its bound
    # reads W', B and Uᵀ and writes V'.  The B8 wrapper, as the factored path calls it,
    # takes (W', V, U, s, Uᵀ) and forms B itself; its bound needs only
    # one GEMM for B, ((W' − Vᵢ)@Uᵢ)·diag(sᵢ), and one for Bᵢ@Uᵢᵀ.
    timings = {}
    for label, out_d, in_d, k, N in (("W0", 400, 784, 78, 4), ("W0", 400, 784, 196, 4),
                                     ("W1", 200, 400, 78, 4), ("W1", 200, 400, 196, 4)):
        W, V, U, s, alpha, A, UT = factored_inputs(torch, kern, gen, out_d, in_d, k, N)
        Wn = kern.maecho_update_left(W, A, UT, alpha, eta)
        B = kern.compressed_residual(Wn, V, U, s)
        OI, OK, KI = out_d * in_d, out_d * k, k * in_d
        gemm = 2.0 * N * OI * k
        cases = {
            "maecho_gram_left": (lambda: kern.maecho_gram_left(A, UT),
                                 lambda: ref.maecho_gram_left_ref(A, UT),
                                 gram_left_flops(N, out_d, in_d, k),
                                 4.0 * (N * OK + N * KI + N * N)),
            "maecho_update_left": (lambda: kern.maecho_update_left(W, A, UT, alpha, eta),
                                   lambda: ref.maecho_update_left_ref(W, A, UT, alpha, eta),
                                   gemm + 2.0 * N * OI + 2.0 * OI,
                                   4.0 * (2 * OI + N * OK + N * KI + N)),
            "maecho_v_update_factored": (
                lambda: kern.maecho_v_update_left(B, UT, Wn, V, frac),
                lambda: ref.maecho_v_update_left_ref(B, UT, Wn, V, frac),
                gemm + 2.0 * N * OI,
                4.0 * (N * OK + N * KI + OI + N * OI)),
            "maecho_v_update_factored wrapper": (
                lambda: kern.maecho_v_update_factored(Wn, V, U, s, frac, UT=UT),
                lambda: ref.maecho_v_update_factored_ref(Wn, V, U, s, frac),
                2 * gemm + N * OK + 5.0 * N * OI,
                4.0 * (OI + 2 * N * OI + N * KI + N * k)),
        }
        time_cases(torch, f"{label}k{k}", cases, timings)
        product_alone(torch, f"{label}k{k}", "B2/B5/B8", "torch.bmm(A, UT)",
                      lambda: torch.bmm(A, UT), 50)
    return err, timings


def phase_diag_kernels(torch, kern, ref):
    """B3/B6/B9 vs plain on the card with non-uniform diagonals p in
    [0, 1]; returns (errors, timings) keyed like :func:`phase_kernels`'."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    frac, eta = 20.0 / 21.0, 0.5

    def inputs(out_d, in_d, N):
        W = torch.randn(out_d, in_d, device="cuda", generator=gen) * 0.1
        V = W + torch.randn(N, out_d, in_d, device="cuda", generator=gen) * 0.05
        p = torch.rand(N, in_d, device="cuda", generator=gen)
        alpha = torch.softmax(torch.randn(N, device="cuda", generator=gen), 0)
        return W, V, p, alpha

    err = {name: 0.0 for name in DIAG}
    for label, out_d, in_d, N in (("W0", 400, 784, 4), ("W1", 200, 400, 4),
                                  ("ragged", 1000, 1100, 8)):
        W, V, p, alpha = inputs(out_d, in_d, N)
        tag = f"{label} ({out_d}x{in_d}, N={N})"
        G, Gr = kern.maecho_gram_diag(W, V, p), ref.maecho_gram_diag_ref(W, V, p)
        e = (G - Gr).abs().max().item()
        tol = GRAM_RTOL * Gr.abs().max().item()
        print(f"[kernels] {tag} maecho_gram_diag max_abs_err {e:.3e} tol {tol:.3e}")
        check(e <= tol, f"maecho_gram_diag disagrees at {tag}")
        check(torch.equal(G, kern.maecho_gram_diag(W, V, p)),
              f"maecho_gram_diag is not reproducible at {tag}")
        err["maecho_gram_diag"] = max(err["maecho_gram_diag"], e)
        Wn = kern.maecho_update_diag(W, V, p, alpha, eta)
        e = (Wn - ref.maecho_update_diag_ref(W, V, p, alpha, eta)).abs().max().item()
        print(f"[kernels] {tag} maecho_update_diag max_abs_err {e:.3e} tol {APPLY_ATOL:.0e}")
        check(e <= APPLY_ATOL, f"maecho_update_diag disagrees at {tag}")
        err["maecho_update_diag"] = max(err["maecho_update_diag"], e)
        for norm in (False, True):
            Vn = kern.maecho_v_update_diag(Wn, V, p, frac, norm)
            e = (Vn - ref.maecho_v_update_diag_ref(Wn, V, p, frac, norm)).abs().max().item()
            print(f"[kernels] {tag} maecho_v_update_diag norm={norm} "
                  f"max_abs_err {e:.3e} tol {APPLY_ATOL:.0e}")
            check(e <= APPLY_ATOL, f"maecho_v_update_diag (norm={norm}) disagrees at {tag}")
            check((Vn - V).abs().max().item() > 0, "maecho_v_update_diag left V unchanged")
            err["maecho_v_update_diag"] = max(err["maecho_v_update_diag"], e)
    torch.cuda.synchronize()

    # Bounds: the elementwise residual (W − Vᵢ)·pᵢ costs 2 operations an
    # element and client, the symmetric pair contraction N(N+1) more;
    # Eq. 7 adds the α-scaled client sum, Eq. 11 (norm off) 1 − frac·pᵢ
    # and the add to Vᵢ; elementwise, at the fp32 SIMT rate.
    timings = {}
    for label, out_d, in_d, N in (("W0", 400, 784, 4), ("W1", 200, 400, 4)):
        W, V, p, alpha = inputs(out_d, in_d, N)
        Wn = kern.maecho_update_diag(W, V, p, alpha, eta)
        OI, NI = out_d * in_d, N * in_d
        cases = {
            "maecho_gram_diag": (lambda: kern.maecho_gram_diag(W, V, p),
                                 lambda: ref.maecho_gram_diag_ref(W, V, p),
                                 2.0 * N * OI + N * (N + 1) * OI,
                                 4.0 * (OI + N * OI + NI + N * N), FP32_FLOPS),
            "maecho_update_diag": (lambda: kern.maecho_update_diag(W, V, p, alpha, eta),
                                   lambda: ref.maecho_update_diag_ref(W, V, p, alpha, eta),
                                   4.0 * N * OI + 2.0 * OI,
                                   4.0 * (2 * OI + N * OI + NI + N), FP32_FLOPS),
            "maecho_v_update_diag": (lambda: kern.maecho_v_update_diag(Wn, V, p, frac),
                                     lambda: ref.maecho_v_update_diag_ref(Wn, V, p, frac),
                                     5.0 * N * OI,
                                     4.0 * (OI + 2 * N * OI + NI), FP32_FLOPS),
        }
        time_cases(torch, label, cases, timings)
    return err, timings


def phase_stacked_kernels(torch, kern, ref):
    """B10/B13/B16 and B12/B15/B18 vs plain on the card; returns
    (errors, timings) with timings keyed (name, leaf label)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    frac, eta = 20.0 / 21.0, 0.5

    def inputs(L, out_d, in_d, N):
        W = torch.randn(L, out_d, in_d, device="cuda", generator=gen) * 0.1
        V = W + torch.randn(N, L, out_d, in_d, device="cuda", generator=gen) * 0.05
        U = torch.linalg.qr(torch.randn(N, L, in_d, in_d // 2, device="cuda",
                                        generator=gen))[0]
        P = (U @ U.transpose(-1, -2)).contiguous()
        p = torch.rand(N, L, in_d, device="cuda", generator=gen)
        alpha = torch.softmax(torch.randn(L, N, device="cuda", generator=gen), -1)
        return W, V, P, p, alpha.contiguous()

    plain = {n: getattr(ref, n + "_ref") for n in STACKED + STACKED_DIAG}
    err = {name: 0.0 for name in STACKED + STACKED_DIAG}
    for label, L, out_d, in_d, N in (("ragged", 3, 200, 300, 5), ("wq", 24, 896, 896, 2),
                                     ("w_gate", 24, 4864, 896, 2)):
        W, V, P, p, alpha = inputs(L, out_d, in_d, N)
        tag = f"{label} (L={L}, {out_d}x{in_d}, N={N})"
        for (g, u, v), proj in ((STACKED, P), (STACKED_DIAG, p)):
            G, Gr = getattr(kern, g)(W, V, proj), plain[g](W, V, proj)
            e = (G - Gr).abs().max().item()
            tol = GRAM_RTOL * Gr.abs().max().item()
            print(f"[kernels] {tag} {g} max_abs_err {e:.3e} tol {tol:.3e}")
            check(e <= tol, f"{g} disagrees at {tag}")
            check(torch.equal(G, getattr(kern, g)(W, V, proj)),
                  f"{g} is not reproducible at {tag}")
            err[g] = max(err[g], e)
            Wn = getattr(kern, u)(W, V, proj, alpha, eta)
            e = (Wn - plain[u](W, V, proj, alpha, eta)).abs().max().item()
            print(f"[kernels] {tag} {u} max_abs_err {e:.3e} tol {APPLY_ATOL:.0e}")
            check(e <= APPLY_ATOL, f"{u} disagrees at {tag}")
            if proj is P:               # B13 (3xTF32): bitwise reproducible too
                check(torch.equal(Wn, getattr(kern, u)(W, V, proj, alpha, eta)),
                      f"{u} is not reproducible at {tag}")
            err[u] = max(err[u], e)
            for norm in ((False, True) if label == "ragged" else (False,)):
                Vn = getattr(kern, v)(Wn, V, proj, frac, norm)
                e = (Vn - plain[v](Wn, V, proj, frac, norm)).abs().max().item()
                print(f"[kernels] {tag} {v} norm={norm} max_abs_err {e:.3e} "
                      f"tol {APPLY_ATOL:.0e}")
                check(e <= APPLY_ATOL, f"{v} (norm={norm}) disagrees at {tag}")
                check((Vn - V).abs().max().item() > 0, f"{v} left V unchanged")
                if proj is P:           # B16 (3xTF32): bitwise reproducible too
                    check(torch.equal(Vn, getattr(kern, v)(Wn, V, proj, frac, norm)),
                          f"{v} (norm={norm}) is not reproducible at {tag}")
                err[v] = max(err[v], e)
        del W, V, P, p
    torch.cuda.synchronize()

    # Bounds as for B1/B4/B7 and B3/B6/B9, times L: each input read once,
    # each output written once.  Dense kernels at wq and w_gate, diagonal
    # ones at wo and w_down (the leaves of the main path that run them).
    timings = {}
    for label, L, out_d, in_d, N, names in (
            ("wq", 24, 896, 896, 2, STACKED), ("w_gate", 24, 4864, 896, 2, STACKED),
            ("wo", 24, 896, 896, 2, STACKED_DIAG), ("w_down", 24, 896, 4864, 2,
                                                    STACKED_DIAG)):
        W, V, P, p, alpha = inputs(L, out_d, in_d, N)
        proj = P if names is STACKED else p
        g, u, v = names
        Wn = getattr(kern, u)(W, V, proj, alpha, eta)
        OI, II, NI = L * out_d * in_d, L * in_d * in_d, L * N * in_d
        gemm = 2.0 * N * OI * in_d
        if names is STACKED:
            costs = {g: (gemm + N * OI + N * (N + 1) * OI,
                         4.0 * (OI + N * OI + N * II + L * N * N)),
                     u: (gemm + 3.0 * N * OI + 2.0 * OI,
                         4.0 * (2 * OI + N * OI + N * II + L * N)),
                     v: (gemm + 4.0 * N * OI, 4.0 * (OI + 2 * N * OI + N * II))}
        else:                   # elementwise: at the fp32 SIMT rate
            costs = {g: (2.0 * N * OI + N * (N + 1) * OI,
                         4.0 * (OI + N * OI + NI + L * N * N), FP32_FLOPS),
                     u: (4.0 * N * OI + 2.0 * OI, 4.0 * (2 * OI + N * OI + NI + L * N),
                         FP32_FLOPS),
                     v: (5.0 * N * OI, 4.0 * (OI + 2 * N * OI + NI), FP32_FLOPS)}
        fns = {g: (lambda: getattr(kern, g)(W, V, proj), lambda: plain[g](W, V, proj)),
               u: (lambda: getattr(kern, u)(W, V, proj, alpha, eta),
                   lambda: plain[u](W, V, proj, alpha, eta)),
               v: (lambda: getattr(kern, v)(Wn, V, proj, frac),
                   lambda: plain[v](Wn, V, proj, frac))}
        reps = 3 if names is STACKED else 10     # B10 at w_gate: ~0.1 s a call
        time_cases(torch, label, {n: fns[n] + costs[n] for n in names}, timings, reps)
        if names is STACKED:    # no one call computes Eq. 6, 7 or 11: time the product alone
            for name, Wd in ((g, W), (u, W), (v, Wn)):
                product_alone(torch, label, name, "torch.bmm(D, P)",
                              lambda D=(Wd[None] - V).reshape(N * L, out_d, in_d),
                              Pf=P.reshape(N * L, in_d, in_d): torch.bmm(D, Pf), reps)
        del W, V, P, p, Wn
    return err, timings


def phase_stacked_left_kernels(torch, kern, ref):
    """B11/B14/B17 vs plain on the card (factored projectors of a stacked
    leaf); returns (errors, timings) keyed like :func:`phase_stacked_kernels`'."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    frac, eta = 20.0 / 21.0, 0.5
    g, u, v = STACKED_LEFT

    def inputs(L, out_d, in_d, k, N):
        W = torch.randn(L, out_d, in_d, device="cuda", generator=gen) * 0.1
        V = W + torch.randn(N, L, out_d, in_d, device="cuda", generator=gen) * 0.05
        U = torch.linalg.qr(torch.randn(N, L, in_d, k, device="cuda",
                                        generator=gen))[0].contiguous()
        s = torch.rand(N, L, k, device="cuda", generator=gen) * 0.9 + 0.1
        alpha = torch.softmax(torch.randn(L, N, device="cuda", generator=gen), -1)
        A = kern.compressed_residual(W, V, U, s)
        return W, V, U, s, alpha.contiguous(), A, U.transpose(-1, -2).contiguous()

    err = {name: 0.0 for name in STACKED_LEFT}
    for label, L, out_d, in_d, k, N in (("ragged", 3, 200, 300, 40, 5),
                                        ("wq", 24, 896, 896, LLM_RANK, 2),
                                        ("w_gate", 24, 4864, 896, LLM_RANK, 2)):
        W, V, U, s, alpha, A, UT = inputs(L, out_d, in_d, k, N)
        tag = f"{label} (L={L}, {out_d}x{in_d}, N={N}, k={k})"
        G, Gr = kern.maecho_gram_left_stacked(A, UT), ref.maecho_gram_left_stacked_ref(A, UT)
        e = (G - Gr).abs().max().item()
        tol = GRAM_RTOL * Gr.abs().max().item()
        print(f"[kernels] {tag} {g} max_abs_err {e:.3e} tol {tol:.3e}")
        check(e <= tol, f"{g} disagrees at {tag}")
        check(torch.equal(G, kern.maecho_gram_left_stacked(A, UT)),
              f"{g} is not reproducible at {tag}")
        err[g] = max(err[g], e)
        Wn = kern.maecho_update_left_stacked(W, A, UT, alpha, eta)
        e = (Wn - ref.maecho_update_left_stacked_ref(W, A, UT, alpha, eta)).abs().max().item()
        print(f"[kernels] {tag} {u} max_abs_err {e:.3e} tol {APPLY_ATOL:.0e}")
        check(e <= APPLY_ATOL, f"{u} disagrees at {tag}")
        err[u] = max(err[u], e)
        for norm in ((False, True) if label == "ragged" else (False,)):
            Vn = kern.maecho_v_update_factored_stacked(Wn, V, U, s, frac, norm, UT=UT)
            e = (Vn - ref.maecho_v_update_factored_stacked_ref(Wn, V, U, s, frac, norm)
                 ).abs().max().item()
            print(f"[kernels] {tag} {v} norm={norm} max_abs_err {e:.3e} "
                  f"tol {APPLY_ATOL:.0e}")
            check(e <= APPLY_ATOL, f"{v} (norm={norm}) disagrees at {tag}")
            check((Vn - V).abs().max().item() > 0, f"{v} left V unchanged")
            err[v] = max(err[v], e)
        del W, V, U, A, UT
    torch.cuda.synchronize()

    # Bounds as for B2/B5/B8, times L (B11's by the cross-Gram identity;
    # B17's kernel, as B8's, without V, which cancels).  B17 is timed as its kernel alone on
    # the reference pallas_call's operands (B, Uᵀ, W', V), and as the
    # wrapper the executor calls, which forms B with a torch GEMM first.
    timings = {}
    for label, L, out_d, in_d, k, N in (("wq", 24, 896, 896, LLM_RANK, 2),
                                        ("w_gate", 24, 4864, 896, LLM_RANK, 2)):
        W, V, U, s, alpha, A, UT = inputs(L, out_d, in_d, k, N)
        Wn = kern.maecho_update_left_stacked(W, A, UT, alpha, eta)
        B = kern.compressed_residual(Wn, V, U, s)
        OI, OK, KI = L * out_d * in_d, L * out_d * k, L * k * in_d
        gemm = 2.0 * N * OI * k
        cases = {
            g: (lambda: kern.maecho_gram_left_stacked(A, UT),
                lambda: ref.maecho_gram_left_stacked_ref(A, UT),
                L * gram_left_flops(N, out_d, in_d, k), 4.0 * (N * OK + N * KI + L * N * N)),
            u: (lambda: kern.maecho_update_left_stacked(W, A, UT, alpha, eta),
                lambda: ref.maecho_update_left_stacked_ref(W, A, UT, alpha, eta),
                gemm + 2.0 * N * OI + 2.0 * OI, 4.0 * (2 * OI + N * OK + N * KI + L * N)),
            v: (lambda: kern.maecho_v_update_left_stacked(B, UT, Wn, V, frac),
                lambda: ref.maecho_v_update_left_stacked_ref(B, UT, Wn, V, frac),
                gemm + 2.0 * N * OI, 4.0 * (N * OK + N * KI + OI + N * OI)),
            f"{v} wrapper": (
                lambda: kern.maecho_v_update_factored_stacked(Wn, V, U, s, frac, UT=UT),
                lambda: ref.maecho_v_update_factored_stacked_ref(Wn, V, U, s, frac),
                2 * gemm + N * OK + 5.0 * N * OI,
                4.0 * (OI + 2 * N * OI + N * KI + N * L * k)),
        }
        time_cases(torch, label, cases, timings, 10)
        product_alone(torch, label, "B11/B14/B17", "torch.bmm(A, UT) over N·L",
                      lambda Af=A.reshape(N * L, out_d, k), UTf=UT.reshape(N * L, k, in_d):
                      torch.bmm(Af, UTf), 10)
        del W, V, U, A, UT, B, Wn
    return err, timings


def residuals64(name: str, *args):
    """Float64 residual stack of a Gram kernel's operands: (N, out, in),
    or (N, L, out, in) for the stacked kernels."""
    a = [x.double() for x in args]
    if "left" in name:
        return a[0] @ a[1]                                  # A @ UT
    d = a[0][None] - a[1]                                   # W - V
    if "diag" in name:
        return d * (a[2][:, None, :] if d.dim() == 3 else a[2][:, :, None, :])
    return d @ a[2]


def gram64(R):
    """(N, N) or (L, N, N) float64 Gram of :func:`residuals64`'s stack."""
    Rf = R.reshape(R.shape[0], -1) if R.dim() == 3 else \
        R.transpose(0, 1).reshape(R.shape[1], R.shape[0], -1)
    return Rf @ Rf.transpose(-1, -2)


def phase_many_clients(torch, kern, ref, timings):
    """The six Gram kernels past 54 clients (B2, B3, B10, B11, B12 in
    client blocks of at most 27, one CTA per tile and block pair; B1 with
    no client cap, its kernels and workspace printed) against their plain
    versions and a float64 Gram on a W0-sized leaf (400 x 784; L = 2 for
    the stacked ones; factored rank 78), bitwise reproducible, timed
    with their plain versions at N = 4 and MANY_CLIENTS.  Returns
    {name: max |kernel - plain|}."""
    from repro_torch.kernels import build, maecho_gram

    gen = torch.Generator(device="cuda").manual_seed(5)
    out_d, in_d, k, L = 400, 784, RANK, 2
    err = {name: 0.0 for name in GRAMS}
    for N in (4,) + MANY_CLIENTS:
        W = torch.randn(L, out_d, in_d, device="cuda", generator=gen) * 0.1
        V = W + torch.randn(N, L, out_d, in_d, device="cuda", generator=gen) * 0.05
        U = torch.linalg.qr(torch.randn(N, L, in_d, in_d // 2, device="cuda",
                                        generator=gen))[0]
        P = (U @ U.transpose(-1, -2)).contiguous()
        del U
        Uf = torch.linalg.qr(torch.randn(N, L, in_d, k, device="cuda",
                                         generator=gen))[0].contiguous()
        s = torch.rand(N, L, k, device="cuda", generator=gen) * 0.9 + 0.1
        p = torch.rand(N, L, in_d, device="cuda", generator=gen)
        A = kern.compressed_residual(W, V, Uf, s)
        UT = Uf.transpose(-1, -2).contiguous()
        one = [x[:, 0].contiguous() for x in (V, P, A, UT, p)]
        args = {"maecho_gram": (W[0].contiguous(), one[0], one[1]),
                "maecho_gram_left": (one[2], one[3]),
                "maecho_gram_diag": (W[0].contiguous(), one[0], one[4]),
                "maecho_gram_stacked": (W, V, P),
                "maecho_gram_left_stacked": (A, UT),
                "maecho_gram_diag_stacked": (W, V, p)}
        OI, II, NI = out_d * in_d, in_d * in_d, N * in_d
        cost = {"maecho_gram": (2.0 * N * OI * in_d + N * OI + N * (N + 1) * OI,
                                4.0 * (OI + N * OI + N * II + N * N)),
                "maecho_gram_left": (gram_left_flops(N, out_d, in_d, k),
                                     4.0 * (N * out_d * k + N * k * in_d + N * N)),
                "maecho_gram_diag": (2.0 * N * OI + N * (N + 1) * OI,
                                     4.0 * (OI + N * OI + NI + N * N), FP32_FLOPS)}
        for name in GRAMS:
            fn, plain = getattr(kern, name), getattr(ref, name + "_ref")
            a = args[name]
            G, Gr, G64 = fn(*a), plain(*a), gram64(residuals64(name, *a))
            e = (G - Gr).abs().max().item()
            tol = GRAM_RTOL * Gr.abs().max().item()
            e64 = (G.double() - G64).abs().max().item()
            p64 = (Gr.double() - G64).abs().max().item()
            tol64 = GRAM_RTOL * G64.abs().max().item()
            print(f"[c1] N={N} {name} ({out_d}x{in_d}{', L=2' if name.endswith('_stacked') else ''})"
                  f" max_abs_err {e:.3e} tol {tol:.3e}; against float64: kernel {e64:.3e}, "
                  f"plain {p64:.3e}, tol {tol64:.3e}")
            check(e <= tol, f"{name} disagrees at N={N}")
            check(e64 <= tol64, f"{name} disagrees with a float64 Gram at N={N}")
            del G64
            check(torch.equal(G, fn(*a)), f"{name} is not reproducible at N={N}")
            err[name] = max(err[name], e)
            fl, nb, *rate = cost[name.replace("_stacked", "")]
            if name.endswith("_stacked"):               # each layer's work, L times
                fl, nb = L * fl, L * nb
            time_cases(torch, f"N{N}", {name: (lambda: fn(*a), lambda: plain(*a), fl, nb,
                                               *rate)},
                       timings, 3 if N > 4 else 20)
            if name == "maecho_gram":   # B1: its kernels by N, its workspace
                ws = build.load(name, maecho_gram._SIGS).maecho_gram_workspace_floats(
                    N, out_d, in_d)
                print(f"[c1] N={N} maecho_gram route {list(B1_ROUTES[N <= 8])}: "
                      f"{timings[(name, f'N{N}')][0]:.4f} ms, workspace {4 * ws / 1e6:.3f} MB")
            elif name == "maecho_gram_left":    # B2: B1's kernels by N, its plan, workspace
                units = -(-out_d // 128) * -(-in_d // 128) * N
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                print(f"[c1] N={N} maecho_gram_left route {list(B1_ROUTES[N <= 8])}, "
                      f"{units} (tile, client) units "
                      f"{'a CTA each' if units <= sms else f'in shares over {sms} CTAs'}: "
                      f"{timings[(name, f'N{N}')][0]:.4f} ms, workspace "
                      f"{4 * gram_left_workspace(N, out_d, in_d, k) / 1e6:.3f} MB")
        del W, V, P, Uf, A, UT, p, one, args
    ws = build.load("maecho_gram_stacked", maecho_gram._STACKED_SIGS)
    n = MANY_CLIENTS[-1]
    print(f"[c1] Gram workspace at N={n}, {out_d}x{in_d}: "
          f"{4 * ws.maecho_gram_stacked_workspace_floats(n, 1, out_d, in_d) / 1e6:.3f} MB "
          f"(L = 1), {4 * ws.maecho_gram_stacked_workspace_floats(n, L, out_d, in_d) / 1e6:.3f}"
          f" MB (L = 2); at N=64, L = 1: "
          f"{4 * ws.maecho_gram_stacked_workspace_floats(64, 1, out_d, in_d) / 1e6:.3f} MB")
    torch.cuda.synchronize()
    return err


def gram_left_workspace(N: int, out_d: int, in_d: int, k: int) -> int:
    """Floats of workspace one B2 launch takes (residual fragments or
    stack, partial tiles, pair partials)."""
    from repro_torch.kernels import build, maecho_gram

    lib = build.load("maecho_gram_left", maecho_gram._LEFT_SIGS)
    return lib.maecho_gram_left_workspace_floats(N, out_d, in_d, k)


def phase_many_clients_mlp(torch, kern):
    """A dense-projector MA-Echo aggregate of 64 synthetic clients at the
    paper MLP's shapes (784-400-200-100-10; rank-in/2 projectors on every
    "W", the scalar rule on every bias), backend="kernel" against
    backend="oracle" at τ = TAU_CHECK."""
    from repro_torch.core.maecho import MAEchoConfig, maecho_aggregate

    clients, projs = synthetic_mlp_clients(torch, 64, 6)

    def run(tau, backend):
        return maecho_aggregate(clients, projs, MAEchoConfig(tau=tau, eta=0.5, mu=20.0),
                                backend=backend)

    t0 = time.perf_counter()
    r = aggregates(torch, kern, run, TAU_CHECK)
    r["t"] = time.perf_counter() - t0
    r.update(shapes=[tuple(lay["W"].shape) for lay in clients[0]], clients=clients,
             projs=projs)
    return r


def synthetic_mlp_clients(torch, N: int, seed: int, rank=None):
    """N seeded synthetic clients at the paper MLP's shapes
    (784-400-200-100-10): one init plus 0.05 noise each, and per "W" a
    rank-in/2 dense projector (``rank=None``) or a factored one
    {"U": orthonormal (in, rank), "s" in [0.1, 1)}; the scalar rule on
    every bias."""
    from repro_torch.fl import models as pm

    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = pm.init(pm.MLP_SPEC, seed=3, device="cuda")
    clients, projs = [], []
    for _ in range(N):
        clients.append([{key: x + 0.05 * torch.randn(x.shape, device="cuda", generator=gen)
                         for key, x in lay.items()} for lay in base])
        proj = []
        for lay in base:
            d = lay["W"].shape[1]
            if rank is None:
                U = torch.linalg.qr(torch.randn(d, d // 2, device="cuda", generator=gen))[0]
                P = (U @ U.T).contiguous()
            else:
                U = torch.linalg.qr(torch.randn(d, rank, device="cuda", generator=gen))[0]
                P = {"U": U.contiguous(),
                     "s": torch.rand(rank, device="cuda", generator=gen) * 0.9 + 0.1}
            proj.append({"W": P, "b": torch.ones((), device="cuda")})
        projs.append(proj)
    return clients, projs


def factor_llm_projections(torch, projs, k: int):
    """Every dense (24, 896, 896) projector of an LLM silo factored layer
    by layer with ``core.projections.factor_projection`` at rank k, as
    {"U": (24, 896, k), "s": (24, k)}; leaves sharing one projector
    (wq/wk/wv, w_gate/w_up) share its factors.  Others are kept."""
    from repro_torch.core.projections import factor_projection
    from repro_torch.utils import trees

    done = {}

    def fac(_, x):
        if x.dim() != 3:
            return x
        if id(x) not in done:
            parts = [factor_projection(x[l], k) for l in range(x.shape[0])]
            done[id(x)] = {"U": torch.stack([q["U"] for q in parts]).contiguous(),
                           "s": torch.stack([q["s"] for q in parts]).contiguous()}
        return done[id(x)]

    return trees.map_with_path(fac, projs)


def phase_llm_factored_path(torch, kern, lm):
    """The LLM path's two silos with their dense projectors factored at
    rank LLM_RANK (the stacked factored route, B11/B14/B17): aggregate at
    LLM_TAU (timed, launches counted, peak memory), kernel vs oracle at
    TAU_CHECK, the aggregate's perplexities."""
    from repro_torch.core.maecho import MAEchoConfig
    from repro_torch.fl.llm_adapter import aggregate_llm
    from repro_torch.utils import trees

    cfg, silos = lm["cfg"], lm["silos"]
    t0 = time.perf_counter()
    projs = [factor_llm_projections(torch, p, LLM_RANK) for p in lm["projs"]]
    torch.cuda.synchronize()
    f = {"t_factor": time.perf_counter() - t0}
    shapes = {p: tuple(x.shape) for p, x in trees.tree_paths(projs[0])}
    print(f"[llm-factored] projector shapes {shapes}")
    for leaf in ("wq", "wk", "wv", "w_gate", "w_up"):
        check(shapes[f"layers.{leaf}.U"] == (24, 896, LLM_RANK)
              and shapes[f"layers.{leaf}.s"] == (24, LLM_RANK),
              f"factored LLM projector shapes {shapes}")

    def run(tau, backend):
        return aggregate_llm(cfg, silos, projs, MAEchoConfig(tau=tau, eta=0.5, mu=20.0),
                             backend=backend)

    f["before_gb"], f["before_gc_gb"] = allocated_gb(torch)
    (agg, f["t_agg"], f["spans"]), f["launches"] = count_launches(
        torch, kern, lambda: timed_calls(torch, lambda: run(LLM_TAU, "kernel")))
    f["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(all(bool(torch.isfinite(x).all()) for _, x in trees.tree_paths(agg)),
          "the factored LLM aggregate has non-finite values")
    t1 = time.perf_counter()
    f["diff"] = tree_max_diff(run(TAU_CHECK, "kernel"), run(TAU_CHECK, "oracle"))
    torch.cuda.synchronize()
    f["t_check"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    f["ppl"] = {"maecho_factored": llm_ppl(torch, lm["model"], cfg, agg)}
    f["t_ppl"] = time.perf_counter() - t1
    f["projs"] = projs
    return f


def phase_bench_stacked_agg(torch, kern):
    """The reference's ``benchmarks/bench_stacked_agg.py`` factored case:
    N = 4 clients of one (L, 512, 512) leaf with factored projectors of
    rank 32 (s uniform in [0, 1)), MAEchoConfig(tau=2, eta=0.5,
    qp_iters=60), at L = 2 and 16.  Kernel vs oracle within AGG_ATOL, and
    one launch of each of B11/B14/B17 per leaf and outer iteration,
    whatever L is.  Returns {L: (launches, max |dW|, wall s)}."""
    from repro_torch.core.maecho import MAEchoConfig, maecho_aggregate

    gen = torch.Generator(device="cuda").manual_seed(7)
    cfg = MAEchoConfig(tau=2, eta=0.5, qp_iters=60)
    out = {}
    for L in (2, 16):
        clients = [{"W": torch.randn(L, 512, 512, device="cuda", generator=gen) * 0.3}
                   for _ in range(4)]
        projs = [{"W": {"U": torch.linalg.qr(torch.randn(L, 512, 32, device="cuda",
                                                         generator=gen))[0].contiguous(),
                        "s": torch.rand(L, 32, device="cuda", generator=gen)}}
                 for _ in range(4)]

        def run(backend):
            return maecho_aggregate(clients, projs, cfg, stack_levels={"W": 1},
                                    backend=backend)

        t0 = time.perf_counter()
        got, launches = count_launches(torch, kern, lambda: run("kernel"))
        wall = time.perf_counter() - t0
        diff = (got["W"] - run("oracle")["W"]).abs().max().item()
        out[L] = (launches, diff, wall)
    return out


def phase_chunk_kernels(torch, kern, ref):
    """B19 and B20 against their plain versions and float64 on the card,
    timed with their plain versions and a PyTorch yardstick; then a
    client's W0 projector chained through ``ops.block_rls_update``.
    Returns (errors, timings, {(name, label): yardstick ms}, chain
    record)."""
    from repro_torch.core import projections as proj
    from repro_torch.data.synthetic import DatasetSpec, generate
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(8)
    err = {"maecho_gram_cross": 0.0, "rank_downdate": 0.0}
    timings, library = {}, {}
    for label, ca, cb, D in (("W0", 64, 64, 400 * 784), ("w_gate", 64, 64, 4864 * 896),
                             ("ragged", 37, 64, 60001), ("one", 1, 64, 313600),
                             ("embed", 1, 1, 896 * 151936), ("W0 16", 16, 16, 400 * 784)):
        Ra = torch.randn(ca, D, device="cuda", generator=gen)
        Rb = torch.randn(cb, D, device="cuda", generator=gen)
        tag = f"{label} (ca={ca}, cb={cb}, D={D})"
        G, Gr = kern.maecho_gram_cross(Ra, Rb), ref.maecho_gram_cross_ref(Ra, Rb)
        G64 = Ra.double() @ Rb.double().T
        e, tol = (G - Gr).abs().max().item(), GRAM_RTOL * Gr.abs().max().item()
        e64, tol64 = (G.double() - G64).abs().max().item(), GRAM_RTOL * G64.abs().max().item()
        p64 = (Gr.double() - G64).abs().max().item()
        l64 = (torch.mm(Ra, Rb.T).double() - G64).abs().max().item()
        del G64
        print(f"[kernels] {tag} maecho_gram_cross max_abs_err {e:.3e} tol {tol:.3e}; "
              f"against float64: kernel {e64:.3e}, plain {p64:.3e}, torch.mm {l64:.3e}, "
              f"tol {tol64:.3e}")
        check(e <= tol, f"maecho_gram_cross disagrees at {tag}")
        check(e64 <= tol64, f"maecho_gram_cross disagrees with float64 at {tag}")
        check(torch.equal(G, kern.maecho_gram_cross(Ra, Rb)),
              f"maecho_gram_cross is not reproducible at {tag}")
        Gs = kern.maecho_gram_cross(Rb, Rb)
        check(torch.equal(Gs, Gs.T), f"maecho_gram_cross (Rb, Rb) is not symmetric at {tag}")
        err["maecho_gram_cross"] = max(err["maecho_gram_cross"], e)
        reps = 3 if D > 10 ** 6 else 20
        time_cases(torch, label, {"maecho_gram_cross": (
            lambda: kern.maecho_gram_cross(Ra, Rb), lambda: ref.maecho_gram_cross_ref(Ra, Rb),
            2.0 * ca * cb * D, 4.0 * ((ca + cb) * D + ca * cb))}, timings, reps)
        library[("maecho_gram_cross", label)] = graph_ms(torch, lambda: torch.mm(Ra, Rb.T), reps)
        print(f"[kernels] {label} torch.mm(Ra, Rb.T) (TF32 off): "
              f"{library[('maecho_gram_cross', label)]:.4f} ms")
        del Ra, Rb, G, Gr, Gs
    for label, d, b in (("bench", 512, 64), ("W0", 784, 128), ("d_model", 896, 128)):
        Q0 = torch.randn(d, d, device="cuda", generator=gen)
        Q = Q0 @ Q0.T / d + torch.eye(d, device="cuda")
        Xb = torch.randn(b, d, device="cuda", generator=gen)
        Xb = Xb / torch.linalg.vector_norm(Xb, dim=-1, keepdim=True)
        U = Q @ Xb.T                                   # block_rls_update's operands
        A = torch.linalg.inv(torch.eye(b, device="cuda") + Xb @ U)
        A = (0.5 * (A + A.T)).contiguous()
        tag = f"{label} (d={d}, b={b})"
        out, plain = kern.rank_downdate(Q, U, A), ref.rank_downdate_ref(Q, U, A)
        out64 = Q.double() - U.double() @ A.double() @ U.double().T
        e = (out - plain).abs().max().item()
        e64 = (out.double() - out64).abs().max().item()
        print(f"[kernels] {tag} rank_downdate max_abs_err {e:.3e}, against float64 "
              f"{e64:.3e} (plain {(plain.double() - out64).abs().max().item():.3e}), "
              f"tol 1e-3")
        check(e <= 1e-3 and e64 <= 1e-3, f"rank_downdate disagrees at {tag}")
        err["rank_downdate"] = max(err["rank_downdate"], e)
        time_cases(torch, label, {"rank_downdate": (
            lambda: kern.rank_downdate(Q, U, A), lambda: ref.rank_downdate_ref(Q, U, A),
            downdate_flops(d, b),
            4.0 * (2 * d * d + d * b + b * b))}, timings)
        library[("rank_downdate", label)] = graph_ms(
            torch, lambda: torch.addmm(Q, U @ A, U.T, alpha=-1), 50)
        print(f"[kernels] {label} library: none (2 calls, torch.addmm(Q, U @ A, U.T, "
              f"alpha=-1): {library[('rank_downdate', label)]:.4f} ms)")

    data = generate(DatasetSpec("fidelity", n_train=6000, n_test=1200, latent=24,
                                out_dim=784, seed=0))
    X = torch.as_tensor(data["train_x"][:2048], device="cuda")
    X = X / torch.linalg.vector_norm(X, dim=-1, keepdim=True).clamp_min(1e-6)

    def chain():
        Q = proj.null_projector_init(X.shape[1], device="cuda")
        for Xb in X.reshape(-1, 128, X.shape[1]):
            Q = ops.block_rls_update(Q, Xb, 1.0)
        return Q

    t0 = time.perf_counter()
    Q, launches = count_launches(torch, kern, chain)
    chained = {"t": time.perf_counter() - t0, "launches": launches,
               "blocks": X.shape[0] // 128}
    chained["diff"] = (Q - proj.null_projector_from_features(X, 1.0, 128)).abs().max().item()
    return err, timings, library, chained


def phase_large_n(torch, kern, ref):
    """The reference's ``bench_largeN_agg`` grid on the card (one factored
    leaf, fixed uniform α, no QP): chunked through B19 against unchunked
    plain, with each side's device memory peak above its inputs and
    outputs; N = 4096 chunked only; the QP at N = 512 and 4096, timed,
    with its memory peak above G, against the same solve on the CPU."""
    from repro_torch.core import qp
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(9)

    def case(N, d, rank):
        W = torch.randn(d, d, device="cuda", generator=gen) * 0.3
        V = torch.randn(N, d, d, device="cuda", generator=gen) * 0.3
        U = torch.linalg.qr(torch.randn(N, d, rank, device="cuda", generator=gen))[0]
        s = torch.rand(N, rank, device="cuda", generator=gen) * 0.9 + 0.1
        return W, V, {"U": U.contiguous(), "s": s}, torch.full((N,), 1.0 / N, device="cuda")

    def chunked(W, V, P, alpha):
        G, ctx = ops.maecho_streaming_gram_chunked(W, V, P, chunk=CHUNK, use_kernel=True)
        return (G,) + ops.maecho_streaming_apply_chunked(alpha, ctx, eta=0.5, frac=0.5,
                                                         norm=True)

    def unchunked(W, V, P, alpha):
        Wn = ref.maecho_update_ref_any(W, V, P, alpha, 0.5)
        return ref.maecho_gram_ref(W, V, P), Wn, ref.maecho_v_update_ref(Wn, V, P, 0.5, True)

    def measure(fn, *args):
        """(outputs, wall s, peak bytes above inputs and outputs)."""
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        outs = fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return outs, wall, torch.cuda.max_memory_allocated() - base - sum(
            x.numel() * x.element_size() for x in outs)

    rows = {}
    for N in (8, 64, 128, 512):
        W, V, P, alpha = case(N, 256, 16)
        (ch, t_ch, m_ch), launches = count_launches(
            torch, kern, lambda: measure(chunked, W, V, P, alpha))
        un, t_un, m_un = measure(unchunked, W, V, P, alpha)
        nc = -(-N // CHUNK)
        check(launches["maecho_gram_cross"] == nc * (nc + 1) // 2
              and sum(launches.values()) == launches["maecho_gram_cross"],
              f"largeN N={N}: launches {launches}")
        eg = (ch[0] - un[0]).abs().max().item()
        tol = GRAM_RTOL * un[0].abs().max().item()
        ew = max((a - b).abs().max().item() for a, b in zip(ch[1:], un[1:]))
        print(f"[largeN] N={N} 256x256 k=16 chunk={CHUNK}: chunked {t_ch * 1e3:.3f} ms, "
              f"peak above inputs+outputs {m_ch / 1e6:.3f} MB ({launches['maecho_gram_cross']}"
              f" B19 launches); unchunked plain {t_un * 1e3:.3f} ms, {m_un / 1e6:.3f} MB; "
              f"G max_abs_err {eg:.3e} tol {tol:.3e}, W'/V' max_abs_err {ew:.3e} "
              f"tol {AGG_ATOL:.0e}")
        check(eg <= tol and ew <= AGG_ATOL, f"largeN N={N}: chunked disagrees with unchunked")
        rows[N] = (t_ch, m_ch, t_un, m_un)
        del W, V, P, ch, un
    ch512, ch128 = rows[512][1], rows[128][1]
    un512, un128 = rows[512][3], rows[128][3]
    print(f"[largeN] chunked peak N=512 / N=128: {ch512 / ch128:.3f} (limit 1.25); unchunked "
          f"peak N=512 / N=128: {un512 / un128:.3f} (at least 3); unchunked / chunked at "
          f"N=512: {un512 / ch512:.3f} (printed beside the >= 4x the reference's bench "
          f"asserts on XLA's temp bytes)")
    check(ch512 <= 1.25 * ch128, "the chunked peak is not O(chunk)")
    check(un512 >= 3 * un128, "the unchunked peak does not grow with N")
    W, V, P, alpha = case(4096, 32, 8)
    (ch, t_ch, m_ch), launches = count_launches(
        torch, kern, lambda: measure(chunked, W, V, P, alpha))
    check(all(bool(torch.isfinite(x).all()) for x in ch), "largeN N=4096 is not finite")
    print(f"[largeN] N=4096 32x32 k=8 chunk={CHUNK}, chunked only: {t_ch * 1e3:.3f} ms, "
          f"peak above inputs+outputs {m_ch / 1e6:.3f} MB, {launches['maecho_gram_cross']} "
          f"B19 launches")
    rows[4096] = (t_ch, m_ch, None, None)
    del W, V, P, ch
    for N, iters in ((512, 200), (4096, 30)):
        X = torch.randn(N, min(N, 256), device="cuda", generator=gen) * 0.5
        G = X @ X.T + 0.1 * torch.eye(N, device="cuda")
        mask = torch.arange(N, device="cuda") % 10 != 3
        del X
        qp.solve_qp(G, 0.6, iters, mask)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        a = qp.solve_qp(G, 0.6, iters, mask)
        torch.cuda.synchronize()
        t_qp, m_qp = time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base
        d = (a.cpu() - qp.solve_qp(G.cpu(), 0.6, iters, mask.cpu())).abs().max().item()
        print(f"[largeN] QP N={N} (a tenth masked out), {iters} iterations: "
              f"{t_qp * 1e3:.3f} ms, peak above G {m_qp / 1e6:.3f} MB (G {G.numel() * 4 / 1e6:.3f}"
              f" MB); max |alpha - the same solve on the CPU| {d:.3e} tol 1e-5")
        check(d <= 1e-5, f"the QP on the card disagrees with the CPU at N={N}")
        check(bool((a[~mask] == 0).all()), f"the QP gives weight to masked-out clients at N={N}")
        del G, a
    return rows


def phase_chunked_mlp(torch, kern, m64):
    """256 synthetic clients with factored rank-78 projectors through the
    chunked kernel aggregate (chunk 64, τ = 2), against the unchunked
    kernel and oracle aggregates; then phase 9's 64 dense clients at
    chunk 16 against the oracle."""
    from repro_torch.core.maecho import MAEchoConfig, maecho_aggregate

    t0 = time.perf_counter()
    clients, projs = synthetic_mlp_clients(torch, 256, 10, RANK)
    r = {"t_setup": time.perf_counter() - t0}

    def cfg(chunk):
        return MAEchoConfig(tau=2, eta=0.5, mu=20.0, client_chunk=chunk)

    r["before_gb"], r["before_gc_gb"] = allocated_gb(torch)
    (agg, r["t_agg"], r["spans"]), r["launches"] = count_launches(
        torch, kern, lambda: timed_calls(
            torch, lambda: maecho_aggregate(clients, projs, cfg(CHUNK), backend="kernel")))
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    t1 = time.perf_counter()
    unchunked, r["launches_unchunked"] = count_launches(
        torch, kern, lambda: maecho_aggregate(clients, projs, cfg(0), backend="kernel"))
    r["diff_kernel"] = max_diff(agg, unchunked)
    r["diff_oracle"] = max_diff(agg, maecho_aggregate(clients, projs, cfg(0), backend="oracle"))
    torch.cuda.synchronize()
    r["t_check"] = time.perf_counter() - t1
    del clients, projs, agg, unchunked

    t1 = time.perf_counter()
    agg, r["launches16"] = count_launches(torch, kern, lambda: maecho_aggregate(
        m64["clients"], m64["projs"], cfg(16), backend="kernel"))
    r["diff16"] = max_diff(agg, maecho_aggregate(m64["clients"], m64["projs"], cfg(0),
                                                 backend="oracle"))
    torch.cuda.synchronize()
    r["t16"] = time.perf_counter() - t1
    return r


def phase_llm_chunked(torch, kern, lm, lf):
    """The LLM silos with phase 10's factored projectors through
    ``aggregate_llm`` at client_chunk 1, τ = 2 (timed, launches counted,
    peak memory), against the unchunked kernel aggregate at τ = 2."""
    from repro_torch.core.maecho import MAEchoConfig
    from repro_torch.fl.llm_adapter import aggregate_llm

    def run(chunk):
        return aggregate_llm(lm["cfg"], lm["silos"], lf["projs"],
                             MAEchoConfig(tau=2, eta=0.5, mu=20.0, client_chunk=chunk),
                             backend="kernel")

    r = {}
    r["before_gb"], r["before_gc_gb"] = allocated_gb(torch)
    (agg, r["t_agg"], r["spans"]), r["launches"] = count_launches(
        torch, kern, lambda: timed_calls(torch, lambda: run(1)))
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    t1 = time.perf_counter()
    r["diff"] = tree_max_diff(agg, run(0))
    torch.cuda.synchronize()
    r["t_check"] = time.perf_counter() - t1
    return r


def attention_cases(torch, gen):
    """Phase 16's kernel inputs: B21 at Qwen2-0.5B's prefill (B = 8,
    S = 512, 14/2 heads of 64) in bf16 and fp32 and at a ragged S = 200;
    B22 at its serving decode (B = 8, W = 640, 2 kv heads, group 7, D 64)
    filled to 576, wrapped (fill 700) with row 0 empty, and through a
    ``w_live`` view of a 1024-slot cache."""
    def qkv(B, S, dtype):
        return [torch.randn(B, S, h, 64, device="cuda", generator=gen).to(dtype)
                for h in (14, 2, 2)]

    def decode(fill, W=640, dtype=torch.bfloat16):
        q = torch.randn(8, 1, 14, 64, device="cuda", generator=gen).to(dtype)
        kc, vc = (torch.randn(8, W, 2, 64, device="cuda", generator=gen).to(dtype)
                  for _ in range(2))
        idx = torch.arange(W, device="cuda")
        last = (fill - 1) - torch.remainder(fill - 1 - idx, W)
        return q, kc, vc, ((last >= 0) & (last > fill - 1 - W)).expand(8, W)

    flash = {"main bf16": qkv(8, 512, torch.bfloat16), "main f32": qkv(8, 512, torch.float32),
             "ragged S=200 bf16": qkv(8, 200, torch.bfloat16)}
    wrapped = decode(700)
    wrapped = wrapped[:3] + (wrapped[3].clone(),)
    wrapped[3][0] = False
    q, kc, vc, mask = decode(576, W=1024)      # ops.live_window(576, 1024) = 640
    dec = {"main bf16 fill 576": decode(576), "main f32 fill 576": decode(576, dtype=torch.float32),
           "wrapped fill 700, row 0 empty": wrapped,
           "w_live view of W=1024": (q, kc[:, :640], vc[:, :640], mask[:, :640])}
    return flash, dec


def phase_serve_kernels(torch, kern, ref):
    """B21 and B22 against their plain versions at the serving path's
    shapes, timed from CUDA-graph replays beside their plain versions and
    ``scaled_dot_product_attention`` (timed only; the port never calls
    it).  Returns (errors, timings, {(name, label): SDPA ms})."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(16)
    flash, dec = attention_cases(torch, gen)
    err, timings, library = {}, {}, {}
    for tag, (q, k, v) in flash.items():
        got = kern.flash_attention(q, k, v)
        e = (got.float() - ref.flash_attention_ref(q, k, v).float()).abs().max().item()
        tol = 2e-5 if q.dtype == torch.float32 else 1e-2
        print(f"[kernels] serve {tag} (B={q.shape[0]}, S={q.shape[1]}, 14/2 heads of 64, "
              f"causal) flash_attention max_abs_err {e:.3e} tol {tol:.0e}")
        check(e <= tol, f"flash_attention disagrees with its plain version at {tag}")
        check(torch.equal(got, kern.flash_attention(q, k, v)),
              f"flash_attention is not reproducible at {tag}")
        if tag == "main bf16":
            err["flash_attention"] = e
    for tag, (q, kc, vc, mask) in dec.items():
        got = kern.decode_attention(q, kc, vc, mask)
        e = (got.float() - ref.decode_attention_ref(q, kc, vc, mask).float()).abs().max().item()
        tol = 2e-5 if q.dtype == torch.float32 else 1e-2
        empty = not bool(mask[0].any())
        print(f"[kernels] serve {tag} (B=8, W={kc.shape[1]}, 2 kv heads, group 7, D=64, "
              f"batch stride {kc.stride(0)}) decode_attention max_abs_err {e:.3e} tol {tol:.0e}"
              + (f"; empty row 0 all zero: {bool((got[0] == 0).all())}" if empty else ""))
        check(e <= tol and (not empty or bool((got[0] == 0).all())),
              f"decode_attention disagrees with its plain version at {tag}")
        check(torch.equal(got, kern.decode_attention(q, kc, vc, mask)),
              f"decode_attention is not reproducible at {tag}")
        if tag == "main bf16 fill 576":
            err["decode_attention"] = e
    q, kc, vc, mask = dec["main bf16 fill 576"]
    names = kernel_names(torch, lambda: kern.decode_attention(q, kc, vc, mask))
    print(f"[kernels] serve decode_attention: kernels a call {names}")
    check(len(names) == 1 and "decode_attention" in names[0],
          f"decode_attention launched {names} in one call, expected its one kernel")

    # timing at the main path's shapes and dtype (bf16); least work and bytes:
    # B21 the unmasked causal half of q.k^T and p.v; B22 the valid slots only;
    # the bound at ATTN_BF16_FLOPS, the fp32 SIMT figure printed beside it
    q, k, v = flash["main bf16"]
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    flops = 2.0 * B * Hq * D * S * (S + 1)
    nbytes = 2.0 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    time_cases(torch, "serve", {"flash_attention": (
        lambda: kern.flash_attention(q, k, v), lambda: ref.flash_attention_ref(q, k, v),
        flops, nbytes, ATTN_BF16_FLOPS)}, timings, 20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library[("flash_attention", "serve")] = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20)
    print(f"[kernels] serve flash_attention: all flops at the fp32 SIMT rate "
          f"{flops / FP32_FLOPS * 1e3:.4f} ms; library scaled_dot_product_attention(is_causal, "
          f"enable_gqa) {library[('flash_attention', 'serve')]:.4f} ms")
    # fp32 operands (the exactness paths) run B21's SIMT body: bound at
    # FP32_TOL_FLOPS (3xTF32 meets the fp32 tolerance; plain TF32 does not),
    # 4-byte operands
    q, k, v = flash["main f32"]
    time_cases(torch, "serve f32", {"flash_attention": (
        lambda: kern.flash_attention(q, k, v), lambda: ref.flash_attention_ref(q, k, v),
        flops, 2 * nbytes)}, timings, 20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library[("flash_attention", "serve f32")] = graph_ms(
        torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True), 20)
    print(f"[kernels] serve f32 flash_attention: library scaled_dot_product_attention"
          f"(is_causal, enable_gqa) {library[('flash_attention', 'serve f32')]:.4f} ms")

    q, kc, vc, mask = dec["main bf16 fill 576"]
    n_valid = int(mask.sum())
    W = kc.shape[1]
    flops = 4.0 * Hq * D * n_valid
    nbytes = 2.0 * (2 * B * Hq * D + 2 * n_valid * Hkv * D) + B * W
    time_cases(torch, "serve", {"decode_attention": (
        lambda: kern.decode_attention(q, kc, vc, mask),
        lambda: ref.decode_attention_ref(q, kc, vc, mask), flops, nbytes, ATTN_BF16_FLOPS)},
        timings, 50)
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    am = mask[:, None, None, :]
    library[("decode_attention", "serve")] = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=am, enable_gqa=True), 50)
    print(f"[kernels] serve decode_attention ({n_valid} valid slots of {B}x{W}): all flops "
          f"at the fp32 SIMT rate {flops / FP32_FLOPS * 1e3:.6f} ms; library "
          f"scaled_dot_product_attention(bool attn_mask, enable_gqa) "
          f"{library[('decode_attention', 'serve')]:.4f} ms")
    return err, timings, library


def profile_decode(torch, cfg, params, prompts, steps: int = 8) -> dict:
    """``torch.profiler`` over ``steps`` decode steps of the fixed batch
    (after its prefill): the device's busy share of the window (kernel
    time summed over the one stream, over the window's host wall time)
    and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import live_bucket, pad_kv_to_window, round_window
    from repro_torch.models.zoo import get_model

    model = get_model(cfg)
    P = prompts.shape[1]
    window = round_window(P + SERVE_GEN)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompts})
        cache = pad_kv_to_window(cache, window)
        step = model.make_serve_step()
        token = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        token, cache = step(params, cache, token, P, w_live=live_bucket(P + 1, window))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(1, steps + 1):
                token, cache = step(params, cache, token, P + t, w_live=live_bucket(P + t + 1, window))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    b22 = [us for n, us in by_name.items() if "decode_attention" in n]
    return {"steps": steps, "wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "n_kernels": len(kernels), "top": [(n[:60], us / 1e3) for n, us in top],
            "b22_ms": sum(b22) / 1e3, "b22_names": len(b22)}


def phase_serve(torch, kern, lm):
    """Serve phase 7's dense kernel aggregate at full width: the fixed
    batch on ``attn_backend="auto"`` (bf16), kernel against oracle at fp32
    compute, and continuous batching against the fixed batch."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import first_mismatch, per_request, run_arrival, run_fixed
    from repro_torch.models.zoo import get_model

    cfg = get_config("qwen2-0.5b")
    params = lm["agg"]
    rng = np.random.RandomState(0)
    prompts = torch.as_tensor(rng.randint(0, cfg.vocab, (SERVE_B, SERVE_PROMPT)).astype(np.int32),
                              device="cuda")
    r = {"cfg": cfg}
    r["before_gb"], r["before_gc_gb"] = allocated_gb(torch)
    (tokens, stats), r["launches"] = count_launches(
        torch, kern, lambda: run_fixed(cfg, get_model(cfg), params, prompts, SERVE_GEN))
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["fixed"] = stats
    r["tokens_ok"] = (tuple(tokens.shape) == (SERVE_B, SERVE_GEN)
                      and bool(((tokens >= 0) & (tokens < cfg.vocab)).all()))
    r["fixed_warm"] = run_fixed(cfg, get_model(cfg), params, prompts, SERVE_GEN)[1]
    r["profile"] = profile_decode(torch, cfg, params, prompts)

    cfg32 = cfg.replace(compute_dtype="float32")
    runs = {}
    for backend in ("kernel", "oracle"):
        c = cfg32.replace(attn_backend=backend)
        t0 = time.perf_counter()
        toks, st = run_fixed(c, get_model(c), params, prompts, SERVE_GEN, keep_logits=True)
        runs[backend] = (toks, st, time.perf_counter() - t0)
    (tk, sk, r["t_kernel32"]), (to, so, r["t_oracle32"]) = runs["kernel"], runs["oracle"]
    r["logit_diff"] = (sk["logits"][0].float() - so["logits"][0].float()).abs().max().item()
    r["kernel_vs_oracle"] = first_mismatch(tk.tolist(), to.tolist(), per_request(sk["logits"]),
                                           per_request(so["logits"]))
    del runs, sk, so

    a = ARRIVAL
    ca = cfg32.replace(attn_backend="kernel")
    p2 = torch.as_tensor(np.random.RandomState(1).randint(0, cfg.vocab, (a["requests"], a["prompt"]))
                         .astype(np.int32), device="cuda")
    t0 = time.perf_counter()
    (outs, sa), r["launches_arrival"] = count_launches(torch, kern, lambda: run_arrival(
        ca, get_model(ca), params, p2, a["gen"], slots=a["slots"],
        arrival_every=a["arrival_every"], keep_logits=True))
    r["t_arrival"], r["arrival"] = time.perf_counter() - t0, sa
    fixed, sf = run_fixed(ca, get_model(ca), params, p2, a["gen"], keep_logits=True)
    r["arrival_match"] = first_mismatch(fixed.tolist(), outs, per_request(sf["logits"]),
                                        sa["logits"])
    return r


def check_serve(r: dict) -> None:
    """Phase 16's contract: launch counts, tokens, kernel vs oracle and
    continuous vs fixed batching."""
    nL, a = r["cfg"].n_layers, ARRIVAL
    f, w = r["fixed"], r["fixed_warm"]
    for tag, st, before in (("first", f, RUN_18D_PREFILL_MS[0]),
                            ("second", w, RUN_18D_PREFILL_MS[1])):
        print(f"[serve] fixed batch ({tag} run), {SERVE_B} requests x prompt {SERVE_PROMPT} x "
              f"gen {SERVE_GEN}, {r['cfg'].compute_dtype}, attn_backend={r['cfg'].attn_backend}, "
              f"window {st['window']}: prefill "
              f"{st['t_prefill'] * 1e3:.3f} ms (run 18d: {before:.3f} ms), decode "
              f"{st['t_decode']:.3f} s "
              f"({st['tok_s']:.1f} tok/s, {st['t_decode'] / (SERVE_GEN - 1) * 1e3:.3f} ms a step)")
    pr = r["profile"]
    print(f"[profile] serve decode, {pr['steps']} steps under torch.profiler: wall "
          f"{pr['wall_ms']:.3f} ms, device busy {pr['busy_ms']:.3f} ms "
          f"({100 * pr['busy_ms'] / pr['wall_ms']:.2f} %, {pr['n_kernels']} kernel launches, "
          f"{pr['n_kernels'] / pr['steps']:.0f} a step); most device time: "
          + "; ".join(f"{n} {ms:.3f} ms" for n, ms in pr["top"]))
    print(f"[profile] serve decode: B22 (decode_attention) {pr['b22_ms']:.3f} ms of the window's "
          f"{pr['busy_ms']:.3f} ms device time ({100 * pr['b22_ms'] / pr['busy_ms']:.2f} %), "
          f"{100 * pr['b22_ms'] / pr['wall_ms']:.2f} % of its wall")
    check(pr["b22_names"] == 1, "the decode window ran B22 under more than one kernel name")
    print(f"[memory] serve: allocated before {r['before_gb']:.3f} GB, {r['before_gc_gb']:.3f} GB "
          f"after gc.collect(), peak in the fixed batch {r['peak_gb']:.3f} GB")
    print(f"[launches] serve fixed batch: {r['launches']}")
    want = {"flash_attention": nL, "decode_attention": nL * (SERVE_GEN - 1)}
    for name in KERNELS:
        check(r["launches"][name] == want.get(name, 0), f"{name} ran {r['launches'][name]} "
              f"times in the fixed batch, expected {want.get(name, 0)}")
    check(r["tokens_ok"], "the fixed batch's tokens have the wrong shape or range")
    print(f"[check] serve fp32 compute, kernel vs oracle ({r['t_kernel32']:.3f} / "
          f"{r['t_oracle32']:.3f} s): prefill logits max |d| {r['logit_diff']:.3e} tol "
          f"{LOGIT_ATOL:.0e}; first token mismatch {r['kernel_vs_oracle']}")
    check(r["logit_diff"] <= LOGIT_ATOL, "kernel and oracle prefill logits disagree")
    check(r["kernel_vs_oracle"] is None, "kernel and oracle emit different tokens")
    sa = r["arrival"]
    print(f"[serve] continuous batching ({a['requests']} requests, {a['slots']} slots, "
          f"arrival_every {a['arrival_every']}, prompt {a['prompt']}, gen {a['gen']}, fp32, "
          f"kernel): {sa['decode_steps']} decode steps, {r['t_arrival']:.3f} s, "
          f"{sa['tok_s']:.1f} tok/s, window {sa['window']}")
    print(f"[launches] serve continuous batching: {r['launches_arrival']}")
    want = {"flash_attention": nL * a["requests"], "decode_attention": nL * sa["decode_steps"]}
    for name in KERNELS:
        check(r["launches_arrival"][name] == want.get(name, 0), f"{name} ran "
              f"{r['launches_arrival'][name]} times in continuous batching, expected "
              f"{want.get(name, 0)}")
    m = r["arrival_match"]
    if m is None:
        print("[check] serve continuous vs fixed batch: every request's tokens identical")
    else:
        req, step, gap, diff = m
        print(f"[check] serve continuous vs fixed batch: first token mismatch at request {req}, "
              f"step {step}: top-2 logit gap {gap:.3e}, that step's logits max |d| {diff:.3e} "
              f"tol {LOGIT_ATOL:.0e}")
        check(diff <= LOGIT_ATOL, "continuous and fixed batching disagree beyond a near tie")


def allocated_gb(torch) -> tuple:
    """Device memory allocated now, and after ``gc.collect()`` frees what
    only reference cycles still hold (GB); then resets the peak."""
    torch.cuda.synchronize()
    now = torch.cuda.memory_allocated() / 1e9
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return now, torch.cuda.memory_allocated() / 1e9


def llm_ppl(torch, model, cfg, params) -> list:
    """exp(mean loss) over 5 batches of 8 x 64 tokens on domains 101 and 202."""
    from repro_torch.data.synthetic import lm_token_batches

    with torch.no_grad():
        return [math.exp(sum(float(model.loss_fn(params, {k: torch.as_tensor(v, device="cuda")
                                                           for k, v in b.items()}))
                             for b in lm_token_batches(cfg.vocab, 8, 64, 5, seed=d)) / 5)
                for d in (101, 202)]


def tree_max_diff(a, b) -> float:
    from repro_torch.utils import trees

    return max((x - y).abs().max().item() for (_, x), (_, y)
               in zip(trees.tree_paths(a), trees.tree_paths(b), strict=True))


def phase_llm_path(torch, kern):
    """The cross-silo LLM example at full width: fine-tune, probe,
    aggregate (timed, launches counted), kernel-vs-oracle check at
    TAU_CHECK, perplexities."""
    from repro_torch.configs import get_config
    from repro_torch.core.aggregators import fedavg
    from repro_torch.core.maecho import MAEchoConfig
    from repro_torch.data.synthetic import lm_token_batches
    from repro_torch.fl.llm_adapter import aggregate_llm, build_projections
    from repro_torch.models.zoo import get_model
    from repro_torch.optim.optimizers import adamw
    from repro_torch.utils import trees

    cfg = get_config("qwen2-0.5b").replace(attn_backend="oracle")
    model = get_model(cfg)

    def on_card(b):
        return {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}

    t0 = time.perf_counter()
    base = model.init_params(0)
    n_params = sum(x.numel() for _, x in trees.tree_paths(base))
    print(f"[llm] {cfg.name}: {n_params} parameters, layers {cfg.n_layers}, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd()}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, compute {cfg.compute_dtype}, microbatches "
          f"{cfg.microbatches}, remat {cfg.remat}, attn_backend {cfg.attn_backend}")
    r = {"t_train": 0.0}
    silos, projs, t_proj = [], [], 0.0
    for k in kern.all:          # the fine-tune (attn_backend="oracle") launches no kernel
        k.launches = 0
    for i, dom in enumerate((101, 202)):
        opt = adamw(1e-3)
        params, state = base, opt.init(base)
        step = model.make_train_step(opt)
        losses = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t, b in enumerate(lm_token_batches(cfg.vocab, 8, 64, 60, seed=dom)):
            params, state, loss = step(params, state, on_card(b), t)
            losses.append(loss)
        losses = [float(x) for x in losses]
        r["t_train"] += time.perf_counter() - t1
        print(f"[llm] silo {i} (domain {dom}): AdamW 1e-3, 60 steps of 8x64 tokens, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        check(all(math.isfinite(x) for x in losses),
              f"silo {i} fine-tune gave a non-finite loss")
        del state
        t1 = time.perf_counter()
        projs.append(build_projections(cfg, params, list(lm_token_batches(
            cfg.vocab, 8, 64, 2, seed=dom))))
        torch.cuda.synchronize()
        t_proj += time.perf_counter() - t1
        silos.append(params)
    r["t_proj"], r["t_setup"] = t_proj, time.perf_counter() - t0
    r["launches_finetune"] = {k.__name__: k.launches for k in kern.all}
    shapes = {p: tuple(x.shape) for p, x in trees.tree_paths(projs[0])}
    print(f"[llm] projector shapes {shapes}")
    check(shapes["layers.wq"] == (24, 896, 896) and shapes["layers.w_gate"] == (24, 896, 896)
          and shapes["layers.wo"] == (24,) and shapes["embed"] == (151936,),
          f"LLM projector shapes {shapes}")

    def run(tau, backend):
        return aggregate_llm(cfg, silos, projs, MAEchoConfig(tau=tau, eta=0.5, mu=20.0),
                             backend=backend)

    r["before_gb"], r["before_gc_gb"] = allocated_gb(torch)
    (agg, r["t_agg"], r["spans"]), r["launches"] = count_launches(
        torch, kern, lambda: timed_calls(torch, lambda: run(LLM_TAU, "kernel")))
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(all(bool(torch.isfinite(x).all()) for _, x in trees.tree_paths(agg)),
          "the LLM aggregate has non-finite values")
    t1 = time.perf_counter()
    r["diff"] = tree_max_diff(run(TAU_CHECK, "kernel"), run(TAU_CHECK, "oracle"))
    torch.cuda.synchronize()
    r["t_check"] = time.perf_counter() - t1

    t1 = time.perf_counter()
    r["ppl"] = {name: llm_ppl(torch, model, cfg, p) for name, p in (
        ("silo0", silos[0]), ("silo1", silos[1]), ("fedavg", fedavg(silos)), ("maecho", agg))}
    r["t_ppl"] = time.perf_counter() - t1
    r.update(cfg=cfg, model=model, silos=silos, projs=projs, agg=agg)
    return r


def check_llm_path(r: dict, five=STACKED, path: str = "llm") -> None:
    """The LLM path's launch contract: the stacked kernels of the five
    projected leaves (``five``: dense B10/B13/B16 or factored
    B11/B14/B17), the diagonal stacked ones on two, the diagonal ones on
    the embedding, each once per leaf and outer iteration; no other
    kernel."""
    launches = r["launches"]
    print(f"[launches] {path} path: {launches}")
    if "launches_finetune" in r:
        print(f"[launches] {path} fine-tune (2 silos x 60 AdamW steps, probes): "
              f"{r['launches_finetune']}")
        check(not any(r["launches_finetune"].values()),
              f"a kernel ran during the {path} fine-tune")
    want = {**{n: 5 * LLM_TAU for n in five}, **{n: 2 * LLM_TAU for n in STACKED_DIAG},
            **{n: LLM_TAU for n in DIAG}}
    for name in KERNELS:
        check(launches[name] == want.get(name, 0), f"{name} ran {launches[name]} times "
              f"on the {path} path, expected {want.get(name, 0)}")
    print(f"[check] {path}: kernel-vs-oracle max |dW| over all leaves at tau={TAU_CHECK} "
          f"{r['diff']:.3e} tol {AGG_ATOL:.0e}")
    check(r["diff"] <= AGG_ATOL, f"{path} kernel aggregate disagrees with the oracle "
          f"aggregate")


def count_launches(torch, kern, run):
    """Set every kernel's launch count to 0, call ``run()``, synchronise
    and return (its result, {kernel name: launches})."""
    for k in kern.all:
        k.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kern.all}


def max_diff(a, b) -> float:
    return max((x[k] - y[k]).abs().max().item()
               for x, y in zip(a, b) for k in ("W", "b"))


def aggregates(torch, kern, run, tau: int) -> dict:
    """``run(tau, backend)`` returns one aggregate.  The ``backend="kernel"``
    aggregate at ``tau`` runs with its launches counted and CUDA events
    around each call; then kernel and oracle aggregates at TAU_CHECK
    (the first reused when ``tau`` is TAU_CHECK) give max |ΔW|."""
    (agg, t_agg, spans), launches = count_launches(
        torch, kern, lambda: timed_calls(torch, lambda: run(tau, "kernel")))
    t0 = time.perf_counter()
    g_kernel = agg if tau == TAU_CHECK else run(TAU_CHECK, "kernel")
    g_oracle = run(TAU_CHECK, "oracle")
    torch.cuda.synchronize()
    return dict(agg=agg, t_agg=t_agg, spans=spans, launches=launches,
                t_check=time.perf_counter() - t0, diff=max_diff(g_kernel, g_oracle))


def train_clients(torch, spec, data, parts, seed_init: int = 3):
    """Local training and projector estimation of one client per part,
    from one seeded init, the paper's recipe cut to 200 steps."""
    from repro_torch.fl import models as pm
    from repro_torch.fl.client import (LocalTrainConfig, compute_projections,
                                       evaluate_classifier, train_classifier)

    test = (data["test_x"], data["test_y"])
    init = pm.init(spec, seed=seed_init)
    local = LocalTrainConfig(epochs=6, max_steps=200, seed=5)
    t0 = time.perf_counter()
    clients = [train_classifier(spec, init, data["train_x"][ix], data["train_y"][ix],
                                local)[0] for ix in parts]
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    local_accs = [evaluate_classifier(spec, p, *test) for p in clients]
    t0 = time.perf_counter()
    projs = [compute_projections(spec, p, data["train_x"][ix])
             for p, ix in zip(clients, parts)]
    torch.cuda.synchronize()
    return dict(clients=clients, projs=projs, test=test, local_accs=local_accs,
                t_train=t_train, t_proj=time.perf_counter() - t0)


def phase_main_path(torch, kern):
    from repro_torch.core.maecho import MAEchoConfig
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import DatasetSpec, generate
    from repro_torch.fl import models as pm
    from repro_torch.fl.client import evaluate_classifier
    from repro_torch.fl.server import one_shot_aggregate

    spec = pm.MLP_SPEC
    data = generate(DatasetSpec("fidelity", n_train=6000, n_test=1200,
                                latent=24, out_dim=784, seed=0))
    parts = dirichlet_partition(data["train_y"], 4, 0.05, seed=1)
    r = train_clients(torch, spec, data, parts)
    clients, projs, test = r["clients"], r["projs"], r["test"]
    r["acc_fedavg"] = evaluate_classifier(
        spec, one_shot_aggregate(spec, clients, None, "fedavg"), *test)

    def run(tau, backend):
        cfg = MAEchoConfig(tau=tau, eta=0.5, mu=20.0)
        return one_shot_aggregate(spec, clients, projs, "maecho", cfg, backend=backend)

    r.update(aggregates(torch, kern, run, TAU))
    r["acc_maecho"] = evaluate_classifier(spec, r["agg"], *test)
    return r


def phase_factored_path(torch, kern, dense):
    """The dense phase's clients with their projectors factored on the
    card at rank 78, through :func:`aggregates`."""
    from repro_torch.core.maecho import MAEchoConfig
    from repro_torch.core.projections import factor_projection_tree
    from repro_torch.fl import models as pm
    from repro_torch.fl.client import evaluate_classifier
    from repro_torch.fl.server import one_shot_aggregate

    spec, clients = pm.MLP_SPEC, dense["clients"]
    t0 = time.perf_counter()
    projs = [factor_projection_tree(p, RANK) for p in dense["projs"]]
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    shapes = [tuple(p["W"]["U"].shape) for p in projs[0]]
    print(f"[factored] U shapes per layer {shapes}")
    check(shapes == [(784, RANK), (400, RANK), (200, RANK), (100, RANK)],
          f"factor_projection_tree gave U shapes {shapes}")

    def run(tau, backend):
        cfg = MAEchoConfig(tau=tau, eta=0.5, mu=20.0)
        return one_shot_aggregate(spec, clients, projs, "maecho", cfg, backend=backend)

    f = aggregates(torch, kern, run, TAU)
    f.update(t_factor=t_factor,
             acc_maecho=evaluate_classifier(spec, f["agg"], *dense["test"]))
    return f


def phase_scalar_path(torch, kern, dense):
    """The dense phase's clients with no projectors: the default scalar
    rule, which the kernel route broadcasts to (N, in) diagonals on W0
    and W1 (B3/B6/B9), at τ = TAU_CHECK."""
    from repro_torch.core.maecho import MAEchoConfig, maecho_aggregate
    from repro_torch.fl import models as pm
    from repro_torch.fl.client import evaluate_classifier

    def run(tau, backend):
        return maecho_aggregate(dense["clients"], None,
                                MAEchoConfig(tau=tau, eta=0.5, mu=20.0), backend=backend)

    s = aggregates(torch, kern, run, TAU_CHECK)
    s["acc_maecho"] = evaluate_classifier(pm.MLP_SPEC, s["agg"], *dense["test"])
    return s


def phase_cnn_path(torch, kern):
    """The paper CNN at full width on the synthetic CIFAR-10: 4 clients on
    a Dirichlet(0.05) split, local training, projectors, FedAvg and
    MA-Echo through :func:`aggregates`."""
    from repro_torch.core.maecho import MAEchoConfig
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import CIFAR_LIKE, generate
    from repro_torch.fl import models as pm
    from repro_torch.fl.client import evaluate_classifier
    from repro_torch.fl.server import one_shot_aggregate

    spec = pm.CNN_SPEC
    t0 = time.perf_counter()
    data = generate(CIFAR_LIKE)
    t_data = time.perf_counter() - t0
    parts = dirichlet_partition(data["train_y"], 4, 0.05, seed=1)
    r = train_clients(torch, spec, data, parts)
    clients, projs, test = r["clients"], r["projs"], r["test"]
    shapes = [tuple(p["W"].shape) for p in projs[0]]
    print(f"[cnn] layer shapes {[tuple(lay['W'].shape) for lay in clients[0]]}, "
          f"projector shapes {shapes}")
    check(shapes == [(27, 27), (288, 288), (576, 576), (1024, 1024), (256, 256),
                     (128, 128)], f"CNN projector shapes {shapes}")
    r["acc_fedavg"] = evaluate_classifier(
        spec, one_shot_aggregate(spec, clients, None, "fedavg"), *test)

    def run(tau, backend):
        cfg = MAEchoConfig(tau=tau, eta=0.5, mu=20.0)
        return one_shot_aggregate(spec, clients, projs, "maecho", cfg, backend=backend)

    r.update(aggregates(torch, kern, run, TAU))
    r.update(t_data=t_data, acc_maecho=evaluate_classifier(spec, r["agg"], *test))
    check(all(tuple(a["W"].shape) == tuple(b["W"].shape)
              and bool(torch.isfinite(a["W"]).all())
              for a, b in zip(r["agg"], clients[0], strict=True)),
          "CNN aggregate has bad shapes or values")
    return r


def timed_calls(torch, run):
    """Run ``run()`` with CUDA events around every batched QP solve and
    every kernel wrapper call inside it.  The executor is host-bound, so
    an event pair spans the call's enqueue as well as its device work.
    Returns (run's result, wall s, {name: summed ms})."""
    from repro_torch.core import qp
    from repro_torch.kernels import ops

    names = [(qp, "solve_qp_batched")] + [(ops, name) for name in KERNELS]
    events = {name: [] for _, name in names}
    originals = [(mod, name, getattr(mod, name)) for mod, name in names]

    def timed(name, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            events[name].append((start, end))
            return out
        return call

    for mod, name, fn in originals:
        setattr(mod, name, timed(name, fn))
    try:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return out, wall, {name: sum(s.elapsed_time(e) for s, e in ev)
                       for name, ev in events.items()}


def report_split(what: str, wall_s: float, spans: dict, names, alone_ms=None):
    wall_ms = wall_s * 1e3
    qp_ms = spans["solve_qp_batched"]
    kern_ms = sum(spans[n] for n in names)
    print(f"[aggregate] {what} with CUDA events around each call: wall "
          f"{wall_ms:.3f} ms, batched QP {qp_ms:.3f} ms "
          f"({100 * qp_ms / wall_ms:.2f} %), kernel calls {kern_ms:.3f} ms "
          f"({100 * kern_ms / wall_ms:.3f} %; "
          + ", ".join(f"{n} {spans[n]:.3f}" for n in names)
          + f"), rest {wall_ms - qp_ms - kern_ms:.3f} ms"
          + ("" if alone_ms is None else f"; the same calls' device time "
             f"(phase 1 times) {alone_ms:.3f} ms"))


def check_path(path: str, r: dict, ran, tau: int) -> None:
    """The path's kernels in ``ran`` launched 2·τ times (two kernel
    leaves), every other kernel never; kernel and oracle aggregates at
    TAU_CHECK within AGG_ATOL."""
    launches = r["launches"]
    print(f"[launches] {path} path: {launches}")
    for name in KERNELS:
        want = 2 * tau if name in ran else 0
        check(launches[name] == want, f"{name} ran {launches[name]} times on the "
              f"{path} path, expected {want}")
    print(f"[check] {path}: kernel-vs-oracle max |dW| at tau={TAU_CHECK} "
          f"{r['diff']:.3e} tol {AGG_ATOL:.0e}")
    check(r["diff"] <= AGG_ATOL,
          f"{path} kernel aggregate disagrees with the oracle aggregate")


def check_accuracy(path: str, acc: float, local_accs, acc_fedavg: float) -> None:
    best = max(local_accs)
    check(acc > best + MARGIN,
          f"{path} MA-Echo {acc:.4f} does not beat the best client {best:.4f}")
    check(acc > acc_fedavg + MARGIN,
          f"{path} MA-Echo {acc:.4f} does not beat FedAvg {acc_fedavg:.4f}")


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run chip_smoke.py from a "
             f"checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import (decode_attention, flash_attention, maecho_gram,
                                     maecho_update, maecho_v_update, rank_update)

    kern = SimpleNamespace(
        compressed_residual=maecho_gram.compressed_residual,
        maecho_gram=maecho_gram.maecho_gram,
        maecho_update=maecho_update.maecho_update,
        maecho_v_update=maecho_v_update.maecho_v_update,
        maecho_gram_left=maecho_gram.maecho_gram_left,
        maecho_update_left=maecho_update.maecho_update_left,
        maecho_v_update_factored=maecho_v_update.maecho_v_update_factored,
        maecho_v_update_left=maecho_v_update.maecho_v_update_left,
        maecho_gram_diag=maecho_gram.maecho_gram_diag,
        maecho_update_diag=maecho_update.maecho_update_diag,
        maecho_v_update_diag=maecho_v_update.maecho_v_update_diag,
        maecho_gram_stacked=maecho_gram.maecho_gram_stacked,
        maecho_update_stacked=maecho_update.maecho_update_stacked,
        maecho_v_update_stacked=maecho_v_update.maecho_v_update_stacked,
        maecho_gram_diag_stacked=maecho_gram.maecho_gram_diag_stacked,
        maecho_update_diag_stacked=maecho_update.maecho_update_diag_stacked,
        maecho_v_update_diag_stacked=maecho_v_update.maecho_v_update_diag_stacked,
        maecho_gram_left_stacked=maecho_gram.maecho_gram_left_stacked,
        maecho_update_left_stacked=maecho_update.maecho_update_left_stacked,
        maecho_v_update_factored_stacked=maecho_v_update.maecho_v_update_factored_stacked,
        maecho_v_update_left_stacked=maecho_v_update.maecho_v_update_left_stacked,
        maecho_gram_cross=maecho_gram.maecho_gram_cross,
        rank_downdate=rank_update.rank_downdate,
        flash_attention=flash_attention.flash_attention,
        decode_attention=decode_attention.decode_attention)
    kern.all = [getattr(kern, n) for n in KERNELS]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[phase] build {time.perf_counter() - t0:.3f} s")
    for name, log in logs.items():     # ptxas: registers, shared memory, spills
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}")
    check_tf32_sass(build)
    check_left_kernel_names()

    t0 = time.perf_counter()
    err, timings = phase_kernels(torch, kern, ref)
    for phase in (phase_factored_kernels, phase_diag_kernels, phase_stacked_kernels,
                  phase_stacked_left_kernels):
        e, t = phase(torch, kern, ref)
        err.update(e)
        timings.update(t)
    print(f"[phase] kernels-vs-plain {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    c1_err = phase_many_clients(torch, kern, ref, timings)
    for name in GRAMS:
        print(f"[c1] {name} device ms by N (400x784; plain in brackets): " + ", ".join(
            f"N={n} {timings[(name, f'N{n}')][0]:.4f} ({timings[(name, f'N{n}')][1]:.4f})"
            for n in (4,) + MANY_CLIENTS) + f"; max_abs_err {c1_err[name]:.3e}")
    print("[c1] B1/B2 (k=78)/B3 at W0, N=4, this run against run Q: " + ", ".join(
        f"{n} {timings[(n, 'W0k78' if n == 'maecho_gram_left' else 'W0')][0]:.4f} vs "
        f"{RUN_Q_MS[n]:.4f} ms" for n in RUN_Q_MS))
    m64 = phase_many_clients_mlp(torch, kern)
    print(f"[phase] many clients {time.perf_counter() - t0:.3f} s: the N=64 MLP aggregates "
          f"(kernel, tau={TAU_CHECK}, timed, and oracle) {m64['t']:.3f} s, layers "
          f"{m64['shapes']}")
    report_split("the N=64 dense MLP kernel aggregate", m64["t_agg"], m64["spans"], DENSE)
    check_path("mlp N=64", m64, DENSE, TAU_CHECK)

    t0 = time.perf_counter()
    e, t, library, chained = phase_chunk_kernels(torch, kern, ref)
    err.update(e)
    timings.update(t)
    print(f"[phase] chunk kernels {time.perf_counter() - t0:.3f} s (the W0 projector chained "
          f"through ops.block_rls_update {chained['t']:.3f} s)")
    print(f"[launches] block_rls_update chain ({chained['blocks']} blocks of 128 rows, "
          f"784 features): {chained['launches']}; max |Q - null_projector_from_features| "
          f"{chained['diff']:.3e} tol {AGG_ATOL:.0e}")
    for name in KERNELS:
        want = chained["blocks"] if name in DOWNDATE else 0
        check(chained["launches"][name] == want, f"{name} ran {chained['launches'][name]} "
              f"times in the block_rls_update chain, expected {want}")
    check(chained["diff"] <= AGG_ATOL, "the chained block_rls_update projector disagrees")

    t0 = time.perf_counter()
    phase_large_n(torch, kern, ref)
    print(f"[phase] largeN grid {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    ck = phase_chunked_mlp(torch, kern, m64)
    print(f"[phase] chunked MLP {time.perf_counter() - t0:.3f} s: 256 clients set up "
          f"{ck['t_setup']:.3f} s, aggregate (kernel, client_chunk={CHUNK}, tau=2, timed) "
          f"{ck['t_agg']:.3f} s, unchunked kernel and oracle aggregates {ck['t_check']:.3f} s; "
          f"64 dense clients at client_chunk=16 (kernel and oracle) {ck['t16']:.3f} s")
    report_split(f"the N=256 factored (k={RANK}) chunked kernel aggregate", ck["t_agg"],
                 ck["spans"], CROSS)
    print(f"[memory] chunked MLP N=256: allocated before {ck['before_gb']:.3f} GB, "
          f"{ck['before_gc_gb']:.3f} GB after gc.collect(), peak in it {ck['peak_gb']:.3f} GB")
    print("[memory] B2 in the unchunked N=256 aggregate (B1's route past 8 clients: the "
          "residual stack, then B19's contraction), workspace a launch: " + ", ".join(
              f"{leaf} ({o}x{i}, k={RANK}) {4 * gram_left_workspace(256, o, i, RANK) / 1e6:.3f} MB"
              f" (stack {4 * 256 * o * i / 1e6:.3f} MB)"
              for leaf, o, i in (("W0", 400, 784), ("W1", 200, 400))))
    for label, launches, ran, n in (("N=256 factored, chunk 64", ck["launches"], CROSS, 10),
                                    ("N=256 factored, unchunked", ck["launches_unchunked"],
                                     FACTORED, 1),
                                    ("N=64 dense, chunk 16", ck["launches16"], CROSS, 10)):
        print(f"[launches] chunked MLP {label}: {launches}")
        for name in KERNELS:       # tau = 2 on two kernel leaves; n chunk pairs each
            want = 2 * 2 * n if name in ran else 0
            check(launches[name] == want, f"{name} ran {launches[name]} times on the chunked "
                  f"MLP path ({label}), expected {want}")
    print(f"[check] chunked MLP N=256: max |dW| against the unchunked kernel aggregate "
          f"{ck['diff_kernel']:.3e}, against the oracle {ck['diff_oracle']:.3e}; N=64 dense "
          f"chunk 16 against the oracle {ck['diff16']:.3e}; tol {AGG_ATOL:.0e}")
    check(max(ck["diff_kernel"], ck["diff_oracle"], ck["diff16"]) <= AGG_ATOL,
          "the chunked MLP aggregate disagrees")

    def device_ms(names, label_suffix="", tau=TAU):
        return tau * sum(timings[(n, l + label_suffix)][0]
                         for n in names for l in ("W0", "W1"))

    t0 = time.perf_counter()
    r = phase_main_path(torch, kern)
    print(f"[phase] main path {time.perf_counter() - t0:.3f} s: train "
          f"{r['t_train']:.3f} s, projections {r['t_proj']:.3f} s, aggregate "
          f"(kernel, tau={TAU}, timed) {r['t_agg']:.3f} s, kernel and oracle "
          f"aggregates (tau={TAU_CHECK}) {r['t_check']:.3f} s")
    report_split("the dense kernel aggregate", r["t_agg"], r["spans"], DENSE,
                 device_ms(DENSE))
    print(f"[accuracy] dense: clients {[round(a, 4) for a in r['local_accs']]}, "
          f"fedavg {r['acc_fedavg']:.4f}, maecho(kernel, tau={TAU}) {r['acc_maecho']:.4f}")
    check_path("dense", r, DENSE, TAU)
    check_accuracy("dense", r["acc_maecho"], r["local_accs"], r["acc_fedavg"])

    t0 = time.perf_counter()
    f = phase_factored_path(torch, kern, r)
    print(f"[phase] factored path {time.perf_counter() - t0:.3f} s: factor "
          f"{f['t_factor']:.3f} s, aggregate (kernel, tau={TAU}, timed) "
          f"{f['t_agg']:.3f} s, kernel and oracle aggregates (tau={TAU_CHECK}) "
          f"{f['t_check']:.3f} s")
    report_split(f"the factored (k={RANK}) kernel aggregate", f["t_agg"], f["spans"],
                 FACTORED, device_ms(FACTORED[:2] + (f"{FACTORED[2]} wrapper",),
                                     f"k{RANK}"))
    print(f"[accuracy] factored k={RANK}: maecho(kernel, tau={TAU}) {f['acc_maecho']:.4f}")
    check_path("factored", f, FACTORED, TAU)
    check_accuracy("factored", f["acc_maecho"], r["local_accs"], r["acc_fedavg"])

    t0 = time.perf_counter()
    sc = phase_scalar_path(torch, kern, r)
    print(f"[phase] scalar path {time.perf_counter() - t0:.3f} s: aggregate "
          f"(kernel, tau={TAU_CHECK}, timed) {sc['t_agg']:.3f} s, oracle aggregate "
          f"(tau={TAU_CHECK}) {sc['t_check']:.3f} s")
    report_split("the scalar-projector kernel aggregate", sc["t_agg"], sc["spans"],
                 DIAG, device_ms(DIAG, tau=TAU_CHECK))
    print(f"[accuracy] scalar: maecho(kernel, tau={TAU_CHECK}) {sc['acc_maecho']:.4f} "
          f"(not checked: the scalar rule is a consensus pull)")
    check_path("scalar", sc, DIAG, TAU_CHECK)

    t0 = time.perf_counter()
    c = phase_cnn_path(torch, kern)
    print(f"[phase] cnn path {time.perf_counter() - t0:.3f} s: data {c['t_data']:.3f} s, "
          f"train {c['t_train']:.3f} s, projections {c['t_proj']:.3f} s, aggregate "
          f"(kernel, tau={TAU}, timed) {c['t_agg']:.3f} s, kernel and oracle "
          f"aggregates (tau={TAU_CHECK}) {c['t_check']:.3f} s")
    report_split("the CNN kernel aggregate", c["t_agg"], c["spans"], DENSE)
    print(f"[accuracy] cnn: clients {[round(a, 4) for a in c['local_accs']]}, "
          f"fedavg {c['acc_fedavg']:.4f}, maecho(kernel, tau={TAU}) {c['acc_maecho']:.4f} "
          f"(not checked)")
    check_path("cnn", c, DENSE, TAU)

    t0 = time.perf_counter()
    lm = phase_llm_path(torch, kern)
    print(f"[phase] llm path {time.perf_counter() - t0:.3f} s: init, fine-tune and "
          f"projections {lm['t_setup']:.3f} s (fine-tune {lm['t_train']:.3f} s, "
          f"projections {lm['t_proj']:.3f} s), aggregate (kernel, tau={LLM_TAU}, timed) "
          f"{lm['t_agg']:.3f} s, kernel and oracle aggregates (tau={TAU_CHECK}) "
          f"{lm['t_check']:.3f} s, perplexities {lm['t_ppl']:.3f} s")
    report_split("the LLM kernel aggregate", lm["t_agg"], lm["spans"],
                 STACKED + STACKED_DIAG + DIAG)
    print(f"[memory] llm: device memory allocated before the kernel aggregate (base "
          f"model, both silos, their projectors) {lm['before_gb']:.3f} GB, "
          f"{lm['before_gc_gb']:.3f} GB after gc.collect(), peak in it "
          f"{lm['peak_gb']:.3f} GB")
    print("[perplexity] llm (ppl@dom101, ppl@dom202; not checked beyond finite): "
          + ", ".join(f"{k} {a:.3f} {b:.3f}" for k, (a, b) in lm["ppl"].items()))
    check(all(math.isfinite(x) for v in lm["ppl"].values() for x in v),
          "an LLM perplexity is not finite")
    check_llm_path(lm)

    t0 = time.perf_counter()
    lf = phase_llm_factored_path(torch, kern, lm)
    print(f"[phase] llm factored path {time.perf_counter() - t0:.3f} s: factor "
          f"(k={LLM_RANK}, layer by layer) {lf['t_factor']:.3f} s, aggregate (kernel, "
          f"tau={LLM_TAU}, timed) {lf['t_agg']:.3f} s, kernel and oracle aggregates "
          f"(tau={TAU_CHECK}) {lf['t_check']:.3f} s, perplexities {lf['t_ppl']:.3f} s")
    report_split(f"the factored (k={LLM_RANK}) LLM kernel aggregate", lf["t_agg"],
                 lf["spans"], STACKED_LEFT + STACKED_DIAG + DIAG)
    print(f"[memory] llm factored: device memory allocated before the kernel aggregate "
          f"{lf['before_gb']:.3f} GB, {lf['before_gc_gb']:.3f} GB after gc.collect(), "
          f"peak in it {lf['peak_gb']:.3f} GB (dense route: {lm['before_gc_gb']:.3f} and "
          f"{lm['peak_gb']:.3f} GB)")
    print("[perplexity] llm factored (ppl@dom101, ppl@dom202; not checked beyond finite): "
          + ", ".join(f"{k} {a:.3f} {b:.3f}" for k, (a, b) in lf["ppl"].items()))
    check(all(math.isfinite(x) for v in lf["ppl"].values() for x in v),
          "a factored LLM perplexity is not finite")
    check_llm_path(lf, STACKED_LEFT, "llm factored")

    t0 = time.perf_counter()
    lc = phase_llm_chunked(torch, kern, lm, lf)
    print(f"[phase] llm chunked path {time.perf_counter() - t0:.3f} s: aggregate (kernel, "
          f"client_chunk=1, tau=2, timed) {lc['t_agg']:.3f} s, unchunked kernel aggregate "
          f"(tau=2) {lc['t_check']:.3f} s")
    report_split("the chunked factored LLM kernel aggregate", lc["t_agg"], lc["spans"], CROSS)
    print(f"[memory] llm chunked: allocated before {lc['before_gb']:.3f} GB, "
          f"{lc['before_gc_gb']:.3f} GB after gc.collect(), peak in it {lc['peak_gb']:.3f} GB "
          f"(unchunked factored route at tau={LLM_TAU}: {lf['peak_gb']:.3f} GB)")
    print(f"[launches] llm chunked path: {lc['launches']}")
    for name in KERNELS:
        want = 2 * 3 if name in CROSS else 0
        check(lc["launches"][name] == want, f"{name} ran {lc['launches'][name]} times on "
              f"the chunked LLM path, expected {want}")
    print(f"[check] llm chunked: max |dW| against the unchunked kernel aggregate at tau=2 "
          f"over all leaves {lc['diff']:.3e} tol {AGG_ATOL:.0e}")
    check(lc["diff"] <= AGG_ATOL, "the chunked LLM aggregate disagrees with the unchunked one")
    del lm["silos"], lm["projs"], lf["projs"]

    t0 = time.perf_counter()
    e, t, serve_library = phase_serve_kernels(torch, kern, ref)
    err.update(e)
    timings.update(t)
    library.update(serve_library)
    t1 = time.perf_counter()
    sv = phase_serve(torch, kern, lm)
    print(f"[phase] serve {time.perf_counter() - t0:.3f} s: kernels vs plain and timed "
          f"{t1 - t0:.3f} s, fixed batch x2, fp32 kernel and oracle, continuous batching "
          f"{time.perf_counter() - t1:.3f} s")
    check_serve(sv)
    del lm["agg"]

    t0 = time.perf_counter()
    bench = phase_bench_stacked_agg(torch, kern)
    print(f"[phase] bench_stacked_agg case {time.perf_counter() - t0:.3f} s")
    for L, (launches, diff, wall) in bench.items():
        print(f"[launches] bench_stacked_agg L={L} (N=4, 512x512, k=32, tau=2): "
              f"{launches}; kernel aggregate {wall:.3f} s; kernel-vs-oracle max |dW| "
              f"{diff:.3e} tol {AGG_ATOL:.0e}")
        for name in KERNELS:
            want = 2 if name in STACKED_LEFT else 0
            check(launches[name] == want, f"{name} ran {launches[name]} times in the "
                  f"bench_stacked_agg case at L={L}, expected {want}")
        check(diff <= AGG_ATOL, f"bench_stacked_agg kernel aggregate at L={L} disagrees "
              f"with the oracle aggregate")

    source = {**{n: r for n in DENSE}, **{n: f for n in FACTORED}, **{n: sc for n in DIAG},
              **{n: lm for n in STACKED + STACKED_DIAG}, **{n: lf for n in STACKED_LEFT},
              **{n: ck for n in CROSS}, **{n: chained for n in DOWNDATE},
              **{n: sv for n in ATTN}}
    label = {**{n: f"W0k{RANK}" for n in FACTORED}, **{n: "w_gate" for n in STACKED},
             **{n: "w_down" for n in STACKED_DIAG}, **{n: "w_gate" for n in STACKED_LEFT},
             **{n: "serve" for n in ATTN}}
    rows = []
    for name in KERNELS:
        ms, plain, b, by = timings[(name, label.get(name, "W0"))]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name],
                     "launches": source[name]["launches"][name],
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by,
                     "library_ms": (library.get((name, label.get(name, "W0")))
                                    if name in CROSS + ATTN else None)})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--kernel-names"]:
        left_kernel_names_main()
    else:
        main()
