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
   as its wrapper, which forms B with a torch GEMM first.
2. The dense main path, through the user entry points: the full-width
   paper MLP on a 4-client Dirichlet(0.05) split of the synthetic
   MNIST, local training, projector estimation, FedAvg, and one-shot
   MA-Echo on ``backend="kernel"`` (τ = 30).  B1/B4/B7 must launch 60
   times each (2 kernel leaves × τ) and B2/B5/B8 never, the kernel
   aggregate must match a ``backend="oracle"`` aggregate to 1e-3, and
   MA-Echo must beat both the best client and FedAvg by 0.05 test
   accuracy.
3. The factored path (paper Table 6): the same clients' projectors
   factored on the card by ``factor_projection_tree(p, 78)``, then the
   same aggregate on both backends.  B2/B5/B8 must launch 60 times
   each and B1/B4/B7 never (no silent dense restore), the two
   aggregates must agree to 1e-3, and factored MA-Echo must beat the
   best client and FedAvg by 0.05.

It prints each phase's time, the QP's and the kernels' time inside a
kernel aggregate of each path (CUDA events around each call), a
``{"kernels": [...]}`` JSON line, the card's name and power limit, and
as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
import json
import pathlib
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

FP32_FLOPS = 67e12      # H100 SXM fp32 peak outside the tensor cores
HBM_BYTES = 3.35e12     # H100 SXM HBM3 bandwidth
TAU = 30
RANK = 78               # table6_svd.py's "factored0.1": int(0.1 * 784)
GRAM_RTOL = 1e-5        # |G - G_plain| <= GRAM_RTOL * max|G_plain| (fp32 sum order)
APPLY_ATOL = 1e-4       # Eq. 7 / Eq. 11 outputs, as the reference's kernel tests
AGG_ATOL = 1e-3         # kernel vs oracle aggregate, as the reference's tests
MARGIN = 0.05           # accuracy margin pinned by tests/test_paper_fidelity.py
DENSE = ("maecho_gram", "maecho_update", "maecho_v_update")                 # B1 B4 B7
FACTORED = ("maecho_gram_left", "maecho_update_left", "maecho_v_update_factored")  # B2 B5 B8
KERNELS = DENSE + FACTORED
REPLACES = {"maecho_gram": "src/repro/kernels/maecho_gram.py:131",
            "maecho_update": "src/repro/kernels/maecho_update.py:76",
            "maecho_v_update": "src/repro/kernels/maecho_v_update.py:107",
            "maecho_gram_left": "src/repro/kernels/maecho_gram.py:194",
            "maecho_update_left": "src/repro/kernels/maecho_update.py:141",
            "maecho_v_update_factored": "src/repro/kernels/maecho_v_update.py:146"}


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


def time_cases(torch, label: str, cases: dict, timings: dict) -> None:
    """Time each ``name: (kernel fn, plain fn, flops, bytes)`` of one
    leaf and record ``timings[(name, label)] = (ms, plain ms, bound ms,
    bound by)``, device times from CUDA graphs."""
    for name, (k_fn, p_fn, flops, nbytes) in cases.items():
        ms, plain = graph_ms(torch, k_fn, 50), graph_ms(torch, p_fn, 50)
        b, by = bound_ms(flops, nbytes)
        timings[(name, label)] = (ms, plain, b, by)
        print(f"[kernels] {label} {name}: {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {b:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB)")


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
    for label, out_d, in_d, N in (("W0", 400, 784, 4), ("W1", 200, 400, 4)):
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
        time_cases(torch, label, cases, timings)
    return err, timings


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
    # the operations each function does.  B2, B5 and the B8 kernel take
    # the reference's pallas_call operands: (A, Uᵀ), (W, A, Uᵀ, α) and
    # (B, Uᵀ, W', V).  The B8 wrapper, as the factored path calls it,
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
                                 gemm + N * (N + 1) * OI,
                                 4.0 * (N * OK + N * KI + N * N)),
            "maecho_update_left": (lambda: kern.maecho_update_left(W, A, UT, alpha, eta),
                                   lambda: ref.maecho_update_left_ref(W, A, UT, alpha, eta),
                                   gemm + 2.0 * N * OI + 2.0 * OI,
                                   4.0 * (2 * OI + N * OK + N * KI + N)),
            "maecho_v_update_factored": (
                lambda: kern.maecho_v_update_left(B, UT, Wn, V, frac),
                lambda: ref.maecho_v_update_left_ref(B, UT, Wn, V, frac),
                gemm + 4.0 * N * OI,
                4.0 * (N * OK + N * KI + OI + 2 * N * OI)),
            "maecho_v_update_factored wrapper": (
                lambda: kern.maecho_v_update_factored(Wn, V, U, s, frac, UT=UT),
                lambda: ref.maecho_v_update_factored_ref(Wn, V, U, s, frac),
                2 * gemm + N * OK + 5.0 * N * OI,
                4.0 * (OI + 2 * N * OI + N * KI + N * k)),
        }
        time_cases(torch, f"{label}k{k}", cases, timings)
    return err, timings


def count_launches(torch, kern, run):
    """Set every kernel's launch count to 0, call ``run()``, synchronise
    and return (its result, {kernel name: launches})."""
    for k in kern.all:
        k.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k.__name__: k.launches for k in kern.all}


def phase_main_path(torch, kern):
    from repro_torch.core.maecho import MAEchoConfig
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import DatasetSpec, generate
    from repro_torch.fl import models as pm
    from repro_torch.fl.client import (LocalTrainConfig, compute_projections,
                                       evaluate_classifier, train_classifier)
    from repro_torch.fl.server import one_shot_aggregate

    spec = pm.MLP_SPEC
    data = generate(DatasetSpec("fidelity", n_train=6000, n_test=1200,
                                latent=24, out_dim=784, seed=0))
    parts = dirichlet_partition(data["train_y"], 4, 0.05, seed=1)
    test = (data["test_x"], data["test_y"])
    init = pm.init(spec, seed=3)
    local = LocalTrainConfig(epochs=6, max_steps=200, seed=5)

    t0 = time.perf_counter()
    clients = []
    for ix in parts:
        p, _ = train_classifier(spec, init, data["train_x"][ix],
                                data["train_y"][ix], local)
        clients.append(p)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    local_accs = [evaluate_classifier(spec, p, *test) for p in clients]

    t0 = time.perf_counter()
    projs = [compute_projections(spec, p, data["train_x"][ix])
             for p, ix in zip(clients, parts)]
    torch.cuda.synchronize()
    t_proj = time.perf_counter() - t0

    acc_fedavg = evaluate_classifier(
        spec, one_shot_aggregate(spec, clients, None, "fedavg"), *test)
    cfg = MAEchoConfig(tau=TAU, eta=0.5, mu=20.0)

    t0 = time.perf_counter()
    g_kernel, launches = count_launches(
        torch, kern, lambda: one_shot_aggregate(spec, clients, projs, "maecho", cfg,
                                         backend="kernel"))
    t_agg = time.perf_counter() - t0

    t0 = time.perf_counter()
    g_oracle = one_shot_aggregate(spec, clients, projs, "maecho", cfg,
                                  backend="oracle")
    torch.cuda.synchronize()
    t_oracle = time.perf_counter() - t0

    diff = max((a[k] - b[k]).abs().max().item()
               for a, b in zip(g_kernel, g_oracle) for k in ("W", "b"))
    acc_maecho = evaluate_classifier(spec, g_kernel, *test)
    acc_oracle = evaluate_classifier(spec, g_oracle, *test)

    _, t_timed, spans = timed_calls(
        torch, lambda: one_shot_aggregate(spec, clients, projs, "maecho", cfg,
                                          backend="kernel"))
    return dict(t_train=t_train, t_proj=t_proj, t_agg=t_agg, t_oracle=t_oracle,
                launches=launches, diff=diff, local_accs=local_accs,
                acc_fedavg=acc_fedavg, acc_maecho=acc_maecho,
                acc_oracle=acc_oracle, t_timed=t_timed, spans=spans,
                clients=clients, projs=projs, test=test, cfg=cfg)


def phase_factored_path(torch, kern, dense):
    """The dense phase's clients with their projectors factored on the
    card at rank 78, aggregated on the kernel backend (CUDA events
    around each call, launch counts read around the same run) and on
    the oracle backend."""
    from repro_torch.core.projections import factor_projection_tree
    from repro_torch.fl import models as pm
    from repro_torch.fl.client import evaluate_classifier
    from repro_torch.fl.server import one_shot_aggregate

    spec, clients, cfg = pm.MLP_SPEC, dense["clients"], dense["cfg"]
    t0 = time.perf_counter()
    projs = [factor_projection_tree(p, RANK) for p in dense["projs"]]
    torch.cuda.synchronize()
    t_factor = time.perf_counter() - t0
    shapes = [tuple(p["W"]["U"].shape) for p in projs[0]]
    print(f"[factored] U shapes per layer {shapes}")
    check(shapes == [(784, RANK), (400, RANK), (200, RANK), (100, RANK)],
          f"factor_projection_tree gave U shapes {shapes}")

    (g_kernel, t_agg, spans), launches = count_launches(
        torch, kern, lambda: timed_calls(torch, lambda: one_shot_aggregate(
            spec, clients, projs, "maecho", cfg, backend="kernel")))
    t0 = time.perf_counter()
    g_oracle = one_shot_aggregate(spec, clients, projs, "maecho", cfg,
                                  backend="oracle")
    torch.cuda.synchronize()
    t_oracle = time.perf_counter() - t0
    diff = max((a[k] - b[k]).abs().max().item()
               for a, b in zip(g_kernel, g_oracle) for k in ("W", "b"))
    return dict(t_factor=t_factor, t_agg=t_agg, t_oracle=t_oracle,
                spans=spans, launches=launches, diff=diff,
                acc_maecho=evaluate_classifier(spec, g_kernel, *dense["test"]),
                acc_oracle=evaluate_classifier(spec, g_oracle, *dense["test"]))


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


def report_split(what: str, wall_s: float, spans: dict, names, alone_ms: float):
    wall_ms = wall_s * 1e3
    qp_ms = spans["solve_qp_batched"]
    kern_ms = sum(spans[n] for n in names)
    print(f"[aggregate] {what} with CUDA events around each call: wall "
          f"{wall_ms:.3f} ms, batched QP {qp_ms:.3f} ms "
          f"({100 * qp_ms / wall_ms:.2f} %), kernel calls {kern_ms:.3f} ms "
          f"({100 * kern_ms / wall_ms:.3f} %; "
          + ", ".join(f"{n} {spans[n]:.3f}" for n in names)
          + f"), rest {wall_ms - qp_ms - kern_ms:.3f} ms; the same calls' device "
          f"time (phase 1 times) {alone_ms:.3f} ms")


def check_launches(path: str, launches: dict, ran, idle) -> None:
    print(f"[launches] {path} path: {launches}")
    for name in ran:
        check(launches[name] == 2 * TAU, f"{name} ran {launches[name]} times on the "
              f"{path} path, expected {2 * TAU}")
    for name in idle:
        check(launches[name] == 0, f"{name} ran {launches[name]} times on the "
              f"{path} path, expected 0")


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
    from repro_torch.kernels import maecho_gram, maecho_update, maecho_v_update

    kern = SimpleNamespace(
        compressed_residual=maecho_gram.compressed_residual,
        maecho_gram=maecho_gram.maecho_gram,
        maecho_update=maecho_update.maecho_update,
        maecho_v_update=maecho_v_update.maecho_v_update,
        maecho_gram_left=maecho_gram.maecho_gram_left,
        maecho_update_left=maecho_update.maecho_update_left,
        maecho_v_update_factored=maecho_v_update.maecho_v_update_factored,
        maecho_v_update_left=maecho_v_update.maecho_v_update_left)
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

    t0 = time.perf_counter()
    err, timings = phase_kernels(torch, kern, ref)
    ferr, ftimings = phase_factored_kernels(torch, kern, ref)
    err.update(ferr)
    timings.update(ftimings)
    print(f"[phase] kernels-vs-plain {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    r = phase_main_path(torch, kern)
    print(f"[phase] main path {time.perf_counter() - t0:.3f} s: train "
          f"{r['t_train']:.3f} s, projections {r['t_proj']:.3f} s, aggregate "
          f"(kernel) {r['t_agg']:.3f} s, aggregate (oracle) {r['t_oracle']:.3f} s")
    report_split("one more dense kernel aggregate", r["t_timed"], r["spans"], DENSE,
                 TAU * sum(timings[(n, l)][0] for n in DENSE for l in ("W0", "W1")))
    print(f"[accuracy] dense: clients {[round(a, 4) for a in r['local_accs']]}, "
          f"fedavg {r['acc_fedavg']:.4f}, maecho(kernel) {r['acc_maecho']:.4f}, "
          f"maecho(oracle) {r['acc_oracle']:.4f}; kernel-vs-oracle max |dW| "
          f"{r['diff']:.3e} tol {AGG_ATOL:.0e}")
    check_launches("dense", r["launches"], DENSE, FACTORED)
    check(r["diff"] <= AGG_ATOL, "dense kernel aggregate disagrees with the oracle aggregate")
    check_accuracy("dense", r["acc_maecho"], r["local_accs"], r["acc_fedavg"])

    t0 = time.perf_counter()
    f = phase_factored_path(torch, kern, r)
    print(f"[phase] factored path {time.perf_counter() - t0:.3f} s: factor "
          f"{f['t_factor']:.3f} s, aggregate (kernel, timed) {f['t_agg']:.3f} s, "
          f"aggregate (oracle) {f['t_oracle']:.3f} s")
    report_split(f"the factored (k={RANK}) kernel aggregate", f["t_agg"], f["spans"],
                 FACTORED, TAU * sum(timings[(n, l + f"k{RANK}")][0]
                                     for n in FACTORED[:2] + (f"{FACTORED[2]} wrapper",)
                                     for l in ("W0", "W1")))
    print(f"[accuracy] factored k={RANK}: maecho(kernel) {f['acc_maecho']:.4f}, "
          f"maecho(oracle) {f['acc_oracle']:.4f}; kernel-vs-oracle max |dW| "
          f"{f['diff']:.3e} tol {AGG_ATOL:.0e}")
    check_launches("factored", f["launches"], FACTORED, DENSE)
    check(f["diff"] <= AGG_ATOL,
          "factored kernel aggregate disagrees with the oracle aggregate")
    check_accuracy("factored", f["acc_maecho"], r["local_accs"], r["acc_fedavg"])

    rows = []
    for name in KERNELS:
        dense = name in DENSE
        ms, plain, b, by = timings[(name, "W0" if dense else f"W0k{RANK}")]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name],
                     "launches": (r if dense else f)["launches"][name],
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
