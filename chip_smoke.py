#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero; nothing is caught):

1. Build the CUDA kernels B1 (Gram), B4 (Eq. 7) and B7 (Eq. 11) from
   ``src/repro_torch/kernels/csrc`` and hold each against its plain
   PyTorch version on the card: both paper-MLP kernel leaves at N = 4,
   and a multi-tile ragged shape (1000 x 1100, N = 8), B7 with the
   row-norm off and on.  Each kernel and its plain version are timed
   with CUDA events at the MLP's W0 leaf.
2. The main path, through the user entry points: the full-width paper
   MLP on a 4-client Dirichlet(0.05) split of the synthetic MNIST,
   local training, projector estimation, FedAvg, and one-shot MA-Echo
   on ``backend="kernel"`` (τ = 30).  The kernels' launch counters
   must read 60 each (2 kernel leaves × τ), the kernel aggregate must
   match a ``backend="oracle"`` aggregate to 1e-3, and MA-Echo must
   beat both the best client and FedAvg by 0.05 test accuracy.

It prints each phase's time, the QP's and the kernels' time inside
one more kernel aggregate (CUDA events around each call), a
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
GRAM_RTOL = 1e-5        # |G - G_plain| <= GRAM_RTOL * max|G_plain| (fp32 sum order)
APPLY_ATOL = 1e-4       # Eq. 7 / Eq. 11 outputs, as the reference's kernel tests
AGG_ATOL = 1e-3         # kernel vs oracle aggregate, as the reference's tests
MARGIN = 0.05           # accuracy margin pinned by tests/test_paper_fidelity.py


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
        for name, (k_fn, p_fn, flops, nbytes) in cases.items():
            ms = cuda_ms(torch, k_fn, 50)
            plain = cuda_ms(torch, p_fn, 50)
            b, by = bound_ms(flops, nbytes)
            timings[(name, label)] = (ms, plain, b, by)
            print(f"[kernels] {label} {name}: {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"bound {b:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.2f} MB)")
    return err, timings


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

    for k in (kern.maecho_gram, kern.maecho_update, kern.maecho_v_update):
        k.launches = 0
    t0 = time.perf_counter()
    g_kernel = one_shot_aggregate(spec, clients, projs, "maecho", cfg,
                                  backend="kernel")
    torch.cuda.synchronize()
    t_agg = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in
                (kern.maecho_gram, kern.maecho_update, kern.maecho_v_update)}

    t0 = time.perf_counter()
    g_oracle = one_shot_aggregate(spec, clients, projs, "maecho", cfg,
                                  backend="oracle")
    torch.cuda.synchronize()
    t_oracle = time.perf_counter() - t0

    diff = max((a[k] - b[k]).abs().max().item()
               for a, b in zip(g_kernel, g_oracle) for k in ("W", "b"))
    acc_maecho = evaluate_classifier(spec, g_kernel, *test)
    acc_oracle = evaluate_classifier(spec, g_oracle, *test)

    t_timed, spans = timed_calls(
        torch, lambda: one_shot_aggregate(spec, clients, projs, "maecho", cfg,
                                          backend="kernel"))
    return dict(t_train=t_train, t_proj=t_proj, t_agg=t_agg, t_oracle=t_oracle,
                launches=launches, diff=diff, local_accs=local_accs,
                acc_fedavg=acc_fedavg, acc_maecho=acc_maecho,
                acc_oracle=acc_oracle, t_timed=t_timed, spans=spans)


def timed_calls(torch, run):
    """Run ``run()`` with CUDA events around every batched QP solve and
    every kernel wrapper call inside it.  The executor is host-bound, so
    an event pair spans the call's enqueue as well as its device work.
    Returns (wall s, {name: summed ms})."""
    from repro_torch.core import qp
    from repro_torch.kernels import ops

    names = [(qp, "solve_qp_batched"), (ops, "maecho_gram"),
             (ops, "maecho_update"), (ops, "maecho_v_update")]
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
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return wall, {name: sum(s.elapsed_time(e) for s, e in ev)
                  for name, ev in events.items()}


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

    kern = SimpleNamespace(maecho_gram=maecho_gram.maecho_gram,
                           maecho_update=maecho_update.maecho_update,
                           maecho_v_update=maecho_v_update.maecho_v_update)

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
    print(f"[phase] kernels-vs-plain {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    r = phase_main_path(torch, kern)
    print(f"[phase] main path {time.perf_counter() - t0:.3f} s: train "
          f"{r['t_train']:.3f} s, projections {r['t_proj']:.3f} s, aggregate "
          f"(kernel) {r['t_agg']:.3f} s, aggregate (oracle) {r['t_oracle']:.3f} s")
    per_iter = sum(timings[(n, l)][0] for n in err for l in ("W0", "W1"))
    wall_ms = r["t_timed"] * 1e3
    qp_ms = r["spans"]["solve_qp_batched"]
    kern_ms = sum(r["spans"][n] for n in err)
    print(f"[aggregate] one more kernel aggregate with CUDA events around each "
          f"call: wall {wall_ms:.3f} ms, batched QP {qp_ms:.3f} ms "
          f"({100 * qp_ms / wall_ms:.2f} %), kernel calls {kern_ms:.3f} ms "
          f"({100 * kern_ms / wall_ms:.3f} %; "
          + ", ".join(f"{n} {r['spans'][n]:.3f}" for n in err)
          + f"), rest {wall_ms - qp_ms - kern_ms:.3f} ms; kernels alone "
          f"(phase 1 times) {per_iter * TAU:.3f} ms")
    print(f"[accuracy] clients {[round(a, 4) for a in r['local_accs']]}, fedavg "
          f"{r['acc_fedavg']:.4f}, maecho(kernel) {r['acc_maecho']:.4f}, "
          f"maecho(oracle) {r['acc_oracle']:.4f}; kernel-vs-oracle max |dW| "
          f"{r['diff']:.3e} tol {AGG_ATOL:.0e}")
    print(f"[launches] {r['launches']}")
    for name, n in r["launches"].items():
        check(n == 2 * TAU, f"{name} ran {n} times on the main path, expected {2 * TAU}")
    check(r["diff"] <= AGG_ATOL, "kernel aggregate disagrees with the oracle aggregate")
    best = max(r["local_accs"])
    check(r["acc_maecho"] > best + MARGIN,
          f"MA-Echo {r['acc_maecho']:.4f} does not beat the best client {best:.4f}")
    check(r["acc_maecho"] > r["acc_fedavg"] + MARGIN,
          f"MA-Echo {r['acc_maecho']:.4f} does not beat FedAvg {r['acc_fedavg']:.4f}")

    replaces = {"maecho_gram": "src/repro/kernels/maecho_gram.py:131",
                "maecho_update": "src/repro/kernels/maecho_update.py:76",
                "maecho_v_update": "src/repro/kernels/maecho_v_update.py:107"}
    rows = []
    for name in err:
        ms, plain, b, by = timings[(name, "W0")]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": replaces[name], "launches": r["launches"][name],
                     "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
