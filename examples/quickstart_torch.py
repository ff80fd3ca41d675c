"""Quickstart on the PyTorch/CUDA port: one-shot federated aggregation
with MA-Echo on an NVIDIA GPU.

Two clients train the paper MLP (784-400-200-100-10) on near-disjoint
halves of a 10-class problem (Dirichlet β = 0.01), then the server
aggregates WITHOUT any training or public data — the paper's setting —
with FedAvg and with MA-Echo on the kernel backend (the hand-written
CUDA kernels B1/B4/B7 on the two leaves wide enough to tile).

  PYTHONPATH=src python examples/quickstart_torch.py            # on the GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.core.maecho import MAEchoConfig
from repro_torch.data.partition import dirichlet_partition, partition_stats
from repro_torch.data.synthetic import MNIST_LIKE, generate
from repro_torch.fl import models as pm
from repro_torch.fl.client import (LocalTrainConfig, compute_projections,
                                   evaluate_classifier, train_classifier)
from repro_torch.fl.server import one_shot_aggregate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    dev = ap.parse_args().device

    data = generate(MNIST_LIKE)
    parts = dirichlet_partition(data["train_y"], 2, beta=0.01, seed=0)
    print("label partition (rows = clients):")
    print(partition_stats(data["train_y"], parts))

    spec = pm.MLP_SPEC
    test = (data["test_x"], data["test_y"])
    clients, projs = [], []
    for k, ix in enumerate(parts):
        params = pm.init(spec, seed=k, device=dev)           # diff init
        params, _ = train_classifier(
            spec, params, data["train_x"][ix], data["train_y"][ix],
            LocalTrainConfig(epochs=10), device=dev)         # paper recipe
        acc = evaluate_classifier(spec, params, *test, device=dev)
        print(f"client {k}: global test acc {acc:.3f}")
        clients.append(params)
        # the one extra forward epoch: per-layer projection matrices
        projs.append(compute_projections(spec, params, data["train_x"][ix],
                                         device=dev))

    for method in ("fedavg", "maecho"):
        kw = ({"cfg": MAEchoConfig(tau=30, eta=0.5, mu=20.0),
               "backend": "kernel"} if method == "maecho" else {})
        g = one_shot_aggregate(spec, clients, projs, method, device=dev, **kw)
        acc = evaluate_classifier(spec, g, *test, device=dev)
        print(f"{method:12s} -> global acc {acc:.3f}")


if __name__ == "__main__":
    main()
