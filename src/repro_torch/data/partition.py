"""Non-IID client partitions (paper §7, Figure 2), numpy only.

``dirichlet_partition``: p_c ~ Dir(β·1_K); allocate a p_{c,k} fraction
of each class-c sample set to client k — β→0 gives disjoint label
support (the paper's extreme non-identical setting), β→∞ gives IID.
Same draws as ``repro.data.partition``.
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, beta: float,
                        seed: int = 0, min_size: int = 2) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    K = int(labels.max()) + 1
    for _ in range(100):
        idx_per_client: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(K):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            p = rng.dirichlet([beta] * n_clients)
            cuts = (np.cumsum(p) * len(idx_c)).astype(int)[:-1]
            for k, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[k].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            break
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in idx_per_client]


def partition_stats(labels: np.ndarray, parts: list[np.ndarray]) -> str:
    K = int(labels.max()) + 1
    lines = []
    for k, ix in enumerate(parts):
        hist = np.bincount(labels[ix], minlength=K)
        lines.append(f"client {k}: n={len(ix):6d} " +
                     " ".join(f"{h:5d}" for h in hist))
    return "\n".join(lines)
