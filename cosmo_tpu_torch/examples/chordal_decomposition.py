"""Chordal decomposition showcase (reference: examples/chordal_decomposition.jl,
docs/src/decomposition.md): a banded-sparsity SDP solved with and without
decomposition and with different merge strategies.
"""
import time

import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch import problems
from cosmo_tpu_torch.examples._common import run, settings


def main(device=None):
    P, q, A, b, sets, L = problems.banded_sdp(n_nodes=60, bandwidth=5, seed=1, sparse=True)

    results = {}
    for label, s in {
        "no decomposition": settings(decompose=False, sparse=False),
        "decompose, no merging": settings(decompose=True, merge_strategy="none"),
        "decompose, parent-child": settings(decompose=True, merge_strategy="parent_child"),
        "decompose, clique-graph": settings(decompose=True, merge_strategy="clique_graph"),
    }.items():
        model = cosmo.Model(s, device=device)
        if label == "no decomposition":
            model.set(P.toarray() if hasattr(P, "toarray") else P, q,
                      A.toarray() if hasattr(A, "toarray") else A, b, sets)
        else:
            model.set(P, q, A, b, sets)
        t0 = time.perf_counter()
        res = model.optimize()
        results[label] = res.obj_val
        print(f"{label:26s}: {res.status}, obj {res.obj_val:.6f}, "
              f"iters {res.iter}, {time.perf_counter() - t0:.2f}s")

    objs = list(results.values())
    assert max(objs) - min(objs) < 1e-2 * max(1.0, abs(objs[0]))
    print("chordal decomposition example OK")


if __name__ == "__main__":
    run(main, __doc__)
