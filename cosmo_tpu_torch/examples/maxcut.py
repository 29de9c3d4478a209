"""Maxcut SDP relaxation with chordal decomposition (reference:
examples/maxcut.jl; BASELINE.md north-star workload).

Solved in dual form  min 1'y s.t. diag(y) - L/4 PSD  so that the Laplacian
sparsity decomposes into clique blocks.
"""
import cosmo_tpu_torch as cosmo
from cosmo_tpu_torch import problems
from cosmo_tpu_torch.examples._common import run, settings


def main(device=None):
    P, q, A, b, sets, L = problems.maxcut(n_nodes=60, density=0.08, seed=1, sparse=True)
    model = cosmo.Model(settings(decompose=True, verbose=True), device=device)
    model.set(P, q, A, b, sets)
    res = model.optimize()
    assert res.status == "Solved"
    assert model.is_decomposed
    cosmo.print_clique_sizes(model)

    # the SDP bound must be >= the maxcut value of any cut; sanity: >= 0
    print("maxcut SDP bound:", res.obj_val)


if __name__ == "__main__":
    run(main, __doc__)
