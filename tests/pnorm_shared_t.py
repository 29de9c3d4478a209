"""l1.5 regression by the p-norm cone (every cone sharing t), one package
on the CPU in float64: the repro of PERF.md's open question on that
construction at a9a's shape.

    JAX_PLATFORMS=cpu python tests/pnorm_shared_t.py {cosmo_tpu|cosmo_tpu_torch} \
        [--samples 32561] [--max-iter 5000]

Builds ``test_torch_pnorm.pnorm_cone_form`` on ``problems.pnorm_regression``'s
data (123 features, 14 set a sample, p = 1.5, seed 0) and solves it at
eps 1e-5 with the package's defaults otherwise; prints one line: status,
iterations, objective against the L-BFGS-B optimum ||r||_p, ||Z w - y||_p
of the returned w, the last residuals and rho, and the seconds taken.
"""
import argparse
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parent)]

import numpy as np  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("package", choices=["cosmo_tpu", "cosmo_tpu_torch"])
    parser.add_argument("--samples", type=int, default=32561)
    parser.add_argument("--max-iter", type=int, default=5000)
    args = parser.parse_args(argv)
    from cosmo_tpu_torch import problems
    from test_torch_pnorm import pnorm_cone_form

    p, d = 1.5, 123
    *_, (Z, y) = problems.pnorm_regression(args.samples, d, 14, p, seed=0)
    P, q, A, b, sets = pnorm_cone_form(Z, y, p)
    t0 = time.perf_counter()
    if args.package == "cosmo_tpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import cosmo_tpu as ct

        jsets = [ct.ZeroSet(1)] + [ct.PowerCone(1.0 / p) for _ in range(args.samples)]
        model = ct.Model(ct.Settings(eps_abs=1e-5, eps_rel=1e-5, max_iter=args.max_iter))
        model.set(P, q, A, b, jsets)
    else:
        import cosmo_tpu_torch as pt

        model = pt.Model(pt.Settings(eps_abs=1e-5, eps_rel=1e-5, dtype=np.float64,
                                     max_iter=args.max_iter), device="cpu")
        model.set(P, q, A, b, sets)
    res = model.optimize()
    seconds = time.perf_counter() - t0
    f_opt, _ = problems.pnorm_optimum(Z, y, p)
    x = np.asarray(res.x)
    rho = np.asarray(res.info.rho_updates)
    print(f"{args.package} p-norm cone {args.samples}x{d}: {res.status}, {res.iter} iterations, "
          f"objective {res.obj_val:.6e} against the optimum {f_opt:.6e}, ||Zw - y||_p "
          f"{problems.pnorm_loss(Z, y, p, x[:d]):.6e}, r_prim {res.info.r_prim:.3e}, r_dual "
          f"{res.info.r_dual:.3e}, last rho {rho[-1] if rho.size else float('nan'):.3e}, "
          f"{seconds:.1f} s", flush=True)


if __name__ == "__main__":
    main()
