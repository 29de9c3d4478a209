"""Console output (the port of ``cosmo_tpu.utils.printing``; reference:
src/printing.jl): the banner with the problem, set, decomposition and
settings summary (printing.jl:3-36), the residual rows of the termination
checks (printing.jl:38-48), the result footer (printing.jl:60-77), and
the chordal decomposition's merge logs and clique sizes."""
from __future__ import annotations

from collections import Counter


def print_header(model, m: int, n: int, sets=None, chordal_info=None,
                 settings=None):
    """The banner before a solve. ``settings``: the solve's settings with
    the auto choices resolved (the KKT solver), else the model's."""
    s = settings if settings is not None else model.settings
    sets = sets if sets is not None else model.sets
    counts = Counter(f"{type(c).__name__}(dim={c.dim})" for c in sets)
    print("-" * 66)
    print("   cosmo_tpu_torch v0.1 - a conic ADMM solver in PyTorch and CUDA")
    print("-" * 66)
    print(f"Problem:  x in R^{n}, constraints: m = {m}, device: {model.device}")
    for name, cnt in counts.most_common(10):
        print(f"Sets:     {cnt} x {name}")
    if len(counts) > 10:
        print(f"Sets:     ... {len(counts) - 10} more kinds")
    if chordal_info is not None:
        n_pat = len(chordal_info.patterns)
        n_blocks = sum(p.tree.num for p in chordal_info.patterns)
        merges = sum(p.tree.merge_log.num for p in chordal_info.patterns)
        print(
            f"Decomp:   {n_pat} decomposable PSD cone(s) -> {n_blocks} clique "
            f"block(s), {merges} merge(s), strategy: {s.merge_strategy}, "
            f"{chordal_info.num_overlaps} overlap var(s)"
        )
    kkt = s.kkt_solver if isinstance(s.kkt_solver, str) else "custom"
    print(
        f"Settings: eps_abs = {s.eps_abs:.1e}, eps_rel = {s.eps_rel:.1e},\n"
        f"          eps_prim_inf = {s.eps_prim_inf:.1e}, eps_dual_inf = {s.eps_dual_inf:.1e},\n"
        f"          rho = {s.rho}, sigma = {s.sigma}, alpha = {s.alpha},\n"
        f"          max_iter = {s.max_iter}, scaling iter = {s.scaling},\n"
        f"          check termination every {s.check_termination} iter,\n"
        f"          check infeasibility every {s.check_infeasibility} iter,\n"
        f"          KKT solver = {kkt}, accelerator = {s.accelerator}"
    )
    print("Iter:\tObjective:\tPrimal res:\tDual res:\tRho:")


def print_history_rows(rows):
    """One line a termination check: iteration, objective, primal and dual
    residual, rho (the first five columns of each row)."""
    for row in rows:
        it, cost, rp, rd, rho = row[:5]
        print(f"{int(it)}\t{cost:.4e}\t{rp:.4e}\t{rd:.4e}\t{rho:.4e}")


def print_result(model, result):
    """The footer after a solve: status, iterations, objective, times and
    residuals, and the phase timers under ``verbose_timing``."""
    print("-" * 66)
    print(f">>> Results\nStatus: {result.status}")
    print(f"Iterations: {result.iter} (incl. {result.safeguarding_iter} safeguarding)")
    print(f"Optimal objective: {result.obj_val:.6g}")
    print(
        f"Runtime: {result.times.solver_time:.3f}s "
        f"(setup {result.times.setup_time:.3f}s, graph {result.times.graph_time:.3f}s, "
        f"iter {result.times.iter_time:.3f}s)"
    )
    print(
        f"Residuals: r_prim = {result.info.r_prim:.2e}, "
        f"r_dual = {result.info.r_dual:.2e}"
    )
    if model.settings.verbose_timing:
        t = result.times
        print(
            "Timing (phase kernels measured standalone x call count):\n"
            f"  scaling       {t.scaling_time:9.4f}s\n"
            f"  init factor   {t.init_factor_time:9.4f}s\n"
            f"  factor update {t.factor_update_time:9.4f}s\n"
            f"  projections   {t.proj_time:9.4f}s\n"
            f"  kkt solves    {t.update_time:9.4f}s\n"
            f"  acceleration  {t.accelerate_time:9.4f}s\n"
            f"  post/reverse  {t.post_time:9.4f}s"
        )
    print("-" * 66)


def print_merge_logs(model):
    """Merge diagnostics of the last decomposition (clique_merging.jl:665-686)."""
    ci = getattr(model, "_chordal_info", None)
    if ci is None:
        print("No chordal decomposition was performed.")
        return
    print(">>> Merge Logs:")
    for i, pat in enumerate(ci.patterns):
        log = pat.tree.merge_log
        print(f"Sparsity Pattern Nr. {i + 1}, Graph Size: {pat.side}")
        print(f"\t Num merges: {log.num}\n\t Num decisions: {len(log.decisions)}")


def print_clique_sizes(model):
    """Clique-size histogram of the last decomposition (trees.jl:340-380)."""
    ci = getattr(model, "_chordal_info", None)
    if ci is None:
        print("No chordal decomposition was performed.")
        return
    print(">>> Clique Dimensions:")
    for i, pat in enumerate(ci.patterns):
        t = pat.tree
        sizes = Counter(t.n_blk(pos) for pos in range(t.num))
        print(f"Sparsity Pattern Nr. {i + 1}, Graph Size: {pat.side}")
        for dim in sorted(sizes):
            print(f"{sizes[dim]}x dim: {dim}")
