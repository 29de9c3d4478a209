"""Where a round of the cluster kernel goes, on one card.

    python -m cosmo_tpu_torch.profile_cluster

Builds ``csrc/jacobi_eig_cluster.cu`` once more with
``-DJACOBI_CLUSTER_PROFILE`` (``cuda_build.variant_library``) and
runs it on the amortized backend's timed shapes ([8, 256] float64 and
[1, 896] float32, warm and stale, made as ``chip_smoke.eig_case`` makes
them), at every cluster size that holds W. For each it prints the device time of
the W phase and of the V replay (``torch.profiler``) and, from the clock of
thread 0 of the first CTA, the microseconds a round spends waiting for the
other CTAs' copies, computing the angles, writing its mailbox and turning
its tiles (summed over the rounds, divided by them). The profiled build
adds one block barrier a round; its times are a breakdown, not the
kernel's time (``chip_smoke.py`` 10e has that). Then, for the cluster
size rule (``jacobi_eig.cluster_size``), the wrapper's time (``launch_ms``,
a warm case) at every cluster size that holds W, at those shapes and at
maxcut-10k's amortized buckets of sides 64-192, beside the rule's choice.
Needs CUDA.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .kernel_timing import card, launch_ms
from .ops import cuda_build
from .ops import eigh as E
from .ops import jacobi_eig as JE

SHAPES = ((256, 8, torch.float64), (896, 1, torch.float32))
# (k, B) of maxcut-10k's amortized buckets that the cluster kernel takes
# below 896 (chip_smoke.py 10g), float32
MAXCUT_BUCKETS = ((64, 5), (96, 17), (128, 8), (192, 5))
PARTS = ("wait", "angles", "mailbox", "tiles")


def _case(B, k, warm, seed=5):
    """W and V0 of one amortized projection (a symmetric Gaussian X; warm:
    V0 its eigenbasis turned by angles ~0.01 sqrt(48 / k), W = V0' X V0;
    stale: V0 = I, W = X)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, k, k))
    X = (G + G.swapaxes(1, 2)) / 2
    if warm:
        R = rng.standard_normal((B, k, k)) * 0.01 * min(1.0, np.sqrt(48 / k))
        R, _ = np.linalg.qr(np.eye(k) + (R - R.swapaxes(1, 2)))
        V0 = np.linalg.eigh(X)[1] @ R
        W = V0.swapaxes(1, 2) @ X @ V0
        W = (W + W.swapaxes(1, 2)) / 2
    else:
        V0, W = np.broadcast_to(np.eye(k), (B, k, k)), X
    return X, W, V0


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_cluster needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    lib = cuda_build.variant_library("jacobi_eig_cluster.cu", "-DJACOBI_CLUSTER_PROFILE")
    device = torch.device("cuda")
    print(card())
    for k, B, dtype in SHAPES:
        for warm in (True, False):
            X, W, V0 = (torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)
                        for a in _case(B, k, warm))
            stale = E.amortized_rotate(X, V0)[2]
            w, V = torch.empty((B, k), dtype=dtype, device=device), torch.empty_like(W)
            angle_log = torch.empty(B * 8 * (k - 1) * k, dtype=dtype, device=device)
            fn = lib.jacobi_eig_cluster_f32 if dtype == torch.float32 else \
                lib.jacobi_eig_cluster_f64
            for cluster in JE._cluster_sizes(k, dtype.itemsize):
                def call():
                    progress = torch.zeros(B * cluster, dtype=torch.int32, device=device)
                    err = fn(W.data_ptr(), V0.data_ptr(), w.data_ptr(), V.data_ptr(),
                             angle_log.data_ptr(), progress.data_ptr(), stale.data_ptr(), 2,
                             8, None, B, k, cluster,
                             torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"jacobi_eig_cluster: CUDA error {err}")

                call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        call()
                    torch.cuda.synchronize()
                ms = {("W" if "cluster_w" in e.key else "V"):
                      e.device_time_total / e.count / 1e3 for e in prof.key_averages()
                      if e.device_time_total > 0 and "jacobi_eig_cluster" in e.key}
                out = (ctypes.c_longlong * 7)()
                lib.jacobi_eig_cluster_profile(out)
                rounds, khz = max(out[5], 1), out[6]
                parts = " ".join(f"{name} {out[n] / rounds / khz * 1e3:.3f}"
                                 for n, name in enumerate(PARTS))
                print(f"k={k} B={B} {str(dtype).split('.')[1]} "
                      f"{'warm' if warm else 'stale'} cluster={cluster}: W phase "
                      f"{ms.get('W', 0):.4f} ms, V replay {ms.get('V', 0):.4f} ms; a round "
                      f"({out[5]} rounds, us): {parts}", flush=True)
    for k, B, dtype in (*SHAPES, *((k, B, torch.float32) for k, B in MAXCUT_BUCKETS)):
        X, W, V0 = (torch.as_tensor(np.array(a, order="C"), dtype=dtype, device=device)
                    for a in _case(B, k, True))
        stale = E.amortized_rotate(X, V0)[2]
        times = []
        for c in JE._cluster_sizes(k, dtype.itemsize):
            ms = launch_ms(lambda: JE.jacobi_eig_cluster_cuda(W, V0, stale, 2, 8, cluster=c),
                           10)
            times.append(f"{c}: {ms:.4f}")
        rule = JE.cluster_size(B, k, dtype.itemsize,
                               lambda c: JE.max_active_clusters(k, c, dtype, 0))
        print(f"k={k} B={B} {str(dtype).split('.')[1]} warm, ms by cluster size: "
              f"{' '.join(times)}; the rule takes {rule}", flush=True)


if __name__ == "__main__":
    main()
