"""Native (C++) host-side helpers of the chordal analysis, loaded with
ctypes (a copy of ``cosmo_tpu.native``).

The library is compiled from ``chordal.cpp`` with the system g++ at first
use, into ``cosmo_tpu_torch/_build/`` under a name that carries a hash of
the source. Every entry returns None when the library cannot be built or
loaded, and the callers then run their pure-Python implementations. This is
host code that runs once per decomposition, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "chordal.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libchordal_{digest}.so"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not so.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                # compile to a per-process temp file and rename into place:
                # a concurrent process sees no library or the whole one
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                try:
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                        check=True, capture_output=True, timeout=120,
                    )
                    os.replace(tmp, so)
                finally:
                    if tmp.exists():
                        tmp.unlink()
            lib = ctypes.CDLL(str(so))
            I64 = ctypes.POINTER(ctypes.c_int64)
            lib.min_degree.restype = ctypes.c_int64
            lib.min_degree.argtypes = [ctypes.c_int64, ctypes.c_int64, I64, I64, I64]
            lib.symbolic_cholesky.restype = ctypes.c_int64
            lib.symbolic_cholesky.argtypes = [
                ctypes.c_int64, ctypes.c_int64, I64, I64, I64,
                ctypes.c_int64, I64, I64,
            ]
            F64 = ctypes.POINTER(ctypes.c_double)
            lib.nonzero_f64.restype = ctypes.c_int64
            lib.nonzero_f64.argtypes = [ctypes.c_int64, F64, I64]
            lib.clique_graph_merge.restype = ctypes.c_int64
            lib.clique_graph_merge.argtypes = [
                ctypes.c_int64,                       # nc
                I64, I64, I64, I64,                   # snd/sep CSR
                ctypes.c_int64, I64, ctypes.c_int64, ctypes.c_int64,  # weight
                I64, I64, ctypes.c_int64, I64,        # snd out + cap + need
                I64, I64, F64, ctypes.c_int64, I64,   # edges out + cap + n
                I64, I64, I64, ctypes.c_int64, I64,   # log out + cap + n
                I64,                                  # num_merges
            ]
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def available() -> bool:
    return _load() is not None


def _edges_from_adj(adj):
    """Directed edge arrays from either a ``(n, i, j)`` edge-array graph
    (pass-through) or a list of neighbor sets."""
    if isinstance(adj, tuple):
        n, i, j = adj
        return int(n), np.ascontiguousarray(i, np.int64), np.ascontiguousarray(j, np.int64)
    ii, jj = [], []
    for v, nbrs in enumerate(adj):
        for u in nbrs:
            ii.append(v)
            jj.append(u)
    return (
        len(adj),
        np.asarray(ii, dtype=np.int64),
        np.asarray(jj, dtype=np.int64),
    )


def nonzero_f64(x: np.ndarray) -> Optional[np.ndarray]:
    """Indices of nonzeros of a float64 vector (np.flatnonzero equivalent);
    None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    out = np.empty(x.size, dtype=np.int64)
    k = lib.nonzero_f64(
        x.size, x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _ptr(out)
    )
    return out[:k]


def min_degree_ordering(adj) -> Optional[np.ndarray]:
    """Native greedy minimum-degree; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n, i, j = _edges_from_adj(adj)
    perm = np.empty(n, dtype=np.int64)
    lib.min_degree(n, i.size, _ptr(i), _ptr(j), _ptr(perm))
    return perm


def _csr_from_sets(sets_list: List[set]):
    """CSR (ptr, val) int64 arrays over sorted per-set vertex lists."""
    ptr = np.zeros(len(sets_list) + 1, dtype=np.int64)
    for k, s in enumerate(sets_list):
        ptr[k + 1] = ptr[k] + len(s)
    val = np.empty(int(ptr[-1]), dtype=np.int64)
    for k, s in enumerate(sets_list):
        val[ptr[k] : ptr[k + 1]] = sorted(s)
    return ptr, val


def clique_graph_merge(snd: List[set], sep: List[set], weight_mode: int,
                       pads, pad_to: int):
    """Native CliqueGraphMerge (reduced clique graph + greedy merge loop).

    Returns ``(snd_sets, edge_weights, merge_log_pairs, decisions, n_merges)``
    — the merged full cliques, the surviving weighted edges
    ``{(a, b): w}`` for the Kruskal tree rebuild, and the merge log — or
    None when the library is unavailable. Bit-identical to the pure-Python
    ``merging.merge_clique_graph`` loop (same weights and tie order).
    """
    lib = _load()
    if lib is None:
        return None
    nc = len(snd)
    snd_ptr, snd_val = _csr_from_sets(snd)
    sep_ptr, sep_val = _csr_from_sets(sep)
    pads = np.ascontiguousarray(pads, dtype=np.int64)
    snd_cap = int(snd_ptr[-1]) + 1
    edge_cap = max(8 * nc + 64, 1024)
    log_cap = nc + 2
    FP = ctypes.POINTER(ctypes.c_double)
    for _ in range(3):
        out_ptr = np.empty(nc + 1, dtype=np.int64)
        out_val = np.empty(snd_cap, dtype=np.int64)
        snd_need = np.zeros(1, dtype=np.int64)
        ea = np.empty(edge_cap, dtype=np.int64)
        eb = np.empty(edge_cap, dtype=np.int64)
        ew = np.empty(edge_cap, dtype=np.float64)
        n_edges = np.zeros(1, dtype=np.int64)
        la = np.empty(log_cap, dtype=np.int64)
        lb = np.empty(log_cap, dtype=np.int64)
        ld = np.empty(log_cap, dtype=np.int64)
        n_log = np.zeros(1, dtype=np.int64)
        n_merges = np.zeros(1, dtype=np.int64)
        ret = lib.clique_graph_merge(
            nc, _ptr(snd_ptr), _ptr(snd_val), _ptr(sep_ptr), _ptr(sep_val),
            int(weight_mode), _ptr(pads), pads.size, int(pad_to),
            _ptr(out_ptr), _ptr(out_val), snd_cap, _ptr(snd_need),
            _ptr(ea), _ptr(eb), ew.ctypes.data_as(FP), edge_cap, _ptr(n_edges),
            _ptr(la), _ptr(lb), _ptr(ld), log_cap, _ptr(n_log),
            _ptr(n_merges),
        )
        if ret == 0:
            ne, nl = int(n_edges[0]), int(n_log[0])
            snd_sets = [
                set(out_val[out_ptr[k] : out_ptr[k + 1]].tolist())
                for k in range(nc)
            ]
            edges = {
                (int(ea[i]), int(eb[i])): float(ew[i]) for i in range(ne)
            }
            pairs = [(int(la[i]), int(lb[i])) for i in range(nl)]
            decisions = [bool(ld[i]) for i in range(nl)]
            return snd_sets, edges, pairs, decisions, int(n_merges[0])
        snd_cap = int(snd_need[0]) + 16
        edge_cap = int(n_edges[0]) + 16
        log_cap = int(n_log[0]) + 16
    return None


def symbolic_cholesky(adj, perm: np.ndarray) -> Optional[List[np.ndarray]]:
    """Native symbolic factor pattern; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n, i, j = _edges_from_adj(adj)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    cap = max(4 * i.size + 4 * n, 1024)
    for _ in range(3):
        colptr = np.empty(n + 1, dtype=np.int64)
        rowval = np.empty(cap, dtype=np.int64)
        ret = lib.symbolic_cholesky(
            n, i.size, _ptr(i), _ptr(j), _ptr(perm), cap, _ptr(colptr), _ptr(rowval)
        )
        if ret >= 0:
            return [
                rowval[colptr[c] : colptr[c + 1]].copy() for c in range(n)
            ]
        cap = int(-ret) + 16
    return None
