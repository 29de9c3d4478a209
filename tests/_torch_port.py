"""Shared helpers of the tests that hold cosmo_tpu_torch to cosmo_tpu."""
import dataclasses

import numpy as np


def as_numpy_dict(obj):
    """A cosmo_tpu dataclass (ConeData, Bde, buckets) as nested dicts of
    numpy arrays and Python scalars — the input of cosmo_tpu_torch.convert."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: as_numpy_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return [as_numpy_dict(x) for x in obj]
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        return np.asarray(obj)
    return obj


def sym_stack(B, k, seed):
    """A [B, k, k] stack of symmetric Gaussian matrices (float64)."""
    G = np.random.default_rng(seed).standard_normal((B, k, k))
    return (G + G.swapaxes(1, 2)) / 2


def eigh_projection(X):
    """The PSD projection of a numpy stack by LAPACK eigh."""
    w, V = np.linalg.eigh(X)
    return np.einsum("bik,bk,bjk->bij", V, np.maximum(w, 0.0), V)
