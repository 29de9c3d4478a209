"""One-call functional entry point, SCS-style (the port of
``cosmo_tpu.interface``; reference: src/interface.jl:253-366).

``solve(P, q, A, b, cone, ...)`` solves ``min 1/2 x'Px + q'x s.t.
Ax + s = b, s in K`` with K described by a cone dict:

    {"f": #zero rows, "l": #nonneg rows, "q": [soc dims],
     "s": [psd triangle dims], "ep": #exp, "ed": #dual exp,
     "p": [power exponents, negative = dual], "b": #box rows (bounds l, u)}
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from .models.model import Model, cone_sets_from_dict
from .results import Result
from .settings import Settings


def solve(P, q, A, b, cone: dict, l=None, u=None,
          settings: Optional[Settings] = None, device=None, **kwargs) -> Result:
    """Solve ``min 1/2 x'Px + q'x s.t. Ax + s = b, s in K`` in one call on
    ``device`` (None: cuda). ``P`` may be None (a conic-linear program).
    Extra keyword arguments are settings fields (``eps_abs=1e-6``)."""
    q = np.asarray(q, dtype=np.float64).ravel()
    n = q.shape[0]
    if P is None:
        P = sp.csr_matrix((n, n)) if sp.issparse(A) else np.zeros((n, n))
    if settings is None:
        settings = Settings(**kwargs)
    elif kwargs:
        settings = settings.replace(**kwargs)
    model = Model(settings, device=device)
    model.set(P, q, A, b, cone_sets_from_dict(cone, l, u))
    return model.optimize()
