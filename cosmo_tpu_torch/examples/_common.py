"""Shared set-up of the examples: each solves in float64, as the JAX
package's examples do (``examples/_common.py``), on a CUDA device unless
asked for the CPU."""
import argparse

import numpy as np
import torch

import cosmo_tpu_torch as cosmo


def settings(**kw) -> cosmo.Settings:
    """``Settings(**kw)`` in float64."""
    return cosmo.Settings(dtype=np.float64, **kw)


def run(main, doc: str):
    """Run an example's ``main`` with the device of the command line
    (``--device``, default cuda). On the CPU the solves use one thread:
    the examples' small operations run faster without a thread pool."""
    parser = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    device = parser.parse_args().device
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    main(device)
