"""Autotuning support for the port (the part of ``repro.core.autotune`` the
stencil/CG slice needs so far).

Only the CG measurement problem is here: the sweeps, the cache and the
candidate models wait for the autotune slice.
"""
from __future__ import annotations

import numpy as np


def _cg_measure_problem(L: int, seed: int = 7) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic convergent CG problem: a constant-per-direction SU(3)
    gauge field (each U_mu constant along mu, so the site-local-adjoint
    stencil is exactly Hermitian) and a unit-scale right-hand side.

    Built with numpy from ``seed`` exactly as the reference builds it, so
    both packages can consume the same arrays.

    Returns:
        ``(u, b)``: ``u`` (L^4, 4, 3, 3) and ``b`` (L^4, 3), complex64.
    """
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(4, 3, 3)) + 1j * rng.normal(size=(4, 3, 3))
    q, r = np.linalg.qr(a)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    q = q / np.linalg.det(q)[..., None, None] ** (1.0 / 3.0)
    n = L**4
    u = np.broadcast_to(q, (n, 4, 3, 3)).astype(np.complex64)
    b = (rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3))).astype(np.complex64)
    return u, b
