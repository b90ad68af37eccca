"""Torch oracles for the SU3 multiply (port of ``repro.kernels.ref``).

They use complex arithmetic and einsum directly; they are ground truth for
tests, not the port of any kernel.
"""
from __future__ import annotations

import torch


def su3_mult_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SU3_Bench core kernel, canonical complex form.

    C[i, j] = A[i, j] @ B[j]  for every site i and link j (paper Fig. 1).

    a: (n_sites, 4, 3, 3) complex; b: (4, 3, 3) complex -> (n_sites, 4, 3, 3).
    """
    return torch.einsum("sjkl,jlm->sjkm", a, b)


def su3_mult_planar_ref(a_p: torch.Tensor, b_p: torch.Tensor) -> torch.Tensor:
    """Planar oracle: SoA layout (2, 4, 3, 3, n_sites) x (2, 4, 3, 3).

    (ar + i*ai)(br + i*bi) = (ar*br - ai*bi) + i*(ar*bi + ai*br)
    """
    ar, ai = a_p[0], a_p[1]
    br, bi = b_p[0], b_p[1]
    cr = torch.einsum("jkls,jlm->jkms", ar, br) - torch.einsum("jkls,jlm->jkms", ai, bi)
    ci = torch.einsum("jkls,jlm->jkms", ar, bi) + torch.einsum("jkls,jlm->jkms", ai, br)
    return torch.stack([cr, ci], dim=0)
