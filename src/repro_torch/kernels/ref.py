"""Torch oracles (port of ``repro.kernels.ref``): the SU3 multiply,
full-materialisation attention and RMSNorm.

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


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Naive full-materialization attention oracle.

    q: (batch, q_len, n_q_heads, d_head); k/v: (batch, kv_len, n_kv_heads, d_head).
    GQA handled by repeating kv heads. Computes in fp32 regardless of input dtype.
    The causal mask aligns the last query with the last key (qpos + sk - sq),
    unlike the chunked path and the kernel, which count from 0.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    assert hq % hkv == 0
    rep = hq // hkv
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scale = scale if scale is not None else d**-0.5
    qf = q.to(torch.float32) * scale
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, k.to(torch.float32))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w
