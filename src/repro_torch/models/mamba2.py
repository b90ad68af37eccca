"""Mamba-2 (SSD) mixer, the Zamba2 backbone block (port of
``repro.models.mamba2``).

Training and prefill use the chunked state-space-duality algorithm (the
minimal SSD of the Mamba-2 paper): within a chunk an attention-like
product under a decay mask, across chunks a carried state.  Decode keeps
the O(1) recurrent state

  h_t = h_{t-1} * exp(dt*A) + dt * B_t (x) x_t,   y_t = C_t . h_t + D*x_t

with states ``{"ssm": (B, H, P, N), "conv": (B, K-1, conv_dim)}``.

The reference writes the mixer in plain jnp (no Pallas kernel lies on it);
the port writes it in plain PyTorch, which runs on the card as cuBLAS
products and elementwise kernels.  Where the reference scans over chunks
(``lax.scan``), the port loops over them in Python, so that one chunk's
(b, h, q, q) decay matrix exists at a time, as in the reference.

On a mesh (a DTensor ``x`` under ``distributed.act_sharding.use_rules``)
the mixer runs :func:`_apply_mesh`: ``in_proj``'s columns over the model
axes (``"btf"``), the causal conv on each rank's conv channels (the conv
state's shard), the chunk loop and the decode recurrence inside one
``local_map`` on each rank's batch rows and SSM heads (``"bshp"``,
``"bhpn"``: the ``ssm`` state's shard), B and C whole on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import act_sharding, sharding
from repro_torch.distributed.act_sharding import shard
from repro_torch.models import common
from repro_torch.models.common import ParamSpec

CHUNK = 128  # the SSD's chunk: a pass's length must be at most CHUNK or a multiple of it


def dims(cfg: ModelConfig) -> tuple[int, int, int, int, int]:
    """(d_inner, n_heads, head_p, d_state, conv_dim)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = cfg.ssm_heads if cfg.ssm_heads else d_inner // 64
    head_p = d_inner // n_heads
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n  # x, B, C share the causal conv (n_groups=1)
    return d_inner, n_heads, head_p, n, conv_dim


def spec(cfg: ModelConfig) -> common.SpecTree:
    d = cfg.d_model
    d_inner, h, p, n, conv_dim = dims(cfg)
    proj_out = 2 * d_inner + 2 * n + h  # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((d, proj_out), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), (None, "mlp")),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), init="zeros"),
        "dt_bias": ParamSpec((h,), (None,), init="zeros"),
        "a_log": ParamSpec((h,), (None,), init="ones"),
        "d_skip": ParamSpec((h,), (None,), init="ones"),
        "gate_norm": ParamSpec((d_inner,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((d_inner, d), ("mlp", "embed")),
    }


def _split_proj(params, u: torch.Tensor, cfg: ModelConfig):
    d_inner, _, _, _, conv_dim = dims(cfg)
    zxbcdt = torch.matmul(u, params["in_proj"].to(u.dtype))
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt = zxbcdt[..., d_inner + conv_dim:]
    return z, xbc, dt


def _causal_conv(params, xbc: torch.Tensor, conv_state: torch.Tensor | None, cfg: ModelConfig):
    """Depthwise causal conv over (B, S, conv_dim).  Returns (out, new_state):
    the new state is the last K-1 inputs before the convolution.  The taps
    are summed in the model's dtype in the reference's order (Python's
    ``sum``: tap 0, then + tap 1, ...)."""
    k, s = cfg.ssm_conv, xbc.shape[1]
    if conv_state is not None:
        ctx = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    else:
        ctx = F.pad(xbc, (0, 0, k - 1, 0))
    w = params["conv_w"].to(xbc.dtype)  # (k, conv_dim)
    out = ctx[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + ctx[:, i:i + s] * w[i]
    out = F.silu(out + params["conv_b"].to(xbc.dtype))
    new_state = ctx[:, -(k - 1):] if k > 1 else None
    return out, new_state


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., q) -> (..., q, q) lower-triangular pairwise segment sums,
    -inf above the diagonal.  The -inf goes in before the caller's ``exp``
    (as in the reference): ``exp`` of the upper triangle's differences
    would overflow, and masking after it would give NaN gradients."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]  # sum over (j, i]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,  # (b, s, h, p)
    dt: torch.Tensor,  # (b, s, h), post-softplus
    a: torch.Tensor,  # (h,), negative
    b_in: torch.Tensor,  # (b, s, n)
    c_in: torch.Tensor,  # (b, s, n)
    *,
    chunk: int = CHUNK,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimal SSD in f32.  Returns (y (b, s, h, p), final state (b, h, p, n)).

    ``chunk`` is cut to ``s``; ``s`` must then be a multiple of it (the
    reference asserts so), else ``ValueError``.  The intra-chunk product
    ``einsum("bln,bsn,bhls,bshp->blhp", C, B, L, xd)`` is contracted as
    (C B^T) * L, then times xd: no (b, l, s, h, p) tensor is formed.
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    xd = (x.to(f32) * dt[..., None].to(f32)).reshape(bsz, nc, chunk, h, p)
    da = (dt.to(f32) * a.to(f32)).reshape(bsz, nc, chunk, h).movedim(2, 3)  # (b, nc, h, q)
    bc = b_in.to(f32).reshape(bsz, nc, chunk, n)
    cc = c_in.to(f32).reshape(bsz, nc, chunk, n)
    carry = h0.to(f32) if h0 is not None else torch.zeros((bsz, h, p, n), dtype=f32,
                                                           device=x.device)
    ys = []
    for i in range(nc):
        xd_c, da_c, b_c, c_c = xd[:, i], da[:, i], bc[:, i], cc[:, i]
        da_cum = torch.cumsum(da_c, dim=-1)  # (b, h, q)
        l_mat = torch.exp(_segsum(da_c))  # (b, h, q, q)
        scores = torch.matmul(c_c, b_c.transpose(1, 2))[:, None] * l_mat  # (b, h, l, s)
        y_diag = torch.matmul(scores, xd_c.transpose(1, 2)).transpose(1, 2)  # (b, l, h, p)
        # the inter-chunk contribution from the carried state
        state_decay = torch.exp(da_cum).transpose(1, 2)[..., None]  # (b, q, h, 1)
        y_off = torch.einsum("bsn,bhpn->bshp", c_c, carry) * state_decay
        # carry the state to the end of the chunk
        decay_states = torch.exp(da_cum[..., -1:] - da_cum).transpose(1, 2)[..., None]
        states = torch.einsum("bshp,bsn->bhpn", xd_c * decay_states, b_c)
        carry = carry * torch.exp(da_cum[..., -1])[..., None, None] + states
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)
    return y, carry


def _ssm(params, xs: torch.Tensor, dt_raw: torch.Tensor, b_in: torch.Tensor, c_in: torch.Tensor,
         hprev: torch.Tensor | None, chunk: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The mixer's f32 stage, from the model-dtype projections ``xs`` (b, s,
    h, p), ``dt_raw`` (b, s, h), ``b_in`` and ``c_in`` (b, s, n) and the
    heads' ``params["dt_bias"]``, ``["a_log"]`` and ``["d_skip"]`` (h,): dt =
    softplus(dt_raw + dt_bias) and A = -exp(a_log) in f32; the chunked SSD
    (from ``hprev`` where given) or, for one token with a state, the
    recurrence; then the skip term D * x, added in f32.  Returns (y (b, s,
    h, p) in f32, the new state in f32, or None without ``hprev``)."""
    f32 = torch.float32
    dt = F.softplus(dt_raw.to(f32) + params["dt_bias"].to(f32))
    a = -torch.exp(params["a_log"].to(f32))  # (h,) negative
    if hprev is None:
        y, _ = ssd_chunked(xs, dt, a, b_in, c_in, chunk=chunk)
        hnew = None
    elif xs.shape[1] == 1:  # the one-step decode recurrence
        dec = torch.exp(dt[:, 0] * a)  # (b, h)
        upd = torch.einsum("bhp,bn->bhpn", xs[:, 0].to(f32) * dt[:, 0, :, None],
                           b_in[:, 0].to(f32))
        hnew = hprev.to(f32) * dec[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", c_in[:, 0].to(f32), hnew)[:, None]  # (b, 1, h, p)
    else:  # prefill with a state: the chunked SSD carrying h0
        y, hnew = ssd_chunked(xs, dt, a, b_in, c_in, chunk=chunk, h0=hprev)
    return y + xs.to(y.dtype) * params["d_skip"].to(y.dtype)[None, None, :, None], hnew


def apply(
    params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    state: dict[str, torch.Tensor] | None = None,
    chunk: int = CHUNK,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Mamba2 mixer.  ``state=None``: training or a prefill without state
    (no state returned).  With a state: one token (S == 1) runs the
    recurrence, more run the chunked SSD from the state; the new state
    (a new dict) is cast to the given state's dtypes.

    Dtypes as in the reference: the projections and the conv in ``x``'s
    dtype, dt, A, the SSD and the skip term in f32 (:func:`_ssm`), the sum
    cast to ``x``'s dtype before the gate ``y * silu(z)`` and the gated
    RMSNorm.
    """
    if sharding.is_dtensor(x):
        return _apply_mesh(params, x, cfg, state=state, chunk=chunk)
    d_inner, h, p, n, _ = dims(cfg)
    bsz, s, _ = x.shape
    z, xbc, dt_raw = _split_proj(params, x, cfg)
    xbc_c, conv_state = _causal_conv(params, xbc, None if state is None else state["conv"], cfg)
    xs = xbc_c[..., :d_inner].reshape(bsz, s, h, p)
    b_in = xbc_c[..., d_inner:d_inner + n]
    c_in = xbc_c[..., d_inner + n:]
    y, hnew = _ssm(params, xs, dt_raw, b_in, c_in, None if state is None else state["ssm"],
                   chunk)
    new_state = None if state is None else {"ssm": hnew.to(state["ssm"].dtype),
                                            "conv": conv_state.to(state["conv"].dtype)}
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = common.rmsnorm(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    return torch.matmul(y, params["out_proj"].to(x.dtype)), new_state


def _placed(t: torch.Tensor, want: tuple, what: str) -> torch.Tensor:
    """``t`` itself, checked to lie at ``want``: a DTensor slice at an offset
    off the shard grid would have been redistributed silently."""
    if tuple(t.placements) != tuple(want):
        raise RuntimeError(f"mamba2 on a mesh: {what} at {tuple(t.placements)}, expected {want}")
    return t


def _apply_mesh(params, x: torch.Tensor, cfg: ModelConfig, *,
                state: dict[str, torch.Tensor] | None, chunk: int):
    """:func:`apply` on DTensors, the reference's sites and placements.

    ``in_proj``'s output columns lie over the model axes (``"btf"``), and
    are gathered whole before the split into z, xBC and dt: the column
    shards do not fall on those boundaries.  The conv channels and the SSM
    heads both lie over the model axes, but their shards do not line up
    (``conv_dim = d_inner + 2N``: at zamba2-1.2b on 2 ranks rank 0's
    channels end inside head 33, and B and C sit on the last rank), so
    the causal conv runs on the channel shard the ``conv`` state holds
    (one ``local_map``); its output is gathered whole, x goes to each
    rank's heads (the ``ssm`` state's shard) and B and C whole to every
    model rank.  The chunk loop, or one token's recurrence, then runs in
    one ``local_map`` on each rank's batch rows and heads, with the heads'
    ``dt_bias``, ``a_log`` and ``d_skip``; B's and C's gradients are
    partial sums over the model axes that split the heads.  The gate and
    the gated RMSNorm run on each rank's channels, ``out_proj`` gives a
    partial sum over the model axes.  On a (1, 1) mesh every op is the
    one-card path's, on the same local tensors."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    d_inner, h, p, n, conv_dim = dims(cfg)
    bsz, s, _ = x.shape
    mesh = x.device_mesh
    zxbcdt = shard(torch.matmul(x, params["in_proj"].to(x.dtype)), "btf")
    rows = act_sharding.placements("btd", tuple(zxbcdt.shape))  # batch rows, columns whole
    zxbcdt = zxbcdt.redistribute(mesh, rows)
    z = _placed(zxbcdt[..., :d_inner], rows, "z")
    xbc = _placed(zxbcdt[..., d_inner:d_inner + conv_dim], rows, "xBC")
    dt_raw = _placed(zxbcdt[..., d_inner + conv_dim:], rows, "dt")

    # the causal conv on each rank's channels
    def conv(xl, wl, bl, st):
        return _causal_conv({"conv_w": wl, "conv_b": bl}, xl, st, cfg)

    xbc_c, conv_state = common.conv_on_channels(
        conv, xbc, params["conv_w"], params["conv_b"], None if state is None else state["conv"])

    # x to each rank's heads, B and C whole
    xbc_c = xbc_c.redistribute(mesh, rows)
    xs = shard(_placed(xbc_c[..., :d_inner], rows, "x").reshape(bsz, s, h, p), "bshp")
    b_in = _placed(xbc_c[..., d_inner:d_inner + n], rows, "B")
    c_in = _placed(xbc_c[..., d_inner + n:], rows, "C")
    hp = tuple(xs.placements)
    heads = [i for i, q in enumerate(hp) if q == Shard(2)]
    # the heads' dt_bias, a_log, d_skip: their gradients partial sums over the batch rows
    vec_pl = tuple(Shard(0) if i in heads else Replicate() for i in range(mesh.ndim))
    vec_grad = tuple(Shard(0) if i in heads else Partial() if q == Shard(0) else Replicate()
                     for i, q in enumerate(rows))
    bc_grad = tuple(Partial() if i in heads else q for i, q in enumerate(rows))
    st_pl = act_sharding.placements("bhpn", (bsz, h, p, n))
    ssm_args = (xs, dt_raw, b_in, c_in, params["dt_bias"], params["a_log"], params["d_skip"])
    ssm_in = (hp, hp, rows, rows, vec_pl, vec_pl, vec_pl)
    ssm_grad = (hp, hp, bc_grad, bc_grad, vec_grad, vec_grad, vec_grad)

    def ssm(xl, dtl, bl, cl, dtb, alog, dsk, *hprev):
        vecs = {"dt_bias": dtb, "a_log": alog, "d_skip": dsk}
        y, hnew = _ssm(vecs, xl, dtl, bl, cl, hprev[0] if hprev else None, chunk)
        y = y.reshape(y.shape[0], y.shape[1], -1).to(x.dtype)
        return (y, hnew) if hprev else y

    st = () if state is None else (_placed(state["ssm"], st_pl, "the ssm state"),)
    out = local_map(ssm, out_placements=(hp, st_pl) if st else list(hp),
                    in_placements=ssm_in + (st_pl,) * len(st),
                    in_grad_placements=ssm_grad + (st_pl,) * len(st), device_mesh=mesh,
                    redistribute_inputs=True)(*ssm_args, *st)
    y, new_state = (out[0], {"ssm": out[1].to(state["ssm"].dtype),
                             "conv": conv_state.to(state["conv"].dtype)}) if st else (out, None)
    z = z.redistribute(mesh, y.placements)
    y = common.rmsnorm(y * F.silu(z), params["gate_norm"], cfg.norm_eps)
    return torch.matmul(y, params["out_proj"].to(x.dtype)), new_state


def init_state(
    cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> dict[str, torch.Tensor]:
    _, h, p, n, conv_dim = dims(cfg)
    return {
        "ssm": torch.zeros((batch, h, p, n), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
    }


def ssd_ref(x, dt, a, b_in, c_in) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential-recurrence oracle for :func:`ssd_chunked` (tests)."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    f32 = torch.float32
    hst = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    ys = []
    for t in range(s):
        dec = torch.exp(dt[:, t].to(f32) * a.to(f32))  # (b, h)
        upd = torch.einsum("bhp,bn->bhpn", x[:, t].to(f32) * dt[:, t, :, None].to(f32),
                           b_in[:, t].to(f32))
        hst = hst * dec[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", c_in[:, t].to(f32), hst))
    return torch.stack(ys, dim=1), hst
