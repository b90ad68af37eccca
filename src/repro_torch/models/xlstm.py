"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory, strictly
sequential) with exponential gating and a stabilizer state, per Beck et al.
2024 (arXiv:2405.04517) (port of ``repro.models.xlstm``).

Both cells run token by token: where the reference scans over time
(``lax.scan``), the port loops over the time steps in Python, in eager
PyTorch, so every step is a handful of elementwise kernels and small
products on the card.  Decode (one token with a state) is one step of the
same loop.  The reference has no chunkwise or parallel form, and neither
does the port.  The model computes in ``cfg.dtype``; q, k, v, the gates,
the cells and their states are f32, as in the reference.

mLSTM state: {"c": (B,H,dk,dv), "n": (B,H,dk), "m": (B,H), "conv": (B,K-1,d_inner)}
sLSTM state: {"c", "n", "m", "h": (B,d_inner)}
A call with a state returns a new state in the state's dtype.

On a mesh (a DTensor ``x`` under ``distributed.act_sharding.use_rules``)
the up projections put their columns over the model axes (``"btf"``, the
reference's site), the mLSTM's causal conv runs on each rank's channels
(the ``conv`` state's shard), the projections into q, k, v and the gates
contract those channels (a partial sum over the model axes, reduced), and
each cell's time loop runs inside one ``local_map`` on each rank's batch
rows with the heads whole: the reference's state rule places the cells'
states by batch only.  The output norms and the down projections run on
each rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import act_sharding, sharding
from repro_torch.distributed.act_sharding import shard
from repro_torch.models import common
from repro_torch.models.common import ParamSpec


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, heads, head size)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    h = cfg.n_heads
    return d_inner, h, d_inner // h


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bse,e...->bs...") as one matmul over w's flattened trailing dims."""
    return torch.matmul(x, w.to(x.dtype).reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _log_forget(f_pre: torch.Tensor) -> torch.Tensor:
    """log sigmoid(f), the reference's ``-softplus(-f)``: ``jax.nn.softplus``
    is ``logaddexp(x, 0)`` at every x, where torch's ``softplus`` turns into
    the identity above its threshold; ``logsigmoid`` is the same
    ``min(f, 0) - log1p(exp(-|f|))``."""
    return F.logsigmoid(f_pre)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_spec(cfg: ModelConfig) -> common.SpecTree:
    d = cfg.d_model
    d_inner, h, p = _dims(cfg)
    return {
        "w_up": ParamSpec((d, 2 * d_inner), ("embed", "mlp")),  # x_inner, z
        "conv_w": ParamSpec((cfg.ssm_conv, d_inner), (None, "mlp")),
        "conv_b": ParamSpec((d_inner,), ("mlp",), init="zeros"),
        "w_q": ParamSpec((d_inner, h, p), ("mlp", None, None)),
        "w_k": ParamSpec((d_inner, h, p), ("mlp", None, None)),
        "w_v": ParamSpec((d_inner, h, p), ("mlp", None, None)),
        "w_i": ParamSpec((d_inner, h), ("mlp", None), scale=0.02),
        "w_f": ParamSpec((d_inner, h), ("mlp", None), scale=0.02),
        "b_i": ParamSpec((h,), (None,), init="zeros"),
        "b_f": ParamSpec((h,), (None,), init="ones"),  # forget-bias > 0
        "skip": ParamSpec((d_inner,), ("mlp",), init="ones"),
        "out_norm": ParamSpec((d_inner,), ("mlp",), init="ones"),
        "w_down": ParamSpec((d_inner, d), ("mlp", "embed")),
    }


def _mlstm_cell(carry, q, k, v, i_pre, f_pre):
    """One time step.  carry: (c (b,h,dk,dv), n (b,h,dk), m (b,h)); q, k, v
    (b,h,p); i_pre, f_pre (b,h); all f32 and contiguous.

    The reference's arithmetic in fewer kernels: ``i (k v^T)`` as one
    batched rank-1 product added to ``f c`` (``baddbmm``: no (p, p)
    temporary, and autograd keeps the small factors rather than k v^T),
    ``C^T q`` and ``n . q`` as batched products."""
    c, n, m = carry
    b, h, p = k.shape
    lfm = _log_forget(f_pre) + m
    m_new = torch.maximum(lfm, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(lfm - m_new)
    ik = i_g[..., None] * k
    c_new = torch.baddbmm((f_g[..., None, None] * c).view(b * h, p, p), ik.view(b * h, p, 1),
                          v.view(b * h, 1, p)).view(b, h, p, p)
    n_new = f_g[..., None] * n + ik
    num = torch.matmul(q.view(b * h, 1, p), c_new.view(b * h, p, p)).view(b, h, p)
    qn = torch.matmul(n_new.view(b * h, 1, p), q.view(b * h, p, 1)).view(b, h)
    den = torch.clamp_min(torch.abs(qn), 1.0)
    return (c_new, n_new, m_new), num / den[..., None]


def _steps(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """(b, s, ...) -> s contiguous (b, ...) slices: one copy for the whole
    sequence, and one stack in the backward (where a slice per step would
    write a whole-sequence gradient per step)."""
    return x.movedim(1, 0).contiguous().unbind(0)


def _causal_conv(params, x_in: torch.Tensor, conv_state: torch.Tensor | None, cfg: ModelConfig):
    """The depthwise causal conv of the q/k path and its new state (the last
    K-1 inputs; None without a state), taps summed in the model's dtype in
    the reference's order."""
    k_conv, s, dt = cfg.ssm_conv, x_in.shape[1], x_in.dtype
    if conv_state is not None:
        ctx = torch.cat([conv_state.to(dt), x_in], dim=1)
        new_conv = ctx[:, -(k_conv - 1):]
    else:
        ctx = F.pad(x_in, (0, 0, k_conv - 1, 0))
        new_conv = None
    w = params["conv_w"].to(dt)
    x_c = ctx[:, 0:s] * w[0]
    for i in range(1, k_conv):
        x_c = x_c + ctx[:, i:i + s] * w[i]
    return F.silu(x_c + params["conv_b"].to(dt)), new_conv


def mlstm_apply(
    params, x: torch.Tensor, cfg: ModelConfig, *, state: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """The mLSTM block's mixer: x (B, S, d) -> (B, S, d), and the new state
    when one is given."""
    d_inner, h, p = _dims(cfg)
    dt, f32 = x.dtype, torch.float32
    mesh = sharding.is_dtensor(x)
    up = shard(torch.matmul(x, params["w_up"].to(dt)), "btf")
    if mesh:  # the columns whole before the split: x_in's and z's need not meet the shards
        up = up.redistribute(x.device_mesh, act_sharding.placements("btd", tuple(up.shape)))
    x_in, z = up[..., :d_inner], up[..., d_inner:]
    conv_state = None if state is None else state["conv"]
    if mesh:
        x_c, new_conv = common.conv_on_channels(
            lambda xl, wl, bl, st: _causal_conv({"conv_w": wl, "conv_b": bl}, xl, st, cfg),
            x_in, params["conv_w"], params["conv_b"], conv_state)
    else:
        x_c, new_conv = _causal_conv(params, x_in, conv_state, cfg)

    q = _proj(x_c, params["w_q"]).to(f32)
    k = _proj(x_c, params["w_k"]).to(f32) * (p**-0.5)
    v = _proj(x_in, params["w_v"]).to(f32)
    i_pre = (_proj(x_in, params["w_i"]) + params["b_i"]).to(f32)
    f_pre = (_proj(x_in, params["w_f"]) + params["b_f"]).to(f32)
    carry = None if state is None else (state["c"], state["n"], state["m"])
    h_flat, carry = _on_batch_rows(_mlstm_loop, (q, k, v, i_pre, f_pre), carry, 3, dt)
    new_state = None if state is None else {
        "c": carry[0].to(state["c"].dtype), "n": carry[1].to(state["n"].dtype),
        "m": carry[2].to(state["m"].dtype), "conv": new_conv.to(state["conv"].dtype)}

    if mesh:  # the rest on each rank's channels
        h_flat, z = (t.redistribute(x.device_mesh, x_c.placements) for t in (h_flat, z))
    h_flat = h_flat + params["skip"].to(dt) * x_c
    h_flat = common.rmsnorm(h_flat, params["out_norm"], cfg.norm_eps) * F.silu(z)
    return torch.matmul(h_flat, params["w_down"].to(dt)), new_state


def _mlstm_loop(q, k, v, i_pre, f_pre, carry, dt: torch.dtype):
    """The mLSTM's time loop from ``carry`` (c, n, m; zeros when None):
    (h (b, s, d_inner) in ``dt``, the final carry in f32)."""
    bsz, s, h, p = q.shape
    f32 = torch.float32
    if carry is None:
        carry = (torch.zeros((bsz, h, p, p), dtype=f32, device=q.device),
                 torch.zeros((bsz, h, p), dtype=f32, device=q.device),
                 torch.zeros((bsz, h), dtype=f32, device=q.device))
    else:
        carry = tuple(c.to(f32) for c in carry)
    hs = []
    for q_t, k_t, v_t, i_t, f_t in zip(*map(_steps, (q, k, v, i_pre, f_pre))):
        carry, h_t = _mlstm_cell(carry, q_t, k_t, v_t, i_t, f_t)
        hs.append(h_t)
    h_seq = torch.stack(hs, dim=1)  # (b, s, h, p)
    return h_seq.reshape(bsz, s, h * p).to(dt), carry


def _on_batch_rows(loop, inputs: tuple, carry: tuple | None, n_carry: int, dt: torch.dtype,
                   *weights):
    """``loop(*inputs, *weights, carry, dt)`` (a cell's time loop, whose
    carry has ``n_carry`` tensors), or on DTensors the same loop inside one
    ``local_map`` on each rank's batch rows: the inputs whole over the
    model axes (partial sums from the projections are reduced first), the
    ``weights`` whole, the carry at the reference's state rule (batch
    only).  Every model rank runs the same loop, so the inputs' gradients
    are whole over the model axes and the weights' partial sums over the
    data axes."""
    if not sharding.is_dtensor(inputs[0]):
        return loop(*inputs, *weights, carry, dt)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = inputs[0].device_mesh
    rows = act_sharding.placements("btd", (inputs[0].shape[0], 1, 1))  # batch rows, all else whole
    batch = [i for i, q in enumerate(rows) if q == Shard(0)]
    whole = tuple(Replicate() for _ in range(mesh.ndim))
    w_grad = tuple(Partial() if i in batch else Replicate() for i in range(mesh.ndim))
    n_in, n_w = len(inputs), len(weights)

    def local(*args):
        cs = args[n_in + n_w:]
        out, new = loop(*args[:n_in + n_w], tuple(cs) if cs else None, dt)
        return (out, *new)

    n_given = 0 if carry is None else n_carry
    outs = local_map(local, out_placements=(rows,) * (1 + n_carry),
                     in_placements=(rows,) * n_in + (whole,) * n_w + (rows,) * n_given,
                     in_grad_placements=(rows,) * n_in + (w_grad,) * n_w + (rows,) * n_given,
                     device_mesh=mesh, redistribute_inputs=True)(*inputs, *weights,
                                                                 *(carry or ()))
    return outs[0], tuple(outs[1:])


def mlstm_init_state(
    cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> dict[str, torch.Tensor]:
    d_inner, h, p = _dims(cfg)
    shapes = {"c": (batch, h, p, p), "n": (batch, h, p), "m": (batch, h),
              "conv": (batch, cfg.ssm_conv - 1, d_inner)}
    return {k: torch.zeros(v, dtype=dtype, device=device) for k, v in shapes.items()}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_spec(cfg: ModelConfig) -> common.SpecTree:
    d = cfg.d_model
    d_inner, h, p = _dims(cfg)
    return {
        "w_up": ParamSpec((d, d_inner), ("embed", "mlp")),
        # input projections for i, f, z, o gates
        "w_gates": ParamSpec((d_inner, 4, d_inner), ("mlp", None, None), scale=0.02),
        "b_gates": ParamSpec((4, d_inner), (None, None), init="zeros"),
        # block-diagonal (per-head) recurrent weights for each gate
        "r_gates": ParamSpec((4, h, p, p), (None, None, None, None), scale=0.02),
        "out_norm": ParamSpec((d_inner,), ("mlp",), init="ones"),
        "w_down": ParamSpec((d_inner, d), ("mlp", "embed")),
    }


def _slstm_cell(r_hq: torch.Tensor, carry, x_t: torch.Tensor):
    """One time step.  r_hq (h, q, 4 p): the block-diagonal recurrent gates,
    one (p, p) matrix per head and gate, as ``r_gates.permute(1, 3, 0, 2)``
    (``_recurrent``); carry: (c, n, m, h) each (b, d_inner) f32; x_t (b, 4,
    d_inner): the input's gate contributions with the gates' bias, f32."""
    h, p, _ = r_hq.shape
    c, n, m, h_prev = carry
    b = h_prev.shape[0]
    rec = torch.matmul(h_prev.view(b, h, p).transpose(0, 1), r_hq)  # (h, b, 4 p)
    pre = x_t.view(b, 4, h, p) + rec.view(h, b, 4, p).permute(1, 2, 0, 3)
    i_pre, f_pre, z_pre, o_pre = pre.view(b, 4, h * p).unbind(1)
    lfm = _log_forget(f_pre) + m
    m_new = torch.maximum(lfm, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(lfm - m_new)
    c_new = f_g * c + i_g * torch.tanh(z_pre)
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c_new / torch.clamp_min(n_new, 1.0)
    return (c_new, n_new, m_new, h_new), h_new


def _recurrent(r_gates: torch.Tensor) -> torch.Tensor:
    """(4, h, p, q) -> (h, q, 4 p) f32: ``rec[b, g, h, p] = sum_q r[g, h, p, q]
    h_prev[b, h, q]`` becomes one batched product over the heads."""
    g, h, p, q = r_gates.shape
    return r_gates.to(torch.float32).permute(1, 3, 0, 2).reshape(h, q, g * p)


def slstm_apply(
    params, x: torch.Tensor, cfg: ModelConfig, *, state: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """The sLSTM block's mixer: x (B, S, d) -> (B, S, d), and the new state
    when one is given."""
    dt, f32 = x.dtype, torch.float32
    u = shard(torch.matmul(x, params["w_up"].to(dt)), "btf")
    # the input's gate contributions and the bias, (b, s, 4, d_inner) f32
    gates_in = _proj(u, params["w_gates"]).to(f32) + params["b_gates"].to(f32)
    carry = None if state is None else tuple(state[k] for k in ("c", "n", "m", "h"))
    h_seq, carry = _on_batch_rows(_slstm_loop, (gates_in,), carry, 4, dt, params["r_gates"])
    new_state = None if state is None else {
        k: c.to(state[k].dtype) for k, c in zip(("c", "n", "m", "h"), carry)}

    y = common.rmsnorm(shard(h_seq, "btf"), params["out_norm"], cfg.norm_eps)
    return torch.matmul(y, params["w_down"].to(dt)), new_state


def _slstm_loop(gates_in, r_gates, carry, dt: torch.dtype):
    """The sLSTM's time loop from ``carry`` (c, n, m, h; zeros when None):
    (h (b, s, d_inner) in ``dt``, the final carry in f32)."""
    bsz, _, _, d_inner = gates_in.shape
    f32 = torch.float32
    r_hq = _recurrent(r_gates)
    if carry is None:
        zeros = torch.zeros((bsz, d_inner), dtype=f32, device=gates_in.device)
        carry = (zeros, zeros, zeros, zeros)
    else:
        carry = tuple(c.to(f32) for c in carry)
    hs = []
    for x_t in _steps(gates_in):
        carry, h_t = _slstm_cell(r_hq, carry, x_t)
        hs.append(h_t)
    return torch.stack(hs, dim=1).to(dt), carry


def slstm_init_state(
    cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> dict[str, torch.Tensor]:
    d_inner, _, _ = _dims(cfg)
    return {k: torch.zeros((batch, d_inner), dtype=dtype, device=device)
            for k in ("c", "n", "m", "h")}

