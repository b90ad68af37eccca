"""GQA prefill attention with an online softmax: the CUDA kernel's wrapper
and its plain version.

Port of ``repro.kernels.flash_attention.flash_attention_tpu`` (Pallas, TPU),
which the reference documents as the prefill attention on the accelerator;
what it computes is the reference's chunked ``models/attention.py``
``flash_attention``.  The kernel is ``repro_torch/csrc/flash_attention.cu``;
this module holds:

  * :func:`flash_attention_plain` — the chunked online-softmax attention in
    plain PyTorch, the reference's ``models/attention.py`` ``flash_attention``
    with the same chunking and padding (``Dv != D`` included);
  * :func:`flash_attention` — the wrapper: for CUDA tensors it checks the
    arguments, launches the kernel on the current stream and counts the
    launch in :data:`LAUNCHES`; for CPU tensors it runs the plain version;
    for ``meta`` tensors (shapes without data) it runs the plain version too,
    which gives the shapes; any other device raises.
    When grad is enabled and q, k or v requires it, the call goes through
    :class:`FlashAttention`;
  * :class:`FlashAttention` — the autograd function: its forward keeps the
    log-sum-exp of each row (the kernel writes it beside ``out``, the plain
    version returns it), its backward is :func:`flash_attention_bwd`;
  * :func:`flash_attention_split`, :class:`FlashAttentionSplit` and
    :func:`flash_attention_split_bwd` — MLA's attention on its parts
    (q_nope, q_rope, k_nope, a k_rope shared by every head, v), read in
    place by the bf16 kernel at (192, 128);
  * :func:`flash_attention_bwd` — the backward's wrapper: dq, dk, dv from
    q, k, v, out, dout and lse, by the kernel for CUDA tensors (counted in
    :data:`BWD_LAUNCHES`) or :func:`flash_attention_bwd_plain` for CPU
    tensors.  The reference differentiates its chunked attention by
    autodiff; the kernel computes that gradient FA2-style (see
    ``flash_attention.cu``), deterministically;
  * :func:`tiling`, :func:`smem_bytes`, :func:`executed_flops`,
    :func:`kernel_budget` and their backward counterparts
    :func:`bwd_tiling`, :func:`bwd_smem_bytes`, :func:`bwd_executed_flops`,
    :func:`bwd_budget` — each body's tiling, shared memory per block (the
    counterpart of the reference's ``vmem_bytes``), the flops its tiles
    execute, its registers and occupancy.

Layout contract (the reference's, at the public functions):
  q: (B, Sq, Hq, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv), Hq a
  multiple of Hkv; the G = Hq / Hkv query heads of a kv head are read in
  place through the strides.  Causal masking is on absolute positions:
  query i sits at i + q_offset, key j at j.  Scale D^-1/2 on q in f32, f32
  statistics, masked scores -1e30, out = acc / max(l, 1e-37) in q's dtype
  -> (B, Sq, Hq, Dv).

The kernel takes f32 or bf16, (D, Dv) in :data:`HEAD_DIMS` (Dv = D at 32,
64 and 128; MLA's prefill at D = 192, Dv = 128), any Sq and Skv (the
ragged edge is masked in the kernel) and ignores ``q_chunk`` / ``kv_chunk``,
which shape the plain version's chunking only.  It has two bodies:

  * bf16, on the tensor cores: tiles of 128 folded rows (two consumer
    warpgroups of 64) against K/V tiles of 128 keys brought by TMA.  At D =
    Dv = 64 and 128 (G <= 128) one persistent block per SM walks (kv head,
    tile of whole query groups: G * (128 // G) folded rows) items with three
    K and three V stages and two (D=64) or one (D=128) Q stages
    (``flash_group_fwd``).  At MLA's D = 192, Dv = 128 (G = 1 only) one
    persistent block per SM walks a list of (head, row tile) items with a
    ring of two K and two V stages (``flash_mla_fwd``; see
    :func:`smem_bytes`), reading q and k as nope and rope parts
    (:func:`flash_attention_split`).  At D = 32 blocks of 128 folded rows
    take K/V tiles through a ring of three stages (``flash_attention_tc``).
    q . k is summed in f32 from the bf16
    operands and scaled in f32 inside the exponent; p is split into two
    bf16 parts, so P V runs twice.  TMA needs k and v strides in multiples
    of 8 elements (16 bytes).
  * f32, on the CUDA cores: blocks of 64 rows against tiles of 64 keys, all
    in f32 FMAs.

The backward ((D, Dv) in :data:`BWD_HEAD_DIMS`, the forward's pairs: MLA's
training at (192, 128)) has the same two bodies.  bf16, on the tensor cores: a dK/dV
kernel whose two consumer warpgroups own a pair of key tiles of 64 (tile j
and tile n - 1 - j, so that causal blocks carry equal work) and share one
stream of row tiles of q and dout (G * (64 // G) folded rows each, G <= 64)
through four stages by TMA; at (192, 128) a dK/dV kernel of one key tile a
block whose two consumers split the products (dV on one, dK on the other,
P^T handed between them), on q and k as nope and rope parts; a dQ kernel
of blocks of 128 folded rows against K/V tiles of 128 keys by TMA (two
stages; tiles of 64 keys at (192, 128)); at D = Dv = 64 and 128 both
kinds of block are work items of one persistent kernel (``flash_bwd_d64``,
``flash_bwd_d128``: one block per SM claims the items of every head, dK/dV
pairs of key tiles 2j and 2j + 1 and dQ tiles of G * (128 // G) folded
rows, from a counter; :func:`persistent_bwd_plan`).  See
:func:`bwd_smem_bytes`.  P and dS are each
split into two bf16 parts before their products, as the forward splits p,
so dV, dK and dQ run twice.  q, k, v and dout need 16-byte rows, as
in the forward; a dout without them is copied.  f32, on the CUDA cores:
tiles of 64 rows and 64 keys in f32 FMAs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.su3_matmul import LaunchCounter, _check_error

NEG_INF = -1e30
# The forward's instantiations, (D, Dv): q and k's head dim, v's.  (192,
# 128) is MLA's prefill (qk head nope 128 + rope 64, v head 128).
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (192, 128))
BWD_HEAD_DIMS = HEAD_DIMS  # the backward's instantiations, (D, Dv): the forward's
# Each body's tiling as flash_attention.cu fixes it; kernel_budget raises if
# the built library reports another.
BLOCK_ROWS = 64  # f32 body: folded query rows per block
BLOCK_KEYS = 64  # f32 body: keys per tile
TC_ROWS = 128  # bf16 body: folded query rows per block (two warpgroups of 64)
TC_KEYS = 128  # bf16 body: keys per K/V tile
TC_STAGES = 3  # bf16 body: K/V tiles in flight where Dv = D (flash_attention_tc, D=32)
TC_STAGES_SPLIT = 2  # bf16 body at Dv != D (192, 128): K and V stages each
# bf16 body at D = Dv = 64 and 128 (flash_group_fwd): K and V stages each, and
# Q tiles by D (at 64 this item's and the next one's)
TC_GROUP_STAGES = 3
TC_GROUP_Q_STAGES = {64: 2, 128: 1}
MAX_BATCH_HEADS = 65535  # B * Hkv rides on a grid dimension (gridDim.y in the f32 body)
MAX_ROW_TILES = 65535  # bf16 body: row tiles ride on gridDim.y (held in the persistent ones too)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # as flash_attention.cu numbers them
_PLAIN_DEVICES = ("cpu", "meta")  # the devices the plain versions serve


def _plain_chunks(q: torch.Tensor, k: torch.Tensor, q_chunk: int,
                  kv_chunk: int) -> tuple[int, int]:
    """The plain versions' chunks: as given, or on ``meta`` (shapes without
    data: the dry run's trace, ``launch/dryrun.py``) the whole sequences, one
    chunk pair that gives the same shapes in a few ops where chunks of 512 x
    1,024 would repeat the ops per pair."""
    if q.device.type == "meta":
        return q.shape[1], k.shape[1]
    return q_chunk, kv_chunk

LAUNCHES = LaunchCounter("flash_attention")
BWD_LAUNCHES = LaunchCounter("flash_attention_bwd")  # one per backward call (2 or 3 kernels)
# The same launches by the kernel that ran (:func:`kernel_name`): the forward
# kernel's name, or the backward's last kernel's (its persistent one, or its
# dQ kernel) for a backward call
LAUNCHES_BY_KERNEL: dict[str, int] = {}
# The backward's tiling per body, (folded rows per tile, keys per tile, tiles
# in flight) of each kernel; bwd_budget raises if the built library reports
# another.  bf16 dK/dV: rows of a streamed Q/dO tile, keys of one consumer
# warpgroup (a block holds two such tiles); dQ: rows of a block, keys of a
# K/V tile.
BWD_TILING = {
    torch.bfloat16: {"dkdv": (64, 64, 4), "dq": (128, 128, 2)},
    torch.float32: {"dkdv": (64, 64, 1), "dq": (64, 64, 1)},
}
# At D = Dv = 64 one persistent kernel (flash_bwd_d64) holds both roles, with
# the same tiling: its dK/dV items stream row tiles of 64 through four
# stages, its dQ items K/V tiles of 128 keys through two (an item of
# G * (128 // G) folded rows, whole query groups).  At D = Dv = 128
# (flash_bwd_d128) both stream through one ring of three stages: a row tile
# takes one, a dQ key tile two (its V, then its K).
PERSISTENT_BWD_SLOTS = 2  # operand slots (an item's, the next one's)
BWD_TILING_D128 = {"dkdv": (64, 64, 3), "dq": (128, 128, 3)}
# The bf16 body at Dv != D, MLA's (192, 128): a dK/dV block of one key tile
# whose two consumers split the products (flash_bwd_dkdv_mla), four row tiles
# in flight; dQ on K/V tiles of 64 keys (128 would pass the 227 KB of a
# block; see bwd_smem_bytes)
BWD_TILING_SPLIT = {"dkdv": (64, 64, 4), "dq": (128, 64, 2)}


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
    return_lse: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax chunked attention in plain PyTorch.

    q: (B, Sq, Hq, D); k: (B, Skv, Hkv, D); v: (B, Skv, Hkv, Dv).  Ragged
    lengths are padded to whole chunks and the padded keys masked, as the
    reference does; every chunk pair runs (no causal skip).  With
    ``return_lse`` it also returns each row's log-sum-exp of the scaled
    scores, ``m + log(l)``, f32 (B, Hq, Sq): the backward's input.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    sq_orig, skv_orig = sq, skv
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk:  # pad ragged lengths; padded keys masked out below
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, (-sq) % q_chunk))
        sq = q.shape[1]
    if skv % kv_chunk:
        pad = (0, 0, 0, 0, 0, (-skv) % kv_chunk)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
        skv = k.shape[1]
    nq, nk = sq // q_chunk, skv // kv_chunk
    scale = d**-0.5
    f32, dev = torch.float32, q.device

    qc = q.reshape(b, nq, q_chunk, hkv, g, d)
    kc = k.reshape(b, nk, kv_chunk, hkv, d)
    vc = v.reshape(b, nk, kv_chunk, hkv, dv)
    outs, lses = [], []
    for iq in range(nq):
        qf = qc[:, iq].to(f32) * scale  # (b, cq, hkv, g, d)
        q_pos = iq * q_chunk + torch.arange(q_chunk, device=dev) + q_offset
        acc = torch.zeros((b, hkv, g, q_chunk, dv), dtype=f32, device=dev)
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=f32, device=dev)
        for ik in range(nk):
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kc[:, ik].to(f32))
            k_pos = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            penalty = torch.zeros((q_chunk, kv_chunk), dtype=f32, device=dev)
            if causal:
                penalty = torch.where(k_pos[None, :] <= q_pos[:, None], 0.0, NEG_INF)
            if skv != skv_orig:
                penalty = penalty + torch.where(k_pos[None, :] < skv_orig, 0.0, NEG_INF)
            s = s + penalty.to(f32)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vc[:, ik].to(f32))
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-37)  # (b, hkv, g, cq, dv)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (b, cq, hkv, g, dv)
        lses.append((m + torch.log(l)).reshape(b, hq, q_chunk))
    out = torch.cat(outs, dim=1).reshape(b, sq, hq, dv)[:, :sq_orig].to(q.dtype)
    if return_lse:
        return out, torch.cat(lses, dim=-1)[..., :sq_orig]
    return out


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's formulas in chunked plain PyTorch, all in f32:
    ``delta = rowsum(dout * out)``; per chunk pair ``P = exp(S - lse)`` on
    visible (query, key) pairs (else 0), ``dV += P^T dout``,
    ``dS = P (dout V^T - delta)``, ``dQ += scale dS K``,
    ``dK += scale dS^T Q`` (S scaled as the forward scales it).

    Shapes as :func:`flash_attention_plain`'s, ``out`` and ``dout`` (B, Sq,
    Hq, Dv), ``lse`` (B, Hq, Sq) f32 from the forward.  Returns (dq, dk, dv) in q's,
    k's and v's dtypes.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    dv_dim = v.shape[-1]
    g = hq // hkv
    sq_orig, skv_orig = sq, skv
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    f32, dev = torch.float32, q.device
    delta = (dout.to(f32) * out.to(f32)).sum(dim=-1).permute(0, 2, 1)  # (b, hq, sq)
    lse = lse.to(f32)
    if sq % q_chunk:  # pad ragged lengths; padded rows and keys are masked below
        pad = (-sq) % q_chunk
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        dout = torch.nn.functional.pad(dout, (0, 0, 0, 0, 0, pad))
        delta = torch.nn.functional.pad(delta, (0, pad))
        lse = torch.nn.functional.pad(lse, (0, pad))
        sq = q.shape[1]
    if skv % kv_chunk:
        pad = (0, 0, 0, 0, 0, (-skv) % kv_chunk)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
        skv = k.shape[1]
    nq, nk = sq // q_chunk, skv // kv_chunk
    scale = d**-0.5

    qc = q.reshape(b, nq, q_chunk, hkv, g, d)
    doc = dout.reshape(b, nq, q_chunk, hkv, g, dv_dim)
    lsec = lse.reshape(b, hkv, g, nq, q_chunk)
    delc = delta.reshape(b, hkv, g, nq, q_chunk)
    kc = k.reshape(b, nk, kv_chunk, hkv, d)
    vc = v.reshape(b, nk, kv_chunk, hkv, dv_dim)
    dk = torch.zeros((b, nk, kv_chunk, hkv, d), dtype=f32, device=dev)
    dv = torch.zeros((b, nk, kv_chunk, hkv, dv_dim), dtype=f32, device=dev)
    dqs = []
    for iq in range(nq):
        qf = qc[:, iq].to(f32) * scale  # (b, cq, hkv, g, d)
        do = doc[:, iq].to(f32)
        rows = iq * q_chunk + torch.arange(q_chunk, device=dev)
        lse_i, del_i = lsec[:, :, :, iq, :, None], delc[:, :, :, iq, :, None]
        dq_i = torch.zeros((b, hkv, g, q_chunk, d), dtype=f32, device=dev)
        for ik in range(nk):
            kf, vf = kc[:, ik].to(f32), vc[:, ik].to(f32)
            keys = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            visible = (rows[:, None] < sq_orig) & (keys[None, :] < skv_orig)
            if causal:
                visible = visible & (keys[None, :] <= rows[:, None] + q_offset)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf)
            p = torch.where(visible, torch.exp(s - lse_i), 0.0)
            dv[:, ik] += torch.einsum("bhgqk,bqhgd->bkhd", p, do)
            ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", do, vf) - del_i)
            dq_i += torch.einsum("bhgqk,bkhd->bhgqd", ds, kf)
            dk[:, ik] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
        dqs.append((dq_i * scale).permute(0, 3, 1, 2, 4))  # (b, cq, hkv, g, d)
    dq = torch.cat(dqs, dim=1).reshape(b, sq, hq, d)[:, :sq_orig]
    dk = dk.reshape(b, skv, hkv, d)[:, :skv_orig]
    dv = dv.reshape(b, skv, hkv, dv_dim)[:, :skv_orig]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def kernel_tolerance(dtype: torch.dtype) -> tuple[float, float]:
    """``(atol, rtol)`` of the kernel against its plain version on the same
    inputs.  f32: both sum in f32 in another order (dot products, tiles of
    64 keys against chunks of up to 1024); 2e-5 is the reference's own
    tolerance for its kernel.  bf16: the same f32 values, each rounded once
    to bf16, may land one bf16 ulp apart (2^-8 to 2^-7 of the value).

    The backward (:func:`flash_attention_bwd`) is held to the same pair,
    scaled to each gradient's largest magnitude: ``max|got - want| <= atol
    + rtol * max|want|`` for dq, dk and dv each.  Its f32 sums run over up
    to Sq * G rows per key, so an element near zero carries the rounding of
    the large terms that cancelled in it; the gradient's max is the scale
    of that rounding, not the element."""
    if dtype == torch.bfloat16:
        return 1e-5, 2.0**-7
    return 2e-5, 2e-5


def tiling(dtype: torch.dtype, d: int = 128, dv: int | None = None) -> tuple[int, int, int]:
    """``(rows, keys, stages)`` of the body that serves ``dtype`` at head
    dims (d, dv) (dv None: d): folded query rows per block (per work item
    of the persistent bodies), keys per K/V tile and K/V tiles in flight
    (at D = Dv = 64 and 128: K tiles, and as many V tiles)."""
    dv = d if dv is None else dv
    if _group_tc(dtype, d, dv):
        return TC_ROWS, TC_KEYS, TC_GROUP_STAGES
    if dtype == torch.bfloat16:
        return TC_ROWS, TC_KEYS, TC_STAGES if dv == d else TC_STAGES_SPLIT
    return BLOCK_ROWS, BLOCK_KEYS, 1


def _group_tc(dtype: torch.dtype, d: int, dv: int) -> bool:
    """Whether the persistent kernels over whole query groups serve (dtype,
    d, dv): ``flash_group_fwd`` forward, ``flash_bwd_d64`` /
    ``flash_bwd_d128`` backward."""
    return dtype == torch.bfloat16 and d == dv and d in TC_GROUP_Q_STAGES


def kernel_name(dtype: torch.dtype, d: int, dv: int | None = None, *,
                backward: bool = False) -> str:
    """The kernel a forward (or backward) call at (dtype, d, dv) runs, as
    :data:`LAUNCHES_BY_KERNEL` counts it: ``flash_group_fwd<D>``,
    ``flash_mla_fwd``, ``flash_attention_tc`` or ``flash_attention_kernel``
    (f32); a backward by its last kernel, ``flash_bwd_d64``,
    ``flash_bwd_d128``, ``flash_bwd_dq_mla``, ``flash_bwd_dq_tc`` or
    ``flash_bwd_dq`` (f32)."""
    dv = d if dv is None else dv
    if dtype != torch.bfloat16:
        return "flash_bwd_dq" if backward else "flash_attention_kernel"
    if _group_tc(dtype, d, dv):
        return f"flash_bwd_d{d}" if backward else f"flash_group_fwd<{d}>"
    if d != dv:
        return "flash_bwd_dq_mla" if backward else "flash_mla_fwd"
    return "flash_bwd_dq_tc" if backward else "flash_attention_tc"


def _count(name: str) -> None:
    LAUNCHES_BY_KERNEL[name] = LAUNCHES_BY_KERNEL.get(name, 0) + 1


def tile_rows(dtype: torch.dtype, d: int, g: int, dv: int | None = None) -> int:
    """Folded rows of a row tile (a block or a work item) of the body that
    serves ``dtype`` at head dims (d, dv) and G = ``g``: whole query groups,
    G * (128 // G), at bf16 D = Dv = 64 and 128; else the body's rows."""
    rows = tiling(dtype, d, dv)[0]
    return rows // g * g if _group_tc(dtype, d, d if dv is None else dv) else rows


def smem_bytes(d: int, dtype: torch.dtype = torch.bfloat16, dv: int | None = None) -> int:
    """Dynamic shared memory of one block of the body that serves ``dtype``
    at head dims (d, dv) (dv None: d).

    bf16: the Q tile (d wide) and a K (d) and a V tile (dv) per stage in
    bf16, 1 KB to align them to their swizzle, and a full and an empty
    barrier per stage: 58,416 bytes at (32, 32) with three stages.  At
    (192, 128) (``flash_mla_fwd``) three stages would take 289 KB, past the
    227 KB of a block: two K and two V stages, each with its own full and
    empty barrier, and Q's pair (214,096).  At (64, 64) and (128, 128)
    (``flash_group_fwd``) three K and three V stages and two Q stages (D=64:
    132,224) or one (D=128: 230,512; two would take 263,296), each with its
    own full and empty barrier.  f32: q * scale and a K tile
    (both transposed), a V tile and the probabilities, all f32: 144 KB at
    (192, 128).
    """
    dv = d if dv is None else dv
    rows, keys, stages = tiling(dtype, d, dv)
    if dtype == torch.bfloat16:
        if _group_tc(dtype, d, dv):
            q_stages = TC_GROUP_Q_STAGES[d]
            barriers = 8 * (4 * stages + 2 * q_stages)
        else:
            q_stages, barriers = 1, 16 * stages if d == dv else 8 * (4 * stages + 2)
        return 1024 + 2 * q_stages * d * rows + 2 * stages * keys * (d + dv) + barriers
    return 4 * (d * rows + d * keys + dv * keys + rows * keys)


def executed_flops(
    batch: int, sq: int, skv: int, hq: int, hkv: int, d: int, *, causal: bool = True,
    q_offset: int = 0, dtype: torch.dtype = torch.bfloat16, dv: int | None = None,
) -> int:
    """Flops the kernel's tiles execute, masked entries included: each block
    (work item) of folded rows visits key tiles up to the last one that
    holds a key visible to its last row, and computes all its rows (at bf16
    D = 64 a tile of G * (128 // G) rows runs 128 wide).  Per (row, key) of
    a visited tile: 2D for QK^T and 2Dv for PV (dv None: D), which the bf16
    body runs twice (p_hi and p_lo).  (At bf16 D = 64 and 128 a tile of G *
    (128 // G) rows runs 128 wide.)"""
    g = hq // hkv
    dv = d if dv is None else dv
    rows, keys, _ = tiling(dtype, d, dv)
    tile = tile_rows(dtype, d, g, dv)
    per_pair = 2 * d + (4 if dtype == torch.bfloat16 else 2) * dv
    key_tiles = -(-skv // keys)
    visited = 0
    for row0 in range(0, sq * g, tile):
        n = key_tiles
        if causal:
            last = min(row0 + tile, sq * g) - 1
            n = min(n, (last // g + q_offset) // keys + 1)
        visited += n
    return batch * hkv * visited * rows * keys * per_pair


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_fwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
            strides, i32, i32, ctypes.c_float, i32, ptr,
        ]
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_bwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
            strides, i32, i32, ctypes.c_float, i32, ptr,
        ]
        lib.flash_attention_bwd.restype = i32
        lib.flash_attention_attributes.argtypes = [i32, i32, i32, i32, ctypes.POINTER(i32)]
        lib.flash_attention_attributes.restype = i32
        lib.flash_attention_bwd_attributes.argtypes = [i32, i32, i32, i32, i32,
                                                       ctypes.POINTER(i32)]
        lib.flash_attention_bwd_attributes.restype = i32
        lib.flash_attention_mla_fwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, strides, i32, i32,
            ctypes.c_float, ptr,
        ]
        lib.flash_attention_mla_fwd.restype = i32
        lib.flash_attention_mla_bwd.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
            strides, i32, i32, ctypes.c_float, ptr,
        ]
        lib.flash_attention_mla_bwd.restype = i32
        lib.flash_attention_bwd_scratch.argtypes = [i32, i32, i32, i32, i32]
        lib.flash_attention_bwd_scratch.restype = ctypes.c_longlong
        lib.flash_attention_bwd_plan.argtypes = [i32] * 8 + [ctypes.POINTER(i32)] * 2 + [i32]
        lib.flash_attention_bwd_plan.restype = i32
        lib.su3_error_string.argtypes = [i32]
        lib.su3_error_string.restype = ctypes.c_char_p
        lib._repro_typed = True
    return lib


def kernel_budget(
    dtype: torch.dtype = torch.bfloat16, d: int = 128, causal: bool = True,
    dv: int | None = None,
) -> dict[str, int | float | None]:
    """One instantiation's per-block budget on the current CUDA device, at
    head dims (d, dv) (dv None: d).

    Returns:
        The keys of :func:`repro_torch.kernels.su3_matmul.kernel_budget`:
        ``num_regs``, ``shared_bytes`` (dynamic), ``local_bytes`` (spills),
        ``max_threads_per_block``, ``threads_per_block``, ``blocks_per_sm``
        and ``occupancy``.

    Raises:
        RuntimeError: the library's tiling is not :func:`tiling`'s.
    """
    dv = d if dv is None else dv
    lib = _library()
    out = (ctypes.c_int * 9)()
    rc = lib.flash_attention_attributes(_DTYPES[dtype], d, dv, int(causal), out)
    _check_error(lib, rc, "cudaFuncGetAttributes")
    regs, shared, local, max_threads, threads, blocks, *built = list(out)
    if tuple(built) != tiling(dtype, d, dv):
        raise RuntimeError(f"flash_attention: the {dtype} body at (D, Dv) = ({d}, {dv}) is built "
                           f"with (rows, keys, stages) = {tuple(built)}, this module assumes "
                           f"{tiling(dtype, d, dv)}")
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    per_sm = getattr(props, "max_threads_per_multi_processor", None)
    return {
        "num_regs": regs,
        "shared_bytes": shared,
        "local_bytes": local,
        "max_threads_per_block": max_threads,
        "threads_per_block": threads,
        "blocks_per_sm": blocks,
        "occupancy": blocks * threads / per_sm if per_sm else None,
    }


def bwd_tiling(dtype: torch.dtype, d: int = 128,
               dv: int | None = None) -> dict[str, tuple[int, int, int]]:
    """``{"dkdv": (rows, keys, stages), "dq": (rows, keys, stages)}`` of the
    backward body that serves ``dtype`` at head dims (d, dv) (dv None: d;
    see :data:`BWD_TILING` and :data:`BWD_TILING_SPLIT`)."""
    dv = d if dv is None else dv
    if _group_tc(dtype, d, dv) and d == 128:
        return BWD_TILING_D128
    if dtype == torch.bfloat16:
        return BWD_TILING[torch.bfloat16] if dv == d else BWD_TILING_SPLIT
    return BWD_TILING[torch.float32]


def bwd_smem_bytes(d: int, dtype: torch.dtype = torch.bfloat16,
                   dv: int | None = None) -> tuple[int, int]:
    """Dynamic shared memory of one block of the backward's dK/dV and dQ
    kernels of the body that serves ``dtype`` at head dims (d, dv) (dv None:
    d): q, k, dq and dk have width d; v, out, dout and dv width dv.

    bf16: 1 KB to align the tiles to their swizzle; dK/dV: K and V of the
    block's two key tiles and, per stage, a Q and a dO tile of 64 rows with
    their lse and delta (f32), and a full and an empty barrier; dQ: Q and dO
    of the block's rows and, per stage, a K and a V tile, and two barriers.
    At D = Dv = 64 one kernel (``flash_bwd_d64``) holds both, its figure
    given for each: two operand slots of 32 KB (a dK/dV item's K and V of
    two key tiles, or a dQ item's Q and dO of 128 rows), the dK/dV ring and
    the dQ ring, a full and an empty barrier for each slot and stage, and
    16 bytes for the items the slots hold (199,824).  At D = Dv = 128
    (``flash_bwd_d128``) the operand slots take 64 KB each and both kinds of
    item share one ring of three 32 KB stages (a Q and a dO row tile of 64
    with their statistics, or a K or a V tile of 128 keys): 232,032.
    At (192, 128) the dK/dV block holds one key tile's K and V, four stages
    and the row tile's P^T in f32 that its consumers hand on (224,320; two
    key tiles with four stages would take 248,896 bytes, past the 232,448
    of a block), and dQ takes K/V tiles of 64 keys (164,896; 128 keys:
    246,816).  f32: rows of D + 1 f32 words
    (K, q * scale) and of Dv + 1 (V, dO), the probabilities and dS (dK/dV)
    or dS alone (dQ) in rows of 65, and the tile's lse and delta."""
    dv = d if dv is None else dv
    t = bwd_tiling(dtype, d, dv)
    if _group_tc(dtype, d, dv):
        rows, keys, stages = t["dkdv"]
        q_rows, q_keys, q_stages = t["dq"]
        slot = 4 * d * max(2 * keys, q_rows)  # K and V of two key tiles, or Q and dO
        if d == 64:  # a row ring and a K/V ring
            rings = stages * (4 * d * rows + 8 * rows) + q_stages * 4 * d * q_keys
            barriers = 16 * (PERSISTENT_BWD_SLOTS + stages + q_stages)
        else:  # one ring: a Q and a dO row tile with their statistics, or a K or a V tile
            rings = stages * (max(4 * d * rows, 2 * d * q_keys) + 8 * rows)
            barriers = 16 * (PERSISTENT_BWD_SLOTS + stages)
        both = 1024 + PERSISTENT_BWD_SLOTS * slot + rings + barriers + 16
        return both, both
    if dtype == torch.bfloat16:
        rows, keys, stages = t["dkdv"]
        if d == dv:
            dkdv = 1024 + 2 * (d + dv) * (2 * keys + stages * rows) + stages * (8 * rows + 16)
        else:  # one key tile, and P^T (f32) of a row tile
            dkdv = (1024 + 2 * (d + dv) * (keys + stages * rows) + stages * (8 * rows + 16)
                    + 4 * keys * rows)
        rows, keys, stages = t["dq"]
        dq = 1024 + 2 * (d + dv) * (rows + stages * keys) + 16 * stages
        return dkdv, dq
    rows, keys, _ = t["dkdv"]
    tile = (keys + rows) * (d + dv + 2) + 2 * rows
    return 4 * (tile + 2 * rows * (keys + 1)), 4 * (tile + rows * (keys + 1))


def bwd_executed_flops(
    batch: int, sq: int, skv: int, hq: int, hkv: int, d: int, *, causal: bool = True,
    q_offset: int = 0, dtype: torch.dtype = torch.bfloat16, dv: int | None = None,
) -> int:
    """Flops the backward's tiles execute, masked entries included (dv None:
    d).

    dK/dV: each key tile visits the row tiles from the first that holds a
    row seeing its first key to the last (bf16: tiles of G * (64 // G) rows
    computed 64 wide); per (row, key) of a visited tile,
    products of 2D (S^T, dK) and 2Dv (dP^T, dV), where the bf16 body runs dV and
    dK twice (P and dS in two bf16 parts).  The bf16 body visits none where
    no row sees the tile's first key; the f32 body starts at that row's
    tile even past the end.  dQ: each block of folded rows visits key tiles
    up to the last one that holds a key visible to its last row; S and dQ
    (2D), dP (2Dv), dQ twice in the bf16 body."""
    dv = d if dv is None else dv
    g = hq // hkv
    rows = sq * g
    t = bwd_tiling(dtype, d, dv)
    kv_rows, kv_keys, _ = t["dkdv"]
    q_rows, q_keys, _ = t["dq"]
    # rows of a dK/dV row tile: whole query groups in the bf16 body
    tile = kv_rows // g * g if dtype == torch.bfloat16 else kv_rows
    n_rt = -(-rows // tile)
    kv_visited = 0
    for key0 in range(0, skv, kv_keys):
        first = max(key0 - q_offset, 0) * g if causal else 0
        if dtype == torch.bfloat16 and first >= rows:
            continue
        kv_visited += max(n_rt - first // tile, 0)
    key_tiles = -(-skv // q_keys)
    # rows of a dQ block: whole query groups in the persistent kernels' items
    q_tile = q_rows // g * g if _group_tc(dtype, d, dv) else q_rows
    q_visited = 0
    for row0 in range(0, rows, q_tile):
        n = key_tiles
        if causal:
            last = min(row0 + q_tile, rows) - 1
            n = min(n, (last // g + q_offset) // q_keys + 1)
        q_visited += n
    twice = 2 if dtype == torch.bfloat16 else 1  # dV, dK and dQ on two bf16 parts
    kv_per_pair = 2 * d + 2 * dv + twice * (2 * dv + 2 * d)
    q_per_pair = 2 * d + 2 * dv + twice * 2 * d
    return batch * hkv * (kv_visited * kv_rows * kv_keys * kv_per_pair
                          + q_visited * q_rows * q_keys * q_per_pair)


def bwd_budget(dtype: torch.dtype = torch.bfloat16, d: int = 128,
               causal: bool = True, dv: int | None = None) -> dict[str, dict[str, int]]:
    """The backward kernels' per-block budget on the current CUDA device at
    head dims (d, dv) (dv None: d): ``{"dkdv": {...}, "dq": {...}}``, each
    with ``num_regs``,
    ``shared_bytes`` (dynamic), ``local_bytes`` (spills),
    ``threads_per_block`` and ``blocks_per_sm``.

    Raises:
        RuntimeError: the library's tiling is not :func:`bwd_tiling`'s.
    """
    dv = d if dv is None else dv
    lib = _library()
    found = {}
    want = bwd_tiling(dtype, d, dv)
    for which, name in enumerate(("dkdv", "dq")):
        out = (ctypes.c_int * 8)()
        rc = lib.flash_attention_bwd_attributes(_DTYPES[dtype], d, dv, int(causal), which, out)
        _check_error(lib, rc, "cudaFuncGetAttributes")
        *budget, rows, keys, stages = list(out)
        if (rows, keys, stages) != want[name]:
            raise RuntimeError(f"flash_attention_bwd: the {dtype} {name} kernel at (D, Dv) = "
                               f"({d}, {dv}) is built with (rows, keys, stages) = "
                               f"{(rows, keys, stages)}, this module assumes {want[name]}")
        found[name] = dict(zip(("num_regs", "shared_bytes", "local_bytes", "threads_per_block",
                                "blocks_per_sm"), budget))
    return found


def persistent_bwd_plan(batch: int, sq: int, skv: int, hq: int, hkv: int, *,
                        causal: bool = True, q_offset: int = 0, n_sm: int | None = None,
                        ) -> tuple[dict[str, int], list[tuple[str, int, int, int]]]:
    """The persistent backward's work list at one shape (``flash_bwd_d64``'s
    and ``flash_bwd_d128``'s: the same items), as the built library plans it
    on ``n_sm`` SMs (None: the current CUDA device's) and its blocks decode
    it: ``({"q_first", "chunk", "items"}, items)``, the items in the order
    the blocks claim them, each ``("dkdv", batch, kv head, j)`` (key tiles 2j
    and 2j + 1 of 64) or ``("dq", batch, kv head, i)`` (row tile i of G *
    (128 // G) folded rows)."""
    lib = _library()
    if n_sm is None:
        n_sm = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    plan = (ctypes.c_int * 3)()
    args = (batch, sq, skv, hq, hkv, int(causal), q_offset, n_sm, plan)
    _check_error(lib, lib.flash_attention_bwd_plan(*args, None, 0), "persistent_bwd_plan")
    n = plan[2]
    items = (ctypes.c_int * (4 * n))()
    _check_error(lib, lib.flash_attention_bwd_plan(*args, items, n), "persistent_bwd_plan")
    flat = list(items)
    return (dict(zip(("q_first", "chunk", "items"), plan)),
            [("dkdv" if flat[i] else "dq", *flat[i + 1:i + 4]) for i in range(0, 4 * n, 4)])


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    what = "flash_attention"
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{what}: q, k, v must be (B, S, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[1] != v.shape[1] or k.shape[2] != v.shape[2]:
        raise ValueError(f"{what}: batch, key length or kv heads differ: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[-1] != d or k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"{what}: k must be (B, Skv, Hkv, {d}) with Hkv dividing {hq}, "
                         f"got {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q, k, v lie on {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{what}: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int) -> None:
    """What the kernel takes beyond the shapes the plain version takes."""
    what = "flash_attention"
    b, sq, hq, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if dv != d and (d, dv) not in HEAD_DIMS:
        raise NotImplementedError(
            f"{what}: the kernel's only pair with Dv != D is MLA's (D, Dv) = (192, 128), got "
            f"({d}, {dv})")
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel is built for D, Dv in {HEAD_DIMS}, got ({d}, {dv})")
    if q.dtype == torch.bfloat16 and d != dv and hq != hkv:
        raise ValueError(f"{what}: the bf16 kernel at (D, Dv) = ({d}, {dv}) is MLA's, one kv "
                         f"head a query head (G = 1), got Hq = {hq}, Hkv = {hkv}")
    if _group_tc(q.dtype, d, dv) and hq // hkv > TC_ROWS:
        raise ValueError(f"{what}: the bf16 kernel at D = {d} holds whole query groups of at "
                         f"most {TC_ROWS} heads in a row tile, got G = {hq // hkv}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: the kernel takes float32 or bfloat16, got {q.dtype}")
    if min(b, sq, skv) == 0:
        raise ValueError(f"{what}: empty operands {tuple(q.shape)}, {tuple(k.shape)}")
    if q_offset < 0:
        raise ValueError(f"{what}: q_offset must be >= 0, got {q_offset}")
    if b * hkv > MAX_BATCH_HEADS:
        raise ValueError(f"{what}: B * Hkv = {b * hkv} exceeds {MAX_BATCH_HEADS}")
    rows = tiling(q.dtype)[0]
    if q.dtype == torch.bfloat16 and -(-sq * (hq // hkv) // rows) > MAX_ROW_TILES:
        raise ValueError(f"{what}: Sq * G = {sq * (hq // hkv)} exceeds "
                         f"{MAX_ROW_TILES * rows} rows")
    # 16-byte vector loads (cp.async, and TMA boxes for bf16 k and v): the
    # head dim contiguous, the other strides and the base on 16-byte boundaries
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _rows_aligned(t):
            raise ValueError(f"{what}: {name} needs a contiguous, 16-byte aligned head dim "
                             f"and strides in multiples of {16 // t.element_size()} "
                             f"({q.dtype}), got {t.stride()}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t``'s rows by 16-byte copies: the last
    dim contiguous, the other strides and the base on 16-byte boundaries."""
    unit = 16 // t.element_size()
    return (t.stride(-1) == 1 and not any(s % unit for s in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _strides(*ts: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(ts)))(*(st for t in ts for st in t.stride()[:3]))


def _forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, q_chunk: int,
    kv_chunk: int, q_offset: int, with_lse: bool,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(out, lse or None): the kernel for CUDA tensors (one launch, counted),
    the plain version for CPU and ``meta`` tensors; any other device raises."""
    if q.device.type in _PLAIN_DEVICES:
        q_chunk, kv_chunk = _plain_chunks(q, k, q_chunk, kv_chunk)
        res = flash_attention_plain(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                    q_offset=q_offset, return_lse=with_lse)
        return res if with_lse else (res, None)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors (meta for shapes), "
                         f"got {q.device}")
    _check_cuda(q, k, v, q_offset)
    b, sq, hq, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, sq, skv, hq, hkv, d, dv,
            _strides(q, k, v, out), int(causal), q_offset, d**-0.5, _DTYPES[q.dtype], stream)
    _check_error(lib, rc, "flash_attention launch")
    LAUNCHES.count += 1
    _count(kernel_name(q.dtype, d, dv))
    return out, lse


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v), given its
    ``out``, the gradient ``dout`` of out and the forward's ``lse``
    (B, Hq, Sq) f32.

    CUDA tensors go to the backward kernels (one call of three launches,
    two in bf16 at D = Dv = 64 and 128, counted once in :data:`BWD_LAUNCHES`
    and under :func:`kernel_name` in :data:`LAUNCHES_BY_KERNEL`) or
    raise; CPU and ``meta`` tensors go to :func:`flash_attention_bwd_plain`
    with ``q_chunk`` / ``kv_chunk`` (on ``meta`` the whole sequences); any
    other device raises.
    """
    _check_shapes(q, k, v)
    b, sq, hq, d = q.shape
    want = (b, sq, hq, v.shape[-1])
    if out.shape != want or dout.shape != want or lse.shape != (b, hq, sq):
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be {want}, lse "
                         f"{tuple(lse.shape)} must be {(b, hq, sq)}")
    if q.device.type in _PLAIN_DEVICES:
        q_chunk, kv_chunk = _plain_chunks(q, k, q_chunk, kv_chunk)
        return flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=causal,
                                         q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors (meta for shapes), "
                         f"got {q.device}")
    _check_cuda(q, k, v, q_offset)
    if not (out.device == dout.device == lse.device == q.device):
        raise ValueError("flash_attention_bwd: out, dout and lse must lie on q's device")
    if q.dtype == torch.bfloat16 and hq // k.shape[2] > BWD_TILING[torch.bfloat16]["dkdv"][0]:
        raise ValueError(f"flash_attention_bwd: the bf16 body's row tiles hold whole query "
                         f"groups of at most 64 heads, got G = {hq // k.shape[2]}")
    if lse.dtype != torch.float32 or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: out and dout must be q's {q.dtype} and lse "
                         f"float32, got {out.dtype}, {dout.dtype}, {lse.dtype}")
    # out is read element by element (the delta pass): only its head dim must
    # be contiguous, but for the bf16 delta passes at (192, 128), D = 64 and
    # D = 128, which read 16 bytes at a time.  dout too in the f32 body; the
    # bf16 body reads its rows by TMA and cp.async, as q's, so a dout off 16
    # bytes is copied (it is the caller's gradient, whose strides no check can
    # promise).
    out = out if out.stride(-1) == 1 else out.contiguous()
    if ((d != v.shape[-1] or _group_tc(q.dtype, d, d)) and q.dtype == torch.bfloat16
            and not _rows_aligned(out)):
        out = out.clone(memory_format=torch.contiguous_format)
    if dout.dtype == torch.bfloat16 and not _rows_aligned(dout):
        dout = dout.clone(memory_format=torch.contiguous_format)
    elif dout.stride(-1) != 1:
        dout = dout.contiguous()
    lse = lse.contiguous()
    skv, hkv, dv_dim = k.shape[1], k.shape[2], v.shape[-1]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lib = _library()
    # delta (f32 body) or the folded lse/delta planes (bf16 body)
    words = lib.flash_attention_bwd_scratch(_DTYPES[q.dtype], b, sq, hq, hkv)
    delta = torch.empty(words, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, sq, skv, hq, hkv, d, dv_dim, _strides(q, k, v, out, dout, dq, dk, dv), int(causal),
            q_offset, d**-0.5, _DTYPES[q.dtype], stream)
    _check_error(lib, rc, "flash_attention_bwd launch")
    BWD_LAUNCHES.count += 1
    _count(kernel_name(q.dtype, d, dv_dim, backward=True))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward keeps each row's
    lse beside ``out`` (the same bits as without it), the backward is
    :func:`flash_attention_bwd`.  On CUDA tensors both directions are the
    kernels, and a failure to build or launch raises; on CPU tensors they
    are the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_chunk, kv_chunk, q_offset):
        out, lse = _forward(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                            q_offset=q_offset, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = {"causal": causal, "q_chunk": q_chunk, "kv_chunk": kv_chunk,
                       "q_offset": q_offset}
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, **ctx.options)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention: q (B, Sq, Hq, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv,
    Dv) -> (B, Sq, Hq, Dv).

    A CUDA tensor goes to the kernel (or raises); a CPU or ``meta`` tensor
    goes to :func:`flash_attention_plain` with
    ``q_chunk`` / ``kv_chunk``; any other device raises.  When grad is
    enabled and q, k or v requires grad, the call goes through
    :class:`FlashAttention`, which also keeps the lse for the backward;
    otherwise (serving: no tensor requires grad) it is the forward alone,
    one launch and no lse.
    """
    _check_shapes(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk, q_offset)
    return _forward(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                    q_offset=q_offset, with_lse=False)[0]


# -- MLA's attention from its parts ---------------------------------------------------
#
# MLA (``models/mla.py``) makes q as a nope part (B, Sq, H, 128) and a rope
# part (B, Sq, H, 64), and k as a nope part (B, Skv, H, 128) and one rope
# channel (B, Skv, 1, 64) that every head shares.  The entries below take
# those parts as they are: the bf16 kernel at (D, Dv) = (192, 128) reads a
# Q or K tile's first two 64-column boxes from the nope tensor and its third
# from the rope tensor (``flash_mla_fwd``, ``flash_attention_mla_bwd``), so
# neither q nor k is concatenated, nor k's rope channel copied per head.
# Everywhere else (the CPU, ``meta``, the f32 body, other head dims) they
# concatenate and call the entries above: the CPU computes what it computed
# on the concatenated tensors, bit for bit.
MLA_SPLIT = (128, 64, 128)  # (nope, rope, v) head dims of the kernel's split entry


def _joined(q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor,
            k_rope: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q = [q_nope | q_rope], k = [k_nope | k_rope broadcast over the heads]."""
    b, skv, h, _ = k_nope.shape
    k = torch.cat([k_nope, k_rope.expand(b, skv, h, k_rope.shape[-1])], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k


def _check_split(q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor,
                 k_rope: torch.Tensor, v: torch.Tensor) -> None:
    what = "flash_attention_split"
    ts = (q_nope, q_rope, k_nope, k_rope, v)
    if any(t.ndim != 4 for t in ts):
        raise ValueError(f"{what}: every part must be (B, S, H, D), got "
                         f"{[tuple(t.shape) for t in ts]}")
    b, sq, h, _ = q_nope.shape
    skv = k_nope.shape[1]
    if (q_rope.shape[:3] != (b, sq, h) or k_nope.shape[0] != b or k_nope.shape[2] != h
            or k_nope.shape[-1] != q_nope.shape[-1] or k_rope.shape[-1] != q_rope.shape[-1]
            or k_rope.shape[:2] != (b, skv) or k_rope.shape[2] not in (1, h)
            or v.shape[:3] != (b, skv, h)):
        raise ValueError(f"{what}: q_nope (B, Sq, H, N), q_rope (B, Sq, H, R), k_nope (B, Skv, "
                         f"H, N), k_rope (B, Skv, 1 or H, R), v (B, Skv, H, Dv), got "
                         f"{[tuple(t.shape) for t in ts]}")
    if len({t.device for t in ts}) != 1 or len({t.dtype for t in ts}) != 1:
        raise ValueError(f"{what}: the parts lie on {[t.device for t in ts]} as "
                         f"{[t.dtype for t in ts]}")


def _split_kernel(q_nope: torch.Tensor, q_rope: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the parts go to the split kernel: bf16 CUDA tensors at
    :data:`MLA_SPLIT`."""
    return (q_nope.device.type == "cuda" and q_nope.dtype == torch.bfloat16
            and (q_nope.shape[-1], q_rope.shape[-1], v.shape[-1]) == MLA_SPLIT)


def _check_split_cuda(ts: tuple[torch.Tensor, ...], q_offset: int) -> None:
    what = "flash_attention_split"
    b, sq, h, _ = ts[0].shape
    if min(b, sq, ts[2].shape[1]) == 0:
        raise ValueError(f"{what}: empty operands {[tuple(t.shape) for t in ts]}")
    if q_offset < 0:
        raise ValueError(f"{what}: q_offset must be >= 0, got {q_offset}")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"{what}: B * H = {b * h} exceeds {MAX_BATCH_HEADS}")
    for name, t in zip(("q_nope", "q_rope", "k_nope", "k_rope", "v"), ts):
        if not _rows_aligned(t):
            raise ValueError(f"{what}: {name} needs a contiguous, 16-byte aligned head dim and "
                             f"strides in multiples of 8 (bfloat16), got {t.stride()}")


def _split_forward(
    q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor, k_rope: torch.Tensor,
    v: torch.Tensor, *, causal: bool, q_chunk: int, kv_chunk: int, q_offset: int, with_lse: bool,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(out, lse or None): the split kernel (one launch, counted in
    :data:`LAUNCHES`), else :func:`_forward` on the concatenated q and k."""
    if not _split_kernel(q_nope, q_rope, v):
        q, k = _joined(q_nope, q_rope, k_nope, k_rope)
        return _forward(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                        q_offset=q_offset, with_lse=with_lse)
    ts = (q_nope, q_rope, k_nope, k_rope, v)
    _check_split_cuda(ts, q_offset)
    b, sq, h, _ = q_nope.shape
    skv, hr = k_nope.shape[1], k_rope.shape[2]
    out = torch.empty((b, sq, h, v.shape[-1]), dtype=v.dtype, device=v.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=v.device) if with_lse else None
    lib = _library()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.flash_attention_mla_fwd(
            *(t.data_ptr() for t in ts), out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, sq, skv, h, hr, _strides(*ts, out), int(causal), q_offset,
            (q_nope.shape[-1] + q_rope.shape[-1]) ** -0.5, stream)
    _check_error(lib, rc, "flash_attention_mla_fwd launch")
    LAUNCHES.count += 1
    _count("flash_mla_fwd")
    return out, lse


def _split_grads(dq: torch.Tensor, dk: torch.Tensor, rope: int,
                 rope_heads: int) -> tuple[torch.Tensor, ...]:
    """(dq_nope, dq_rope, dk_nope, dk_rope) from the 192-wide dq and dk: views,
    and for one rope channel its heads' gradients summed (what autograd of
    the channel's broadcast computes, the same reduction)."""
    dk_rope = dk[..., -rope:]
    if rope_heads == 1 and dk.shape[2] != 1:
        dk_rope = dk_rope.sum(dim=2, keepdim=True)
    return dq[..., :-rope], dq[..., -rope:], dk[..., :-rope], dk_rope


def flash_attention_split_bwd(
    q_nope: torch.Tensor, q_rope: torch.Tensor, k_nope: torch.Tensor, k_rope: torch.Tensor,
    v: torch.Tensor, out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
    causal: bool = True, q_chunk: int = 512, kv_chunk: int = 1024, q_offset: int = 0,
) -> tuple[torch.Tensor, ...]:
    """(dq_nope, dq_rope, dk_nope, dk_rope, dv) of :func:`flash_attention_split`,
    given its ``out``, the gradient ``dout`` of out and the forward's ``lse``.

    bf16 CUDA parts at :data:`MLA_SPLIT` go to the backward kernel on the
    parts (one call of three launches, counted in :data:`BWD_LAUNCHES`);
    dq_nope and dq_rope are views of one 192-wide result, dk_nope a view,
    and for one rope channel dk_rope its heads' gradients summed over the
    heads.  Everything else goes to :func:`flash_attention_bwd` on the
    concatenated q and k and is split the same way."""
    _check_split(q_nope, q_rope, k_nope, k_rope, v)
    rope, rope_heads = q_rope.shape[-1], k_rope.shape[2]
    if not _split_kernel(q_nope, q_rope, v):
        q, k = _joined(q_nope, q_rope, k_nope, k_rope)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                         q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset)
        return (*_split_grads(dq, dk, rope, rope_heads), dv)
    ts = (q_nope, q_rope, k_nope, k_rope, v)
    _check_split_cuda(ts, q_offset)
    b, sq, h, nope = q_nope.shape
    skv = k_nope.shape[1]
    want = (b, sq, h, v.shape[-1])
    if out.shape != want or dout.shape != want or lse.shape != (b, h, sq):
        raise ValueError(f"flash_attention_split_bwd: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be {want}, lse {tuple(lse.shape)} must be "
                         f"{(b, h, sq)}")
    if lse.dtype != torch.float32 or out.dtype != v.dtype or dout.dtype != v.dtype:
        raise ValueError(f"flash_attention_split_bwd: out and dout must be {v.dtype} and lse "
                         f"float32, got {out.dtype}, {dout.dtype}, {lse.dtype}")
    if not (out.device == dout.device == lse.device == v.device):
        raise ValueError("flash_attention_split_bwd: out, dout and lse must lie on v's device")
    # out's and dout's rows are read by 16-byte loads (the delta pass), and
    # dout's by TMA and cp.async: copied where they are not 16-byte rows
    if not _rows_aligned(out):
        out = out.clone(memory_format=torch.contiguous_format)
    if not _rows_aligned(dout):
        dout = dout.clone(memory_format=torch.contiguous_format)
    lse = lse.contiguous()
    dq = torch.empty((b, sq, h, nope + rope), dtype=v.dtype, device=v.device)
    dk = torch.empty((b, skv, h, nope + rope), dtype=v.dtype, device=v.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lib = _library()
    delta = torch.empty(lib.flash_attention_bwd_scratch(_DTYPES[v.dtype], b, sq, h, h),
                        dtype=torch.float32, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = lib.flash_attention_mla_bwd(
            q_nope.data_ptr(), q_rope.data_ptr(), k_nope.data_ptr(), k_rope.data_ptr(),
            v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, rope_heads,
            _strides(q_nope, k_nope, v, out, dout, dq, dk, dv, q_rope, k_rope), int(causal),
            q_offset, (nope + rope) ** -0.5, stream)
    _check_error(lib, rc, "flash_attention_mla_bwd launch")
    BWD_LAUNCHES.count += 1
    _count("flash_bwd_dq_mla")
    return (*_split_grads(dq, dk, rope, rope_heads), dv)


class FlashAttentionSplit(torch.autograd.Function):
    """:func:`flash_attention_split` with a gradient: the forward keeps each
    row's lse and saves the five parts as given (no concatenated copy); the
    backward is :func:`flash_attention_split_bwd`."""

    @staticmethod
    def forward(ctx, q_nope, q_rope, k_nope, k_rope, v, causal, q_chunk, kv_chunk, q_offset):
        out, lse = _split_forward(q_nope, q_rope, k_nope, k_rope, v, causal=causal,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk, q_offset=q_offset,
                                  with_lse=True)
        ctx.save_for_backward(q_nope, q_rope, k_nope, k_rope, v, out, lse)
        ctx.options = {"causal": causal, "q_chunk": q_chunk, "kv_chunk": kv_chunk,
                       "q_offset": q_offset}
        return out

    @staticmethod
    def backward(ctx, dout):
        q_nope, q_rope, k_nope, k_rope, v, out, lse = ctx.saved_tensors
        grads = flash_attention_split_bwd(q_nope, q_rope, k_nope, k_rope, v, out, dout, lse,
                                          **ctx.options)
        return (*grads, None, None, None, None)


def flash_attention_split(
    q_nope: torch.Tensor,
    q_rope: torch.Tensor,
    k_nope: torch.Tensor,
    k_rope: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """MLA's attention from its parts: :func:`flash_attention` of q =
    [q_nope | q_rope] (B, Sq, H, N + R) and k = [k_nope | k_rope] with
    k_rope (B, Skv, 1 or H, R) broadcast over the H heads, v (B, Skv, H, Dv)
    -> (B, Sq, H, Dv); the scale is (N + R)^-1/2.

    bf16 CUDA parts at :data:`MLA_SPLIT` go to the split kernel (or raise),
    reading each part in place; the rest concatenate and go to
    :func:`flash_attention`'s kernel or plain version.  When grad is enabled
    and a part requires it, the call goes through :class:`FlashAttentionSplit`.
    """
    _check_split(q_nope, q_rope, k_nope, k_rope, v)
    ts = (q_nope, q_rope, k_nope, k_rope, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return FlashAttentionSplit.apply(*ts, causal, q_chunk, kv_chunk, q_offset)
    return _split_forward(*ts, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                          q_offset=q_offset, with_lse=False)[0]
