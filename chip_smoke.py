#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of SU3_Bench and its LM serving path on one
NVIDIA card and check it.

    python3 chip_smoke.py [--seed N] [--flash-yardsticks]

Run from the root of a checkout; it needs one CUDA device and nvcc.  It
builds every CUDA source of the port (``build/repro_torch/``, one nvcc per
source, started together) and, at the paper's L=32 lattice:

  * holds each kernel (the multiply, the slot-batched serving megakernel,
    the stencil, the fused CG body) against its plain PyTorch version on
    random SU(3) links and random vectors, in every storage form;
  * drives the main paths with the launch counters set to 0 just before
    each and read just after: ``SU3Engine.run()`` / ``run_fused(8)``,
    ``ExecutionPlan.stencil_step()`` (and ``depth=2``) on the stencil's
    fixed point, ``ExecutionPlan.cg_solve`` fused and composed on the CG
    measurement problem, held against the plain ``cg_reference_solve``,
    the same lattice split into 2 and 4 t-slabs (``MeshSpec`` plans):
    first-touch init and ``step``, the overlapped ``stencil_step`` at depth
    1 and 2, and ``cg_solve(fused=True, overlap=True)``, each bitwise
    against the serial and one-slab paths, with the kernels' boundary and
    ring launches held against their plain versions, the halo faults, the
    times and phase split, the stencil and CG tuners at 2 slabs and the
    attribution of the traced steps; the same 2 and 4 slabs owned by one
    NCCL rank (a process group of one, started and destroyed in the
    phase): first-touch init, ``step``, ``fused_step``, the stencil at
    both ``overlap`` values and depths, fused and composed CG, bitwise
    against the one-process slab plan, with the stencil-step and
    CG-iteration ms beside its; whole-lattice batches split over a mesh's
    devices (``[card, card]`` in one process, and one NCCL rank owning 2
    slabs): ``BatchedLatticeRunner`` on 4 lattices at k=1 and 3 and an
    8-slot megakernel table, 2 blocks of one launch each, bitwise against
    one device, timed beside the one-launch path, the service's megakernel
    mode on a host of 2 devices, the ranked stencil and CG tuners and the
    ranked CG's two reductions; and ``SU3Service`` in its batch,
    continuous and megakernel modes on one seeded request stream
    (multiplies at L=16 and L=32, then a stencil batch and a solve),
    autotuned against a fresh cache under ``build/``;
  * the LM phase: holds the flash-attention kernel against its plain
    version in fifteen forms (f32 and bf16, causal and not, G in {1, 2, 3,
    4, 8}, D in {32, 64, 128}, ragged lengths, Sq != Skv, q_offset; six of
    them bf16 at D=64, ``flash_group_fwd<64>``'s work lists: zamba2-1.2b's and
    granite-moe's prefill, whisper-tiny's encoder and cross-attention, a
    q_offset, a ragged 333 at G=3 with a partial row tile); drives
    ``ServeEngine`` on full-width qwen3-4b (random bf16 weights from
    ``--seed``) over 4 prompts of 1,024 tokens plus 32 greedy tokens, with
    the counters set to 0 just before and read just after (36 flash launches
    in prefill, none in decode); holds the decode logits against a
    teacher-forced prefill, and the card against the port's CPU path at 2
    layers in f32;
  * the training phase: holds the flash backward kernel against its plain
    version in nine forms (and twice bitwise; one reads a strided dout in
    place), and the forward's ``out`` with and without lse; trains
    full-width qwen3-4b (36 layers, f32 master weights and AdamW moments,
    bf16 compute, remat) through
    ``train.loop.train`` for 5 steps on 2 x 1,024 tokens from the seeded
    ``TokenPipeline``, with the counters set to 0 just before and read just
    after (72 flash forward launches a step, 36 in the remat recompute; 36
    backward calls); profiles one more step; holds one step's loss and
    gradients on the card against the CPU at 2 layers in f32, and 4 steps
    straight against 2 + checkpoint + restore + 2, bitwise, on the card;
  * the mesh phase: a world of one rank on NCCL (``file://`` store,
    in-process), ``make_mesh((1, 1), ("data", "model"))``, full-width
    qwen3-4b cut to 4 layers trained through ``train.loop.train(mesh=...)``
    (DTensor weights, batches and moments at the reference's placements,
    activations pinned by ``act_sharding``, the flash kernels on each
    rank's heads through ``local_map``): 2 steps, checkpoint, the group
    torn down, a new group and mesh, restore, 2 more steps; losses, every
    parameter and moment against ``train.loop.train`` on one card over the
    same 4 steps from the same weights (bitwise expected), the
    ``flash_group_fwd<128>`` and ``flash_bwd_d128`` launches of the mesh
    runs by name, and both step times;
  * the mesh families phase (after the whisper phase): one NCCL rank on a
    (1, 1) mesh again; granite-moe-1b-a400m at full width and depth and
    deepseek-v3-671b on its 3 dense layers + MTP (MLA_TRAIN_REDUCED)
    trained 2 steps through ``train.loop.train(mesh=...)`` (experts through
    ``local_map``, MLA's split flash call on each rank's heads) against
    ``train.loop.train`` on the card, and qwen3-4b (MESH_LAYERS),
    granite-moe and deepseek-v3 (MLA_LAYERS) served through
    ``ServeEngine(..., mesh=...)`` (the state at the reference's state
    rules, rank 0 sampling) against ``ServeEngine`` without a mesh: prefill
    + 16 tokens; every loss, grad norm, leaf fingerprint, token and the
    prefill logits bitwise, step / prefill / decode ms, peak GB and the
    mesh runs' flash launches by kernel name;
  * the mesh state families phase (after the mesh families phase): one
    NCCL rank on a (1, 1) mesh; zamba2-1.2b at full width cut to one group
    of 6 Mamba2 layers and the shared block trained 2 steps and served
    against its one-card twin; xlstm-125m (2 blocks) and whisper-tiny
    (whole) trained and served through ``train.loop.train(mesh=...)`` and
    ``ServeEngine(..., mesh=...)`` against the one-card runs of their own
    phases (the same seeded weights, steps, prompts and frames):
    Mamba2's conv and SSD on each rank's channels and heads, the xLSTM
    cells on each rank's rows, Whisper's attention on each rank's heads;
    every loss, grad norm, leaf fingerprint, token and prefill logit
    bitwise; deepseek-v3 (4 layers) served with ``kv_seq_shard=True``
    (its latents split along their sequence even on (1, 1): the combine
    of one part), its tokens equal and its prefill logits within 1e-3 of
    their max; the combine of 2 and 4 parts of granite-34b's decode cache
    against ``decode_attention`` within 1e-5; the mesh runs'
    ``flash_group_fwd<64>``, ``flash_bwd_d64`` and ``flash_mla_fwd``
    launches by kernel name;
  * the MoE phase, after the qwen3-4b phases have freed the card: on
    full-width, full-depth granite-moe-1b-a400m (24 layers, 32 experts
    top-8, 16/8 heads of 64), ``ServeEngine`` as above (24 flash launches in
    prefill, none in decode; decode against a teacher-forced forward with
    capacity for every assignment and expert choices pinned to the
    teacher's, the served config's drops, flips and difference printed;
    the card against the CPU at 2 layers in f32 with equal routing;
    matrices at std 0.02, see ``_matrices_at``) and ``train.loop.train`` as above (48
    flash forward and 24 backward launches a step; ``nll`` and ``aux`` per
    step; one step twice from one state, bitwise; card against CPU at 2
    layers with equal routing; resume bitwise); then the flash forward and
    backward at its head dim 64 and G = 2 against their plain versions,
    timed beside SDPA and their bounds;
  * the MLA phase: the flash kernel at (D, Dv) = (192, 128) through its
    split entry on MLA's parts (q_nope a view of the q projection, q_rope,
    k_nope, one k_rope channel for every head or one a head, v) against its
    plain version on the concatenated q and k in seven forms (bf16 and f32,
    causal and not, ragged, q_offset); ``ServeEngine`` on full-width
    deepseek-v3-671b cut to its 3
    leading dense layers and 1 MoE layer (+ MTP; 15.8 B parameters, bf16,
    matrices at std 0.02) over 4 x 1,024 prompt tokens + 32 greedy tokens
    (4 flash launches in prefill, none in decode; decode against a
    dropless teacher-forced forward with expert choices pinned); the card
    against the CPU at 2 dense layers of full width in f32 and at the
    reduced config with deepseek-v3's head dims (routing equal); the
    kernel at the prefill shape (the split entry and the concatenated
    call) beside SDPA and its bound;
  * MLA training: the flash backward at (192, 128) through its split entry
    against its plain version in eight forms (bf16 and f32, causal and not,
    ragged, Sq < Skv, q_offset, one rope channel or one a head; five
    gradients; each twice bitwise); ``train.loop.train`` on deepseek-v3 at
    full width cut to its 3 dense layers and the MTP layer (4.29 B
    parameters, ``MLA_TRAIN_REDUCED``) for 5 steps on 2 x 1,024 tokens (7
    flash forward and 4 backward launches a step), one step's gradients
    twice bitwise; the card against the CPU on 2 dense layers + MTP of full
    width in f32; resume bitwise on the reduced config with deepseek-v3's
    head dims; the backward at the training shape beside SDPA's backward
    and its bound, and its three kernels' device ms;
  * GPipe: qwen3-4b's 36 layers at full width in 4 logical stages of 9
    (``distributed.pipeline``), 4 microbatches of 512 tokens in bf16:
    outputs and gradients of a sum-of-squares loss bitwise against the
    sequential pass, launches and peak memory;
  * the zamba phase: full-width zamba2-1.2b cut from 38 to 14 Mamba2
    layers (``ZAMBA_DEPTH``, for the time limit; the shared attention
    block applied after every 6: 2 applications at 32/32 heads of 64, G =
    1; random weights from the seed, f32 states) through ``ServeEngine``
    as above (bf16, matrices at std 0.02; 2 flash launches in prefill, none
    in decode; decode against one cache-less teacher forward over the
    served tokens padded to a multiple of the SSD's chunk, also at the
    reference's init rule in f32; the launches of one Mamba2
    layer and one shared application) and ``train.loop.train`` as above
    (2 flash forward and 2 backward launches a step; one step twice
    bitwise); the card against the CPU on a full-width cut of 3 layers
    (matrices at std 0.02): logits and every state leaf, one step's loss
    and gradients; resume bitwise; the flash forward (B=4) and backward
    (B=2, the training shape) at S=1,024, H=32, D=64, G=1 against their
    plain versions, SDPA and their bounds;
  * the xLSTM phase: full-width xlstm-125m cut to its first 2 blocks
    (one mLSTM, one sLSTM; ``XLSTM_DEPTH``, for the time limit); bf16, f32 cells
    and states; no kernel of the port: both cells step through time in
    plain PyTorch) through ``ServeEngine`` as above (decode against one
    state-less teacher forward over the served tokens; the launches of one
    mLSTM and one sLSTM block per phase) and ``train.loop.train`` as above
    (each block rematted; one step twice bitwise); the card against the
    CPU on a full-width cut of one mLSTM and one sLSTM block in f32:
    logits, every state leaf, one step's loss and gradients; resume
    bitwise;
  * the whisper phase: the flash forward and backward against their
    plain versions at whisper-tiny's shapes (D=64, G = 1: non-causal over
    1,500 frames, cross-attention with Sq != Skv = 1,500, the decoder's
    causal self-attention); full-width, full-depth whisper-tiny (4 + 4
    layers, 1,500 stub frames, 56.4 M parameters, nothing cut) through
    ``ServeEngine`` (4 x (1,500 frames, 16 tokens) + 32 greedy tokens, bf16,
    matrices at std 0.02; 12 flash launches in prefill, none in decode;
    decode against one cache-less teacher pass) and ``train.loop.train``
    (2 x (1,500 frames, 448 tokens), 5 steps; 20 flash forward and 12
    backward launches a step; one step twice bitwise); the card against the
    CPU on the whole model in f32; resume bitwise; the kernels' yardsticks
    at the encoder's and the cross-attention's prefill and at training's
    three shapes;
  * the dry run: the reference's four dry-run cases through
    ``python -m repro_torch.launch.dryrun`` (``meta`` tensors; at once), and
    ``--su3-fig7 --L 32 --device-counts 1,2,4 --controllers 2``: two
    controller processes on the card, no divergence;
  * the wide phase (``WIDE_ARCHS``): full-width internvl2-26b (48 layers,
    48/8 heads of 128: G = 6; 256 stub patch positions; 19.86 B
    parameters), yi-6b (32 layers, 32/4 heads: G = 8; 6.06 B), minitron-8b
    (32 layers, 32/8 heads: G = 4; a 256,000-wide separate head; 9.88 B)
    and granite-34b (MQA, 48 heads on one kv head: G = 48; cut from 88 to
    64 layers, 34.53 B), each bf16 with matrices at std 0.02, through
    ``ServeEngine`` as above (the VLM's seeded random patches drawn on the
    CPU and moved; one launch of ``flash_group_fwd<128>`` a layer in
    prefill, none in decode; decode against one cache-less teacher pass;
    the peak memory beside its prediction), and the card against the CPU at
    2 layers in f32; ``train.loop.train`` at full width on a cut depth
    (internvl2-26b 6 layers, yi-6b 20, minitron-8b 6, granite-34b 6; each
    in its row's ``reduced``; 2 forward and 1 backward launches a layer a
    step, by kernel; the step's gradients twice bitwise; the peak memory
    beside its prediction), one step's loss and gradients on the card
    against the CPU at 2 layers in f32 (the host's memory beside it);
  * the tools phase: ``python -m repro_torch.core.autotune --L 4`` in
    process (every sweep, no TPU constant), each of ``examples/torch/``
    through its ``main(argv)`` at a small size (each must launch its
    kernel on the card), ``serve_lattices.py --autotune`` twice (the second
    starts tuned), ``scripts/torch/profile_dispatch.py --quick --trace`` and
    ``scripts/torch/trace_report.py`` on that trace;
  * last, the bf16 forward at D=64 (``flash_group_fwd<64>``) at
    zamba2-1.2b's, granite-moe's and whisper-tiny's shapes against its plain
    version, then timed in turns beside SDPA (eager and in CUDA graphs);
    then the bf16 backward at D=64 (``flash_bwd_delta_vec<64>`` and the
    persistent ``flash_bwd_d64``) at their five training shapes against its
    plain version and twice bitwise, its kernels by name, timed in turns
    beside SDPA's backward (eager and in CUDA graphs), with the turns' sum of
    graph times weighted by each shape's main-path launches; then the bf16
    kernels at D=128 (``flash_group_fwd<128>``, ``flash_bwd_delta_vec<128>``
    and the persistent ``flash_bwd_d128``) against their plain versions at
    every D=128 architecture's heads (G = 4, 8, 6, 48), and every D=128
    main-path shape timed the same way (rows 5 and 5b: qwen3-4b's and
    minitron-8b's prefill and training shapes; 5-yi, 5-internvl,
    5-granite and their backward rows), with the rows weighted by their
    main-path launches;
  * times each kernel against its bound, its plain version and, where one
    PyTorch call computes the same function, that call (every time in the
    kernels line from eager calls; the flash kernel and SDPA also in a CUDA
    graph of back-to-back calls, printed beside them, where the wrapper's
    host cost does not show).

It prints:

  * the card's name and power limit (nvidia-smi) and the tool versions;
  * the HGMMA, UTMALDG and HMMA counts of the built flash-attention library
    (``cuobjdump -sass``): its bf16 body must run wgmma fed by TMA; and the
    HGMMA count of the persistent bf16 forward at D=64 and 128 (both masks)
    and of each bf16 backward kernel (dK/dV and dQ at D=32 and (192, 128),
    the persistent ones at 64 and 128; every mask), which must run wgmma
    too;
  * one JSON line per check, per main-path row and per yardstick;
  * a ``{"flash_rows": {...}}`` line: the flash rows PERF.md's kernels
    table compares (rows 5 and 5b at D=128, 5-yi, 5-internvl, 5-granite
    and their 5b rows, 5-64, 5-zamba, 5-whisper
    encoder and cross, 5b-64, 5b-zamba, 5b-whisper encoder, cross and self,
    5-mla, 5b-mla; ms, library ms, bound, and the backward's kernels by
    name; the launch-weighted sums of the D=128 rows and of the D=64
    backward rows);
  * a ``{"kernels": [...]}`` line with each ported kernel's numbers (the
    flash backward beside the forward, the bf16 forward and backward at
    D=128 and at D=64 with their registers, shared bytes and spill and
    their launches by kernel name, and the (192, 128) instantiations of both
    with their own launches) and the total wall time;
  * last, ``{"ok": true, "device": {...}}`` — only if every phase passed.

``--flash-yardsticks`` builds and times those flash rows alone, then prints
the digests, and runs on older checkouts as well: run it on two checkouts
in one call to compare them on one card.

The whole output is over 20 KB; where only the end of a log is kept, run
``mkdir -p build && python3 chip_smoke.py | tee build/chip_smoke.log`` to
keep all of it.  Without CUDA, or without the rest of the repository, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

KERNEL_SOURCE = "src/repro_torch/csrc/su3_mult.cu"
REPLACES = "src/repro/kernels/su3_matmul.py:199"  # su3_mult_planar (pallas_call at :229)
STENCIL_SOURCE = "src/repro_torch/csrc/su3_stencil.cu"
STENCIL_REPLACES = "src/repro/kernels/su3_stencil.py:136"  # su3_stencil_planar (pallas_call :159)
CG_REPLACES = "src/repro/kernels/su3_stencil.py:240"  # su3_cg_fused_planar (pallas_call :276)
MEGA_REPLACES = "src/repro/kernels/su3_matmul.py:292"  # su3_mult_planar_batched (pallas_call :340)
SLOT_K = [0, 1, 3, 8, 13]  # dead, single, deep, max_k, above max_k (clamped to max_k)
MAX_K = 8
SERVICE_LS = (16, 32)  # the stream's lattice sizes: the small one arrives first
SERVICE_STREAM = [(0, 3), (0, 8), (0, 1), (0, 5), (1, 2), (1, 7), (1, 4), (1, 6)]  # (L index, k)
TABLE_SLOTS = 8
FUSED_K = 8
FUSED_REPS = 3  # SU3Engine.run_fused's default
STENCIL_REPS = 20  # timed stencil steps per main-path row
CG_TIMED_ITERS = 20
BETA = 0.3718  # the CG body's beta in the kernel checks (nonzero)
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:69"  # flash_attention_tpu (pallas_call :92)
LM_ARCH = "qwen3-4b"  # full width: 36 layers, d_model 2560, 32/8 heads of 128, vocab 151,936
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 32  # 4 prompts of 1,024 tokens, 32 greedy tokens
LM_MAX_LEN = 1064
# decode logits against a teacher-forced prefill, bf16 at full depth: every
# op rounds to bf16 (2^-9 relative), the two paths round in other places and
# other matmul shapes over 36 residual layers; logits are O(1), so a wrong
# cache row or position moves them by O(1), far past 0.1 of their range
LM_TEACHER_TOL = 0.1
# the card against the port's CPU path at 2 layers in f32, TF32 off: sums in
# another order (cuBLAS against the CPU's BLAS, the kernel's 64-key tiles
# against 1,024-key chunks), ~1e-6 relative per op on O(1) logits
LM_CROSS_TOL = 1e-3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 5  # 2 x 1,024 tokens a step, 5 steps
MESH_LAYERS = 4
MESH_REDUCED = {"n_layers": "36 -> 4: the smoke's time limit"}
MESH_SHAPE, MESH_AXES = (1, 1), ("data", "model")
MESH_STEPS = (2, 2)  # steps before the checkpoint, steps after the restore
MESH_LOSS_TOL, MESH_LEAF_TOL = 1e-4, 1e-3  # if not bitwise: loss relative, leaf of its max
# the mesh families phase: granite-moe and deepseek-v3 trained, qwen3-4b,
# granite-moe and deepseek-v3 served, on one NCCL rank's (1, 1) mesh
MESH_FAMILY_STEPS, MESH_FAMILY_NEW = 2, 16  # train steps; tokens served after the prompt
# the mesh state families phase: zamba2-1.2b at full width cut to one group (its own
# one-card twin beside it: the zamba phase runs 14 layers); xlstm-125m (XLSTM_DEPTH)
# and whisper-tiny held against their phases' one-card runs; deepseek-v3 (MLA_LAYERS)
# served on a sequence-sharded latent cache against the mesh families phase's one card
ZAMBA_MESH_DEPTH = {"n_layers": 6}
ZAMBA_MESH_REDUCED = {"n_layers": "38 -> 6: one group of 6 Mamba2 layers and the shared block "
                                  "(the smoke's time limit)"}
SEQ_SHARD_LOGITS_TOL = 1e-3  # of the logits' max: the combine adds in another order than softmax
COMBINE_PARTS, COMBINE_TOL = (2, 4), 1e-5  # parts of granite-34b's decode cache; of the max
# the MoE phase, served and trained at the LM and training shapes above: full
# width, 24 layers, d_model 1,024, 16/8 heads of 64, 32 experts top-8 (d_ff
# 512), vocab 49,155, tied embeddings; 1.33 B parameters, 0.40 B active
MOE_ARCH = "granite-moe-1b-a400m"
# step 1's NLL against ``_start_nll``: ln(vocab) plus the spread of the
# logits that a 0.02 head gives, which grows with d_model
TRAIN_START_TOL = 1.0
# one train step's loss and gradients, the card against the CPU at 2 layers
# in f32, TF32 off: sums in another order (cuBLAS and the kernels' tiles
# against the CPU's BLAS and 512 / 1,024-row chunks), ~1e-6 relative per op;
# an element near zero carries the rounding of the terms that cancelled in
# it, so each gradient is held against its largest magnitude
TRAIN_CROSS_LOSS_TOL = 1e-4
TRAIN_CROSS_GRAD_TOL = 1e-3
TRAIN_CROSS_SEQ = 128
# the backward replaces the reference's autodiff of its chunked attention:
# flash_attention_tpu (FLASH_REPLACES) has no backward
BWD_SOURCE_LINE = "src/repro/models/attention.py:52"
BWD_FORMS = [  # (label, batch, sq, skv, hq, hkv, d, causal, q_offset, dtype)
    ("training shape bf16 causal", 2, 1024, 1024, 32, 8, 128, True, 0, "bfloat16"),
    ("training shape f32 causal", 2, 1024, 1024, 32, 8, 128, True, 0, "float32"),
    ("ragged 100 G=4 D=64 bf16", 1, 100, 100, 4, 1, 64, True, 0, "bfloat16"),
    ("ragged 100 G=1 D=32 f32 non-causal", 1, 100, 100, 4, 4, 32, False, 0, "float32"),
    ("Sq<Skv q_offset 136 G=4 D=64 f32", 2, 64, 200, 8, 2, 64, True, 136, "float32"),
    ("Sq<Skv q_offset 136 G=4 D=32 bf16", 2, 64, 200, 8, 2, 32, True, 136, "bfloat16"),
    ("Sq<Skv G=1 D=64 bf16 non-causal", 1, 64, 200, 4, 4, 64, False, 0, "bfloat16"),
    ("ragged 130 G=4 D=128 f32", 1, 130, 130, 8, 2, 128, True, 0, "float32"),
    # dout a slice of a (B, S, Hq, 2 D) tensor: 16-byte rows, read in place
    ("G=4 D=128 bf16 causal dout strided", 1, 512, 512, 16, 4, 128, True, 0, "bfloat16"),
]
# the bf16 backward's wgmma kernels, and the (D, Dv) pairs each is built for
# (two instantiations a pair: causal or not): D=32 on the dK/dV and dQ
# kernels, MLA's (192, 128) on dK/dV and dQ kernels of its own, D = Dv = 64
# and 128 on one persistent kernel each for both
BWD_TC_KERNELS = ("flash_bwd_dkdv_tc", "flash_bwd_dq_tc", "flash_bwd_dkdv_mla",
                  "flash_bwd_dq_mla", "flash_bwd_d64", "flash_bwd_d128")
BWD_TC_PAIRS = {"flash_bwd_dkdv_tc": 1, "flash_bwd_dq_tc": 1, "flash_bwd_dkdv_mla": 1,
                "flash_bwd_dq_mla": 1, "flash_bwd_d64": 1, "flash_bwd_d128": 1}
# bytes of spill a backward kernel may have: none (until PR 24 bf16 dK/dV at
# (192, 128) held 104-112 bytes of stack under an allowance of 128)
BWD_SPILL_LIMITS: dict[tuple, int] = {}
# the flash rows the kernels' table compares (PERF.md), gathered from the
# phases that time them and printed together on one line before the last
FLASH_ROWS: dict[str, dict] = {}
FLASH_ROW_KEYS = ("kernel_ms", "kernel_graph_ms", "concat_kernel_ms", "library_ms",
                  "library_graph_ms", "bound_ms", "bound_by", "kernel_split_ms", "plain_ms")
# the MLA phase: deepseek-v3 at full width (d_model 7,168, 128 heads, q_lora
# 1,536, kv_lora 512, qk head 128 + 64, v head 128, 256 experts top-8 sigmoid
# aux-free + 1 shared of d_ff 2,048, dense d_ff 18,432, vocab 129,280),
# cut from 61 layers to its 3 leading dense layers and 1 MoE layer (+ MTP)
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = 4
MLA_REDUCED = {"n_layers": "61 -> 4: 671 B parameters do not fit one card"}
# the backward at MLA's (D, Dv) = (192, 128), G = 1, through the split
# entry: (label, batch, sq, skv, heads, rope_heads, causal, q_offset, dtype)
MLA_BWD_FORMS = [
    ("mla training shape bf16 causal", 2, 1024, 1024, 128, 1, True, 0, "bfloat16"),
    ("mla training shape f32 causal", 2, 1024, 1024, 128, 1, True, 0, "float32"),
    ("mla ragged 333 bf16 causal", 1, 333, 333, 8, 1, True, 0, "bfloat16"),
    ("mla ragged 333 bf16 causal, k_rope per head", 1, 333, 333, 8, 8, True, 0, "bfloat16"),
    ("mla ragged 100 f32 causal", 1, 100, 100, 4, 1, True, 0, "float32"),
    ("mla Sq<Skv q_offset 136 f32", 2, 64, 200, 8, 8, True, 136, "float32"),
    ("mla Sq<Skv q_offset 1024 bf16", 2, 64, 1088, 16, 1, True, 1024, "bfloat16"),
    ("mla ragged Sq<Skv bf16 non-causal", 2, 200, 333, 8, 1, False, 0, "bfloat16"),
]
# deepseek-v3 trained at full width: its 3 dense layers and the dense MTP
# layer, 4.29 B parameters (f32 master weights and AdamW moments: ~69 GB)
MLA_TRAIN_LAYERS = 3
MLA_TRAIN_REDUCED = {"n_layers": "61 -> 3: one MoE layer holds ~180 GB of training state"}
MLA_CROSS_SEQ = 64  # the card against the CPU: 2 dense layers + MTP of full width, f32
# GPipe on the card: qwen3-4b's 36 layers at full width in 4 stages of 9, 4
# microbatches of one 512-token sequence, bf16, matrices at std 0.02
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 4, 512
# the dry run: the reference's cases (tests/test_dryrun_subprocess.py), and
# the fig7 launch at PAPER_L32's lattice
DRYRUN_CASES = [("whisper-tiny", "train_4k", "single"), ("xlstm-125m", "decode_32k", "single"),
                ("granite-moe-1b-a400m", "prefill_32k", "multi"),
                ("zamba2-1.2b", "long_500k", "single")]
DRYRUN_FIG7 = ["--su3-fig7", "--L", "32", "--device-counts", "1,2,4", "--controllers", "2"]
# MLA's flash forms: (label, batch, sq, skv, heads, rope_heads, causal,
# q_offset, dtype) at D=192 (nope 128 + rope 64), Dv=128, G=1, through the
# split entry on the parts as MLA makes them (k_rope of one head, as MLA's,
# or of every head)
MLA_FORMS = [
    ("prefill shape bf16 causal", 4, 1024, 1024, 128, 1, True, 0, "bfloat16"),
    ("bf16 causal, k_rope per head", 1, 1024, 1024, 32, 32, True, 0, "bfloat16"),
    ("f32 causal", 1, 512, 512, 16, 1, True, 0, "float32"),
    ("ragged Sq<Skv bf16 non-causal", 2, 200, 333, 8, 1, False, 0, "bfloat16"),
    ("ragged 333 f32 non-causal", 1, 333, 333, 8, 8, False, 0, "float32"),
    ("q_offset 1024 bf16", 2, 64, 1088, 16, 1, True, 1024, "bfloat16"),
    ("ragged q_offset 200 f32", 1, 100, 300, 8, 1, True, 200, "float32"),
]
# the zamba phase: zamba2-1.2b at full width (38 Mamba2 layers of d_model
# 2,048, d_inner 4,096, 64 SSM heads of 64, state 64, conv 4; one shared
# attention + SwiGLU block of 32/32 heads of 64 and d_ff 8,192 after every 6
# layers: 6 applications; vocab 32,000; 1.17 B parameters), served and
# trained at the LM and training shapes above
ZAMBA_ARCH = "zamba2-1.2b"
# its first 14 layers: the shared block after layers 6 and 12, then a tail
# of 2; the whole depth took ~100 s of the smoke (host-bound: 51,911
# launches a training step), and the smoke gained the wide phase
ZAMBA_DEPTH = {"n_layers": 14}
ZAMBA_REDUCED = {"n_layers": "38 -> 14 (the shared block after layers 6 and 12, a tail of 2): "
                             "the smoke's time limit"}
# the card against the CPU: full width, 2 Mamba2 layers, one shared
# application and a tail layer, f32
ZAMBA_CUT = {"n_layers": 3, "hybrid_attn_every": 2}
# the xLSTM phase: xlstm-125m at full width and depth (12 blocks of d_model
# 768, d_inner 1,536, 4 heads of 384, conv 4; sLSTM at blocks 5 and 11; vocab
# 50,304; 212.0 M parameters by the spec), served and trained at the LM and
# training shapes above; nothing cut.  It reaches no kernel of the port.
XLSTM_ARCH = "xlstm-125m"
# its first 2 blocks, one mLSTM and one sLSTM (XLSTM_CUT): a whole-depth step
# took 32-54 s, 6 blocks 161-185 s of the smoke, and the smoke gained the MLA
# training, GPipe, dry-run, VLM and dense phases
XLSTM_DEPTH = {"n_layers": 2, "slstm_layers": (1,)}
XLSTM_REDUCED = {"n_layers": "12 -> 2 (mLSTM at 0, sLSTM at 1): the smoke's time limit"}
# a training step makes ~1 M eager launches (30-50 s); 3 steps instead of 5,
# and the step twice on a quarter of the tokens, keep the whole smoke inside
# its time limit
XLSTM_TRAIN_STEPS = 3
XLSTM_PROFILE_SEQ = 256  # the tokens a row of the step twice and of the profiled step
XLSTM_CUTS = {"train_steps": f"{TRAIN_STEPS} -> 3: a step takes tens of seconds (host-bound)",
              "step_twice_seq": f"{TRAIN_SEQ} -> {XLSTM_PROFILE_SEQ}: the same, a quarter of it"}
# the card against the CPU: full width, one mLSTM block then one sLSTM block,
# f32, over 64 tokens
XLSTM_CUT = {"n_layers": 2, "slstm_layers": (1,)}
XLSTM_CROSS_SEQ = 64
# the whisper phase: whisper-tiny at full width and depth (4 encoder layers
# over 1,500 stub frames, 4 decoder layers; d_model 384, 6 heads of 64, d_ff
# 1,536, vocab 51,865; 56.4 M parameters), nothing cut
WHISPER_ARCH = "whisper-tiny"
WHISPER_PROMPT = 16  # tokens of each served prompt, after its 1,500 frames
WHISPER_MAX_LEN = 64
WHISPER_TRAIN_SEQ = 448  # Whisper's published decoder context (max_decode_len)
WHISPER_FORMS = [  # as FLASH_FORMS: 6 heads of 64, G = 1
    ("whisper encoder bf16", 4, 1500, 1500, 6, 6, 64, False, 0, "bfloat16"),
    ("whisper encoder f32", 1, 1500, 1500, 6, 6, 64, False, 0, "float32"),
    ("whisper cross prefill bf16", 4, 16, 1500, 6, 6, 64, False, 0, "bfloat16"),
    ("whisper decoder self prefill bf16", 4, 16, 16, 6, 6, 64, True, 0, "bfloat16"),
    ("whisper cross prefill f32", 1, 64, 1500, 6, 6, 64, False, 0, "float32"),
    ("whisper encoder training bf16", 2, 1500, 1500, 6, 6, 64, False, 0, "bfloat16"),
    ("whisper cross training bf16", 2, 448, 1500, 6, 6, 64, False, 0, "bfloat16"),
    ("whisper decoder self training bf16", 2, 448, 448, 6, 6, 64, True, 0, "bfloat16"),
    ("whisper cross training f32", 2, 128, 1500, 6, 6, 64, False, 0, "float32"),
]
# the VLM phase: internvl2-26b at full width and depth (48 layers of d_model
# 6,144, 48/8 heads of 128: G = 6; d_ff 16,384, vocab 92,553, 256 stub patch
# positions at the head of the sequence; 19.86 B parameters, 39.7 GB in bf16),
# served at the LM shapes above (the patches drawn on the CPU and moved)
VLM_ARCH = "internvl2-26b"
# trained at full width on its first 6 layers: at ~16.9 bytes a parameter (f32
# master weights, gradients and AdamW moments; qwen3-4b's 67.8 GB for 4.02 B),
# 1.14 B of embedding and head and 6 x 0.39 B of layers take ~59 GB
VLM_TRAIN_LAYERS = 6
VLM_TRAIN_REDUCED = {"n_layers": "48 -> 6: the training state of all 48 layers (f32 weights, "
                                 "gradients and AdamW moments, ~318 GB) does not fit one card"}
# the card against the CPU: 2 layers of full width in f32 over the 256 patch
# positions and 64 tokens after them
VLM_CROSS_SEQ = 256 + 64
# the D=128 architectures served and trained at full width beside qwen3-4b
# (``_wide_phase``): (tag, arch, served layers, their cut, trained layers,
# their cut, tokens of the card-against-CPU step).  yi-6b: 32 layers of
# d_model 4,096, 32/4 heads of 128 (G = 8), d_ff 11,008, vocab 64,000, 6.06 B;
# minitron-8b: 32 layers of 4,096, 32/8 heads (G = 4), d_ff 16,384, vocab
# 256,000 with a separate head (2.10 B of its 9.88 B are embedding and head);
# granite-34b: 88 layers of 6,144, 48 heads on one kv head (MQA, G = 48),
# d_ff 24,576, vocab 49,152, 47.25 B.  Training keeps 16.2-16.9 bytes a
# parameter (``_train_peak_gb``): the cuts below keep each under ~67 GB
WIDE_ARCHS = [
    ("vlm", VLM_ARCH, 48, {}, VLM_TRAIN_LAYERS, VLM_TRAIN_REDUCED, VLM_CROSS_SEQ),
    ("yi-6b", "yi-6b", 32, {}, 20,
     {"n_layers": "32 -> 20: the training state of all 32 layers (6.06 B parameters at "
                  "~16.5 bytes each, ~100 GB) does not fit one card"}, TRAIN_CROSS_SEQ),
    ("minitron-8b", "minitron-8b", 32, {}, 6,
     {"n_layers": "32 -> 6: the training state of all 32 layers (9.88 B parameters, ~163 GB) "
                  "does not fit one card; the 2.10 B of embedding and head stay whole"},
     TRAIN_CROSS_SEQ),
    ("granite-34b", "granite-34b", 64,
     {"n_layers": "88 -> 64: 47.25 B parameters are 94.5 GB in bf16, over one card's 80 GB"}, 6,
     {"n_layers": "88 -> 6: the training state of all 88 layers (47.25 B parameters, ~780 GB) "
                  "does not fit one card"}, TRAIN_CROSS_SEQ),
]
# the forms whose backward is checked too: training's shapes, and the f32
# ones of the card-against-CPU training check
WHISPER_BWD_FORMS = [f for f in WHISPER_FORMS if "training" in f[0] or f[0].endswith("encoder f32")]
FLASH_FORMS = [  # (label, batch, sq, skv, hq, hkv, d, causal, q_offset, dtype)
    ("main path bf16 causal", 4, 1024, 1024, 32, 8, 128, True, 0, "bfloat16"),
    ("main path f32 causal", 4, 1024, 1024, 32, 8, 128, True, 0, "float32"),
    ("main path bf16 non-causal", 4, 1024, 1024, 32, 8, 128, False, 0, "bfloat16"),
    ("G=1 D=64 f32", 2, 512, 512, 8, 8, 64, True, 0, "float32"),
    ("G=8 D=32 bf16", 2, 512, 512, 16, 2, 32, True, 0, "bfloat16"),
    ("G=8 D=128 f32 ragged 333", 1, 333, 333, 32, 4, 128, True, 0, "float32"),
    ("ragged 1000 bf16", 1, 1000, 1000, 32, 8, 128, True, 0, "bfloat16"),
    ("Sq!=Skv non-causal f32 D=64", 2, 300, 700, 16, 4, 64, False, 0, "float32"),
    ("q_offset 1024 bf16", 2, 64, 1088, 32, 8, 128, True, 1024, "bfloat16"),
    # bf16 at D=64: flash_group_fwd<64>'s work lists (items of G * (128 // G) folded rows)
    ("zamba2-1.2b shared block bf16 D=64 G=1", 4, 1024, 1024, 32, 32, 64, True, 0, "bfloat16"),
    ("granite-moe bf16 D=64 G=2", 4, 1024, 1024, 16, 8, 64, True, 0, "bfloat16"),
    ("whisper encoder bf16 D=64 ragged 1500 non-causal", 4, 1500, 1500, 6, 6, 64, False, 0,
     "bfloat16"),
    ("Sq=16 Skv=1500 bf16 D=64 non-causal", 4, 16, 1500, 6, 6, 64, False, 0, "bfloat16"),
    ("q_offset 1024 bf16 D=64 G=2", 2, 64, 1088, 16, 8, 64, True, 1024, "bfloat16"),
    # G=3: items of 126 rows (two rows of each Q tile zero), the last one partial
    ("ragged 333 bf16 D=64 G=3", 1, 333, 333, 12, 4, 64, True, 0, "bfloat16"),
]
# the largest error of each flash forward kernel against its plain version
# over every form checked (_flash_checks), by ``flash_attention.kernel_name``
FLASH_ERRS: dict[str, float] = {}
# the flash kernels of bf16 at D = Dv = 128 (qwen3-4b's, yi-6b's,
# minitron-8b's, granite-34b's and internvl2-26b's heads), as
# ``flash_attention.LAUNCHES_BY_KERNEL`` names them
D128_FWD_KERNEL, D128_BWD_KERNEL = "flash_group_fwd<128>", "flash_bwd_d128"
D128_ARCHS = ("qwen3-4b", "yi-6b", "minitron-8b", "granite-34b", "internvl2-26b")
# the D=128 shapes of the main paths, prefill (B=4) and training (B=2), timed
# in turns beside SDPA (``_group_fwd_yardsticks``, ``_group_bwd_yardsticks``):
# (row, arch, batch, sq, skv, hq, hkv, causal, main-path launches).  Rows 5
# and 5b: qwen3-4b's heads, which minitron-8b shares (serving 36 + 32,
# training 360 + 60, GPipe 144 forward; training 180 + 30, GPipe 144
# backward); yi-6b's G = 8 (32 + 200; 100), internvl2-26b's G = 6 (48 + 60;
# 30), granite-34b's G = 48 (64 + 60; 30), 5 training steps each
D128_ROWS = [("5 D=128", "qwen3-4b, minitron-8b", 4, 1024, 1024, 32, 8, True, 632),
             ("5-yi", "yi-6b", 4, 1024, 1024, 32, 4, True, 232),
             ("5-internvl", "internvl2-26b", 4, 1024, 1024, 48, 8, True, 108),
             ("5-granite", "granite-34b", 4, 1024, 1024, 48, 1, True, 124)]
D128_BWD_ROWS = [("5b D=128", "qwen3-4b, minitron-8b", 2, 1024, 1024, 32, 8, True, 354),
                 ("5b-yi", "yi-6b", 2, 1024, 1024, 32, 4, True, 100),
                 ("5b-internvl", "internvl2-26b", 2, 1024, 1024, 48, 8, True, 30),
                 ("5b-granite", "granite-34b", 2, 1024, 1024, 48, 1, True, 30)]
# the D=64 forward's shapes on the main paths, timed in turns beside SDPA
# (``_group_fwd_yardsticks``): (row, arch, batch, sq, skv, hq, hkv, causal)
D64_ROWS = [
    ("5-zamba", "zamba2-1.2b", 4, 1024, 1024, 32, 32, True),
    ("5-64", "granite-moe-1b-a400m", 4, 1024, 1024, 16, 8, True),
    ("5-whisper encoder", "whisper-tiny", 4, 1500, 1500, 6, 6, False),
    ("5-whisper cross", "whisper-tiny", 4, 16, 1500, 6, 6, False),
]
# the D=64 backward's shapes on the main paths (training, B=2), timed in
# turns beside SDPA's backward (``_group_bwd_yardsticks``): (row, arch, batch,
# sq, skv, hq, hkv, causal, main-path launches: 5 steps, one call a layer)
D64_BWD_ROWS = [
    ("5b-64", "granite-moe-1b-a400m", 2, 1024, 1024, 16, 8, True, 120),
    ("5b-zamba", "zamba2-1.2b", 2, 1024, 1024, 32, 32, True, 10),
    ("5b-whisper encoder", "whisper-tiny", 2, 1500, 1500, 6, 6, False, 20),
    ("5b-whisper cross", "whisper-tiny", 2, 448, 1500, 6, 6, False, 20),
    ("5b-whisper self", "whisper-tiny", 2, 448, 448, 6, 6, True, 20),
]


def _emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _tool_line(cmd: list[str]) -> str:
    out = _tool_output(cmd).strip()
    return out.splitlines()[-1] if out else ""


def _tool_output(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True).stdout


def _sass_per_function(listing: str, op: str) -> dict[str, int]:
    """The count of instruction ``op`` in each function of a ``cuobjdump
    -sass`` listing, keyed by the function's (mangled) name."""
    counts: dict[str, int] = {}
    name = None
    for line in listing.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            counts[name] = 0
        elif name is not None and re.search(rf"\b{op}\b", line):
            counts[name] += 1
    return counts


def random_su3(rng, shape: tuple[int, ...]):
    """Random SU(3) matrices (*shape, 3, 3) complex64: Gram-Schmidt on two
    random complex rows, row 2 = conj(row0 x row1), so det = 1."""
    import numpy as np

    g = rng.standard_normal(shape + (2, 3, 2))
    g = g[..., 0] + 1j * g[..., 1]
    u0 = g[..., 0, :] / np.linalg.norm(g[..., 0, :], axis=-1, keepdims=True)
    v = g[..., 1, :] - np.sum(u0.conj() * g[..., 1, :], axis=-1, keepdims=True) * u0
    u1 = v / np.linalg.norm(v, axis=-1, keepdims=True)
    u2 = np.conj(np.cross(u0, u1))
    return np.stack([u0, u1, u2], axis=-2).astype(np.complex64)


def _time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms per call over ``reps`` calls, between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Mean device ms per call: ``calls`` back-to-back calls captured in one
    CUDA graph, replayed ``reps`` times between two CUDA events, so that
    the host's cost per call does not show."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def _best_ms(fn, reps: int, warmup: int = 2) -> float:
    """Best ms of one call over ``reps`` calls, each between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return min(a.elapsed_time(b) for a, b in pairs)


def _bits(x):
    import torch

    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def _counters() -> tuple:
    from repro_torch.kernels import flash_attention, su3_matmul, su3_stencil

    return (su3_matmul.LAUNCHES, su3_matmul.MEGA_LAUNCHES, su3_stencil.STENCIL_LAUNCHES,
            su3_stencil.CG_LAUNCHES, flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES)


def _reset_counts() -> None:
    from repro_torch.kernels import flash_attention

    for counter in _counters():
        counter.count = 0
    flash_attention.LAUNCHES_BY_KERNEL.clear()


def _counts() -> dict[str, int]:
    return {c.name: c.count for c in _counters()}


def _by_kernel() -> dict[str, int]:
    """The flash launches since the last ``_reset_counts``, by the kernel
    that ran (``flash_attention.kernel_name``)."""
    from repro_torch.kernels import flash_attention

    return dict(flash_attention.LAUNCHES_BY_KERNEL)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the random SU(3) data")
    ap.add_argument("--flash-yardsticks", action="store_true",
                    help="build, then time the flash rows of PERF.md's kernels table alone "
                         "(every D=128 row, 5-64, 5-zamba, 5-whisper, 5b at D=64, 5-mla, "
                         "5b-mla), print the digests and stop; it runs on older checkouts "
                         "too")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import roofline
    from repro_torch.core.su3 import layouts
    from repro_torch.core.su3.engine import SU3Engine
    from repro_torch.core.su3.layouts import Layout
    from repro_torch.core.su3.plan import verify_tolerance
    from repro_torch.kernels import _build, flash_attention, su3_matmul, su3_stencil

    t_start = time.perf_counter()
    failures: list[str] = []
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    hw = roofline.hardware_for_device(name)
    torch.backends.cuda.matmul.allow_tf32 = False  # the yardstick runs in full f32

    # -- 1. the card and the tools ---------------------------------------------
    card = _tool_line(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(card)
    _emit({"torch": torch.__version__, "cuda": torch.version.cuda,
           "nvcc": _tool_line([_build.nvcc_path(), "--version"]),
           "device": name, "count": torch.cuda.device_count(),
           "spec": hw.name if hw else None})

    # -- 2. build (set-up time) ---------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    _build.load("su3_mult")
    _build.load("su3_stencil")
    _build.load("flash_attention")
    _emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": sorted(logs)})
    for src, log in logs.items():  # one line per source: registers and spills per kernel
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sorted({line.strip() for line in log.splitlines() if "spill" in line})
        print(f"ptxas[{src}]: registers per kernel {regs}; {' | '.join(spills)}")
    if args.flash_yardsticks:
        _flash_yardsticks(args.seed, hw, failures)
        print(card)
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        if failures:
            return 1
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    budgets: dict[str, list] = {}
    for mode, (dtype, accum) in {"f32": (torch.float32, None),
                                 "bf16": (torch.bfloat16, None),
                                 "bf16+acc-f32": (torch.bfloat16, "float32")}.items():
        for compressed in (False, True):
            for aosoa in (False, True):
                found = {
                    "su3_mult_planar": su3_matmul.kernel_budget(dtype, accum, compressed, aosoa),
                    "su3_mult_planar_batched": su3_matmul.kernel_budget(
                        dtype, accum, compressed, aosoa, megakernel=True),
                    "su3_stencil_planar": su3_stencil.kernel_budget(
                        "stencil", dtype, accum, compressed, aosoa),
                    "su3_cg_fused_planar": su3_stencil.kernel_budget(
                        "cg", dtype, accum, compressed, aosoa),
                }
                for kname, b in found.items():
                    budgets.setdefault(kname, []).append(
                        [mode, compressed, aosoa, b["num_regs"], b["local_bytes"],
                         b["threads_per_block"], b["blocks_per_sm"], b["occupancy"]])
    for kname, forms in budgets.items():
        _emit({"kernel_budget": kname,
               "columns": ["mode", "two_row", "aosoa", "num_regs", "local_bytes",
                           "threads_per_block", "blocks_per_sm", "occupancy"], "forms": forms})
    flash_forms = []
    for dtype, body in (("float32", "cuda cores"), ("bfloat16", "tensor cores")):
        for d, dv in flash_attention.HEAD_DIMS:
            for causal in (True, False):
                dt = getattr(torch, dtype)
                b = flash_attention.kernel_budget(dt, d, causal, dv=dv)
                flash_forms.append([body, dtype, d, dv, causal, b["num_regs"], b["local_bytes"],
                                    b["shared_bytes"], b["threads_per_block"],
                                    b["blocks_per_sm"], b["occupancy"],
                                    list(flash_attention.tiling(dt, d, dv))])
                if b["local_bytes"] or b["blocks_per_sm"] < 1:
                    failures.append(f"flash_attention {dtype} (D, Dv) = ({d}, {dv}): {b}")
    _emit({"kernel_budget": "flash_attention",
           "columns": ["body", "dtype", "head_dim", "v_head_dim", "causal", "num_regs",
                       "local_bytes", "shared_bytes", "threads_per_block", "blocks_per_sm",
                       "occupancy", "tiling_rows_keys_stages"],
           "forms": flash_forms})
    bwd_forms = []
    for dtype in ("float32", "bfloat16"):
        for d, dv in flash_attention.BWD_HEAD_DIMS:
            for causal in (True, False):
                for kname, b in flash_attention.bwd_budget(getattr(torch, dtype), d, causal,
                                                            dv=dv).items():
                    bwd_forms.append([kname, dtype, d, dv, causal, b["num_regs"],
                                      b["local_bytes"], b["shared_bytes"],
                                      b["threads_per_block"], b["blocks_per_sm"]])
                    spill_limit = BWD_SPILL_LIMITS.get((kname, dtype, d, dv), 0)
                    if b["local_bytes"] > spill_limit or b["blocks_per_sm"] < 1:
                        failures.append(f"flash_attention_bwd {kname} {dtype} (D, Dv) = "
                                        f"({d}, {dv}): {b}")
    _emit({"kernel_budget": "flash_attention_bwd",
           "columns": ["kernel", "dtype", "head_dim", "v_head_dim", "causal", "num_regs",
                       "local_bytes", "shared_bytes", "threads_per_block", "blocks_per_sm"],
           "forms": bwd_forms})
    # the bf16 body runs on the tensor cores: wgmma (HGMMA) fed by TMA (UTMALDG)
    sass = _tool_output([str(pathlib.Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
                           str(_build.library_path("flash_attention"))])
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG", "HMMA")}
    _emit({"sass": "flash_attention", "instructions": counts})
    if not (counts["HGMMA"] and counts["UTMALDG"]):
        failures.append(f"flash_attention: no HGMMA or UTMALDG in the built library: {counts}")
    # the bf16 backward on the tensor cores: HGMMA in each of its kernels
    per_fn = _sass_per_function(sass, "HGMMA")
    # the bf16 forward at D = 64 and 128: the persistent kernel, causal and not
    group_hgmma = {fn: n for fn, n in per_fn.items() if "flash_group_fwd" in fn}
    _emit({"sass": "flash_group_fwd", "HGMMA_per_function": sorted(group_hgmma.values())})
    if len(group_hgmma) != 4 or not all(group_hgmma.values()):
        failures.append(f"flash_group_fwd lacks HGMMA or instantiations: {group_hgmma}")
    bwd_hgmma = {kname: {fn: n for fn, n in per_fn.items() if kname in fn}
                 for kname in BWD_TC_KERNELS}
    _emit({"sass": "flash_attention_bwd bf16", "HGMMA_per_function": {
        kname: sorted(found.values()) for kname, found in bwd_hgmma.items()}})
    for kname, found in bwd_hgmma.items():
        if len(found) != 2 * BWD_TC_PAIRS[kname] or not all(found.values()):
            failures.append(f"flash_attention_bwd: {kname} lacks HGMMA or instantiations: {found}")

    # -- 3. kernel vs plain version on random SU(3) links, L=32 --------------------
    t_su3 = time.perf_counter()
    n_sites = PAPER_L32.shape.n_sites
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    u = torch.from_numpy(random_su3(rng, (n_sites, layouts.LINKS))).to(dev)
    b_c = torch.from_numpy(random_su3(rng, (layouts.LINKS,))).to(dev)
    _emit({"phase": "data", "sites": n_sites, "seconds": time.perf_counter() - t0})

    checks = [  # (layout, dtype, accum, compression, k)
        ("soa", "float32", "", "none", 1), ("soa", "float32", "", "none", 8),
        ("soa", "float32", "", "none", 13), ("aosoa", "float32", "", "none", 1),
        ("soa", "bfloat16", "float32", "none", 1), ("soa", "bfloat16", "float32", "none", 8),
        ("soa", "float32", "", "two_row", 1), ("soa", "float32", "", "two_row", 8),
        ("soa", "bfloat16", "", "two_row", 1), ("soa", "bfloat16", "", "none", 8),
        ("aosoa", "bfloat16", "float32", "two_row", 8),
    ]
    max_err = 0.0
    for layout, dtype, accum, comp, k in checks:
        codec = layouts.make_codec(Layout(layout), tile=PAPER_L32.tile, dtype=dtype,
                                   accum_dtype=accum, compression=comp)
        a, b = codec.pack(u).contiguous(), codec.pack_b(b_c).contiguous()
        kw = {"k_iters": k, "accum_dtype": accum or None, "compressed": codec.is_compressed}
        got = su3_matmul.su3_mult_planar(a, b, tile=codec.tile, **kw)
        plain = codec.from_planar_view(
            su3_matmul.su3_mult_planar_plain(codec.planar_view(a), b, **kw), a)
        torch.cuda.synchronize()
        err = torch.max(torch.abs(got.float() - plain.float())).item()
        tol = verify_tolerance(dtype, accum, codec.is_compressed)
        ok = err <= tol and bool(torch.isfinite(got.float()).all())
        max_err = max(max_err, err)
        _emit({"check": "kernel_vs_plain", "layout": layout, "dtype": dtype,
               "accum": accum or dtype, "compression": comp, "k": k,
               "max_abs_err": err, "tol": tol, "bitwise": err == 0.0, "ok": ok})
        if not ok:
            failures.append(f"kernel vs plain {layout}/{dtype}/{accum}/{comp}/k={k}: {err}")

    codec = layouts.make_codec(Layout.SOA, tile=PAPER_L32.tile)
    a, b = codec.pack(u).contiguous(), codec.pack_b(b_c).contiguous()
    chained = su3_matmul.su3_mult_planar(a, b, k_iters=13)
    x = a
    for _ in range(13):
        x = su3_matmul.su3_mult_planar(x, b)
    in_place = a.clone()
    aliased = su3_matmul.su3_mult_planar(in_place, b, k_iters=13, alias=True)
    torch.cuda.synchronize()
    chain_ok = torch.equal(chained, x)
    alias_ok = aliased.data_ptr() == in_place.data_ptr() and torch.equal(in_place, chained)
    _emit({"check": "13-chain bitwise equals 13 single launches (f32)", "ok": chain_ok})
    _emit({"check": "in-place 13-chain equals out-of-place", "ok": alias_ok})
    if not (chain_ok and alias_ok):
        failures.append("13-chain bitwise / in-place check")

    # -- 4. the main path: SU3Engine at PAPER_L32 ---------------------------------
    rows = [
        ("soa f32", PAPER_L32),
        ("aosoa f32", dataclasses.replace(PAPER_L32, layout=Layout.AOSOA)),
        ("soa bf16+acc-f32",
         dataclasses.replace(PAPER_L32, dtype="bfloat16", accum_dtype="float32")),
        ("soa f32 two-row", dataclasses.replace(PAPER_L32, compression="two_row")),
        ("soa f32 host_scatter", dataclasses.replace(PAPER_L32, placement="host_scatter")),
    ]
    _reset_counts()
    for label, cfg in rows:
        engine = SU3Engine(cfg)
        modes = [("run", lambda: engine.run(), cfg.warmups + cfg.iterations)]
        if cfg.placement == "sharded":
            modes.append((f"run_fused({FUSED_K})", lambda: engine.run_fused(FUSED_K, reps=FUSED_REPS),
                          max(1, cfg.warmups) + FUSED_REPS))
        for mode, fn, expected in modes:
            before = su3_matmul.LAUNCHES.count
            r = fn()
            launches = su3_matmul.LAUNCHES.count - before
            row = r.row()
            out = {"row": label, "mode": mode, "verified": row["verified"],
                   "best_ms": row["best_s"] * 1e3, "mean_ms": row["mean_s"] * 1e3,
                   "GBYTES": row["GBYTES"], "GFLOPS": row["GFLOPS"],
                   "bound_ms": None if row["bound_s"] is None else row["bound_s"] * 1e3,
                   "bound_share": row["bound_share"], "launches": launches,
                   "expected_launches": expected, "init_s": row["init_s"],
                   "scatter_s": row["scatter_s"], "plan": row["plan"]}
            ok = launches == expected and row["verified"]
            if not row["verified"] and cfg.is_mixed_precision and mode != "run":
                # su3_bench's fixed point is not one for bf16 B under an f32
                # chain (the reference fails it too): hold the output to the
                # drift that B = bf16(1/3) predicts instead.
                out["drift_matches"] = _drift_matches(engine, FUSED_K, 1 + FUSED_REPS)
                out["note"] = ("bf16(1/3) = 0.333984375: an f32 chain drifts by 1.00195x "
                               "per multiply off the (1,0) fixed point; checked against it")
                ok = launches == expected and out["drift_matches"]
            out["ok"] = ok
            _emit(out)
            if not ok:
                failures.append(f"engine {label} {mode}: {out}")
    main_path_launches = su3_matmul.LAUNCHES.count
    if main_path_launches == 0:
        failures.append("the main path never launched su3_mult_planar")

    # -- 4b. stencil and CG kernels vs their plain versions, L=32 ------------------
    vecs = _stencil_data(rng, n_sites, dev)
    _emit({"phase": "stencil data", "sites": n_sites})
    stencil_err, cg_err = _stencil_kernel_checks(u, vecs, failures)

    # -- 4c. the main path: stencil_step at PAPER_L32 ---------------------------------
    stencil_rows = _stencil_main_path(hw, failures)
    # -- 4d. the main path: cg_solve at PAPER_L32 -------------------------------------
    cg_launches, stencil_cg_launches = _cg_main_path(hw, failures)
    stencil_launches = sum(r["launches"] for r in stencil_rows) + stencil_cg_launches
    if stencil_launches == 0:
        failures.append("the main path never launched su3_stencil_planar")
    if cg_launches == 0:
        failures.append("the main path never launched su3_cg_fused_planar")

    # -- 4e. the main path on 2 and 4 slabs: MeshSpec plans at PAPER_L32 -------------
    slabs = _multislab_phase(u, args.seed, hw, failures)
    main_path_launches += slabs[su3_matmul.LAUNCHES.name]
    stencil_launches += slabs[su3_stencil.STENCIL_LAUNCHES.name]
    cg_launches += slabs[su3_stencil.CG_LAUNCHES.name]
    if not all(slabs.values()):
        failures.append(f"the multi-slab main path left a kernel unlaunched: {slabs}")
    # -- 4e'. the slabs on the ranks of a process group: one NCCL rank, 2 and 4 slabs --
    ranked = _ranked_slab_phase(u, args.seed, failures)
    main_path_launches += ranked[su3_matmul.LAUNCHES.name]
    stencil_launches += ranked[su3_stencil.STENCIL_LAUNCHES.name]
    cg_launches += ranked[su3_stencil.CG_LAUNCHES.name]
    if not all(ranked.values()):
        failures.append(f"the ranked-slab main path left a kernel unlaunched: {ranked}")
    # -- 4e''. whole-lattice batches over a device list and one NCCL rank ------------------
    batches = _lattice_batch_phase(u, args.seed, hw, failures)
    main_path_launches += batches[su3_matmul.LAUNCHES.name]
    stencil_launches += batches[su3_stencil.STENCIL_LAUNCHES.name]
    cg_launches += batches[su3_stencil.CG_LAUNCHES.name]

    # -- 4f. the serving megakernel vs its plain version, L=32 slot tables ----------
    mega_err = _megakernel_checks(u, rng, failures)
    # -- 4g. the main path: SU3Service in its three dispatch modes --------------------
    mega_launches, svc_counts = _service_main_path(u, rng, failures)
    mega_launches += batches[su3_matmul.MEGA_LAUNCHES.name]
    if mega_launches == 0:
        failures.append("the main path never launched su3_mult_planar_batched")
    stencil_launches += svc_counts["su3_stencil_planar"]
    cg_launches += svc_counts["su3_cg_fused_planar"]

    # -- 5. yardsticks at the main path's shape (SoA f32, k=1, L=32) ----------------
    codec = layouts.make_codec(Layout.SOA, tile=PAPER_L32.tile)
    a, b = codec.pack(u).contiguous(), codec.pack_b(b_c).contiguous()
    kernel_ms = _time_ms(lambda: su3_matmul.su3_mult_planar(a, b), reps=50)
    plain_ms = _time_ms(lambda: su3_matmul.su3_mult_planar_plain(a, b), reps=5, warmup=1)
    b_mat = b_c.contiguous()
    library_ms = _time_ms(lambda: torch.matmul(u, b_mat), reps=20)
    bytes_moved = 2 * a.numel() * a.element_size() + b.numel() * b.element_size()
    ops_done = layouts.TrafficModel(Layout.SOA, n_sites, 4).flops_per_site * n_sites
    bound_ms = bound_by = None
    if hw is not None:  # A read + C written + B read, once each
        bound = roofline.SU3Roofline("su3_mult_planar", hw, flops=ops_done, bytes=bytes_moved)
        bound_ms, bound_by = bound.bound_s * 1e3, bound.bound_by
    _emit({"yardstick": "su3_mult_planar soa f32 k=1 L=32", "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "torch.matmul((S,4,3,3) complex64, (4,3,3) complex64)",
           "bytes": bytes_moved, "flops": ops_done, "bound_ms": bound_ms,
           "kernel_GBps": bytes_moved / kernel_ms / 1e6,
           "bound_share": None if bound_ms is None else bound_ms / kernel_ms})

    # pure bf16 rounds after every operation (as the reference does): time
    # what that costs the multiply, at k=1 and in an 8-chain
    codec = layouts.make_codec(Layout.SOA, tile=PAPER_L32.tile, dtype="bfloat16")
    a16, b16 = codec.pack(u).contiguous(), codec.pack_b(b_c).contiguous()
    bf16_ms = {k: _time_ms(lambda: su3_matmul.su3_mult_planar(a16, b16, k_iters=k), reps=20)
               for k in (1, FUSED_K)}
    bf16_bytes = 2 * a16.numel() * a16.element_size()
    _emit({"yardstick": "su3_mult_planar soa pure bf16 L=32", "k1_ms": bf16_ms[1],
           f"k{FUSED_K}_ms": bf16_ms[FUSED_K],
           "k1_bound_ms": None if hw is None else bf16_bytes / hw.hbm_bw * 1e3,
           "note": "every product, sum and difference rounds to bf16"})
    del a16

    st, cg = _stencil_yardsticks(u, vecs, hw, failures)
    mega = _megakernel_yardsticks(u, rng, hw)
    torch.cuda.empty_cache()
    _emit({"phase": "su3", "seconds": time.perf_counter() - t_su3})

    # -- 5b. the LM phase: the flash kernel, ServeEngine on qwen3-4b -----------------
    t0 = time.perf_counter()
    flash = _lm_phase(args.seed, failures)
    _emit({"phase": "lm", "seconds": time.perf_counter() - t0})

    # -- 5c. the training phase: the flash backward, training qwen3-4b -------------
    # full-width training needs ~70 GB of the card: free the SU3 phases' data
    del u, b_c, a, b, got, plain, vecs, codec, chained, x, in_place, aliased, b_mat, b16
    del engine
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flash_bwd, train_fwd_launches, train_fwd_named = _train_phase(args.seed, failures)
    _emit({"phase": "train", "seconds": time.perf_counter() - t0})
    flash["serve_launches"], flash["train_launches"] = flash["launches"], train_fwd_launches
    flash["launches"] += train_fwd_launches
    flash["launches_by_kernel"][D128_FWD_KERNEL] = (
        flash["launches_by_kernel"].get(D128_FWD_KERNEL, 0) + train_fwd_named)

    # -- 5c'. the mesh phase: qwen3-4b on a (1, 1) NCCL mesh, save, new group, restore ---
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_fwd, mesh_bwd = _mesh_phase(args.seed, failures)
    _emit({"phase": "mesh", "seconds": time.perf_counter() - t0})
    flash["mesh_train_launches"], flash_bwd["mesh_train_launches"] = mesh_fwd, mesh_bwd
    flash["launches"] += mesh_fwd
    flash_bwd["launches"] += mesh_bwd
    for entry, kname, n in ((flash, D128_FWD_KERNEL, mesh_fwd),
                            (flash_bwd, D128_BWD_KERNEL, mesh_bwd)):
        entry["launches_by_kernel"][kname] = entry["launches_by_kernel"].get(kname, 0) + n

    # -- 5d. the MoE phase: granite-moe served and trained, the kernels at D=64 ------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_launches = _moe_phase(args.seed, hw, failures)
    _emit({"phase": "moe", "seconds": time.perf_counter() - t0})
    # granite's, zamba's and whisper's forward launches are flash_group_fwd<64>'s
    # (bf16 at D=64): the kernels line's entry of their own
    flash_d64 = {"launches": moe_launches["serve"] + moe_launches["train_fwd"],
                 "moe_serve_launches": moe_launches["serve"],
                 "moe_train_launches": moe_launches["train_fwd"]}
    # and their backward calls flash_bwd_d64's (bf16 at D=64): an entry of its own
    flash_bwd_d64 = {"launches": moe_launches["train_bwd"],
                     "moe_train_launches": moe_launches["train_bwd"]}

    # -- 5e. the MLA phase: deepseek-v3 served, the kernel at (D, Dv) = (192, 128) ------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flash_mla = _mla_phase(args.seed, hw, failures)
    _emit({"phase": "mla", "seconds": time.perf_counter() - t0})
    # -- 5e'. MLA training: the backward at (192, 128), deepseek-v3's 3 dense layers ----
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    flash_bwd_mla, mla_train_fwd = _mla_train(args.seed, hw, failures)
    _emit({"phase": "mla train", "seconds": time.perf_counter() - t0})
    flash_mla["serve_launches"], flash_mla["train_launches"] = flash_mla["launches"], mla_train_fwd
    flash_mla["launches"] += mla_train_fwd
    # -- 5e''. GPipe over 4 logical stages of qwen3-4b's layers ----------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gpipe = _pipeline_phase(args.seed, failures)
    _emit({"phase": "gpipe", "seconds": time.perf_counter() - t0})
    flash["gpipe_launches"], flash_bwd["gpipe_launches"] = gpipe["fwd"], gpipe["bwd"]
    flash["launches"] += gpipe["fwd"]
    flash_bwd["launches"] += gpipe["bwd"]
    for entry, kname in ((flash, D128_FWD_KERNEL), (flash_bwd, D128_BWD_KERNEL)):
        entry["launches_by_kernel"][kname] = (entry["launches_by_kernel"].get(kname, 0)
                                              + gpipe["by_kernel"].get(kname, 0))
    flash["max_abs_err"] = max(flash["max_abs_err"], gpipe["fwd_err"])
    flash_bwd["max_abs_err"] = max(flash_bwd["max_abs_err"], gpipe["bwd_err"])

    # the one-card runs the mesh state families phase holds its mesh runs against, by
    # arch and part: filled by the xLSTM, whisper and mesh families phases
    twins: dict[str, dict] = {}

    # -- 5f. the zamba phase: zamba2-1.2b served and trained, the kernels at D=64, G=1 ----
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zamba_launches = _zamba_phase(args.seed, hw, failures)
    _emit({"phase": "zamba", "seconds": time.perf_counter() - t0})
    flash_d64["zamba_serve_launches"] = zamba_launches["serve"]
    flash_d64["zamba_train_launches"] = zamba_launches["train_fwd"]
    flash_d64["launches"] += zamba_launches["serve"] + zamba_launches["train_fwd"]
    flash_bwd_d64["zamba_train_launches"] = zamba_launches["train_bwd"]
    flash_bwd_d64["launches"] += zamba_launches["train_bwd"]

    # -- 5g. the xLSTM phase: xlstm-125m served and trained (no kernel of the port) -----
    # its time loops allocate millions of short-lived objects: keep the earlier
    # phases' survivors out of the collector's scans
    torch.cuda.empty_cache()
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    _xlstm_phase(args.seed, hw, failures, twins)
    _emit({"phase": "xlstm", "seconds": time.perf_counter() - t0})

    # -- 5h. the whisper phase: whisper-tiny served and trained, the kernels at its shapes --
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whisper = _whisper_phase(args.seed, hw, failures, twins)
    _emit({"phase": "whisper", "seconds": time.perf_counter() - t0})
    flash_d64["whisper_serve_launches"] = whisper["serve"]
    flash_d64["whisper_train_launches"] = whisper["train_fwd"]
    flash_d64["launches"] += whisper["serve"] + whisper["train_fwd"]
    flash["max_abs_err"] = max(flash["max_abs_err"], whisper["fwd_err"])
    flash_bwd_d64["whisper_train_launches"] = whisper["train_bwd"]
    flash_bwd_d64["launches"] += whisper["train_bwd"]
    flash_bwd["max_abs_err"] = max(flash_bwd["max_abs_err"], whisper["bwd_f32_err"])

    # -- 5h'. the mesh families: MoE and MLA trained, three families served, (1, 1) NCCL --
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fam = _mesh_families_phase(args.seed, failures, twins)
    _emit({"phase": "mesh families", "seconds": time.perf_counter() - t0})
    for entry, kname, parts in (
            (flash, D128_FWD_KERNEL, ("serve",)), (flash_d64, "flash_group_fwd<64>",
                                                   ("train", "serve")),
            (flash_bwd_d64, "flash_bwd_d64", ("train",)),
            (flash_mla, "flash_mla_fwd", ("train", "serve")),
            (flash_bwd_mla, "flash_bwd_dq_mla", ("train",))):
        for part in parts:
            n = fam[part].get(kname, 0)
            entry[f"mesh_families_{part}_launches"] = n
            entry["launches"] += n
            if "launches_by_kernel" in entry:
                entry["launches_by_kernel"][kname] = entry["launches_by_kernel"].get(kname, 0) + n

    # -- 5h''. the mesh state families: Zamba2, xLSTM, Whisper on (1, 1) NCCL, held against
    # their one-card runs; deepseek-v3 on a sequence-sharded cache; the combine ----------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    state_fam = _mesh_state_families_phase(args.seed, failures, twins)
    del twins
    _emit({"phase": "mesh state families", "seconds": time.perf_counter() - t0})
    for entry, kname, parts in ((flash_d64, "flash_group_fwd<64>", ("train", "serve")),
                                (flash_bwd_d64, "flash_bwd_d64", ("train",)),
                                (flash_mla, "flash_mla_fwd", ("serve",))):
        for part in parts:
            n = state_fam[part].get(kname, 0)
            entry[f"mesh_state_families_{part}_launches"] = n
            entry["launches"] += n
            if "launches_by_kernel" in entry:
                entry["launches_by_kernel"][kname] = entry["launches_by_kernel"].get(kname, 0) + n

    # -- 5i. the dry run: the LM cases on meta tensors, the fig7 launch on the card -------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _dryrun_phase(failures)
    _emit({"phase": "dryrun", "seconds": time.perf_counter() - t0})

    # -- 5i'. internvl2-26b, yi-6b, minitron-8b, granite-34b: served, trained at full width ---
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wide = _wide_phase(args.seed, failures)
    _emit({"phase": "wide", "seconds": time.perf_counter() - t0})
    for tag, found in wide.items():
        flash[f"{tag}_serve_launches"] = found["serve"]
        flash[f"{tag}_train_launches"] = found["train_fwd"]
        flash["launches"] += found["serve"] + found["train_fwd"]
        flash_bwd[f"{tag}_train_launches"] = found["train_bwd"]
        flash_bwd["launches"] += found["train_bwd"]
        for entry, kname, named in (
                (flash, D128_FWD_KERNEL, (found["serve_by_kernel"], found["train_by_kernel"])),
                (flash_bwd, D128_BWD_KERNEL, (found["train_by_kernel"],))):
            entry["launches_by_kernel"][kname] = (entry["launches_by_kernel"].get(kname, 0)
                                                  + sum(n.get(kname, 0) for n in named))

    # -- 5i''. the port's tools: the autotune CLI, the examples, the dispatch profiler -----
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _tools_phase(failures)
    _emit({"phase": "tools", "seconds": time.perf_counter() - t0})

    # -- 5j. the D=64 forward at the main paths' shapes, in turns beside SDPA -------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d64_rows = _group_fwd_yardsticks(D64_ROWS, 64, np.random.default_rng(args.seed + 25), hw,
                                     failures)
    granite = d64_rows["5-64"]  # the table's 5-64 row
    budget = flash_attention.kernel_budget(torch.bfloat16, 64, True)
    flash_d64.update(max_abs_err=FLASH_ERRS["flash_group_fwd<64>"], ms=granite["kernel_ms"],
                     plain_ms=granite["plain_ms"], bound_ms=granite["bound_ms"],
                     bound_by=granite["bound_by"], library_ms=granite["library_ms"],
                     graph_ms=granite["kernel_graph_ms"],
                     library_graph_ms=granite["library_graph_ms"],
                     shape="granite-moe-1b-a400m prefill: B=4, S=1,024, Hq=16, Hkv=8, causal",
                     num_regs=budget["num_regs"], shared_bytes=budget["shared_bytes"],
                     local_bytes=budget["local_bytes"])
    # -- 5k. the D=64 backward at the main paths' training shapes, in turns ---------------
    torch.cuda.empty_cache()
    d64_bwd_rows = _group_bwd_yardsticks(D64_BWD_ROWS, 64, np.random.default_rng(args.seed + 26),
                                         hw, failures)
    granite = d64_bwd_rows["5b-64"]  # the table's 5b-64 row
    budget = flash_attention.bwd_budget(torch.bfloat16, 64, True)["dkdv"]  # both roles: one kernel
    flash_bwd_d64.update(max_abs_err=max([whisper["bwd_err"]]
                                         + [r["max_abs_err"] for r in d64_bwd_rows.values()]),
                         ms=granite["kernel_ms"], plain_ms=granite["plain_ms"],
                         bound_ms=granite["bound_ms"], bound_by=granite["bound_by"],
                         library_ms=granite["library_ms"], graph_ms=granite["kernel_graph_ms"],
                         library_graph_ms=granite["library_graph_ms"],
                         kernel_split_ms=granite["kernel_split_ms"],
                         shape="granite-moe-1b-a400m training: B=2, S=1,024, Hq=16, Hkv=8, causal",
                         num_regs=budget["num_regs"], shared_bytes=budget["shared_bytes"],
                         local_bytes=budget["local_bytes"])
    _emit({"phase": "d64 yardsticks", "seconds": time.perf_counter() - t0})
    # -- 5l. D=128 at every G of the registry; its main-path shapes in turns beside SDPA ----
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    d128_err, d128_bwd_err = _d128_registry_checks(np.random.default_rng(args.seed + 27), failures)
    fwd128, bwd128 = _d128_yardsticks(np.random.default_rng(args.seed + 28), hw, failures)
    for entry, row, err, budget in (
            (flash, fwd128, d128_err, flash_attention.kernel_budget(torch.bfloat16, 128, True)),
            (flash_bwd, bwd128, d128_bwd_err,
             flash_attention.bwd_budget(torch.bfloat16, 128, True)["dkdv"])):  # both roles
        entry.update(max_abs_err=max(entry["max_abs_err"], err), ms=row["kernel_ms"],
                     plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                     library_ms=row["library_ms"], graph_ms=row["kernel_graph_ms"],
                     library_graph_ms=row["library_graph_ms"],
                     num_regs=budget["num_regs"], shared_bytes=budget["shared_bytes"],
                     local_bytes=budget["local_bytes"])
    _emit({"phase": "d128", "seconds": time.perf_counter() - t0})
    flash["shape"] = "qwen3-4b prefill: B=4, S=1,024, Hq=32, Hkv=8, causal"
    flash_bwd.update(kernel_split_ms=bwd128["kernel_split_ms"],
                     shape="qwen3-4b training: B=2, S=1,024, Hq=32, Hkv=8, causal")
    for what, entry in (("flash_attention", flash), ("flash_group_fwd<64>", flash_d64),
                        ("flash_attention_bwd", flash_bwd), ("flash_bwd_d64", flash_bwd_d64)):
        if entry["launches"] == 0:
            failures.append(f"the main paths never launched {what}")
    for what, entry, kname in (("flash_attention", flash, D128_FWD_KERNEL),
                               ("flash_attention_bwd", flash_bwd, D128_BWD_KERNEL)):
        if entry["launches_by_kernel"].get(kname, 0) != entry["launches"]:
            failures.append(f"{what}: the D=128 main paths (qwen3-4b, {', '.join(wide)}) ran "
                            f"{entry['launches_by_kernel']}, not {entry['launches']} launches "
                            f"of {kname}")

    # -- 6. the kernels line -----------------------------------------------------------
    _emit({"kernels": [{
        "name": "su3_mult_planar", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_path_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }, {
        "name": "su3_mult_planar_batched", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": MEGA_REPLACES, "launches": mega_launches, "max_abs_err": mega_err, **mega,
    }, {
        "name": "su3_stencil_planar", "route": "cuda", "source": STENCIL_SOURCE,
        "replaces": STENCIL_REPLACES, "launches": stencil_launches, "max_abs_err": stencil_err,
        **st,
    }, {
        "name": "su3_cg_fused_planar", "route": "cuda", "source": STENCIL_SOURCE,
        "replaces": CG_REPLACES, "launches": cg_launches, "max_abs_err": cg_err, **cg,
    }, {
        "name": f"flash_attention (bf16 D=128: {D128_FWD_KERNEL})", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": FLASH_REPLACES, **flash,
    }, {
        "name": "flash_attention (bf16 D=64: flash_group_fwd<64>)", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": FLASH_REPLACES, **flash_d64,
    }, {
        "name": f"flash_attention_bwd (bf16 D=128: flash_bwd_delta_vec<128> + {D128_BWD_KERNEL})",
        "route": "cuda", "source": FLASH_SOURCE, "replaces": BWD_SOURCE_LINE, **flash_bwd,
    }, {
        "name": "flash_attention_bwd (bf16 D=64: flash_bwd_delta_vec<64> + flash_bwd_d64)",
        "route": "cuda", "source": FLASH_SOURCE, "replaces": BWD_SOURCE_LINE, **flash_bwd_d64,
    }, {
        "name": "flash_attention (D=192, Dv=128)", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, **flash_mla,
    }, {
        "name": "flash_attention_bwd (D=192, Dv=128)", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": BWD_SOURCE_LINE, **flash_bwd_mla,
    }]})
    _emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    # the rows the kernels' table compares, side by side (ms; bound by bytes
    # or operations; the (192, 128) backward's three kernels by name)
    _emit({"flash_rows": FLASH_ROWS})

    print(card)  # again, next to the results (the first lines may scroll away)
    if failures:
        for f in failures:
            print(f"FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


STENCIL_FORMS = [  # (label, layout, dtype, accum, compression)
    ("soa f32", "soa", "float32", "", "none"),
    ("aosoa f32", "aosoa", "float32", "", "none"),
    ("soa bf16+acc-f32", "soa", "bfloat16", "float32", "none"),
    ("soa bf16", "soa", "bfloat16", "", "none"),
    ("soa f32 two-row", "soa", "float32", "", "two_row"),
    ("soa bf16 two-row", "soa", "bfloat16", "", "two_row"),
]


def _stencil_data(rng, n_sites: int, dev) -> dict:
    """Random f32 neighbour blocks and vectors on the card, from the seed."""
    import numpy as np
    import torch

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    return {"v_nbr": normal(8, 2, 3, n_sites), "r_nbr": normal(8, 2, 3, n_sites),
            "p_nbr": normal(8, 2, 3, n_sites), "r": normal(2, 3, n_sites),
            "p": normal(2, 3, n_sites),
            "coefs": torch.tensor([[BETA, 16.0]], dtype=torch.float32, device=dev)}


def _stencil_kernel_checks(u, vecs: dict, failures: list[str]) -> tuple[float, float]:
    """Both kernels against their plain versions in every form: bitwise at
    f32 storage, within ``verify_tolerance`` otherwise.  Returns the largest
    error of each kernel."""
    import numpy as np
    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core.su3 import layouts
    from repro_torch.core.su3.plan import verify_tolerance
    from repro_torch.kernels import su3_stencil

    worst = {"su3_stencil_planar": 0.0, "su3_cg_fused_planar": 0.0}
    for label, layout, dtype, accum, comp in STENCIL_FORMS:
        codec = layouts.make_codec(layout, tile=PAPER_L32.tile, dtype=dtype, accum_dtype=accum,
                                   compression=comp)
        u_phys = codec.pack(u).contiguous()
        u_plain = codec.planar_view(u_phys)
        w = {k: (t if k == "coefs" else t.to(codec.word_dtype)) for k, t in vecs.items()}
        kw = {"accum_dtype": accum or None, "compressed": codec.is_compressed}
        got = {"su3_stencil_planar": [su3_stencil.su3_stencil_planar(u_phys, w["v_nbr"], **kw)],
               "su3_cg_fused_planar": list(su3_stencil.su3_cg_fused_planar(
                   u_phys, w["r_nbr"], w["p_nbr"], w["r"], w["p"], w["coefs"], **kw))}
        want = {"su3_stencil_planar": [su3_stencil.su3_stencil_planar_plain(
                    u_plain, w["v_nbr"], **kw)],
                "su3_cg_fused_planar": list(su3_stencil.su3_cg_fused_planar_plain(
                    u_plain, w["r_nbr"], w["p_nbr"], w["r"], w["p"], w["coefs"], **kw))}
        torch.cuda.synchronize()
        tol = verify_tolerance(dtype, accum, codec.is_compressed)
        for name in got:
            err = max(torch.max(torch.abs(g.float() - x.float())).item()
                      for g, x in zip(got[name], want[name]))
            bitwise = all(torch.equal(_bits(g), _bits(x)) for g, x in zip(got[name], want[name]))
            finite = all(bool(torch.isfinite(g.float()).all()) for g in got[name])
            ok = finite and (bitwise if dtype == "float32" else err <= tol)
            worst[name] = max(worst[name], err)
            _emit({"check": "kernel_vs_plain", "kernel": name, "form": label,
                   "max_abs_err": err, "tol": 0.0 if dtype == "float32" else tol,
                   "bitwise": bitwise, "ok": ok})
            if not ok:
                failures.append(f"{name} vs plain {label}: err {err}, bitwise {bitwise}")

    # a random site subset (links and neighbours gathered there) gives the
    # full pass's bits at those sites
    codec = layouts.make_codec("soa", tile=PAPER_L32.tile)
    u_soa = codec.pack(u).contiguous()
    full = su3_stencil.su3_stencil_planar(u_soa, vecs["v_nbr"])
    gen = np.random.default_rng(1)
    idx = torch.from_numpy(gen.permutation(u.shape[0])[: 1 << 18]).to(u.device)
    sub = su3_stencil.su3_stencil_planar(u_soa[:, :, idx].contiguous(),
                                         vecs["v_nbr"][..., idx].contiguous())
    torch.cuda.synchronize()
    subset_ok = torch.equal(_bits(sub), _bits(full[:, :, idx]))
    _emit({"check": "stencil on a random 2^18-site subset equals the full pass (f32)",
           "bitwise": subset_ok, "ok": subset_ok})
    if not subset_ok:
        failures.append("stencil site-subset check")
    return worst["su3_stencil_planar"], worst["su3_cg_fused_planar"]


def _stencil_main_path(hw, failures: list[str]) -> list[dict]:
    """``build_plan`` -> ``init_stencil_data`` -> ``stencil_step`` at
    PAPER_L32 in four forms: counted launches, the fixed point, depth 2
    against two single steps, and the step / gather / kernel times."""
    import dataclasses

    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import roofline
    from repro_torch.core.su3.layouts import Layout
    from repro_torch.core.su3.plan import build_plan
    from repro_torch.kernels import su3_stencil

    rows = [
        ("soa f32", PAPER_L32),
        ("aosoa f32", dataclasses.replace(PAPER_L32, layout=Layout.AOSOA)),
        ("soa bf16+acc-f32", dataclasses.replace(PAPER_L32, dtype="bfloat16",
                                                 accum_dtype="float32")),
        ("soa f32 two-row", dataclasses.replace(PAPER_L32, compression="two_row")),
    ]
    out_rows = []
    for label, cfg in rows:
        plan = build_plan(cfg)
        u_phys, v_p = plan.init_stencil_data()
        step, step2 = plan.stencil_step(), plan.stencil_step(depth=2)
        torch.cuda.synchronize()
        _reset_counts()
        out = step(u_phys, v_p)
        twice = step(u_phys, step(u_phys, v_p))
        depth2 = step2(u_phys, v_p)
        step_ms = _best_ms(lambda: step(u_phys, v_p), STENCIL_REPS)
        calls = 1 + 2 + 2 + 2 + STENCIL_REPS  # single, two singles, depth 2, warmup, timed
        counts = _counts()
        verified = plan.verify_stencil(out)
        depth2_ok = torch.equal(_bits(depth2), _bits(twice))
        # the split, outside the counted window: the gather alone, the kernel alone
        gather_ms = _best_ms(lambda: plan.gather_neighbors(v_p), STENCIL_REPS)
        kernel, kw = plan._stencil_kernel_kwargs()
        v_nbr = plan.gather_neighbors(v_p)
        kernel_ms = _best_ms(lambda: kernel.fn(u_phys, v_nbr, **kw), STENCIL_REPS)
        bound = roofline.stencil_bound(cfg, hw) if hw is not None else None
        gather_bytes = roofline.GATHER_WORDS_PER_SITE * cfg.word_bytes * cfg.shape.n_sites
        row = {"row": label, "mode": "stencil_step", "verified": verified,
               "depth2_equals_two_steps": depth2_ok, "step_ms": step_ms,
               "gather_ms": gather_ms, "kernel_ms": kernel_ms,
               "kernel_GBps": None if bound is None else bound.bytes / kernel_ms / 1e6,
               "bound_ms": None if bound is None else bound.bound_s * 1e3,
               "bound_share": None if bound is None else bound.bound_s * 1e3 / kernel_ms,
               "step_bound_ms": None if bound is None else
               (bound.bytes + gather_bytes) / hw.hbm_bw * 1e3,
               "launches": counts[su3_stencil.STENCIL_LAUNCHES.name],
               "expected_launches": calls, "plan": plan.describe()}
        row["step_bound_share"] = (None if bound is None else row["step_bound_ms"] / step_ms)
        row["ok"] = verified and depth2_ok and row["launches"] == calls and \
            counts[su3_stencil.CG_LAUNCHES.name] == 0
        _emit(row)
        if not row["ok"]:
            failures.append(f"stencil main path {label}: {row}")
        out_rows.append(row)
        del plan, u_phys, v_p, out, twice, depth2, v_nbr
    return out_rows


def _cg_main_path(hw, failures: list[str]) -> tuple[int, int]:
    """``cg_solve`` at PAPER_L32 on the CG measurement problem, fused and
    composed; the oracle on the card; the per-iteration split; one bf16 +
    f32-accumulation row.  Returns the counted fused-kernel launches and the
    stencil launches of the composed solve."""
    import dataclasses

    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import roofline
    from repro_torch.core.autotune import _cg_measure_problem
    from repro_torch.core.su3.plan import build_plan, cg_reference_solve
    from repro_torch.kernels import su3_stencil

    L, max_iters = PAPER_L32.L, 200
    t0 = time.perf_counter()
    u_np, b_np = _cg_measure_problem(L)
    _emit({"phase": "cg data", "L": L, "seconds": time.perf_counter() - t0})
    plan = build_plan(PAPER_L32)
    u_phys, b_p = plan.pack_gauge(u_np), plan.pack_rhs(b_np)

    solves, counts = {}, {}
    for fused in (True, False):
        torch.cuda.synchronize()
        _reset_counts()
        solves[fused] = plan.cg_solve(u_phys, b_p, fused=fused, max_iters=max_iters)
        torch.cuda.synchronize()
        counts[fused] = _counts()
    res, comp = solves[True], solves[False]
    dispatched = res.iterations + (1 if res.iterations < max_iters else 0)
    fused_launches = counts[True][su3_stencil.CG_LAUNCHES.name]
    composed_launches = counts[False][su3_stencil.STENCIL_LAUNCHES.name]
    bitwise = (res.residuals == comp.residuals and res.iterations == comp.iterations
               and torch.equal(_bits(res.x_p), _bits(comp.x_p)))

    u_c = torch.from_numpy(u_np).to(plan.device)
    b_c = torch.from_numpy(b_np).to(plan.device)
    _x, oracle, oracle_conv = cg_reference_solve(u_c, b_c, L, max_iters=max_iters)
    close = abs(len(oracle) - res.iterations) <= 1 and all(
        abs(g - w) <= 1e-2 * w for g, w in zip(res.residuals, oracle) if w > 1e-5)
    del u_c, b_c, _x
    row = {"row": "cg soa f32", "mode": "cg_solve", "converged": res.converged,
           "iterations": res.iterations, "residuals": res.residuals,
           "fused_equals_composed_bitwise": bitwise,
           "oracle_iterations": len(oracle), "oracle_residuals": oracle,
           "oracle_converged": oracle_conv, "matches_oracle": close,
           "launches": fused_launches, "expected_launches": dispatched,
           "composed_stencil_launches": composed_launches, "wall_s": res.wall_s}
    row["ok"] = (res.converged and bitwise and close and fused_launches == dispatched
                 and composed_launches == dispatched
                 and counts[True][su3_stencil.STENCIL_LAUNCHES.name] == 0
                 and counts[False][su3_stencil.CG_LAUNCHES.name] == 0)
    _emit(row)
    if not row["ok"]:
        failures.append(f"cg main path: {row}")

    # per-iteration split, outside the counted windows
    state = plan.cg_state_init(b_p)
    for _ in range(2):
        state = plan.cg_iterate(u_phys, state)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CG_TIMED_ITERS):
        state = plan.cg_iterate(u_phys, state)
    end.record()
    torch.cuda.synchronize()
    iter_ms = start.elapsed_time(end) / CG_TIMED_ITERS
    r, p = state["r"], state["p"]
    coefs = plan._cg_helpers()["coef"](state["beta"], 16.0)
    gathers_ms = _best_ms(lambda: (plan.gather_neighbors(r, "r"), plan.gather_neighbors(p, "p")),
                          STENCIL_REPS)
    kernel, kw = plan._stencil_kernel_kwargs("cuda_cg")
    r_nbr, p_nbr = plan.gather_neighbors(r, "r"), plan.gather_neighbors(p, "p")
    kernel_ms = _best_ms(lambda: kernel.fn(u_phys, r_nbr, p_nbr, r, p, coefs, **kw),
                         STENCIL_REPS)
    split = {"row": "cg soa f32", "mode": "cg_iterate split", "iteration_ms": iter_ms,
             "kernel_ms": kernel_ms, "gathers_ms": gathers_ms,
             "rest_ms": iter_ms - kernel_ms - gathers_ms}
    if hw is not None:
        terms = roofline.cg_iteration_bound(PAPER_L32, hw)
        split.update({f"bound_{k}_ms": t.bound_s * 1e3 for k, t in terms.items()})
        split["bound_share"] = terms["total"].bound_s * 1e3 / iter_ms
        split["kernel_bound_share"] = terms["kernel"].bound_s * 1e3 / kernel_ms
    _emit(split)
    del plan, u_phys, b_p, state, r_nbr, p_nbr

    # bf16 storage with f32 accumulation, held to benchmarks/cg_solve.py's TOL_BF16
    cfg = dataclasses.replace(PAPER_L32, dtype="bfloat16", accum_dtype="float32")
    plan = build_plan(cfg)
    torch.cuda.synchronize()
    _reset_counts()
    bf = plan.cg_solve(plan.pack_gauge(u_np), plan.pack_rhs(b_np), tol=2e-2, max_iters=max_iters)
    torch.cuda.synchronize()
    bf_launches = _counts()[su3_stencil.CG_LAUNCHES.name]
    bf_dispatched = bf.iterations + (1 if bf.iterations < max_iters else 0)
    bf_row = {"row": "cg soa bf16+acc-f32", "mode": "cg_solve", "tol": 2e-2,
              "converged": bf.converged, "iterations": bf.iterations,
              "residuals": bf.residuals, "launches": bf_launches,
              "expected_launches": bf_dispatched,
              "ok": bf.converged and bf_launches == bf_dispatched}
    _emit(bf_row)
    if not bf_row["ok"]:
        failures.append(f"cg bf16 row: {bf_row}")
    return fused_launches + bf_launches, composed_launches


def _stencil_yardsticks(u, vecs: dict, hw, failures: list[str]) -> tuple[dict, dict]:
    """Kernel, plain-version and library times of both kernels at SoA f32,
    L=32, on the random data; the entries of the kernels line."""
    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import roofline
    from repro_torch.core.su3 import layouts
    from repro_torch.kernels import su3_stencil

    codec = layouts.make_codec("soa", tile=PAPER_L32.tile)
    u_soa = codec.pack(u).contiguous()
    v_nbr, r_nbr, p_nbr = vecs["v_nbr"], vecs["r_nbr"], vecs["p_nbr"]
    r, p, coefs = vecs["r"], vecs["p"], vecs["coefs"]
    st_ms = _time_ms(lambda: su3_stencil.su3_stencil_planar(u_soa, v_nbr), reps=50)
    st_plain = _time_ms(lambda: su3_stencil.su3_stencil_planar_plain(u_soa, v_nbr), reps=3,
                        warmup=1)
    # the library yardstick: [U_mu ; U_mu^dagger] and the 8 neighbour vectors
    # as complex64, contracted by one einsum (the same function of the
    # gathered inputs; the port never calls it)
    ut = u.transpose(0, 1)  # (4, S, 3, 3)
    w = torch.cat([ut, ut.conj_physical().transpose(-1, -2)]).contiguous()
    vc = torch.complex(v_nbr[:, 0], v_nbr[:, 1]).transpose(1, 2).contiguous()  # (8, S, 3)
    lib = torch.einsum("dskl,dsl->sk", w, vc)
    st_lib = _time_ms(lambda: torch.einsum("dskl,dsl->sk", w, vc), reps=10)
    kern = su3_stencil.su3_stencil_planar(u_soa, v_nbr)
    lib_err = torch.max(torch.abs(torch.complex(kern[0], kern[1]).T - lib)).item()
    del w, vc, lib
    cg_ms = _time_ms(lambda: su3_stencil.su3_cg_fused_planar(u_soa, r_nbr, p_nbr, r, p, coefs),
                     reps=50)
    cg_plain = _time_ms(lambda: su3_stencil.su3_cg_fused_planar_plain(
        u_soa, r_nbr, p_nbr, r, p, coefs), reps=3, warmup=1)
    st_bound = cg_bound = None
    if hw is not None:
        st_bound = roofline.stencil_bound(PAPER_L32, hw)
        cg_bound = roofline.cg_iteration_bound(PAPER_L32, hw)["kernel"]
    out = {"yardstick": "su3_stencil_planar / su3_cg_fused_planar soa f32 L=32",
           "stencil_ms": st_ms, "stencil_plain_ms": st_plain, "stencil_library_ms": st_lib,
           "library_call": 'torch.einsum("dskl,dsl->sk", W (8,S,3,3) c64, V (8,S,3) c64)',
           "library_max_abs_diff": lib_err, "cg_ms": cg_ms, "cg_plain_ms": cg_plain,
           "cg_library_ms": None}
    if hw is not None:
        out.update(stencil_bound_ms=st_bound.bound_s * 1e3,
                   stencil_bound_share=st_bound.bound_s * 1e3 / st_ms,
                   stencil_GBps=st_bound.bytes / st_ms / 1e6,
                   cg_bound_ms=cg_bound.bound_s * 1e3,
                   cg_bound_share=cg_bound.bound_s * 1e3 / cg_ms,
                   cg_GBps=cg_bound.bytes / cg_ms / 1e6)
    _emit(out)
    if not lib_err <= 1e-4:
        failures.append(f"library yardstick disagrees with the stencil kernel: {lib_err}")

    def entry(ms, plain_ms, bound, library_ms):
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": None if bound is None else bound.bound_s * 1e3,
                "bound_by": None if bound is None else bound.bound_by}

    return entry(st_ms, st_plain, st_bound, st_lib), entry(cg_ms, cg_plain, cg_bound, None)


MEGA_FORMS = [  # (label, layout, dtype, accum, compression)
    ("soa f32", "soa", "float32", "", "none"),
    ("aosoa f32", "aosoa", "float32", "", "none"),
    ("soa bf16+acc-f32", "soa", "bfloat16", "float32", "none"),
    ("soa bf16", "soa", "bfloat16", "", "none"),
    ("soa f32 two-row", "soa", "float32", "", "two_row"),
    ("soa bf16 two-row", "soa", "bfloat16", "", "two_row"),
]


def _slot_lattices(u, n: int):
    """``n`` distinct random SU(3) lattices from ``u`` (S, 4, 3, 3): slot s
    holds ``u`` rolled by s * 997 sites, made on the card."""
    import torch

    return [torch.roll(u, s * 997, 0) for s in range(n)]


def _megakernel_checks(u, rng, failures: list[str]) -> float:
    """The megakernel against its plain version in every form at L=32 on a
    slot table with mixed depths ``SLOT_K`` (bitwise), a slot's chain
    against single launches, in place against out of place, and the
    multiply's batch axis (``BatchedLatticeRunner.run``) against per-lattice
    launches.  Returns the largest error."""
    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core.su3 import layouts
    from repro_torch.core.su3.plan import BatchedLatticeRunner
    from repro_torch.kernels import su3_matmul

    slots = len(SLOT_K)
    lattices = _slot_lattices(u, slots)
    b_c = torch.from_numpy(random_su3(rng, (slots, layouts.LINKS))).to(u.device)
    ks = torch.tensor(SLOT_K, dtype=torch.int32, device=u.device)
    worst = 0.0
    for label, layout, dtype, accum, comp in MEGA_FORMS:
        codec = layouts.make_codec(layout, tile=PAPER_L32.tile, dtype=dtype, accum_dtype=accum,
                                   compression=comp)
        a = torch.stack([codec.pack(x) for x in lattices]).contiguous()
        b = torch.stack([codec.pack_b(x) for x in b_c]).contiguous()
        kw = {"max_k": MAX_K, "accum_dtype": accum or None, "compressed": codec.is_compressed}
        got = su3_matmul.su3_mult_planar_batched(a, b, ks, tile=codec.tile, **kw)
        want = su3_matmul.su3_mult_planar_batched_plain(a, b, ks, **kw)
        in_place = a.clone()
        su3_matmul.su3_mult_planar_batched(in_place, b, ks, tile=codec.tile, alias=True, **kw)
        torch.cuda.synchronize()
        err = torch.max(torch.abs(got.float() - want.float())).item()
        bitwise = torch.equal(_bits(got), _bits(want))
        alias_ok = torch.equal(_bits(in_place), _bits(got))
        row = {"check": "megakernel_vs_plain", "form": label, "slot_k": SLOT_K,
               "max_abs_err": err, "bitwise": bitwise, "in_place_equals": alias_ok}
        if label == "soa f32":  # slot chains against single launches
            chains_ok = True
            for s, k in enumerate(SLOT_K):
                x = a[s]
                for _ in range(min(k, MAX_K)):
                    x = su3_matmul.su3_mult_planar(x, b[s], tile=codec.tile)
                chains_ok = chains_ok and torch.equal(_bits(x), _bits(got[s]))
            row["chains_equal_single_launches"] = chains_ok
            bitwise = bitwise and chains_ok
        row["ok"] = bitwise and alias_ok
        worst = max(worst, err)
        _emit(row)
        if not row["ok"]:
            failures.append(f"megakernel vs plain {label}: {row}")
        del a, b, got, want, in_place

    runner = BatchedLatticeRunner(PAPER_L32, u.device)
    a = runner.pack_batch(torch.stack(lattices[:4]))
    b = runner.pack_b_batch(b_c[:4])
    before = su3_matmul.LAUNCHES.count
    batch = runner.run(a, b, k=3)
    one_launch = su3_matmul.LAUNCHES.count - before == 1
    singles = [runner.plan.fused_step(3)(a[s].clone(), b[s]) for s in range(4)]
    torch.cuda.synchronize()
    ok = one_launch and all(torch.equal(_bits(batch[s]), _bits(x)) for s, x in enumerate(singles))
    _emit({"check": "BatchedLatticeRunner.run (one launch, k=3) equals per-lattice launches",
           "one_launch": one_launch, "ok": ok})
    if not ok:
        failures.append("batch-axis run vs per-lattice launches")
    return worst


def _service_main_path(u, rng, failures: list[str]) -> tuple[int, dict[str, int]]:
    """``SU3Service`` on one seeded stream in each dispatch mode: 8
    multiplies (L=16 first, then L=32 while those are in flight), then a
    stencil batch and a CG solve at L=32.  Autotuned against a fresh cache
    under ``build/`` (the first mode sweeps, the others read the cache).
    Returns the megakernel's launches in the megakernel mode's multiply
    window, and the stencil and CG launches of the three stencil+solve
    windows."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.core import autotune
    from repro_torch.core.su3 import layouts
    from repro_torch.serve.su3 import BatcherConfig, ServiceConfig, SU3Service

    small_L, big_L = SERVICE_LS  # u holds big_L**4 sites
    cache = ROOT / "build" / "chip_smoke_autotune"
    shutil.rmtree(cache, ignore_errors=True)
    big = _slot_lattices(u, 4)
    small = [x[: small_L**4].contiguous() for x in _slot_lattices(u, 4)]
    lattices = [iter(small), iter(big)]
    requests = [(next(lattices[i]), SERVICE_LS[i], k) for i, k in SERVICE_STREAM]
    b_c = torch.from_numpy(random_su3(rng, (len(requests), layouts.LINKS))).to(u.device)
    u_cg, rhs_cg = (torch.from_numpy(x).to(u.device)
                    for x in autotune._cg_measure_problem(big_L))
    v_st = [torch.from_numpy((rng.standard_normal((big_L**4, 3))
                              + 1j * rng.standard_normal((big_L**4, 3))).astype(np.complex64)
                             ).to(u.device) for _ in range(2)]
    modes = {"batch": {}, "continuous": {"continuous": True},
             "megakernel": {"continuous": True, "megakernel": True}}
    mega_launches = 0
    side = {"su3_stencil_planar": 0, "su3_cg_fused_planar": 0}
    tuned = {}
    for mode, flags in modes.items():
        svc = SU3Service(ServiceConfig(
            autotune=True, cache_directory=str(cache), chain_slots=TABLE_SLOTS,
            batcher=BatcherConfig(max_batch=TABLE_SLOTS, warm_batch_sizes=(1, 2, 4, 8)),
            **flags), device=u.device)
        swept = not autotune.load_cache(str(cache))
        t0 = time.perf_counter()
        svc.warm(SERVICE_LS)  # set-up: the autotune sweep (first mode) and first touch
        tuned[mode] = {"warm_s": time.perf_counter() - t0, "swept": swept, **{
            f"L{L}": {k: autotune.best_config(L=L, cache_directory=str(cache), device=u.device)[k]
                      for k in ("tile", "fused_k")} for L in SERVICE_LS}}
        torch.cuda.synchronize()
        # -- the multiply stream: counts from 0 --------------------------------
        _reset_counts()
        t0 = time.perf_counter()
        ids = [svc.submit(a, b_c[i], k=k) for i, (a, L, k) in enumerate(requests)
               if L == small_L]
        svc.step()
        ids += [svc.submit(a, b_c[i], k=k) for i, (a, L, k) in enumerate(requests)
                if L == big_L]
        grew = None
        if mode == "megakernel":
            svc.step()
            table, arrays = svc._tables[0]
            grew = arrays.cap_L == big_L and any(
                r.L == small_L for _s, r, _k in table.occupants())
        svc.run_until_drained()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = _counts()
        snap = svc.metrics.snapshot()
        results = [svc.pop_result(i) for i in ids]
        # -- held against the chained single-step path (outside the window) ----
        bitwise = True
        for i, ((a, L, k), got) in enumerate(zip(requests, results)):
            runner = svc.runner_for(L)
            x = runner.pack_batch(a[None])[0]
            b_p = runner.plan.codec.pack_b(b_c[i])
            for _ in range(k):
                x = runner.plan.step(x, b_p)
            want = runner.plan.unpack(x)
            bitwise = bitwise and got.shape == want.shape and torch.equal(
                torch.view_as_real(got).view(torch.int32),
                torch.view_as_real(want).view(torch.int32))
        row = {"row": "service", "mode": mode, "completed": snap["completed"],
               "dispatches": snap["dispatches"], "iterations": snap["iterations"],
               "midchain_admits": snap["midchain_admits"], "launches": counts,
               "dispatch_wall_ms": snap["busy_s"] / max(1, snap["dispatches"]) * 1e3,
               "stream_wall_ms": wall_s * 1e3, "bitwise_vs_chained_steps": bitwise}
        expected = {"batch": "su3_mult_planar", "continuous": "su3_mult_planar",
                    "megakernel": "su3_mult_planar_batched"}[mode]
        ok = (snap["completed"] == len(requests) and bitwise
              and counts[expected] == snap["dispatches"]
              and sum(counts.values()) == counts[expected])
        if mode == "megakernel":
            mega_launches = counts["su3_mult_planar_batched"]
            row["table_grew_in_flight"] = grew
            ok = ok and grew
            table = svc._tables[0][1]
            ks1 = [1] * table.slots
            row["megakernel_ms_per_launch"] = _time_ms(lambda: table.advance(ks1), reps=20)
        # -- a stencil batch and a solve at L=32: counts from 0 ------------------
        torch.cuda.synchronize()
        _reset_counts()
        before_iters = snap["kind_iterations"].get("solve", 0)
        st_ids = [svc.submit_stencil(big[i], v_st[i]) for i in range(2)]
        cg_id = svc.submit_solve(u_cg, rhs_cg, tol=1e-6, max_iters=200)
        svc.run_until_drained()
        torch.cuda.synchronize()
        c2 = _counts()
        iters = svc.metrics.snapshot()["kind_iterations"]["solve"] - before_iters
        for name in side:
            side[name] += c2[name]
        plan = svc.runner_for(big_L).plan
        st_ok = all(torch.equal(
            torch.view_as_real(svc.pop_result(sid)).view(torch.int32),
            torch.view_as_real(plan.unpack_vec(plan.stencil_step()(
                plan.pack_gauge(big[i]), plan.pack_rhs(v_st[i])))).view(torch.int32))
            for i, sid in enumerate(st_ids))
        x_svc = svc.pop_result(cg_id)
        ref = plan.cg_solve(plan.pack_gauge(u_cg), plan.pack_rhs(rhs_cg), tol=1e-6)
        x_ref = plan.unpack_vec(ref.x_p)
        rel = (torch.linalg.vector_norm(x_svc - x_ref) / torch.linalg.vector_norm(x_ref)).item()
        row.update({"stencil_launches": c2["su3_stencil_planar"], "stencil_bitwise": st_ok,
                    "solve_iterations": iters, "cg_launches": c2["su3_cg_fused_planar"],
                    "cg_solve_iterations": ref.iterations, "solve_rel_diff": rel})
        ok = ok and st_ok and c2["su3_stencil_planar"] == 2 and \
            c2["su3_cg_fused_planar"] == iters and rel <= 1e-5
        row["ok"] = ok
        _emit(row)
        if not ok:
            failures.append(f"service {mode}: {row}")
        del svc, results
    _emit({"autotune": tuned, "cache": str(cache.relative_to(ROOT))})
    return mega_launches, side


def _megakernel_yardsticks(u, rng, hw) -> dict:
    """The megakernel on a full table of TABLE_SLOTS L=32 slots (SoA f32),
    in place, at uniform k=1 and k=8; its plain version and one batched
    complex64 ``torch.matmul`` step at k=1; the bound of each launch; and
    the cost of one small launch (the autotune model's launch term)."""
    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import roofline
    from repro_torch.core.su3 import layouts
    from repro_torch.kernels import su3_matmul

    codec = layouts.make_codec("soa", tile=PAPER_L32.tile)
    lattices = _slot_lattices(u, TABLE_SLOTS)
    b_c = torch.from_numpy(random_su3(rng, (TABLE_SLOTS, layouts.LINKS))).to(u.device)
    a = torch.stack([codec.pack(x) for x in lattices]).contiguous()
    b = torch.stack([codec.pack_b(x) for x in b_c]).contiguous()
    dev, n = u.device, u.shape[0]
    ks = {k: torch.full((TABLE_SLOTS,), k, dtype=torch.int32, device=dev) for k in (1, 8)}
    ms = {k: _time_ms(lambda k=k: su3_matmul.su3_mult_planar_batched(
        a, b, ks[k], tile=codec.tile, alias=True), reps=20) for k in (1, 8)}
    plain_ms = _time_ms(lambda: su3_matmul.su3_mult_planar_batched_plain(a, b, ks[1]), reps=2,
                        warmup=1)
    del a
    a_c = torch.stack(lattices)  # (slots, S, 4, 3, 3) complex64
    b_m = b_c[:, None].contiguous()  # (slots, 1, 4, 3, 3)
    library_ms = _time_ms(lambda: torch.matmul(a_c, b_m), reps=3, warmup=1)
    del a_c, lattices
    # the launch cost: one 256-site slot, in place, host clock and events
    a_t = torch.zeros((1, 2, 36, 256), device=dev)
    b_t, k_t = torch.zeros((1, 2, 36), device=dev), torch.ones(1, dtype=torch.int32, device=dev)
    launch = lambda: su3_matmul.su3_mult_planar_batched(a_t, b_t, k_t, tile=256, alias=True)  # noqa: E731
    event_us = _time_ms(launch, reps=200, warmup=20) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        launch()
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    bounds = {k: roofline.megakernel_bound([k] * TABLE_SLOTS, n_sites=n, hw=hw) if hw else None
              for k in (1, 8)}
    out = {"yardstick": f"su3_mult_planar_batched soa f32 L=32, {TABLE_SLOTS} slots, in place",
           "k1_ms": ms[1], "k8_ms": ms[8], "plain_k1_ms": plain_ms, "library_k1_ms": library_ms,
           "library_call": "torch.matmul((8,S,4,3,3) c64, (8,1,4,3,3) c64)",
           "launch_cost_us": {"host": host_us, "events": event_us}}
    if hw is not None:
        out.update({f"k{k}_bound_ms": bnd.bound_s * 1e3 for k, bnd in bounds.items()})
        out.update({f"k{k}_bound_by": bnd.bound_by for k, bnd in bounds.items()})
        out.update({f"k{k}_bound_share": bounds[k].bound_s * 1e3 / ms[k] for k in ms})
    _emit(out)
    bound = bounds[1]
    return {"ms": ms[1], "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": None if bound is None else bound.bound_s * 1e3,
            "bound_by": None if bound is None else bound.bound_by}


def _flash_checks(rng, failures: list[str], forms=FLASH_FORMS) -> float:
    """The flash kernel against its plain version on the card in every form
    of ``forms``, within ``kernel_tolerance`` (f32 summation order; one
    bf16 output rounding).  Returns the largest absolute error."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    dev, worst = torch.device("cuda"), 0.0
    for label, b, sq, skv, hq, hkv, d, causal, q_offset, dtype in forms:
        dt = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)).to(dev, dt)
                   for shp in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
        got = fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
        want = fa.flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
        torch.cuda.synchronize()
        atol, rtol = fa.kernel_tolerance(dt)
        diff = torch.abs(got.float() - want.float())
        err = diff.max().item()
        ok = bool(torch.isfinite(got.float()).all()) and bool(
            (diff <= atol + rtol * torch.abs(want.float())).all())
        worst = max(worst, err)
        kernel = fa.kernel_name(dt, d)
        FLASH_ERRS[kernel] = max(FLASH_ERRS.get(kernel, 0.0), err)
        _emit({"check": "kernel_vs_plain", "kernel": "flash_attention", "form": label,
               "shape": [b, sq, skv, hq, hkv, d], "causal": causal, "q_offset": q_offset,
               "dtype": dtype, "max_abs_err": err, "atol": atol, "rtol": rtol, "ok": ok})
        if not ok:
            failures.append(f"flash_attention vs plain {label}: err {err}")
        del q, k, v, got, want, diff
    return worst


def _profile(fn, top: int = 6, cpu: bool = True) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time between
    CUDA events, the device time summed over its kernels, the device's idle
    share of the wall, device ms and launches by kernel class, and the
    kernels that took the most device time (by name, ms).  Device time is
    None where the profiler records none.  ``cpu=False`` records the
    device's activity alone: a call of a million eager launches (an xLSTM
    training step) would record several host events for each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3  # noqa: E731  (us -> ms)
    device_ms = sum(dev(e) for e in kernels) or None
    ranked = sorted(kernels, key=dev, reverse=True)[:top]
    by_class: dict[str, float] = {}
    launches_by_class: dict[str, int] = {}
    for e in kernels:
        by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + dev(e)
        launches_by_class[_kernel_class(e.key)] = \
            launches_by_class.get(_kernel_class(e.key), 0) + e.count
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": None if device_ms is None else max(0.0, 1.0 - device_ms / wall_ms),
            "kernel_launches": sum(e.count for e in kernels),
            "device_ms_by_class": by_class, "launches_by_class": launches_by_class,
            "top_kernels": [[e.key[:60], dev(e), e.count] for e in ranked]}


def _kernel_class(name: str) -> str:
    """The port's kernels by name; cuBLAS's matrix products (``nvjet``,
    ``gemm``, ``cutlass``); every other kernel (elementwise passes,
    reductions, copies) as ``other``."""
    if "flash_bwd" in name:
        return "flash_attention_bwd"
    if any(tag in name for tag in ("flash_attention", "flash_mla_fwd", "flash_group_fwd")):
        return "flash_attention"
    if any(tag in name.lower() for tag in ("nvjet", "gemm", "cutlass", "xmma")):
        return "matmul"
    return "other"


def _lm_phase(seed: int, failures: list[str]) -> dict:
    """The LM serving path on the card: the flash kernel's forms, then
    ``ServeEngine`` on full-width qwen3-4b (random bf16 weights from the
    seed) serving 4 x 1,024-token prompts + 32 greedy tokens, with the
    flash counter set to 0 just before and read just after; decode logits
    against a teacher-forced prefill; the card against the port's CPU path
    at 2 layers in f32.  Returns the flash entry of the kernels line (its
    times come from ``_d128_yardsticks``, row 5, at the end)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, registry, transformer
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    rng = np.random.default_rng(seed + 14)
    max_err = _flash_checks(rng, failures)
    dev = torch.device("cuda")

    # -- the main path ------------------------------------------------------------
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed), cfg,
                                   torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, model, ServeConfig(max_len=LM_MAX_LEN), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, LM_NEW)
    first_s = time.perf_counter() - t0
    counts = _counts()
    launches = counts[fa.LAUNCHES.name]
    by_kernel = _by_kernel()
    # the same call again, timed in steady state, with the peak memory
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = engine.generate(prompts, LM_NEW)
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tm = engine.last_timings
    # prefill alone, then the 31 decode steps on the served tokens, through
    # the engine's own calls, each counted from 0
    toks_d = torch.from_numpy(tokens).to(dev)
    state = engine.init_state(LM_BATCH)
    _reset_counts()
    logits_p, state = engine.prefill({"tokens": toks_d[:, :LM_PROMPT]}, state)
    torch.cuda.synchronize()
    prefill_launches = _counts()[fa.LAUNCHES.name]
    step_logits = [logits_p]
    _reset_counts()
    for t in range(LM_NEW - 1):
        lg, state = engine.decode(toks_d[:, LM_PROMPT + t:LM_PROMPT + t + 1], state,
                                  LM_PROMPT + t)
        step_logits.append(lg)
    torch.cuda.synchronize()
    decode_launches = _counts()[fa.LAUNCHES.name]
    # where the time goes: one prefill, and 4 decode steps from the filled cache
    prof_state = engine.init_state(LM_BATCH)
    prof_prefill = _profile(lambda: engine.prefill({"tokens": toks_d[:, :LM_PROMPT]}, prof_state))

    def four_steps():
        for t in range(4):
            engine.decode(toks_d[:, LM_PROMPT + t:LM_PROMPT + t + 1], prof_state, LM_PROMPT + t)

    prof_decode = _profile(four_steps)
    _emit({"profile": "lm prefill (4 x 1,024 tokens)", **prof_prefill})
    _emit({"profile": "lm decode (4 steps)", **prof_decode})
    del prof_state
    served = torch.cat(step_logits, dim=1).float()  # (B, 32, V): positions 1023 .. 1054
    # teacher forcing: one prefill-style forward over prompt + generated tokens
    x, _, _ = transformer.forward(engine.params, {"tokens": toks_d[:, :-1]}, cfg,
                                  q_chunk=512, kv_chunk=1024)
    teacher = transformer._logits(engine.params, x[:, LM_PROMPT - 1:], cfg).float()
    torch.cuda.synchronize()
    diff = torch.abs(served - teacher)
    scale = torch.abs(teacher).max().item()
    teacher_err = diff.max().item()
    token_agree = float((served.argmax(-1) == teacher.argmax(-1)).float().mean().item())
    finite = bool(torch.isfinite(served).all()) and bool(torch.isfinite(teacher).all())
    new_tok = LM_BATCH * LM_NEW
    row = {"row": "lm serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": common.count_params(engine.params), "dtype": cfg.dtype,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
           "max_len": LM_MAX_LEN, "init_s": init_s, "first_generate_s": first_s,
           "flash_launches": launches, "expected_launches": cfg.n_layers,
           "prefill_launches": prefill_launches, "decode_launches": decode_launches,
           "other_launches": sum(counts.values()) - launches,
           "flash_launches_by_kernel": by_kernel,
           "prefill_ms": tm["prefill_s"] * 1e3,
           "decode_ms_per_token": tm["decode_s"] * 1e3 / tm["decode_steps"],
           "generate_wall_ms": wall_s * 1e3, "new_tokens_per_s": new_tok / wall_s,
           "decode_tokens_per_s": LM_BATCH * tm["decode_steps"] / tm["decode_s"],
           "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / tm["prefill_s"],
           "peak_memory_GB": peak_gb, "same_tokens_twice": bool(np.array_equal(tokens, again)),
           "prefill_idle_share": prof_prefill["idle_share"],
           "decode_idle_share": prof_decode["idle_share"],
           "logits_finite": finite, "teacher_max_abs_diff": teacher_err,
           "teacher_mean_abs_diff": diff.mean().item(), "teacher_logit_scale": scale,
           "teacher_tol": LM_TEACHER_TOL * scale, "teacher_token_agreement": token_agree}
    row["ok"] = (launches == cfg.n_layers and prefill_launches == cfg.n_layers
                 and by_kernel == {D128_FWD_KERNEL: cfg.n_layers}
                 and decode_launches == 0 and row["other_launches"] == 0 and finite
                 and tokens.shape == (LM_BATCH, LM_PROMPT + LM_NEW)
                 and teacher_err <= LM_TEACHER_TOL * scale)
    _emit(row)
    if not row["ok"]:
        failures.append(f"lm serve main path: {row}")
    del engine, model, state, x, teacher, served, step_logits, logits_p, diff
    torch.cuda.empty_cache()

    # -- the card against the port's CPU path: full width, 2 layers, f32 ----------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    _serve_cross_device("lm cross-device", cfg2,
                        registry.get(cfg2).init(torch.Generator().manual_seed(seed), cfg2), rng,
                        failures)

    return {"launches": launches, "launches_by_kernel": by_kernel, "max_abs_err": max_err}


def _state_leaves(state, prefix: str = "") -> list:
    """(path, tensor) of every tensor in a decode state (nested dicts and
    lists), in a fixed order."""
    import torch

    if isinstance(state, torch.Tensor):
        return [(prefix, state)]
    items = sorted(state.items()) if isinstance(state, dict) else enumerate(state)
    return [leaf for key, value in items for leaf in _state_leaves(value, f"{prefix}/{key}")]


def _serve_cross_device(row_name: str, cfg2, model2, rng, failures: list[str]) -> None:
    """The card against the port's CPU path on ``model2`` (``cfg2`` in f32,
    TF32 off): 8 greedy tokens after a prompt of 64 tokens on each (an
    encoder-decoder's on the same seeded frames; a VLM's on the same seeded
    patches, after its ``n_patches`` positions), then the CPU's tokens
    prefilled and decoded on both: logits within LM_CROSS_TOL, every leaf
    of the state after the last decode step (KV or latent caches, Mamba2 or
    xLSTM states, cross K/V) within LM_CROSS_TOL of its largest magnitude,
    and every MoE layer's expert choices (``moe._route``) equal; the host's
    memory over the check (``_watch_host_memory``)."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import moe, registry
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    host_memory = _watch_host_memory()
    plen = 64 + cfg2.n_patches
    cpu = ServeEngine(cfg2, copy.deepcopy(model2), ServeConfig(max_len=plen + 16), device="cpu")
    card = ServeEngine(cfg2, model2, ServeConfig(max_len=plen + 16), device=torch.device("cuda"))
    prompt2 = rng.integers(0, cfg2.vocab_size, (1, plen), dtype=np.int32)
    extras = {}
    if cfg2.is_encoder_decoder:
        extras["frames"] = rng.standard_normal((1, cfg2.encoder_len, cfg2.d_model),
                                               dtype=np.float32)
    if cfg2.n_patches:
        extras["patches"] = rng.standard_normal((1, cfg2.n_patches, cfg2.d_model),
                                                dtype=np.float32)
    cpu_tokens = cpu.generate(prompt2, 8, extras=extras or None)
    card_tokens = card.generate(prompt2, 8, extras=extras or None)
    logits, routes, states = [], [], []
    for eng in (cpu, card):
        t = torch.from_numpy(cpu_tokens).to(eng.device)
        st = eng.init_state(1)
        routes.append([])
        with _wrapped(moe, "_route", _recording_routes(routes[-1])):
            lg, st = eng.prefill({"tokens": t[:, :plen], **{
                k: torch.from_numpy(v).to(eng.device) for k, v in extras.items()}}, st)
            out = [lg]
            for i in range(7):
                lg, st = eng.decode(t[:, plen + i:plen + i + 1], st, plen + i)
                out.append(lg)
        logits.append(torch.cat(out, dim=1).float().cpu())
        states.append(_state_leaves(st))
    err = torch.abs(logits[0] - logits[1]).max().item()
    n_moe = registry.get(cfg2).stack_sizes(cfg2).get("moe_layers", 0)
    same_routes = len(routes[0]) == len(routes[1]) == 8 * n_moe and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(*routes))
    row = {"row": row_name, "arch": cfg2.name, "n_layers": cfg2.n_layers, "dtype": cfg2.dtype,
           "tf32": torch.backends.cuda.matmul.allow_tf32, "prompt": plen, "new_tokens": 8,
           "max_abs_logit_diff": err, "tol": LM_CROSS_TOL,
           "logit_scale": logits[0].abs().max().item(), "routes_compared": len(routes[0]),
           "same_routes": same_routes, "same_tokens": bool(np.array_equal(cpu_tokens, card_tokens)),
           **host_memory()}
    shares = {name: (b.cpu().double() - a.double()).abs().max().item()
              / max(a.double().abs().max().item(), 1e-30)
              for (name, a), (_, b) in zip(states[0], states[1])}
    worst = max(shares, key=shares.get)
    row.update(state_leaves=len(shares), worst_state_leaf=worst,
               worst_state_err_of_max=shares[worst])
    row["ok"] = (err <= LM_CROSS_TOL and same_routes and not row["tf32"]
                 and len(states[0]) == len(states[1]) and shares[worst] <= LM_CROSS_TOL)
    _emit(row)
    if not row["ok"]:
        failures.append(f"{row_name}: {row}")


def _train_cross_device(row_name: str, cfg2, model, seed: int, failures: list[str],
                        seq: int = TRAIN_CROSS_SEQ) -> None:
    """One step's loss and gradients on ``model`` (trainable, on the CPU;
    ``cfg2`` in f32), the card against the CPU on TRAIN_BATCH x ``seq``
    seeded tokens, TF32 off: the loss within
    TRAIN_CROSS_LOSS_TOL (relative), each gradient within
    TRAIN_CROSS_GRAD_TOL of its leaf's largest magnitude (an element near
    zero carries the rounding of the terms that cancelled in it), and
    every MoE layer's expert choices (forward and remat recompute)
    equal; the host's memory over the check, ``model`` already on the CPU
    at its start (``_watch_host_memory``)."""
    import copy

    import torch

    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.models import moe, registry
    from repro_torch.train import train_step

    host_memory = _watch_host_memory()
    card_model = copy.deepcopy(model).to(torch.device("cuda"))
    pipe = TokenPipeline(DataConfig(cfg2.vocab_size, seq, TRAIN_BATCH, seed=seed))
    found, routes = {}, {}
    for name, m in (("cpu", model), ("card", card_model)):
        batch, _ = make_train_batch(pipe, PipelineState(), cfg2, device=next(m.parameters()).device)
        routes[name] = []
        with _wrapped(moe, "_route", _recording_routes(routes[name])):
            grads, metrics = train_step.make_grad_fn(cfg2, q_chunk=seq, kv_chunk=seq)(m, batch)
        found[name] = ({n: g.cpu() for n, g in grads.items()},
                       {k: v.item() for k, v in metrics.items()})
        del grads
    del model, card_model
    (g_cpu, m_cpu), (g_card, m_card) = found["cpu"], found["card"]
    loss_rel = abs(m_card["loss"] - m_cpu["loss"]) / abs(m_cpu["loss"])
    tree_max = max(g.abs().max().item() for g in g_cpu.values())
    leaf_errs = {n: (g_card[n] - g).abs().max().item()
                 / max(g.abs().max().item(), 1e-30)
                 for n, g in g_cpu.items()}
    worst_leaf = max(leaf_errs, key=leaf_errs.get)
    worst5 = [[n, leaf_errs[n], g_cpu[n].abs().max().item() / tree_max]
              for n in sorted(leaf_errs, key=leaf_errs.get, reverse=True)[:5]]
    router_errs = [e for n, e in leaf_errs.items() if n.endswith("moe.router")]
    n_moe = registry.get(cfg2).stack_sizes(cfg2).get("moe_layers", 0)
    same_routes = len(routes["cpu"]) == len(routes["card"]) == 2 * n_moe and all(
        torch.equal(a.cpu(), b.cpu()) for a, b in zip(routes["cpu"], routes["card"]))
    row = {"row": row_name, "arch": cfg2.name, "n_layers": cfg2.n_layers, "dtype": cfg2.dtype,
           "tf32": torch.backends.cuda.matmul.allow_tf32, "batch": TRAIN_BATCH,
           "seq": seq, "loss_cpu": m_cpu["loss"], "loss_card": m_card["loss"],
           "aux_cpu": m_cpu.get("aux"), "aux_card": m_card.get("aux"), "loss_rel_diff": loss_rel,
           "loss_tol": TRAIN_CROSS_LOSS_TOL, "leaves": len(leaf_errs), "worst_leaf": worst_leaf,
           "worst_leaf_err_of_max": leaf_errs[worst_leaf],
           "worst_leaves_err_and_max_of_tree": worst5,
           "router_err_of_max": max(router_errs) if router_errs else None,
           "grad_tol_of_max": TRAIN_CROSS_GRAD_TOL,
           "routes_compared": len(routes["cpu"]),
           "same_routes": same_routes, **host_memory()}
    row["ok"] = (loss_rel <= TRAIN_CROSS_LOSS_TOL and not row["tf32"] and same_routes
                 and leaf_errs[worst_leaf] <= TRAIN_CROSS_GRAD_TOL)
    _emit(row)
    if not row["ok"]:
        failures.append(f"{row_name}: {row}")


def _resume_check(row_name: str, cfg2, seed: int, failures: list[str]) -> None:
    """``train.loop.train`` on ``cfg2`` on the card: 4 steps straight
    against 2 steps + checkpoint (under ``build/``) + restore + 2: losses,
    aux, parameters and moments bitwise."""
    import shutil

    import torch

    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop

    dev = torch.device("cuda")
    ckpt_dir = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    quiet = lambda line: None  # noqa: E731

    def resume_cfg(n: int, directory: str | None):
        return loop.TrainConfig(steps=n, seq_len=TRAIN_CROSS_SEQ, global_batch=TRAIN_BATCH,
                                log_every=1, seed=seed, checkpoint_dir=directory,
                                checkpoint_every=100,
                                opt=AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=4))

    t0 = time.perf_counter()
    straight = loop.train(cfg2, resume_cfg(4, None), log=quiet, device=dev)
    first_hist = loop.train(cfg2, resume_cfg(2, str(ckpt_dir)), log=quiet, device=dev)["history"]
    torch.cuda.empty_cache()
    resumed = loop.train(cfg2, resume_cfg(4, str(ckpt_dir)), log=quiet, device=dev)
    same_params = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        straight["params"].named_parameters(), resumed["params"].named_parameters()))
    same_moments = all(torch.equal(straight["opt_state"][k][n], resumed["opt_state"][k][n])
                       for k in ("m", "v") for n in straight["opt_state"][k])
    curves = {key: ([h[key] for h in straight["history"]],
                    [h[key] for h in first_hist + resumed["history"]])
              for key in ("loss", "aux") if key in straight["history"][0]}  # the hybrid has no aux
    row = {"row": row_name, "arch": cfg2.name, "n_layers": cfg2.n_layers, "dtype": cfg2.dtype,
           "losses_straight": curves["loss"][0], "losses_resumed": curves["loss"][1],
           "aux_straight": curves.get("aux", (None,))[0],
           "aux_resumed": curves.get("aux", (None, None))[1],
           "params_bitwise": same_params, "moments_bitwise": same_moments,
           "seconds": time.perf_counter() - t0}
    row["ok"] = same_params and same_moments and all(a == b for a, b in curves.values())
    _emit(row)
    if not row["ok"]:
        failures.append(f"{row_name}: {row}")
    del straight, resumed
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()


def _bwd_checks(rng, failures: list[str], forms=BWD_FORMS) -> float:
    """The flash backward kernel against its plain version on the card in
    every form of ``forms``, within ``kernel_tolerance`` scaled to each
    gradient's largest magnitude (``flash_attention.kernel_tolerance``
    states the rule); each form twice, bitwise; the forward's ``out`` with
    lse against without it (bitwise) and its lse against the plain
    version's (within 1e-5 + 1e-5 relative: f32 sums in another order).
    Returns the largest absolute error of dq, dk and dv."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    dev, worst = torch.device("cuda"), 0.0
    for label, b, sq, skv, hq, hkv, d, causal, q_offset, dtype in forms:
        d, dv = d if isinstance(d, tuple) else (d, d)  # (D, Dv) where they differ
        dt = getattr(torch, dtype)
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)).to(dev, dt)
                         for shp in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv),
                                     (b, sq, hq, dv)))
        if label.endswith("dout strided"):
            wide = torch.zeros((b, sq, hq, 2 * d), dtype=dt, device=dev)
            wide[..., :d] = dout
            dout = wide[..., :d]
        kw = dict(causal=causal, q_chunk=512, kv_chunk=1024, q_offset=q_offset)
        bare, _ = fa._forward(q, k, v, with_lse=False, **kw)
        out, lse = fa._forward(q, k, v, with_lse=True, **kw)
        _, lse_plain = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, q_offset=q_offset)
        again = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal, q_offset=q_offset)
        want = fa.flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        torch.cuda.synchronize()
        atol, rtol = fa.kernel_tolerance(dt)
        row = {"check": "kernel_vs_plain", "kernel": "flash_attention_bwd", "form": label,
               "shape": [b, sq, skv, hq, hkv, d, dv], "causal": causal, "q_offset": q_offset,
               "dtype": dtype, "dout_strides": list(dout.stride()), "atol": atol,
               "rtol_of_max": rtol}
        ok = True
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
            row[f"{name}_max_abs_err"], row[f"{name}_max"] = err, scale
            row[f"{name}_share_of_limit"] = err / (atol + rtol * scale)
            ok = ok and err <= atol + rtol * scale and bool(torch.isfinite(g.float()).all())
            worst = max(worst, err)
        row["bitwise_twice"] = all(torch.equal(x, y) for x, y in zip(got, again))
        row["out_bitwise_with_lse"] = torch.equal(out, bare)
        lse_diff = (lse - lse_plain).abs()
        row["lse_max_abs_err"] = lse_diff.max().item()
        lse_ok = bool((lse_diff <= 1e-5 + 1e-5 * lse_plain.abs()).all())
        row["ok"] = ok and row["bitwise_twice"] and row["out_bitwise_with_lse"] and lse_ok
        _emit(row)
        if not row["ok"]:
            failures.append(f"flash_attention_bwd vs plain {label}: {row}")
        del q, k, v, dout, bare, out, lse, lse_plain, got, again, want
    return worst


def _train_phase(seed: int, failures: list[str]) -> tuple[dict, int, int]:
    """The training path on the card: the backward kernel's checks; then
    ``train.loop.train`` on full-width, full-depth qwen3-4b (f32 master
    weights and moments, bf16 compute, remat; ~68 GB of the card) for
    TRAIN_STEPS steps with the counters set to 0 just before and read just
    after; one more step profiled, and one split into gradients and
    optimizer; one step's
    loss and gradients, the card against the CPU, at 2 layers in f32; 4
    steps straight against 2 + checkpoint + restore + 2, bitwise, on the
    card.  Returns the backward's entry of the kernels line (its times come
    from ``_d128_yardsticks``, row 5b, at the end), the forward launches of
    the training run and those of them that ran the D=128 forward kernel."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, registry
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop, train_step

    rng = np.random.default_rng(seed + 17)
    max_err = _bwd_checks(rng, failures)
    dev = torch.device("cuda")
    base = get_config(LM_ARCH)
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    tcfg = loop.TrainConfig(steps=TRAIN_STEPS, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            log_every=1, seed=seed, opt=opt)

    # -- the main path: full width and depth ----------------------------------------------
    cfg, log_lines = base, []
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = loop.train(cfg, tcfg, log=log_lines.append, device=dev)
    wall_s = time.perf_counter() - t0
    counts, by_kernel = _counts(), _by_kernel()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd, bwd = counts[fa.LAUNCHES.name], counts[fa.BWD_LAUNCHES.name]
    for line in log_lines:
        print(f"train: {line}")
    hist, step_ms = out["history"], out["step_ms"]
    for h, ms in zip(hist, step_ms):
        _emit({"train_step": h["step"], "loss": h["loss"], "grad_norm": h["grad_norm"],
               "lr": h["lr"], "step_ms": ms})
    params, opt_state = out["params"], out["opt_state"]
    del out
    n_params = common.count_params(params)
    # where the time goes: one more step under the profiler
    step_fn = train_step.make_train_step(cfg, opt, q_chunk=512, kv_chunk=1024)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed))
    batch, _ = make_train_batch(pipe, PipelineState(step=TRAIN_STEPS), cfg, device=dev)
    prof = _profile(lambda: step_fn(params, opt_state, batch), top=10)
    _emit({"profile": f"lm train step ({TRAIN_BATCH} x {TRAIN_SEQ} tokens)", **prof})
    # the step split, unprofiled: gradients (forward, remat recompute, backward)
    # and then the optimizer, between CUDA events
    grad_fn = train_step.make_grad_fn(cfg, q_chunk=512, kv_chunk=1024)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    grads, _ = grad_fn(params, batch)
    marks[1].record()
    adamw.update(grads, opt_state, params, opt)
    marks[2].record()
    torch.cuda.synchronize()
    grad_ms, opt_ms = marks[0].elapsed_time(marks[1]), marks[1].elapsed_time(marks[2])
    del params, opt_state, batch, step_fn, grads
    torch.cuda.empty_cache()

    losses, gnorms = [h["loss"] for h in hist], [h["grad_norm"] for h in hist]
    start = _start_nll(cfg)
    median_ms = float(np.median(step_ms[1:]))
    steps = len(hist)
    row = {"row": "lm train", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size, "params": n_params,
           "master_dtype": "float32", "moment_dtype": opt.moment_dtype,
           "compute_dtype": cfg.dtype, "remat": True, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": steps, "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
           "step_ms_median_2_5": median_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median_ms * 1e3,
           "split_grad_ms": grad_ms, "split_optimizer_ms": opt_ms,
           "peak_memory_GB": peak_gb, "wall_s": wall_s,
           "flash_launches": fwd, "flash_bwd_launches": bwd, "flash_launches_by_kernel": by_kernel,
           "flash_launches_per_step": fwd / steps, "flash_bwd_launches_per_step": bwd / steps,
           "expected_per_step": [2 * cfg.n_layers, cfg.n_layers],
           "other_launches": sum(counts.values()) - fwd - bwd,
           "idle_share": prof["idle_share"], "start_loss": losses[0],
           "start_loss_target": start, "start_loss_tol": TRAIN_START_TOL}
    row["ok"] = (steps == TRAIN_STEPS and all(math.isfinite(x) for x in losses + gnorms)
                 and abs(losses[0] - start) <= TRAIN_START_TOL
                 and fwd == 2 * cfg.n_layers * steps and bwd == cfg.n_layers * steps
                 and by_kernel == {D128_FWD_KERNEL: fwd, D128_BWD_KERNEL: bwd}
                 and row["other_launches"] == 0)
    _emit(row)
    if not row["ok"]:
        failures.append(f"lm train main path: {row}")

    # -- one step's loss and gradients: the card against the CPU, 2 layers, f32 -------
    cfg2 = dataclasses.replace(base, n_layers=2, dtype="float32")
    _train_cross_device("lm train cross-device", cfg2, common.trainable(
        registry.get(cfg2).init(torch.Generator().manual_seed(seed), cfg2)), seed, failures)

    # -- resume: 4 steps straight against 2 + checkpoint + restore + 2, on the card ----
    _resume_check("lm train resume", cfg2, seed, failures)

    return ({"launches": bwd, "launches_per_step": bwd / steps, "max_abs_err": max_err,
             "launches_by_kernel": {D128_BWD_KERNEL: by_kernel.get(D128_BWD_KERNEL, 0)}},
            fwd, by_kernel.get(D128_FWD_KERNEL, 0))


def _mesh_phase(seed: int, failures: list[str]) -> tuple[int, int]:
    """qwen3-4b at full width (``MESH_LAYERS`` layers: ``MESH_REDUCED``),
    bf16 compute, f32 weights and moments, 2 x 1,024 tokens a step, trained
    on a ``MESH_SHAPE`` mesh of one NCCL rank: ``MESH_STEPS[0]`` steps and a
    checkpoint, the process group destroyed, a new group and mesh, the
    checkpoint restored onto it, ``MESH_STEPS[1]`` more steps; against
    ``train.loop.train`` on the card without a mesh over the same steps
    from the same seeded weights.  Returns the mesh runs' D=128 forward and
    backward launches (counted by kernel name between the counters' reset
    just before the first mesh run and the read just after the second)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshes
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=MESH_LAYERS)
    total = sum(MESH_STEPS)
    ckpt_dir = ROOT / "build" / "chip_smoke_mesh_checkpoints"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    quiet = lambda line: None  # noqa: E731

    def tcfg(steps: int, directory=None):
        return loop.TrainConfig(steps=steps, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                log_every=1, seed=seed, checkpoint_dir=directory,
                                checkpoint_every=100,
                                opt=AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=total))

    t0 = time.perf_counter()
    one = loop.train(cfg, tcfg(total), log=quiet, device=dev)

    def on_new_mesh(run):
        store = tempfile.mkdtemp(dir=ROOT / "build")
        meshes.init_distributed("cuda", init_method=f"file://{store}/store", rank=0,
                                world_size=1)
        try:
            return run(meshes.make_mesh(MESH_SHAPE, MESH_AXES))
        finally:
            torch.distributed.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)

    _reset_counts()
    first = on_new_mesh(lambda mesh: loop.train(cfg, tcfg(MESH_STEPS[0], str(ckpt_dir)),
                                                log=quiet, mesh=mesh))
    first_hist, first_ms = first["history"], first["step_ms"]
    del first
    torch.cuda.empty_cache()
    t_restart = time.perf_counter()
    second = on_new_mesh(lambda mesh: loop.train(cfg, tcfg(total), log=quiet, mesh=mesh,
                                                 restore_dir=str(ckpt_dir)))
    counts, by_kernel = _counts(), _by_kernel()
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    mesh_hist = first_hist + second["history"]
    pairs = [(n, a.detach().to_local(), b.detach()) for (n, a), (_, b) in zip(
        second["params"].named_parameters(), one["params"].named_parameters())]
    pairs += [(f"{k}/{n}", second["opt_state"][k][n].to_local(), one["opt_state"][k][n])
              for k in ("m", "v") for n in one["opt_state"][k]]
    bitwise = all(torch.equal(a, b) for _, a, b in pairs)
    leaf_errs = {n: float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(
        1e-30)) for n, a, b in pairs}
    worst = max(leaf_errs, key=leaf_errs.get)
    losses_one = [h["loss"] for h in one["history"]]
    losses_mesh = [h["loss"] for h in mesh_hist]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses_mesh, losses_one))
    fwd, bwd = counts["flash_attention"], counts["flash_attention_bwd"]
    expected = {D128_FWD_KERNEL: 2 * cfg.n_layers * total, D128_BWD_KERNEL: cfg.n_layers * total}
    row = {"row": "mesh train", "arch": cfg.name, "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
           "backend": "nccl", "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "reduced": MESH_REDUCED, "compute_dtype": cfg.dtype,
           "master_dtype": "float32", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": list(MESH_STEPS), "losses_mesh": losses_mesh, "losses_one_card": losses_one,
           "grad_norms_mesh": [h["grad_norm"] for h in mesh_hist],
           "grad_norms_one_card": [h["grad_norm"] for h in one["history"]],
           "mesh_step_ms": first_ms + second["step_ms"], "one_card_step_ms": one["step_ms"],
           "bitwise": bitwise, "leaves_compared": len(pairs), "max_loss_rel_err": loss_err,
           "worst_leaf": worst, "worst_leaf_err": leaf_errs[worst],
           "flash_launches_by_kernel": by_kernel, "expected_launches_by_kernel": expected,
           "other_launches": sum(counts.values()) - fwd - bwd,
           "restart_s": time.perf_counter() - t_restart, "seconds": time.perf_counter() - t0}
    row["ok"] = (len(losses_mesh) == total
                 and (bitwise or (loss_err <= MESH_LOSS_TOL and leaf_errs[worst] <= MESH_LEAF_TOL))
                 and by_kernel == expected and fwd == expected[D128_FWD_KERNEL]
                 and bwd == expected[D128_BWD_KERNEL] and row["other_launches"] == 0)
    print(f"mesh train: mesh step ms {row['mesh_step_ms']}, one-card step ms "
          f"{row['one_card_step_ms']}")
    _emit(row)
    if not row["ok"]:
        failures.append(f"mesh train: {row}")
    del one, second, pairs
    torch.cuda.empty_cache()
    return fwd, bwd


def _fingerprint(t) -> tuple[int, float]:
    """A tensor's bits in two numbers: the int64 sum of its words (as
    int32 or int16) and the f64 sum of its values; equal bits give equal
    numbers, and two runs' leaves compare without both on the card."""
    import torch

    t = t.detach()
    t = (t.to_local() if hasattr(t, "to_local") else t).contiguous()
    words = t.view(torch.int32 if t.element_size() == 4 else torch.int16)
    return int(words.sum(dtype=torch.int64)), float(t.sum(dtype=torch.float64))


def _run_fingerprints(run: dict) -> dict[str, tuple[int, float]]:
    """Every parameter's and AdamW moment's :func:`_fingerprint` of a
    ``train.loop.train`` result."""
    out = {n: _fingerprint(p) for n, p in run["params"].named_parameters()}
    for k in ("m", "v"):
        out.update({f"{k}/{n}": _fingerprint(x) for n, x in run["opt_state"][k].items()})
    return out


def _mesh_families_phase(seed: int, failures: list[str],
                         twins: dict) -> dict[str, dict[str, int]]:
    """The MoE and MLA families on the mesh path, one NCCL rank on a
    MESH_SHAPE mesh (``file://`` store under ``build/``): granite-moe at
    full width and depth and deepseek-v3 on its 3 dense layers + MTP
    (MLA_TRAIN_REDUCED) trained MESH_FAMILY_STEPS steps through
    ``train.loop.train(mesh=...)`` against ``train.loop.train`` on the card
    from the same seeded weights (``_mesh_family_train``); qwen3-4b
    (MESH_LAYERS), granite-moe and deepseek-v3 (MLA_LAYERS) served,
    prefill + MESH_FAMILY_NEW tokens, through ``ServeEngine(...,
    mesh=...)`` against ``ServeEngine`` without one on the same weights
    (``_mesh_family_serve``).  Returns the mesh runs' flash launches by
    kernel name: ``train`` and ``serve``, each counted from 0 just before
    a mesh run and read just after.  ``twins`` takes each served arch's
    one-card run (``_mesh_family_serve``'s ``keep``)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshes

    rng = np.random.default_rng(seed + 31)
    store = tempfile.mkdtemp(dir=ROOT / "build")
    meshes.init_distributed("cuda", init_method=f"file://{store}/store", rank=0, world_size=1)
    found = {"train": {}, "serve": {}}

    def add(part: str, by_kernel: dict[str, int]) -> None:
        for k, n in by_kernel.items():
            found[part][k] = found[part].get(k, 0) + n

    try:
        mesh = meshes.make_mesh(MESH_SHAPE, MESH_AXES)
        mla_train = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_TRAIN_LAYERS,
                                        n_dense_layers=MLA_TRAIN_LAYERS)
        for cfg, reduced in ((get_config(MOE_ARCH), {}), (mla_train, MLA_TRAIN_REDUCED)):
            add("train", _mesh_family_train(cfg, reduced, seed, mesh, failures))
            torch.cuda.empty_cache()
        for cfg, reduced in (
                (dataclasses.replace(get_config(LM_ARCH), n_layers=MESH_LAYERS), MESH_REDUCED),
                (get_config(MOE_ARCH), {}),
                (dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS), MLA_REDUCED)):
            add("serve", _mesh_family_serve(cfg, reduced, seed, mesh, rng, failures,
                                            keep=twins.setdefault(cfg.name, {}).setdefault(
                                                "serve", {})))
            torch.cuda.empty_cache()
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return found


def _mesh_family_train(cfg, reduced: dict, seed: int, mesh, failures: list[str],
                       per_step: dict | None = None) -> dict:
    """``cfg`` (bf16 compute, f32 weights and moments, TRAIN_BATCH x
    TRAIN_SEQ tokens a step) trained MESH_FAMILY_STEPS steps on the card,
    its state fingerprinted and freed (two deepseek-v3 states do not fit
    the card), then on ``mesh`` against it (``_mesh_twin_train``: the
    "mesh family train" row); the flash launches by kernel name held
    against ``per_step`` a step (by default a rematted decoder-only
    stack's: two forwards and one backward a layer).  Returns them."""
    import torch

    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import loop

    tcfg = loop.TrainConfig(steps=MESH_FAMILY_STEPS, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                            log_every=1, seed=seed,
                            opt=AdamWConfig(peak_lr=3e-4, warmup_steps=2,
                                            total_steps=MESH_FAMILY_STEPS))
    gc.collect()  # the last run's cycles, so the peak below is this run's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = loop.train(cfg, tcfg, log=lambda line: None, device=torch.device("cuda"))
    torch.cuda.synchronize()
    twin = {"tcfg": tcfg, "history": run["history"], "step_ms": run["step_ms"],
            "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
            "fingerprints": _run_fingerprints(run)}
    del run
    mtp = cfg.mtp_depth
    if per_step is None:
        per_step = {_kernel_of(cfg): 2 * cfg.n_layers + mtp,
                    _kernel_of(cfg, True): cfg.n_layers + mtp}
    return _mesh_twin_train(cfg, reduced, twin, mesh, per_step, failures, "the card, before")


def _kernel_of(cfg, backward: bool = False) -> str:
    """The flash kernel (forward or backward, by the name the counters use)
    of ``cfg``'s attention in bf16."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    if cfg.use_mla:
        return fa.kernel_name(torch.bfloat16, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                              cfg.v_head_dim, backward=backward)
    return fa.kernel_name(torch.bfloat16, cfg.head_dim, backward=backward)


def _mesh_family_serve(cfg, reduced: dict, seed: int, mesh, rng, failures: list[str],
                       expected: dict | None = None, keep: dict | None = None) -> dict:
    """``cfg`` (bf16 weights from the seed, f32 caches) served to LM_BATCH
    prompts of LM_PROMPT tokens + MESH_FAMILY_NEW tokens by ``ServeEngine``
    on the card, twice (the second timed warm), and its prefill's logits
    kept (in ``keep``, else a dict of its own, as ``_keep_served`` keeps
    them); then by ``ServeEngine(..., mesh=mesh)`` on the same weights
    (placed on the (1, 1) mesh without a copy) against it
    (``_mesh_twin_serve``: the "mesh family serve" row).  The mesh run's
    peak holds one transient copy of a layer's weights gathered over
    ``data`` (FSDP's all-gather, which allocates on a one-rank mesh too).
    Returns the first mesh run's flash launches by kernel name, held
    against ``expected`` (by default one launch a layer in prefill, none
    in decode)."""
    import numpy as np
    import torch

    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    dev = torch.device("cuda")
    model = registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed), cfg,
                                   torch.bfloat16)
    scfg = ServeConfig(max_len=LM_PROMPT + MESH_FAMILY_NEW)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    engine = ServeEngine(cfg, model, scfg, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tokens = engine.generate(prompts, MESH_FAMILY_NEW)
    engine.generate(prompts, MESH_FAMILY_NEW)
    warm = engine.last_timings
    logits, _ = engine.prefill({"tokens": torch.from_numpy(prompts).to(dev)},
                               engine.init_state(LM_BATCH))
    twin = keep if keep is not None else {}
    twin.update(prompts=prompts, tokens=tokens, prefill_logits=logits[:, -1].float().cpu(),
                max_len=scfg.max_len, new_tokens=MESH_FAMILY_NEW,
                prefill_ms=warm["prefill_s"] * 1e3,
                decode_ms_per_token=warm["decode_s"] * 1e3 / warm["decode_steps"],
                peak_GB=torch.cuda.max_memory_allocated() / 1e9, extras={})
    del engine, logits
    if expected is None:
        expected = {_kernel_of(cfg): cfg.n_layers}  # one a layer in prefill
    return _mesh_twin_serve(cfg, reduced, model, twin, mesh, expected, failures,
                            one_card_run="the card, before")


def _mesh_state_families_phase(seed: int, failures: list[str],
                               twins: dict) -> dict[str, dict[str, int]]:
    """Zamba2, xLSTM and Whisper on the mesh path and decode on a cache
    split along its sequence, one NCCL rank on a MESH_SHAPE mesh
    (``file://`` store under ``build/``): zamba2-1.2b at full width cut to
    ZAMBA_MESH_DEPTH trained MESH_FAMILY_STEPS steps and served against its
    one-card twin (``_mesh_family_train``, ``_mesh_family_serve``);
    xlstm-125m (XLSTM_DEPTH) and whisper-tiny trained and served through
    ``train.loop.train(mesh=...)`` and ``ServeEngine(..., mesh=...)``
    against the one-card runs of their own phases (``twins``: the same
    ``TrainConfig``, seeded weights, prompts and frames); deepseek-v3
    (MLA_LAYERS) served with ``kv_seq_shard=True`` against the mesh
    families phase's one-card run; then the combine at granite-34b's
    decode shape (``_combine_check``).  Returns the mesh runs' flash
    launches by kernel name: ``train`` and ``serve``, each counted from 0
    just before a mesh run and read just after."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import registry, zamba

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 33)
    store = tempfile.mkdtemp(dir=ROOT / "build")
    meshes.init_distributed("cuda", init_method=f"file://{store}/store", rank=0, world_size=1)
    found = {"train": {}, "serve": {}}

    def add(part: str, by_kernel: dict[str, int]) -> None:
        for k, n in by_kernel.items():
            found[part][k] = found[part].get(k, 0) + n
        torch.cuda.empty_cache()

    def init(cfg):
        return registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed), cfg,
                                      torch.bfloat16)

    try:
        mesh = meshes.make_mesh(MESH_SHAPE, MESH_AXES)
        cfg = dataclasses.replace(get_config(ZAMBA_ARCH), **ZAMBA_MESH_DEPTH)
        groups = zamba._counts(cfg)[0]  # the shared block, not rematted: once a step
        add("train", _mesh_family_train(cfg, ZAMBA_MESH_REDUCED, seed, mesh, failures,
                                        per_step={_kernel_of(cfg): groups,
                                                  _kernel_of(cfg, True): groups}))
        add("serve", _mesh_family_serve(cfg, ZAMBA_MESH_REDUCED, seed, mesh, rng, failures,
                                        expected={_kernel_of(cfg): groups}))
        cfg = dataclasses.replace(get_config(XLSTM_ARCH), **XLSTM_DEPTH)
        twin = twins[XLSTM_ARCH]
        add("train", _mesh_twin_train(cfg, XLSTM_REDUCED, twin["train"], mesh, {}, failures))
        add("serve", _mesh_twin_serve(cfg, XLSTM_REDUCED, init(cfg), twin["serve"], mesh, {},
                                      failures))
        cfg = get_config(WHISPER_ARCH)
        n_enc, n_dec, twin = cfg.n_encoder_layers, cfg.n_layers, twins[WHISPER_ARCH]
        add("train", _mesh_twin_train(cfg, {}, twin["train"], mesh,
                                      {_kernel_of(cfg): n_enc + 4 * n_dec,
                                       _kernel_of(cfg, True): n_enc + 2 * n_dec}, failures))
        add("serve", _mesh_twin_serve(cfg, {}, _matrices_at(init(cfg), 0.02, seed),
                                      twin["serve"], mesh, {_kernel_of(cfg): n_enc + 2 * n_dec},
                                      failures))
        cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
        add("serve", _mesh_twin_serve(cfg, MLA_REDUCED, init(cfg), twins[MLA_ARCH]["serve"],
                                      mesh, {_kernel_of(cfg): MLA_LAYERS}, failures,
                                      kv_seq_shard=True))
        _combine_check(rng, failures)
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return found


def _mesh_twin_train(cfg, reduced: dict, twin: dict, mesh, per_step: dict,
                     failures: list[str], one_card_run: str = "its family's phase") -> dict:
    """``train.loop.train(cfg, twin["tcfg"], mesh=mesh)`` against the
    one-card run of the same ``TrainConfig`` that ``twin`` holds (its
    history, step times, peak and fingerprints: ``_train_main_path``'s
    ``keep``; ``one_card_run`` says where it ran): every loss, grad norm
    and leaf and moment fingerprint bitwise; the flash launches by kernel
    name against ``per_step`` a step.  Emits the "mesh family train" row
    and returns the launches."""
    import torch

    from repro_torch.train import loop

    tcfg = twin["tcfg"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    run = loop.train(cfg, tcfg, log=lambda line: None, mesh=mesh)
    torch.cuda.synchronize()
    by_kernel, peak = _by_kernel(), torch.cuda.max_memory_allocated() / 1e9
    fingerprints, hist, step_ms = _run_fingerprints(run), run["history"], run["step_ms"]
    del run
    differ = [n for n, f in twin["fingerprints"].items() if fingerprints.get(n) != f]
    expected = {k: n * tcfg.steps for k, n in per_step.items()}
    row = {"row": "mesh family train", "arch": cfg.name, "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
           "backend": "nccl", "n_layers": cfg.n_layers, "mtp_depth": cfg.mtp_depth,
           "d_model": cfg.d_model, "reduced": reduced, "compute_dtype": cfg.dtype,
           "master_dtype": "float32", "batch": tcfg.global_batch, "seq": tcfg.seq_len,
           "steps": tcfg.steps, "one_card_run": one_card_run,
           "losses_mesh": [h["loss"] for h in hist],
           "losses_one_card": [h["loss"] for h in twin["history"]],
           "grad_norms_mesh": [h["grad_norm"] for h in hist], "mesh_step_ms": step_ms,
           "one_card_step_ms": twin["step_ms"], "mesh_peak_GB": peak,
           "one_card_peak_GB": twin["peak_GB"], "leaves_compared": len(twin["fingerprints"]),
           "leaves_differing": differ[:8],
           "bitwise": (hist == twin["history"] and not differ
                       and len(fingerprints) == len(twin["fingerprints"])),
           "flash_launches_by_kernel": by_kernel, "expected_launches_by_kernel": expected}
    row["ok"] = row["bitwise"] and by_kernel == expected
    print(f"mesh family train {cfg.name}: mesh step ms {step_ms}, one-card {twin['step_ms']}")
    _emit(row)
    if not row["ok"]:
        failures.append(f"mesh family train {cfg.name}: {row}")
    return by_kernel


def _mesh_twin_serve(cfg, reduced: dict, model, twin: dict, mesh, expected: dict,
                     failures: list[str], kv_seq_shard: bool = False,
                     one_card_run: str = "its family's phase") -> dict:
    """``ServeEngine(..., mesh=mesh, kv_seq_shard=...)`` on ``model`` (the
    one-card run's seeded weights) over ``twin``'s prompts (and stub
    inputs), twice, against the one-card run ``twin`` holds
    (``_keep_served``; ``one_card_run`` says where it ran): the tokens
    equal, the prefill's last-position
    logits bitwise, or with ``kv_seq_shard`` (the latents split along their
    sequence: every cache leaf ``Shard(1)`` on the model axis, a combine of
    one part) within SEQ_SHARD_LOGITS_TOL of their max; the first run's
    flash launches by kernel name against ``expected``.  Emits the "mesh
    family serve" row and returns the launches."""
    import numpy as np
    import torch
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import sharding
    from repro_torch.models import common
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    dev = torch.device("cuda")
    engine = ServeEngine(cfg, model, ServeConfig(max_len=twin["max_len"]), mesh=mesh,
                         kv_seq_shard=kv_seq_shard)
    extras = {k: v.to(dev) for k, v in twin["extras"].items()} or None
    prompts, n_new = twin["prompts"], twin["new_tokens"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tokens = engine.generate(prompts, n_new, extras=extras)
    torch.cuda.synchronize()
    by_kernel, first = _by_kernel(), dict(engine.last_timings)
    again = engine.generate(prompts, n_new, extras=extras)
    warm = dict(engine.last_timings)
    state = engine.init_state(prompts.shape[0])
    batch = {"tokens": torch.from_numpy(prompts).to(dev), **(extras or {})}
    logits, state = engine.prefill(batch, state)
    got = sharding.whole(logits)[:, -1].float().cpu()
    leaves = common.tree_leaves(state)
    model_dim = MESH_AXES.index("model")  # the sequence: dim 2 of a stacked (L, B, S, H, D)
    n_split = sum(x.placements[model_dim] == Shard(2 if x.ndim == 5 else 1) for _, x in leaves)
    n_leaves = len(leaves)
    del engine, logits, state, leaves, model
    want = twin["prefill_logits"]
    err = float((got - want).abs().max() / want.abs().max())

    def ms(t: dict) -> dict:
        return {"prefill_ms": t["prefill_s"] * 1e3,
                "decode_ms_per_token": t["decode_s"] * 1e3 / t["decode_steps"]}

    row = {"row": "mesh family serve", "arch": cfg.name, "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
           "backend": "nccl", "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "reduced": reduced, "dtype": "bfloat16", "cache_dtype": "float32",
           "kv_seq_shard": kv_seq_shard, "batch": int(prompts.shape[0]),
           "prompt": int(prompts.shape[1]), "new_tokens": n_new,
           "one_card_run": one_card_run, "mesh_first": ms(first), "mesh_warm": ms(warm),
           "one_card_warm": {"prefill_ms": twin["prefill_ms"],
                             "decode_ms_per_token": twin["decode_ms_per_token"]},
           "mesh_peak_GB": torch.cuda.max_memory_allocated() / 1e9,
           "one_card_peak_GB": twin["peak_GB"],
           "tokens_equal": bool(np.array_equal(tokens, twin["tokens"])
                                and np.array_equal(again, twin["tokens"])),
           "prefill_logits_bitwise": bool(torch.equal(got, want)),
           "prefill_logits_err_of_max": err, "finite": bool(torch.isfinite(got).all()),
           "flash_launches_by_kernel": by_kernel, "expected_launches_by_kernel": expected}
    if kv_seq_shard:
        row.update(logits_tol_of_max=SEQ_SHARD_LOGITS_TOL, state_leaves=n_leaves,
                   leaves_split_along_sequence=n_split)
        close = err <= SEQ_SHARD_LOGITS_TOL and n_split == n_leaves > 0
    else:
        close = row["prefill_logits_bitwise"]
    row["ok"] = row["tokens_equal"] and row["finite"] and close and by_kernel == expected
    print(f"mesh family serve {cfg.name}: mesh {row['mesh_warm']}, one card "
          f"{row['one_card_warm']}")
    _emit(row)
    if not row["ok"]:
        failures.append(f"mesh family serve {cfg.name}: {row}")
    return by_kernel


def _combine_check(rng, failures: list[str]) -> None:
    """``attention.combine_partials`` on the card at granite-34b's decode
    shape (LM_BATCH rows, a cache of LM_MAX_LEN rows, Hq=48 on one kv head
    of 128; a bf16 query, f32 caches, the first decode step's ``cur_len``):
    the partials of COMBINE_PARTS parts (``decode_partial``) combined,
    against the unsplit ``decode_attention`` in f32 within COMBINE_TOL of
    its max, the same bits twice; each timed beside ``decode_attention``.
    Emits the "mesh state families combine" row."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import attention

    dev = torch.device("cuda")
    cfg = get_config("granite-34b")
    b, s, hq, hkv, d = LM_BATCH, LM_MAX_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cur = LM_PROMPT + 1
    q = torch.from_numpy(rng.standard_normal((b, 1, hq, d), dtype=np.float32)).to(dev,
                                                                                torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((b, s, hkv, d), dtype=np.float32)).to(dev)
            for _ in range(2))
    want = attention.decode_attention(q.float(), k, v, cur)[:, 0]
    rows = {}
    for parts in COMBINE_PARTS:
        n = s // parts

        def combined():
            return attention.combine_partials([
                attention.decode_partial(q, k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                                         cur, offset=i * n) for i in range(parts)])

        got, again = combined(), combined()
        rows[str(parts)] = {"err_of_max": float((got - want).abs().max() / want.abs().max()),
                            "bitwise_twice": bool(torch.equal(got, again)),
                            "ms": _time_ms(combined, 20)}
    row = {"row": "mesh state families combine",
           "shape": f"granite-34b decode: B={b}, cache {s} rows, Hq={hq}, Hkv={hkv}, D={d}, "
                    f"cur_len {cur}; bf16 query, f32 caches",
           "parts": rows, "tol_of_max": COMBINE_TOL,
           "decode_attention_ms": _time_ms(lambda: attention.decode_attention(q, k, v, cur), 20)}
    row["ok"] = all(r["err_of_max"] <= COMBINE_TOL and r["bitwise_twice"] for r in rows.values())
    _emit(row)
    if not row["ok"]:
        failures.append(f"mesh state families combine: {row}")


@contextlib.contextmanager
def _wrapped(owner, name: str, make):
    """Within the block ``owner.name`` is ``make(original)``."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _counting_drops(sink: list):
    """A wrapper of ``moe._dispatch_indices`` that appends each call's count
    of dropped assignments (past their expert's capacity) to ``sink``, as a
    device tensor."""
    def make(inner):
        def counted(idx, n_tokens, cfg, cap):
            tok, ks = inner(idx, n_tokens, cfg, cap)
            sink.append(idx.numel() - (tok < n_tokens).sum())
            return tok, ks
        return counted
    return make


def _recording_routes(sink: list):
    """A wrapper of ``moe._route`` that appends each call's top-k indices
    to ``sink``."""
    def make(inner):
        def recorded(params, x, cfg):
            out = inner(params, x, cfg)
            sink.append(out[1])
            return out
        return recorded
    return make


def _matrices_at(model, std: float, seed: int):
    """Redraw every matrix of ``model`` (each parameter of 2 or more dims)
    from N(0, std^2), in place, from a generator on its device seeded by
    ``seed``; norms and biases keep their values.  Returns ``model``.

    The MoE phase's checks run granite-moe at std 0.02 (GPT-2's rule, which
    the reference's embeddings and router already follow).  The reference's
    rule, 1/sqrt(shape[0]) (the layer count for a stacked leaf), gives
    granite-moe, which has no qk-norm, attention logits of std ~d_model
    std^2 (~40 at full depth, ~500 at a 2-layer cut): a saturated softmax
    whose near-ties amplify rounding, so that the card and the CPU (f32)
    and two bf16 passes part by more than the rounding of one op."""
    import torch

    with torch.no_grad():
        for p in model.parameters():
            if p.dim() >= 2:
                gen = torch.Generator(device=p.device).manual_seed(seed)
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device).mul_(std))
                seed += 1
    return model


def _pinned_routes(routes: list, n_layers: int, flips: list):
    """A wrapper of ``moe._route`` that takes each call's expert choices
    from ``routes``, a teacher-forced pass's (B, S, k) indices per MoE layer
    (``n_layers`` of them): the calls run layer by layer, first a prefill of
    LM_PROMPT tokens, then one token a step.  The weights are the call's
    own router's at those choices (softmax probabilities, or sigmoid scores
    under aux-free routing), normalized over the k, as ``moe._route``
    weighs its own; ``flips`` gets each call's count of tokens whose own
    top-k differs."""
    import itertools

    import torch

    def make(inner):
        calls = itertools.count()

        def pinned(params, x, cfg):
            _, idx, aux = inner(params, x, cfg)
            step, layer = divmod(next(calls), n_layers)
            start = 0 if step == 0 else LM_PROMPT + step - 1
            want = routes[layer][:, start:start + x.shape[1]]
            flips.append((idx != want).any(-1).sum())
            logits = torch.matmul(x.float(), params["router"].float())
            scores = torch.sigmoid(logits) if cfg.router_aux_free else torch.softmax(logits, -1)
            top = torch.gather(scores, -1, want)
            w = top / torch.clamp_min(torch.sum(top, dim=-1, keepdim=True), 1e-9)
            return w.to(x.dtype), want, aux
        return pinned
    return make


def _moe_phase(seed: int, hw, failures: list[str]) -> dict[str, int]:
    """The MoE family on the card at granite-moe-1b-a400m's full width and
    depth: serving (``_moe_serve``), training (``_moe_train``) and the flash
    kernels at its head dim 64, G = 2 (``_head_yardsticks``).  Returns the
    flash launches of its main paths: ``serve``, ``train_fwd``, ``train_bwd``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 19)
    serve = _moe_serve(seed, rng, failures)
    torch.cuda.empty_cache()
    train_fwd, train_bwd = _moe_train(seed, failures)
    torch.cuda.empty_cache()
    fwd, bwd = _head_yardsticks(MOE_ARCH, rng, hw, failures)
    FLASH_ROWS["5-64"] = {key: fwd.get(key) for key in FLASH_ROW_KEYS if key in fwd}
    FLASH_ROWS["5b-64"] = {key: bwd.get(key) for key in FLASH_ROW_KEYS if key in bwd}
    return {"serve": serve, "train_fwd": train_fwd, "train_bwd": train_bwd}


def _moe_serve(seed: int, rng, failures: list[str]) -> int:
    """``ServeEngine`` on full-width granite-moe (random bf16 weights from
    the seed, matrices at std 0.02 (``_matrices_at``), f32 KV cache) through
    ``_serve_routed``, the dropless teacher at capacity factor E/k (every
    expert holds a whole group); then the card against the port's CPU path
    at 2 layers in f32, routing equal.  Returns the flash launches of the
    served generate."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import registry

    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH)
    t0 = time.perf_counter()
    model = _matrices_at(registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                                                cfg, torch.bfloat16), 0.02, seed)
    torch.cuda.synchronize()
    launches, _ = _serve_routed(
        "moe", cfg, model, rng, failures,
        lambda routes: cfg.n_experts / cfg.experts_per_token,
        {"heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
         "init_s": time.perf_counter() - t0})
    del model
    torch.cuda.empty_cache()

    # -- the card against the port's CPU path: full width, 2 layers, f32 ----------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    _serve_cross_device("moe cross-device", cfg2, _matrices_at(
        registry.get(cfg2).init(torch.Generator().manual_seed(seed), cfg2), 0.02, seed), rng,
        failures)
    return launches


def _busiest_expert(routes: list, cfg) -> int:
    """The most assignments any expert takes in any group (batch row) of
    any MoE layer, over ``routes`` ((B, S, k) choices per layer)."""
    import torch

    return max(int(torch.stack([torch.bincount(row.reshape(-1), minlength=cfg.n_experts)
                                for row in r]).max()) for r in routes)


def _serve_routed(tag: str, cfg, model, rng, failures: list[str], free_factor,
                  extra: dict) -> tuple[int, dict]:
    """``ServeEngine`` on ``model`` (an MoE model on the card; ``cfg`` with its
    served capacity factor) over 4 x 1,024-token prompts + 32 greedy
    tokens, the flash counter set to 0 just before and read just after
    (one launch per layer in prefill, 0 in decode); decode logits against a
    teacher-forced forward on the same weights, with capacity for every
    assignment and the decode path's expert choices pinned to the
    teacher's (the served config's difference, the capacity drops of both
    passes and the routing flips printed beside it); a profile of one
    prefill and 4 decode steps.  ``free_factor(routes)`` gives the
    dropless capacity factor from the served teacher pass's routes.
    Emits the ``"{tag} serve"`` row (``extra`` merged in) and returns
    (flash launches of the served generate, the row)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, moe, transformer
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    dev = torch.device("cuda")
    n_moe = transformer.stack_sizes(cfg)["moe_layers"]
    engine = ServeEngine(cfg, model, ServeConfig(max_len=LM_MAX_LEN), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    tokens, counts, speed = _generate_twice(engine, prompts)
    launches = counts[fa.LAUNCHES.name]
    # decode logits against a teacher-forced forward over prompt + generated
    # tokens, through the engine's own calls (prefill, then the 31 decode
    # steps, each counted from 0), with the capacity drops of both passes
    # counted.  Two things differ between the paths besides what the check
    # is for (the cache, the positions, the kernels):
    # * capacity is per group: at the served factor 1.25 the 1,024-token
    #   prefill, the 1,055-token teacher pass and decode (1 slot, never
    #   full) hold different slots per expert, so wherever an expert
    #   overflows the paths drop different assignments;
    # * bf16 rounds the router's inputs otherwise in the two paths, and a
    #   token whose k-th and (k+1)-th experts nearly tie changes expert.
    # The check is held on the same weights with capacity for every
    # assignment (``free_factor``: no pass drops one) and each decode call's
    # expert choices pinned to the teacher pass's (weights from its own
    # router); the flips that pinning undid, and the served config's own
    # difference, are printed beside it.
    toks_d = torch.from_numpy(tokens).to(dev)
    found: dict = {}
    served_routes: list = []
    for name in ("served", "dropless pinned"):
        if name == "served":
            eng = engine
        else:
            free_cfg = dataclasses.replace(cfg, capacity_factor=free_factor(served_routes))
            eng = ServeEngine(free_cfg, engine.params, ServeConfig(max_len=LM_MAX_LEN),
                              device=dev)
        drops: dict[str, list] = {"prefill": [], "teacher": []}
        routes: list = served_routes if name == "served" else []
        with _wrapped(moe, "_dispatch_indices", _counting_drops(drops["teacher"])), \
                _wrapped(moe, "_route", _recording_routes(routes)):
            x, _, _ = transformer.forward(eng.params, {"tokens": toks_d[:, :-1]}, eng.cfg,
                                          q_chunk=512, kv_chunk=1024)
        teacher = transformer._logits(eng.params, x[:, LM_PROMPT - 1:], eng.cfg).float()
        del x
        flips: list = []
        pin = (_wrapped(moe, "_route", _pinned_routes(routes, n_moe, flips))
               if eng is not engine else contextlib.nullcontext())
        state = eng.init_state(LM_BATCH)
        with pin:
            _reset_counts()
            with _wrapped(moe, "_dispatch_indices", _counting_drops(drops["prefill"])):
                lg, state = eng.prefill({"tokens": toks_d[:, :LM_PROMPT]}, state)
            torch.cuda.synchronize()
            prefill_launches = _counts()[fa.LAUNCHES.name]
            step_logits = [lg]
            _reset_counts()
            for t in range(LM_NEW - 1):
                lg, state = eng.decode(toks_d[:, LM_PROMPT + t:LM_PROMPT + t + 1], state,
                                       LM_PROMPT + t)
                step_logits.append(lg)
            torch.cuda.synchronize()
            decode_launches = _counts()[fa.LAUNCHES.name]
        served = torch.cat(step_logits, dim=1).float()  # (B, 32, V): positions 1023 .. 1054
        diff = torch.abs(served - teacher)
        found[name] = {
            "capacity_factor": eng.cfg.capacity_factor,
            "capacity": [moe.capacity(LM_PROMPT, eng.cfg),
                         moe.capacity(LM_PROMPT + LM_NEW - 1, eng.cfg), moe.capacity(1, eng.cfg)],
            "prefill_launches": prefill_launches, "decode_launches": decode_launches,
            "finite": bool(torch.isfinite(served).all()) and bool(torch.isfinite(teacher).all()),
            "max_abs_diff": diff.max().item(), "mean_abs_diff": diff.mean().item(),
            "scale": torch.abs(teacher).max().item(),
            "token_agreement": float((served.argmax(-1) == teacher.argmax(-1)).float().mean()),
            "dropped": {k: int(sum(d.item() for d in v)) for k, v in drops.items()},
            "pinned_calls": len(flips),
            "routing_flips": {"prefill": int(sum(f.item() for f in flips[:n_moe])),
                              "decode": int(sum(f.item() for f in flips[n_moe:]))}}
        del state, step_logits, served, teacher, diff, eng
    del served_routes
    torch.cuda.empty_cache()
    prof_prefill, prof_decode = _serving_profiles(tag, engine, toks_d, LM_PROMPT,
                                                  "4 x 1,024 tokens")
    served, free = found["served"], found["dropless pinned"]
    prefill_launches, decode_launches = served["prefill_launches"], served["decode_launches"]
    scale, teacher_err = free["scale"], free["max_abs_diff"]
    finite = served["finite"] and free["finite"]
    assignments = LM_BATCH * cfg.experts_per_token * n_moe
    row = {"row": f"{tag} serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "moe_layers": n_moe, "d_model": cfg.d_model, **extra,
           "experts": [cfg.n_experts, cfg.experts_per_token, cfg.d_ff_expert],
           "vocab": cfg.vocab_size, "params": common.count_params(engine.params),
           "active_params": cfg.active_params(), "dtype": "bfloat16", "cache_dtype": "float32",
           "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW,
           "capacity": [moe.capacity(LM_PROMPT, cfg), moe.capacity(1, cfg)],
           "flash_launches": launches, "expected_launches": cfg.n_layers,
           "prefill_launches": prefill_launches, "decode_launches": decode_launches,
           "other_launches": sum(counts.values()) - launches,
           "prefill_kernel_launches": prof_prefill["kernel_launches"],
           "decode_kernel_launches_per_step": prof_decode["kernel_launches"] / 4, **speed,
           "prefill_idle_share": prof_prefill["idle_share"],
           "decode_idle_share": prof_decode["idle_share"],
           "assignments": {"prefill": assignments * LM_PROMPT,
                           "teacher": assignments * (LM_PROMPT + LM_NEW - 1)},
           "dropped_assignments": served["dropped"],
           "dropless_capacity_factor": free["capacity_factor"],
           "dropless_capacity": free["capacity"],
           "dropless_dropped_assignments": free["dropped"],
           "pinned_calls": free["pinned_calls"], "routing_flips_pinned": free["routing_flips"],
           "logits_finite": finite,
           "teacher_max_abs_diff": teacher_err, "teacher_mean_abs_diff": free["mean_abs_diff"],
           "teacher_logit_scale": scale, "teacher_tol": LM_TEACHER_TOL * scale,
           "teacher_token_agreement": free["token_agreement"],
           "served_config_teacher": {k: served[k] for k in (
               "max_abs_diff", "mean_abs_diff", "scale", "token_agreement")},
           "pinned_launches": [free["prefill_launches"], free["decode_launches"]]}
    row["ok"] = (launches == cfg.n_layers and prefill_launches == cfg.n_layers
                 and decode_launches == 0 and row["other_launches"] == 0 and finite
                 and tokens.shape == (LM_BATCH, LM_PROMPT + LM_NEW)
                 and free["dropped"] == {"prefill": 0, "teacher": 0}
                 and free["pinned_calls"] == n_moe * LM_NEW
                 and teacher_err <= LM_TEACHER_TOL * scale)
    _emit(row)
    if not row["ok"]:
        failures.append(f"{tag} serve main path: {row}")
    del engine, toks_d
    torch.cuda.empty_cache()
    return launches, row


def _snapshot(params, opt_state) -> list:
    """Copies of every parameter, moment and the step count, on the card."""
    return ([p.detach().clone() for p in params.parameters()]
            + [t.clone() for k in ("m", "v") for t in opt_state[k].values()]
            + [opt_state["count"].clone()])


def _live(params, opt_state) -> list:
    return ([p.detach() for p in params.parameters()]
            + [t for k in ("m", "v") for t in opt_state[k].values()] + [opt_state["count"]])


def _same_bits_twice(tag: str, cfg, step_fn, params, opt_state, batch,
                     failures: list[str]) -> None:
    """One train step twice from the same parameters and moments: the same
    bits in the parameters, the moments, the count and the metrics.  The
    second step's state is left in place."""
    import torch

    start = _snapshot(params, opt_state)
    _, _, m1 = step_fn(params, opt_state, batch)
    first = _snapshot(params, opt_state)
    with torch.no_grad():
        for t, s in zip(_live(params, opt_state), start):
            t.copy_(s)
    _, _, m2 = step_fn(params, opt_state, batch)
    twice = (all(torch.equal(a, b) for a, b in zip(first, _live(params, opt_state)))
             and all(torch.equal(m1[k], m2[k]) for k in m1))
    _emit({"row": f"{tag} train same bits twice", "arch": cfg.name, "tensors": len(first),
           "loss": m1["loss"].item(), "bitwise": twice})
    if not twice:
        failures.append(f"{tag} train: one step twice from one state differs")


def _same_grads_twice(tag: str, cfg, params, batch, failures: list[str]) -> None:
    """One step's gradients and metrics twice from the same parameters: the
    same bits, both sets held on the card (the caller has freed the
    moments); the optimizer's update is elementwise on those inputs."""
    import torch

    from repro_torch.train import train_step

    grad_fn = train_step.make_grad_fn(cfg, q_chunk=min(512, batch["tokens"].shape[1]),
                                      kv_chunk=min(1024, batch["tokens"].shape[1]))
    first, m1 = grad_fn(params, batch)
    grads, m2 = grad_fn(params, batch)
    twice = (first.keys() == grads.keys() and all(torch.equal(first[n], g)
                                                   for n, g in grads.items())
             and all(torch.equal(m1[k], m2[k]) for k in m1))
    _emit({"row": f"{tag} train same bits twice", "arch": cfg.name, "tensors": len(first),
           "what": "one step's gradients and metrics", "loss": m1["loss"].item(),
           "bitwise": twice})
    del grads, first
    torch.cuda.empty_cache()
    if not twice:
        failures.append(f"{tag} train: one step's gradients twice from one state differ")


def _generate_twice(engine, prompts, extras: dict | None = None) -> tuple:
    """``engine.generate`` of ``prompts`` and LM_NEW greedy tokens twice:
    the first with the counters set to 0 just before and read just after,
    the second timed, with the peak memory.  Returns the tokens, the counts
    and the served row's speed fields (the first call's flash launches by
    kernel among them)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, LM_NEW, extras=extras)
    first_s = time.perf_counter() - t0
    counts, by_kernel = _counts(), _by_kernel()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = engine.generate(prompts, LM_NEW, extras=extras)
    wall_s = time.perf_counter() - t0
    tm, (batch, prompt) = engine.last_timings, prompts.shape
    return tokens, counts, {
        "first_generate_s": first_s, "flash_launches_by_kernel": by_kernel,
        "prefill_ms": tm["prefill_s"] * 1e3,
        "decode_ms_per_token": tm["decode_s"] * 1e3 / tm["decode_steps"],
        "generate_wall_ms": wall_s * 1e3, "new_tokens_per_s": batch * LM_NEW / wall_s,
        "decode_tokens_per_s": batch * tm["decode_steps"] / tm["decode_s"],
        "prefill_tokens_per_s": batch * prompt / tm["prefill_s"],
        "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
        "same_tokens_twice": bool(np.array_equal(tokens, again))}


def _served_decode(engine, toks_d, prompt: int, extras: dict | None = None) -> tuple:
    """The engine's prefill of the first ``prompt`` served tokens (and
    ``extras``), then its LM_NEW - 1 decode steps on the served tokens
    after them, the flash launches of each part counted from 0.  Returns
    the logits of positions ``prompt - 1`` on, (B, LM_NEW, V) in f32, and
    the flash launches of the prefill and of the decode steps."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    state = engine.init_state(toks_d.shape[0])
    _reset_counts()
    lg, state = engine.prefill({"tokens": toks_d[:, :prompt], **(extras or {})}, state)
    torch.cuda.synchronize()
    prefill_launches = _counts()[fa.LAUNCHES.name]
    step_logits = [lg]
    _reset_counts()
    for t in range(LM_NEW - 1):
        lg, state = engine.decode(toks_d[:, prompt + t:prompt + t + 1], state, prompt + t)
        step_logits.append(lg)
    torch.cuda.synchronize()
    return torch.cat(step_logits, dim=1).float(), prefill_launches, _counts()[fa.LAUNCHES.name]


def _keep_served(keep: dict, prompts, tokens, served, speed: dict, max_len: int,
                 **extras) -> None:
    """Into ``keep``: a one-card serving run's prompts, generated tokens,
    prefill logits (``served``'s first position: ``_served_decode``'s f32
    logits, on the CPU), its ``ServeConfig.max_len``, warm timings
    (``_generate_twice``'s) and ``extras`` (a family's stub inputs, on the
    CPU), for a mesh run to be held against."""
    keep.update(prompts=prompts, tokens=tokens, prefill_logits=served[:, 0].cpu(),
                max_len=max_len, new_tokens=LM_NEW, prefill_ms=speed["prefill_ms"],
                decode_ms_per_token=speed["decode_ms_per_token"],
                peak_GB=speed["peak_memory_GB"], extras=extras)


def _serving_profiles(tag: str, engine, toks_d, prompt: int, what: str,
                      extras: dict | None = None, cpu: bool = True) -> tuple[dict, dict]:
    """Where the serving time goes: one prefill of the first ``prompt``
    served tokens (``what`` names it in the output), then 4 decode steps
    from its state, each under the profiler (``cpu`` as ``_profile``
    takes it).  Both are emitted and returned."""
    box = {"state": engine.init_state(toks_d.shape[0])}

    def prefill():
        box["state"] = engine.prefill({"tokens": toks_d[:, :prompt], **(extras or {})},
                                      box["state"])[1]

    def four_steps():
        for t in range(4):
            box["state"] = engine.decode(toks_d[:, prompt + t:prompt + t + 1], box["state"],
                                         prompt + t)[1]

    prof_prefill = _profile(prefill, cpu=cpu)
    prof_decode = _profile(four_steps)
    _emit({"profile": f"{tag} prefill ({what})", **prof_prefill})
    _emit({"profile": f"{tag} decode (4 steps)", **prof_decode})
    return prof_prefill, prof_decode


def _train_main_path(tag: str, cfg, opt, seed: int, steps: int, seq: int, failures: list[str],
                     profile_seq: int | None = None, grads_twice: bool = False,
                     keep: dict | None = None) -> tuple[bool, list, dict]:
    """``train.loop.train`` on ``cfg`` on the card for ``steps`` steps of
    TRAIN_BATCH x ``seq`` tokens (AdamW ``opt``), the counters set to 0
    just before and read just after, its log and one line a step printed;
    one more step twice from the trained state, bitwise
    (``_same_bits_twice``); one more step under the profiler, its flash
    launches counted, then the gradient / optimizer split; with
    ``grads_twice``, where copies of the parameters and moments would not
    fit beside them, the moments are freed after the split and the step's
    gradients and metrics computed twice instead (``_same_grads_twice``).  With
    ``profile_seq`` the step twice and the profiled step take the batch's
    first ``profile_seq`` tokens, the profiler records the device's
    activity alone, and no split is timed: every xLSTM block steps through
    time, so a step's time, launches and idle share scale with its length,
    ~1 M launches of a whole step take the profiler minutes to read, and
    AdamW's eager passes take ~0.1 s of a step's tens.  ``keep`` (a dict)
    takes the run's ``TrainConfig``, history, step times, peak and every
    leaf's and moment's fingerprint (``_run_fingerprints``), for a mesh run
    to be held against.  Returns whether the run took its steps with
    finite metrics, a first loss (the NLL, where the family adds an aux
    loss) within TRAIN_START_TOL of ``_start_nll`` and no launch of the port's
    but the flash kernels'; its history; and the fields every family's
    train row carries."""
    import math

    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig, PipelineState, TokenPipeline, make_train_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common
    from repro_torch.optim import adamw
    from repro_torch.train import loop, train_step

    dev = torch.device("cuda")
    tcfg = loop.TrainConfig(steps=steps, seq_len=seq, global_batch=TRAIN_BATCH, log_every=1,
                            seed=seed, opt=opt)
    log_lines: list[str] = []
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = loop.train(cfg, tcfg, log=log_lines.append, device=dev)
    wall_s = time.perf_counter() - t0
    counts, by_kernel = _counts(), _by_kernel()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for line in log_lines:
        print(f"{tag} train: {line}")
    hist, step_ms = out["history"], out["step_ms"]
    for h, ms in zip(hist, step_ms):
        _emit({f"{tag}_train_step": h["step"], **{k: v for k, v in h.items() if k != "step"},
               "step_ms": ms})
    if keep is not None:
        keep.update(tcfg=tcfg, history=hist, fingerprints=_run_fingerprints(out),
                    step_ms=step_ms, peak_GB=peak_gb)
    params, opt_state = out["params"], out["opt_state"]
    del out
    n_params = common.count_params(params)

    # one more step twice from the same state: the same bits
    chunks = {"q_chunk": min(512, seq), "kv_chunk": min(1024, seq)}  # as loop.train's
    step_fn = train_step.make_train_step(cfg, opt, **chunks)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, seq, TRAIN_BATCH, seed=seed))
    batch, _ = make_train_batch(pipe, PipelineState(step=steps), cfg, device=dev)
    short = batch if profile_seq is None else {k: v[:, :profile_seq] for k, v in batch.items()}
    if not grads_twice:
        _same_bits_twice(tag, cfg, step_fn, params, opt_state, short, failures)
        torch.cuda.empty_cache()
    # where the time goes: one more step under the profiler, then the split
    fields: dict = {}
    _reset_counts()
    t0 = time.perf_counter()
    prof = _profile(lambda: step_fn(params, opt_state, short), top=10, cpu=profile_seq is None)
    prof_s = time.perf_counter() - t0
    prof_counts = _counts()
    what = f"{short['tokens'].shape[1]} tokens"
    if cfg.is_encoder_decoder:
        what = f"({cfg.encoder_len} frames, {what})"
    _emit({"profile": f"{tag} train step ({TRAIN_BATCH} x {what})", **prof})
    if profile_seq is None:
        grad_fn = train_step.make_grad_fn(cfg, **chunks)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        grads, _ = grad_fn(params, batch)
        marks[1].record()
        adamw.update(grads, opt_state, params, opt)
        marks[2].record()
        torch.cuda.synchronize()
        fields.update(split_grad_ms=marks[0].elapsed_time(marks[1]),
                      split_optimizer_ms=marks[1].elapsed_time(marks[2]))
        del grads, grad_fn
    else:
        fields.update(profiled_seq=profile_seq, profiled_step_with_processing_s=prof_s)
    del opt_state  # with grads_twice, room for two sets of gradients on the card
    torch.cuda.empty_cache()
    if grads_twice:
        _same_grads_twice(tag, cfg, params, short, failures)
    del params, batch, short, step_fn
    torch.cuda.empty_cache()

    fwd, bwd = counts[fa.LAUNCHES.name], counts[fa.BWD_LAUNCHES.name]
    losses, gnorms = [h["loss"] for h in hist], [h["grad_norm"] for h in hist]
    auxs = [h["aux"] for h in hist if "aux" in h]
    first, start = hist[0].get("nll", losses[0]), _start_nll(cfg)
    median_ms = float(np.median(step_ms[1:]))
    n = len(hist)
    fields.update({
        "params": n_params, "master_dtype": "float32", "moment_dtype": opt.moment_dtype,
        "compute_dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq": seq, "steps": n,
        "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
        f"step_ms_median_2_{steps}": median_ms,
        "tokens_per_s": TRAIN_BATCH * seq / median_ms * 1e3,
        "peak_memory_GB": peak_gb, "wall_s": wall_s,
        "flash_launches": fwd, "flash_bwd_launches": bwd, "flash_launches_by_kernel": by_kernel,
        "flash_launches_per_step": fwd / n, "flash_bwd_launches_per_step": bwd / n,
        "other_launches": sum(counts.values()) - fwd - bwd,
        "profiled_step_flash_launches": [prof_counts[fa.LAUNCHES.name],
                                         prof_counts[fa.BWD_LAUNCHES.name]],
        "profiled_kernel_launches": prof["kernel_launches"],
        "profiled_launches_by_class": prof["launches_by_class"],
        "idle_share": prof["idle_share"], "start_loss": first, "start_loss_target": start,
        "start_loss_tol": TRAIN_START_TOL})
    ok = (n == steps and all(math.isfinite(x) for x in losses + gnorms + auxs)
          and abs(first - start) <= TRAIN_START_TOL and fields["other_launches"] == 0)
    return ok, hist, fields


def _start_nll(cfg) -> float:
    """The expected NLL of step 1: ln(vocab) plus half the variance of the
    logits, which an output head drawn at std 0.02 over RMS-normalised
    features of width d_model gives as 0.02^2 d_model (E[logsumexp] of V
    normal logits of variance s^2 is about ln V + s^2 / 2).  deepseek-v3's
    d_model of 7,168 puts it 1.43 above ln(vocab); xlstm-125m's 768, 0.15.
    On an H100 (seed 0) each family's first NLL came within 0.04 of it:
    qwen3-4b 12.428 (12.443), granite-moe 11.014 (11.008), deepseek-v3
    13.169 (13.203), zamba2 10.767 (10.783), xlstm 10.952 (10.979), whisper
    10.931 (10.933), where ln(vocab) alone misses by 0.08 to 1.4; the tied
    and the reference-initialised heads draw at 0.02 too."""
    import math

    return math.log(cfg.vocab_size) + 0.5 * 0.02**2 * cfg.d_model


def _moe_train(seed: int, failures: list[str]) -> tuple[int, int]:
    """``train.loop.train`` on full-width, full-depth granite-moe (f32
    master weights and moments, bf16 compute, remat) for TRAIN_STEPS steps
    through ``_train_main_path`` (48 flash forward launches a step, half of
    them the remat recompute; 24 backward calls); one step's loss and
    gradients, the card against the CPU at 2 layers in f32 (matrices at std
    0.02), routing equal; 4 steps straight against 2 + checkpoint +
    restore + 2, bitwise.  Returns the flash forward and backward launches
    of the training run."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common, moe, registry
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config(MOE_ARCH)
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    ok, hist, fields = _train_main_path("moe", cfg, opt, seed, TRAIN_STEPS, TRAIN_SEQ, failures)
    fwd, bwd = fields["flash_launches"], fields["flash_bwd_launches"]
    row = {"row": "moe train", "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "remat": True, "capacity": moe.capacity(TRAIN_SEQ, cfg),
           **fields, "nlls": [h["nll"] for h in hist], "auxs": [h["aux"] for h in hist],
           "expected_per_step": [2 * cfg.n_layers, cfg.n_layers]}
    row["ok"] = ok and fwd == 2 * cfg.n_layers * TRAIN_STEPS and bwd == cfg.n_layers * TRAIN_STEPS
    _emit(row)
    if not row["ok"]:
        failures.append(f"moe train main path: {row}")

    # -- one step's loss and gradients: the card against the CPU, 2 layers, f32 -------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    _train_cross_device("moe train cross-device", cfg2, common.trainable(_matrices_at(
        registry.get(cfg2).init(torch.Generator().manual_seed(seed), cfg2), 0.02, seed)), seed,
        failures)

    # -- resume: 4 steps straight against 2 + checkpoint + restore + 2, on the card ----
    _resume_check("moe train resume", cfg2, seed, failures)
    return fwd, bwd


def _head_yardsticks(arch: str, rng, hw, failures: list[str]) -> tuple[dict, dict]:
    """The flash forward and backward at ``arch``'s heads (bf16, causal; the
    forward at the prefill shape, LM_BATCH x LM_PROMPT, the backward at the
    training shape, TRAIN_BATCH x TRAIN_SEQ): ``_fwd_yardstick`` and
    ``_bwd_yardstick``.  Returns their rows."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return (_fwd_yardstick(arch, LM_BATCH, LM_PROMPT, LM_PROMPT, hq, hkv, d, True, rng, hw,
                           failures),
            _bwd_yardstick(arch, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, hq, hkv, d, True, rng, hw,
                           failures))


def _yardstick_label(kernel: str, b, sq, skv, hq, hkv, d, causal, dv=None) -> str:
    length = f"S={sq}" if sq == skv else f"Sq={sq} Skv={skv}"
    return (f"{kernel} bf16 {'causal' if causal else 'non-causal'} B={b} {length} "
            f"Hq={hq} Hkv={hkv} D={d}" + ("" if dv in (None, d) else f" Dv={dv}"))


def _fwd_yardstick(arch: str, b, sq, skv, hq, hkv, d, causal: bool, rng, hw,
                   failures: list[str]) -> dict:
    """The flash forward (bf16) at one shape against its plain version within
    ``kernel_tolerance``, then timed (eager calls; also in a CUDA graph,
    where the wrapper's host cost does not show: at D=64 it is a large part
    of an eager call) beside the plain version, SDPA and the bound.  Emits
    the row and returns it."""
    import numpy as np
    import torch

    from repro_torch.core import roofline
    from repro_torch.kernels import flash_attention as fa

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    atol, rtol = fa.kernel_tolerance(bf16)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, bf16)

    q, k, v = normal(b, sq, hq, d), normal(b, skv, hkv, d), normal(b, skv, hkv, d)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool(
        (diff <= atol + rtol * want.float().abs()).all())
    kernel_ms = _time_ms(lambda: fa.flash_attention(q, k, v, causal=causal), reps=20)
    kernel_graph_ms = _graph_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
    plain_ms = _time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal), reps=5,
                        warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    library_ms = _time_ms(sdpa, reps=20)
    library_graph_ms = _graph_ms(sdpa)
    bound = roofline.attention_bound(batch=b, sq=sq, skv=skv, hq=hq, hkv=hkv, d=d,
                                     causal=causal, dtype=bf16, hw=hw) if hw is not None else None
    executed = fa.executed_flops(b, sq, skv, hq, hkv, d, causal=causal)
    row = {"yardstick": _yardstick_label("flash_attention", b, sq, skv, hq, hkv, d, causal),
           "arch": arch, "max_abs_err": diff.max().item(), "atol": atol, "rtol": rtol, "ok": ok,
           "kernel_ms": kernel_ms, "kernel_graph_ms": kernel_graph_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_graph_ms": library_graph_ms,
           "library_call": f"F.scaled_dot_product_attention(is_causal={causal}, enable_gqa=True)",
           "flops": None if bound is None else bound.flops,
           "bytes": None if bound is None else bound.bytes,
           "bound_ms": None if bound is None else bound.bound_s * 1e3,
           "bound_by": None if bound is None else bound.bound_by,
           "kernel_TFLOPs": None if bound is None else bound.flops / kernel_ms / 1e9,
           "bound_share": None if bound is None else bound.bound_s * 1e3 / kernel_ms,
           "kernel_vs_library": kernel_ms / library_ms, "executed_flops": executed,
           "executed_TFLOPs": executed / kernel_ms / 1e9}
    _emit(row)
    if not ok:
        failures.append(f"flash_attention vs plain at {row['yardstick']}: {diff.max().item()}")
    return row


def _bwd_yardstick(arch: str, b, sq, skv, hq, hkv, d, causal: bool, rng, hw,
                   failures: list[str], dv: int | None = None) -> dict:
    """The flash backward (bf16) at one shape (v's head dim ``dv``, None:
    d) against its plain version within ``kernel_tolerance`` of each
    gradient's max, and twice bitwise, then timed (eager calls and a CUDA
    graph) beside the plain version, SDPA's backward (the backend it picks,
    by name) and the bound.  Emits the row and returns it."""
    import numpy as np
    import torch

    from repro_torch.core import roofline
    from repro_torch.kernels import flash_attention as fa

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    atol, rtol = fa.kernel_tolerance(bf16)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, bf16)

    dv = d if dv is None else dv
    q, k, v, dout = normal(b, sq, hq, d), normal(b, skv, hkv, d), normal(b, skv, hkv, dv), \
        normal(b, sq, hq, dv)
    o, lse = fa._forward(q, k, v, causal=causal, q_chunk=512, kv_chunk=1024, q_offset=0,
                         with_lse=True)
    got = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)
    want = fa.flash_attention_bwd_plain(q, k, v, o, dout, lse, causal=causal, q_chunk=512,
                                        kv_chunk=1024)
    shares = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
        shares[name] = err / (atol + rtol * scale)
    twice = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = (max(shares.values()) <= 1.0 and twice
          and all(bool(torch.isfinite(g.float()).all()) for g in got))
    bwd = lambda: fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)  # noqa: E731
    kernel_ms = _time_ms(bwd, reps=50)
    kernel_graph_ms = _graph_ms(bwd)
    plain_ms = _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, dout, lse,
                                                             causal=causal), reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(
        qt, kt, vt, None, 0.0, causal, enable_gqa=True)).name
    o_lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                             enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), dout.transpose(1, 2),  # noqa: E731
                                           retain_graph=True)
    library_ms = _time_ms(sdpa_bwd, reps=50)
    bound = roofline.attention_bwd_bound(batch=b, sq=sq, skv=skv, hq=hq, hkv=hkv, d=d,
                                         causal=causal, dtype=bf16, hw=hw,
                                         dv=dv) if hw is not None else None
    executed = fa.bwd_executed_flops(b, sq, skv, hq, hkv, d, causal=causal, dv=dv)
    # the three kernels of a call (delta, dK/dV, dQ): device ms per call by
    # name, over 10 calls
    split = _profile(lambda: [bwd() for _ in range(10)], top=3)["top_kernels"]
    row = {"yardstick": _yardstick_label("flash_attention_bwd", b, sq, skv, hq, hkv, d, causal,
                                         dv),
           "kernel_split_ms": {name: ms / count for name, ms, count in split},
           "arch": arch, "share_of_limit": shares, "bitwise_twice": twice, "ok": ok,
           "kernel_ms": kernel_ms, "kernel_graph_ms": kernel_graph_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "timing": "*_ms: eager calls; kernel_graph_ms: CUDA graph of 20 calls",
           "library_call": f"backward of F.scaled_dot_product_attention(is_causal={causal}, "
                           "enable_gqa=True) (torch.autograd.grad)",
           "library_backend": backend,
           "flops": None if bound is None else bound.flops,
           "bytes": None if bound is None else bound.bytes,
           "bound_ms": None if bound is None else bound.bound_s * 1e3,
           "bound_by": None if bound is None else bound.bound_by,
           "kernel_TFLOPs": None if bound is None else bound.flops / kernel_ms / 1e9,
           "bound_share": None if bound is None else bound.bound_s * 1e3 / kernel_ms,
           "kernel_vs_library": kernel_ms / library_ms, "executed_flops": executed,
           "executed_TFLOPs": executed / kernel_ms / 1e9}
    _emit(row)
    if not ok:
        failures.append(f"flash_attention_bwd vs plain at {row['yardstick']}: {shares}")
    return row


def _mla_phase(seed: int, hw, failures: list[str]) -> dict:
    """MLA on the card.  The flash kernel at (D, Dv) = (192, 128) through its
    split entry on MLA's parts against its plain version in MLA_FORMS
    (``_mla_fwd_checks``); ``ServeEngine`` on full-width deepseek-v3
    cut to MLA_LAYERS layers (``_serve_routed``: 4 flash launches in
    prefill, 0 in decode; the dropless teacher at the least capacity factor
    that holds the busiest expert of the served teacher pass, whose one MoE
    layer routes alike at any capacity; E/k would give every expert 1,055
    slots a group, a 15 GB dispatch buffer); the card against the CPU at 2
    dense layers of full width in f32, and on the reduced config with
    deepseek-v3's head dims (MLA, sigmoid routing, a shared expert),
    routing equal; the kernel's yardsticks at the prefill shape
    (``_mla_fwd_yardstick``).  Returns the instantiation's entry of the
    kernels line."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import mla, registry

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 20)

    # -- the kernel against its plain version, on MLA's parts -----------------------------
    worst = _mla_fwd_checks(rng, failures)

    # -- the main path: full width, 3 dense + 1 MoE layer -----------------------------------
    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    print(f"reduced: {json.dumps(MLA_REDUCED)}")
    t0 = time.perf_counter()
    model = _matrices_at(registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                                                cfg, torch.bfloat16), 0.02, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches, _ = _serve_routed(
        "mla", cfg, model, rng, failures,
        lambda routes: _busiest_expert(routes, cfg) * cfg.n_experts
        / (LM_PROMPT * cfg.experts_per_token),
        {"mla": {"q_lora": cfg.q_lora_rank, "kv_lora": cfg.kv_lora_rank,
                 "qk_head": [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
                 "v_head": cfg.v_head_dim, "heads": cfg.n_heads},
         "dense_layers": cfg.n_dense_layers, "d_ff": cfg.d_ff, "reduced": MLA_REDUCED,
         "init_s": init_s})
    del model
    torch.cuda.empty_cache()

    # -- the card against the port's CPU path: full width, 2 dense layers, f32 ----------
    # (the weights are drawn on the card, which is fast, and copied to the CPU)
    cfg2 = dataclasses.replace(cfg, n_layers=2, n_dense_layers=2, dtype="float32")
    _serve_cross_device("mla cross-device", cfg2, _matrices_at(
        registry.get(cfg2).init(torch.Generator(device=dev).manual_seed(seed), cfg2), 0.02, seed),
        rng, failures)
    torch.cuda.empty_cache()
    # and the MoE structure (MLA + a dense layer + 3 sigmoid-routed MoE layers with
    # a shared expert) at the reduced widths with the kernel's head dims
    cfg3 = mla.with_kernel_heads(get_config(MLA_ARCH).reduced())
    _serve_cross_device("mla cross-device reduced", cfg3, _matrices_at(
        registry.get(cfg3).init(torch.Generator().manual_seed(seed), cfg3), 0.02, seed), rng,
        failures)

    # -- yardsticks at the prefill shape ------------------------------------------------
    row = _mla_fwd_yardstick(LM_BATCH, LM_PROMPT, cfg.n_heads, rng, hw, failures)
    return {"launches": launches, "max_abs_err": worst, "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def _mla_train(seed: int, hw, failures: list[str]) -> tuple[dict, int]:
    """MLA training on the card.  The flash backward at (D, Dv) = (192, 128)
    through its split entry on MLA's parts against its plain version in
    MLA_BWD_FORMS (``_mla_bwd_checks``: each twice, bitwise); then
    ``train.loop.train`` on deepseek-v3 at full width, cut to its 3 dense
    layers and the MTP layer (MLA_TRAIN_REDUCED; f32 master weights and
    moments, bf16 compute, remat) through ``_train_main_path`` (7 flash
    forward launches a step at (192, 128): 3 layers, their remat recompute,
    the MTP layer's; 4 backward calls), the step's gradients twice
    bitwise; one step's loss and gradients, the card against the CPU on 2
    dense layers + MTP of full width in f32 (matrices at std 0.02); 4 steps
    straight against 2 + checkpoint + restore + 2, bitwise, on the reduced
    config with deepseek-v3's head dims (two runs' states must fit the card
    at once); the
    backward's yardsticks at the training shape.  Returns the (192, 128)
    backward's entry of the kernels line and the training run's forward
    launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common, mla, registry
    from repro_torch.optim.adamw import AdamWConfig

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 23)
    max_err = _mla_bwd_checks(rng, failures)
    base = get_config(MLA_ARCH)
    cfg = dataclasses.replace(base, n_layers=MLA_TRAIN_LAYERS, n_dense_layers=MLA_TRAIN_LAYERS)
    print(f"reduced: {json.dumps(MLA_TRAIN_REDUCED)}")
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    ok, hist, fields = _train_main_path("mla", cfg, opt, seed, TRAIN_STEPS, TRAIN_SEQ, failures,
                                        grads_twice=True)
    fwd, bwd = fields["flash_launches"], fields["flash_bwd_launches"]
    per_step = [2 * cfg.n_layers + cfg.mtp_depth, cfg.n_layers + cfg.mtp_depth]
    row = {"row": "mla train", "arch": cfg.name, "n_layers": cfg.n_layers,
           "mtp_depth": cfg.mtp_depth, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "heads": cfg.n_heads, "qk_head": [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim],
           "v_head": cfg.v_head_dim, "q_lora": cfg.q_lora_rank, "kv_lora": cfg.kv_lora_rank,
           "remat": True, "reduced": MLA_TRAIN_REDUCED, **fields,
           "nlls": [h["nll"] for h in hist], "expected_per_step": per_step}
    row["ok"] = ok and fwd == per_step[0] * TRAIN_STEPS and bwd == per_step[1] * TRAIN_STEPS
    _emit(row)
    if not row["ok"]:
        failures.append(f"mla train main path: {row}")
    torch.cuda.empty_cache()
    _emit({"mem": "mla train, after the main path", "allocated_GB":
           torch.cuda.memory_allocated() / 1e9})

    # -- one step's loss and gradients: the card against the CPU, 2 dense layers + MTP --
    # (the weights are drawn on the card, which is fast, and moved to the CPU)
    cfg2 = dataclasses.replace(cfg, n_layers=2, n_dense_layers=2, dtype="float32")
    model2 = _matrices_at(registry.get(cfg2).init(torch.Generator(device=dev).manual_seed(seed),
                                                  cfg2), 0.02, seed).cpu()
    _train_cross_device("mla train cross-device", cfg2, common.trainable(model2), seed, failures,
                        seq=MLA_CROSS_SEQ)
    del model2
    torch.cuda.empty_cache()
    _emit({"mem": "mla train, after the cross-device check", "allocated_GB":
           torch.cuda.memory_allocated() / 1e9})

    _emit({"mem": "mla train, before resume", "allocated_GB":
           torch.cuda.memory_allocated() / 1e9})

    # -- resume: 4 steps straight against 2 + checkpoint + restore + 2, on the card ----
    # (deepseek-v3's reduced config with its own head dims: MLA at (192, 128), a
    # dense layer and MoE layers with the sigmoid router and a shared expert;
    # at full width two runs' states would not fit the card at once)
    _resume_check("mla train resume", mla.with_kernel_heads(base.reduced()), seed, failures)

    # -- yardsticks at the training shape -----------------------------------------------
    row = _mla_bwd_yardstick(TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, rng, hw, failures)
    return ({"launches": bwd, "launches_per_step": bwd / TRAIN_STEPS, "max_abs_err": max_err,
             "ms": row["kernel_ms"], "kernel_graph_ms": row["kernel_graph_ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"],
             "library_backend": row["library_backend"]}, fwd)


def _flash_yardsticks(seed: int, hw, failures: list[str]) -> None:
    """The flash rows of PERF.md's kernels table alone, at the shapes the
    full run times them: the D=128 rows (5 and 5b: qwen3-4b's and
    minitron-8b's prefill, B=4, S=1,024, Hq=32, Hkv=8, and training, B=2;
    5-yi, 5-internvl, 5-granite and their 5b rows at G = 8, 6 and 48) in
    turns beside SDPA's forward and backward (``_d128_yardsticks``), the
    D=64 forward at
    zamba2-1.2b's, granite-moe's and whisper-tiny's shapes in turns beside
    SDPA (``_group_fwd_yardsticks``: 5-zamba, 5-64, 5-whisper encoder and
    cross), the D=64 backward at granite-moe's, zamba2-1.2b's and
    whisper-tiny's training shapes in turns beside SDPA's backward
    (``_group_bwd_yardsticks``: 5b-64, 5b-zamba, 5b-whisper encoder, cross
    and self), 5-mla (deepseek-v3's prefill at (192, 128)) and 5b-mla (its
    training); then the FLASH_ROWS line and the digests.  Run on two
    checkouts in one call (parent, change, change, parent) it compares them
    on one card."""
    import numpy as np

    from repro_torch.configs import get_config

    rng = np.random.default_rng(seed + 24)
    _d128_yardsticks(rng, hw, failures)
    _group_fwd_yardsticks(D64_ROWS, 64, rng, hw, failures)
    _group_bwd_yardsticks(D64_BWD_ROWS, 64, rng, hw, failures)
    h = get_config(MLA_ARCH).n_heads
    _mla_fwd_yardstick(LM_BATCH, LM_PROMPT, h, rng, hw, failures)
    _mla_bwd_yardstick(TRAIN_BATCH, TRAIN_SEQ, h, rng, hw, failures)
    _emit({"flash_rows": FLASH_ROWS})
    _emit({"flash_digests": _flash_digests(seed)})


def _d128_yardsticks(rng, hw, failures: list[str]) -> tuple[dict, dict]:
    """The bf16 forward and backward at D=128 at every main-path shape
    (``_group_fwd_yardsticks`` on D128_ROWS, ``_group_bwd_yardsticks`` on
    D128_BWD_ROWS: rows 5 and 5b, qwen3-4b's and minitron-8b's heads, and
    yi-6b's, internvl2-26b's and granite-34b's), and every row weighted by
    its main-path launches, turn by turn (the forward turns and backward
    turns of the same index).  Returns rows 5 and 5b's entries."""
    fwd = _group_fwd_yardsticks(D128_ROWS, 128, rng, hw, failures)
    bwd = _group_bwd_yardsticks(D128_BWD_ROWS, 128, rng, hw, failures)
    rows = list(fwd.values()) + list(bwd.values())
    weighted = [sum(r["main_path_launches"] * r["kernel_graph_ms_turns"][i] for r in rows)
                for i in range(len(rows[0]["kernel_graph_ms_turns"]))]
    FLASH_ROWS["5 + 5b D=128 launch-weighted"] = {"launch_weighted_graph_ms_turns": weighted}
    _emit({"yardstick": "the D=128 rows weighted by their main-path launches",
           "launches": {name: r["main_path_launches"] for name, r in {**fwd, **bwd}.items()},
           "launch_weighted_graph_ms_turns": weighted})
    return fwd[D128_ROWS[0][0]], bwd[D128_BWD_ROWS[0][0]]


def _d128_registry_checks(rng, failures: list[str]) -> tuple[float, float]:
    """The bf16 kernels at D = Dv = 128 (``flash_group_fwd<128>``,
    ``flash_bwd_d128``) against their plain versions at every D=128
    architecture's heads (D128_ARCHS: G = 4, 8, 4, 48, 6): causal at
    training's length, and ragged with Sq < Skv and a q_offset (the G = 6
    and 48 items hold 126 and 96 folded rows); the backward twice, bitwise
    (``_flash_checks``, ``_bwd_checks``).  Returns the largest errors of the
    forward and the backward."""
    from repro_torch.configs import get_config

    fwd_forms, bwd_forms = [], []
    for arch in D128_ARCHS:
        cfg = get_config(arch)
        hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if d != 128:
            failures.append(f"{arch}: head dim {d}, not 128")
            continue
        g = hq // hkv
        causal = (f"{arch} G={g} bf16 causal", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, hq, hkv, d,
                  True, 0, "bfloat16")
        ragged = (f"{arch} G={g} bf16 ragged Sq<Skv q_offset 367", 1, 333, 700, hq, hkv, d, True,
                  367, "bfloat16")
        fwd_forms += [causal, ragged]
        bwd_forms += [causal, ragged]
    return (_flash_checks(rng, failures, forms=fwd_forms),
            _bwd_checks(rng, failures, forms=bwd_forms))


def _group_fwd_yardsticks(rows: list, d: int, rng, hw, failures: list[str]) -> dict[str, dict]:
    """The bf16 forward at D = Dv = ``d`` (``flash_group_fwd<d>``) at each
    shape of ``rows`` (D64_ROWS: zamba2-1.2b's shared block and granite-moe's
    heads at the prefill shape, whisper-tiny's encoder and cross-attention at
    serving's prefill; D128_ROWS: qwen3-4b's prefill).  Each against its
    plain version within ``kernel_tolerance`` (the plain call timed once,
    ``plain_ms``), then the kernel and SDPA of every shape timed in three
    alternating turns (``_timed_in_turns``: eager calls and CUDA graphs of
    20 calls), beside the bound.  Emits one row, records each shape in
    FLASH_ROWS under its row name and returns the shapes' entries."""
    import numpy as np
    import torch

    from repro_torch.core import roofline
    from repro_torch.kernels import flash_attention as fa

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    atol, rtol = fa.kernel_tolerance(bf16)
    forms, shapes = {}, {}
    for name, arch, b, sq, skv, hq, hkv, causal, *launches in rows:
        q, k, v = (torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)).to(dev, bf16)
                   for shp in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        end.record()
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        ok = bool(torch.isfinite(got.float()).all()) and bool(
            (diff <= atol + rtol * want.float().abs()).all())
        if not ok:
            failures.append(f"flash_attention vs plain at {name}: {diff.max().item()}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        forms[name] = lambda q=q, k=k, v=v, c=causal: fa.flash_attention(q, k, v, causal=c)
        forms[f"{name} sdpa"] = (
            lambda qt=qt, kt=kt, vt=vt, c=causal: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=c, enable_gqa=True))
        bound = roofline.attention_bound(batch=b, sq=sq, skv=skv, hq=hq, hkv=hkv, d=d,
                                         causal=causal, dtype=bf16,
                                         hw=hw) if hw is not None else None
        shapes[name] = {"arch": arch, "shape": [b, sq, skv, hq, hkv, d], "causal": causal,
                        "main_path_launches": launches[0] if launches else None,
                        "max_abs_err": diff.max().item(), "ok": ok,
                        "plain_ms": start.elapsed_time(end),
                        "bound_ms": None if bound is None else bound.bound_s * 1e3,
                        "bound_by": None if bound is None else bound.bound_by,
                        "executed_flops": fa.executed_flops(b, sq, skv, hq, hkv, d,
                                                            causal=causal)}
        del want, got, diff
    turns = {}
    _timed_in_turns(turns, forms, reps=20, graph=True)
    for name, entry in shapes.items():
        entry.update(kernel_ms=turns[f"{name}_kernel_ms"],
                     kernel_ms_turns=turns[f"{name}_kernel_ms_turns"],
                     kernel_graph_ms=turns[f"{name}_kernel_graph_ms"],
                     kernel_graph_ms_turns=turns[f"{name}_kernel_graph_ms_turns"],
                     library_ms=turns[f"{name} sdpa_kernel_ms"],
                     library_graph_ms=turns[f"{name} sdpa_kernel_graph_ms"],
                     library_graph_ms_turns=turns[f"{name} sdpa_kernel_graph_ms_turns"])
        entry["kernel_vs_library_graph"] = entry["kernel_graph_ms"] / entry["library_graph_ms"]
        if entry["bound_ms"] is not None:
            entry["bound_share_graph"] = entry["bound_ms"] / entry["kernel_graph_ms"]
        FLASH_ROWS[name] = {key: entry[key] for key in FLASH_ROW_KEYS if key in entry}
    _emit({"yardstick": f"flash_attention bf16 D={d} (flash_group_fwd<{d}>) at the main paths' "
                        "shapes",
           "rows": shapes,
           "library_call": "F.scaled_dot_product_attention(is_causal=causal, enable_gqa=True)",
           "timing": "kernel_ms, library_ms: median of 3 alternating turns of 20 eager calls; "
                     "*_graph_ms: of CUDA graphs of 20 calls in the same turns; plain_ms: one "
                     "call"})
    return shapes


def _group_bwd_yardsticks(rows: list, d: int, rng, hw, failures: list[str]) -> dict[str, dict]:
    """The bf16 backward at D = Dv = ``d`` (``flash_bwd_delta_vec<d>`` then
    ``flash_bwd_d64`` or ``flash_bwd_d128``) at each shape of ``rows``
    (D64_BWD_ROWS: granite-moe's, zamba2-1.2b's and whisper-tiny's training
    attention; D128_BWD_ROWS: qwen3-4b's).  Each against its plain version
    within ``kernel_tolerance`` of each gradient's max and twice bitwise (the
    plain call timed once, ``plain_ms``), its kernels by name (device ms a
    call, over 10 calls), then the backward and SDPA's backward of every
    shape timed in three alternating turns (``_timed_in_turns``: eager calls
    and CUDA graphs of 20 calls; SDPA's backward in a graph is a graph of
    its forward and backward less one of its forward), beside the bound.  Also the turns'
    launch-weighted sum of graph times (the main paths' launches of each
    shape).  Emits one row, records each shape in FLASH_ROWS under its row
    name and returns the shapes' entries."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.core import roofline
    from repro_torch.kernels import flash_attention as fa

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    atol, rtol = fa.kernel_tolerance(bf16)
    forms, graph_forms, shapes = {}, {}, {}
    # the persistent kernels' work list (a checkout from before them has none;
    # one from before flash_bwd_d128 names it d64_bwd_plan and runs it at D=64)
    plan = getattr(fa, "persistent_bwd_plan", None) or (
        getattr(fa, "d64_bwd_plan", None) if d == 64 else None)
    for name, arch, b, sq, skv, hq, hkv, causal, launches in rows:
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(shp, dtype=np.float32)).to(dev, bf16)
                         for shp in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                                     (b, sq, hq, d)))
        o, lse = fa._forward(q, k, v, causal=causal, q_chunk=512, kv_chunk=1024, q_offset=0,
                             with_lse=True)
        got = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)
        again = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = fa.flash_attention_bwd_plain(q, k, v, o, dout, lse, causal=causal)
        end.record()
        torch.cuda.synchronize()
        shares, errs = {}, []
        for grad, g, w in zip(("dq", "dk", "dv"), got, want):
            errs.append((g.float() - w.float()).abs().max().item())
            shares[grad] = errs[-1] / (atol + rtol * w.float().abs().max().item())
        twice = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = (max(shares.values()) <= 1.0 and twice
              and all(bool(torch.isfinite(g.float()).all()) for g in got))
        if not ok:
            failures.append(f"flash_attention_bwd vs plain at {name}: {shares}, twice {twice}")
        grp = hq // hkv  # query heads of a kv head
        bwd = lambda q=q, k=k, v=v, o=o, dout=dout, lse=lse, c=causal: (  # noqa: E731
            fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=c))
        for _ in range(3):  # the profiler at times records no device event: again
            split = _profile(lambda bwd=bwd: [bwd() for _ in range(10)], top=3)["top_kernels"]
            if split:
                break
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        dout_t = dout.transpose(1, 2)
        o_lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                                 enable_gqa=True)
        forms[name] = bwd
        forms[f"{name} sdpa"] = lambda o_lib=o_lib, ins=(qt, kt, vt), g=dout_t: (
            torch.autograd.grad(o_lib, ins, g, retain_graph=True))
        # A backward is captured with its forward, on leaves of their own: a
        # leaf whose autograd node an eager forward made (and o_lib keeps)
        # syncs the capture with the legacy stream.  SDPA's backward in a
        # graph is the graph of both less the forward's.
        leaves = tuple(x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa = lambda ins=leaves, c=causal: (  # noqa: E731
            torch.nn.functional.scaled_dot_product_attention(*ins, is_causal=c, enable_gqa=True))
        graph_forms[f"{name} sdpa"] = lambda sdpa=sdpa, ins=leaves, g=dout_t: (
            torch.autograd.grad(sdpa(), ins, g))
        forms[f"{name} sdpa forward"] = sdpa
        backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, None, 0.0, causal, enable_gqa=True)).name
        bound = roofline.attention_bwd_bound(batch=b, sq=sq, skv=skv, hq=hq, hkv=hkv, d=d,
                                             causal=causal, dtype=bf16,
                                             hw=hw) if hw is not None else None
        shapes[name] = {"arch": arch, "shape": [b, sq, skv, hq, hkv, d], "causal": causal,
                        "main_path_launches": launches, "share_of_limit": shares,
                        "max_abs_err": max(errs), "bitwise_twice": twice, "ok": ok,
                        "plain_ms": start.elapsed_time(end), "library_backend": backend,
                        "kernel_split_ms": {kname: ms / count for kname, ms, count in split},
                        "bound_ms": None if bound is None else bound.bound_s * 1e3,
                        "bound_by": None if bound is None else bound.bound_by,
                        # the persistent kernel's: a head's pairs of key tiles of
                        # 64 and its dQ tiles of whole query groups
                        "work_items": b * hkv * ((-(-skv // 64) + 1) // 2
                                                 + -(-sq * grp // (128 // grp * grp))),
                        # its plan: the kind first, the chunk
                        "plan": None if plan is None
                        else plan(b, sq, skv, hq, hkv, causal=causal)[0],
                        "executed_flops": fa.bwd_executed_flops(b, sq, skv, hq, hkv, d,
                                                                causal=causal)}
        del want, got, again
    turns = {}
    _timed_in_turns(turns, forms, reps=20, graph=True, graph_forms=graph_forms)
    weighted = [0.0, 0.0, 0.0]
    for name, entry in shapes.items():
        library_turns = [both - fwd for both, fwd in zip(
            turns[f"{name} sdpa_kernel_graph_ms_turns"],
            turns[f"{name} sdpa forward_kernel_graph_ms_turns"])]
        entry.update(kernel_ms=turns[f"{name}_kernel_ms"],
                     kernel_ms_turns=turns[f"{name}_kernel_ms_turns"],
                     kernel_graph_ms=turns[f"{name}_kernel_graph_ms"],
                     kernel_graph_ms_turns=turns[f"{name}_kernel_graph_ms_turns"],
                     library_ms=turns[f"{name} sdpa_kernel_ms"],
                     library_graph_ms=statistics.median(library_turns),
                     library_graph_ms_turns=library_turns,
                     library_forward_graph_ms=turns[f"{name} sdpa forward_kernel_graph_ms"])
        entry["kernel_vs_library_graph"] = entry["kernel_graph_ms"] / entry["library_graph_ms"]
        if entry["bound_ms"] is not None:
            entry["bound_share_graph"] = entry["bound_ms"] / entry["kernel_graph_ms"]
        for i, ms in enumerate(entry["kernel_graph_ms_turns"]):
            weighted[i] += entry["main_path_launches"] * ms
        FLASH_ROWS[name] = {key: entry[key] for key in FLASH_ROW_KEYS if key in entry}
    FLASH_ROWS[f"5b D={d} launch-weighted"] = {"launch_weighted_graph_ms_turns": weighted}
    _emit({"yardstick": f"flash_attention_bwd bf16 D={d} (the persistent flash_bwd_d{d}) at the "
                        "main paths' training shapes", "rows": shapes,
           "launch_weighted_graph_ms_turns": weighted,
           "library_call": "backward of F.scaled_dot_product_attention(is_causal=causal, "
                           "enable_gqa=True) (torch.autograd.grad)",
           "timing": "kernel_ms, library_ms: median of 3 alternating turns of 20 eager calls; "
                     "*_graph_ms: of CUDA graphs of 20 calls in the same turns (SDPA's "
                     "backward: a graph of its forward and backward less one of its forward, "
                     "turn by turn); plain_ms: one call; kernel_split_ms: profiler, device ms "
                     "a call"})
    return shapes


# the digest forms: (label, dtype, batch, sq, skv, hq, hkv, d, dv, causal)
DIGEST_FORMS = [
    ("bf16 D=128 G=4", "bfloat16", 2, 512, 512, 16, 4, 128, 128, True),
    ("bf16 D=64 G=2", "bfloat16", 2, 333, 333, 8, 4, 64, 64, True),
    ("bf16 D=32 G=1", "bfloat16", 1, 200, 200, 4, 4, 32, 32, True),
    ("f32 D=128 G=4", "float32", 1, 300, 300, 8, 2, 128, 128, True),
    ("f32 D=192 Dv=128 G=1", "float32", 1, 256, 256, 4, 4, 192, 128, True),
    # flash_bwd_d64 with fewer dQ items than dK/dV items (2 row tiles, 6 pairs a head)
    ("bf16 D=64 G=1 Sq<Skv non-causal", "bfloat16", 2, 200, 700, 4, 4, 64, 64, False),
    # D=128 at the registry's other G: internvl2-26b's 6 (items of 126
    # folded rows, the last group ragged), granite-34b's 48 (MQA) and
    # yi-6b's 8, non-causal with Sq < Skv
    ("bf16 D=128 G=6 ragged 333", "bfloat16", 2, 333, 333, 24, 4, 128, 128, True),
    ("bf16 D=128 G=48", "bfloat16", 1, 300, 300, 48, 1, 128, 128, True),
    ("bf16 D=128 G=8 Sq<Skv non-causal", "bfloat16", 2, 200, 700, 32, 4, 128, 128, False),
]


def _flash_digests(seed: int) -> dict[str, str]:
    """The first 16 hex digits of a sha256 over the flash kernels' results
    in each form of DIGEST_FORMS (inputs from ``seed``): the forward's out
    and lse, the backward's dq, dk and dv.  Two checkouts that print the
    same digest for a form give the same bits there."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(seed + 99)
    digests = {}
    for label, dtype, b, sq, skv, hq, hkv, d, dv, causal in DIGEST_FORMS:
        dt = getattr(torch, dtype)
        q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
            "cuda", dt) for shape in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, dv),
                                      (b, sq, hq, dv)))
        out, lse = fa._forward(q, k, v, causal=causal, q_chunk=512, kv_chunk=1024, q_offset=0,
                               with_lse=True)
        grads = fa.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal)
        digest = hashlib.sha256()
        for t in (out, lse, *grads):
            digest.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        digests[label] = digest.hexdigest()[:16]
    return digests


def _mla_parts(rng, b, sq, skv, h, rope_heads, dt, *, dout: bool = False) -> list:
    """MLA's attention parts on the card as ``models/mla.py`` makes them:
    q_nope a view of a 192-wide q projection (its rope columns beside it),
    q_rope, k_nope, k_rope of ``rope_heads`` heads (MLA's one shared
    channel, or one a head), v; and dout."""
    import numpy as np
    import torch

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to("cuda", dt)

    parts = [normal(b, sq, h, 192)[..., :128], normal(b, sq, h, 64), normal(b, skv, h, 128),
             normal(b, skv, rope_heads, 64), normal(b, skv, h, 128)]
    return parts + [normal(b, sq, h, 128)] * dout


def _mla_fwd_checks(rng, failures: list[str]) -> float:
    """The flash forward's split entry (``flash_attention_split``, the
    kernel on MLA's parts in place) against the plain version on the
    concatenated q and k in every form of MLA_FORMS, within
    ``kernel_tolerance``, and the same bits twice.  Returns the largest
    absolute error."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    worst = 0.0
    for label, b, sq, skv, h, hr, causal, q_offset, dtype in MLA_FORMS:
        dt = getattr(torch, dtype)
        parts = _mla_parts(rng, b, sq, skv, h, hr, dt)
        got = fa.flash_attention_split(*parts, causal=causal, q_offset=q_offset)
        again = fa.flash_attention_split(*parts, causal=causal, q_offset=q_offset)
        q, k = fa._joined(*parts[:4])
        want = fa.flash_attention_plain(q, k, parts[4], causal=causal, q_offset=q_offset)
        torch.cuda.synchronize()
        atol, rtol = fa.kernel_tolerance(dt)
        diff = torch.abs(got.float() - want.float())
        err = diff.max().item()
        ok = (got.shape == (b, sq, h, 128) and bool(torch.isfinite(got.float()).all())
              and bool((diff <= atol + rtol * torch.abs(want.float())).all())
              and torch.equal(got, again))
        worst = max(worst, err)
        _emit({"check": "kernel_vs_plain", "kernel": "flash_attention_split",
               "form": f"mla {label}", "shape": [b, sq, skv, h, hr, 192, 128], "causal": causal,
               "q_offset": q_offset, "dtype": dtype, "max_abs_err": err, "atol": atol,
               "rtol": rtol, "bitwise_twice": torch.equal(got, again), "ok": ok})
        if not ok:
            failures.append(f"flash_attention_split (192, 128) vs plain {label}: err {err}")
        del parts, got, again, q, k, want, diff
    return worst


def _mla_bwd_checks(rng, failures: list[str]) -> float:
    """The flash backward's split entry (``flash_attention_split_bwd``)
    against the plain backward on the concatenated q and k, split the same
    way, in every form of MLA_BWD_FORMS: the five gradients (dq's two
    parts, dk_nope, dk_rope, dv) within ``kernel_tolerance`` scaled to each
    one's largest magnitude; each form twice, bitwise; the forward's out
    with lse against without it (bitwise) and its lse against the plain
    version's (1e-5 + 1e-5 relative).  Returns the largest absolute error."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    worst = 0.0
    names = ("dq_nope", "dq_rope", "dk_nope", "dk_rope", "dv")
    for label, b, sq, skv, h, hr, causal, q_offset, dtype in MLA_BWD_FORMS:
        dt = getattr(torch, dtype)
        *parts, dout = _mla_parts(rng, b, sq, skv, h, hr, dt, dout=True)
        kw = dict(causal=causal, q_chunk=512, kv_chunk=1024, q_offset=q_offset)
        bare, _ = fa._split_forward(*parts, with_lse=False, **kw)
        out, lse = fa._split_forward(*parts, with_lse=True, **kw)
        q, k = fa._joined(*parts[:4])
        _, lse_plain = fa.flash_attention_plain(q, k, parts[4], return_lse=True, **kw)
        got = fa.flash_attention_split_bwd(*parts, out, dout, lse, causal=causal,
                                           q_offset=q_offset)
        again = fa.flash_attention_split_bwd(*parts, out, dout, lse, causal=causal,
                                             q_offset=q_offset)
        dq, dk, dv = fa.flash_attention_bwd_plain(q, k, parts[4], out, dout, lse, **kw)
        want = (*fa._split_grads(dq, dk.float(), 64, hr), dv)  # dk_rope's heads summed in f32
        torch.cuda.synchronize()
        atol, rtol = fa.kernel_tolerance(dt)
        row = {"check": "kernel_vs_plain", "kernel": "flash_attention_split_bwd", "form": label,
               "shape": [b, sq, skv, h, hr, 192, 128], "causal": causal, "q_offset": q_offset,
               "dtype": dtype, "atol": atol, "rtol_of_max": rtol}
        ok = True
        for name, g, w, t in zip(names, got, want, parts):
            err, scale = (g.float() - w.float()).abs().max().item(), w.float().abs().max().item()
            row[f"{name}_share_of_limit"] = err / (atol + rtol * scale)
            ok = (ok and err <= atol + rtol * scale and g.shape == t.shape
                  and bool(torch.isfinite(g.float()).all()))
            worst = max(worst, err)
        row["bitwise_twice"] = all(torch.equal(x, y) for x, y in zip(got, again))
        row["out_bitwise_with_lse"] = torch.equal(out, bare)
        lse_diff = (lse - lse_plain).abs()
        row["lse_max_abs_err"] = lse_diff.max().item()
        lse_ok = bool((lse_diff <= 1e-5 + 1e-5 * lse_plain.abs()).all())
        row["ok"] = ok and row["bitwise_twice"] and row["out_bitwise_with_lse"] and lse_ok
        _emit(row)
        if not row["ok"]:
            failures.append(f"flash_attention_split_bwd vs plain {label}: {row}")
        del parts, dout, bare, out, lse, lse_plain, got, again, want, q, k, dq, dk, dv
    return worst


def _timed_in_turns(row: dict, forms: dict, reps: int, graph: bool, rounds: int = 3,
                    graph_forms: dict | None = None) -> None:
    """Each form of ``forms`` (name -> call) timed in ``rounds`` turns, the
    forms alternating within a turn, so that a card that warms over the row
    weighs on every form alike: ``<form>_kernel_ms`` the median of the
    turns (eager calls), ``<form>_kernel_ms_turns`` each, and with
    ``graph`` ``<form>_kernel_graph_ms`` the median of CUDA graphs timed in
    the same turns, ``<form>_kernel_graph_ms_turns`` each.  ``graph_forms``
    (name -> call) gives a form's graph a call of its own."""
    import statistics

    eager = {form: [] for form in forms}
    graphs = {form: [] for form in forms}
    for _ in range(rounds):
        for form, fn in forms.items():
            eager[form].append(_time_ms(fn, reps=reps))
            if graph:
                graphs[form].append(_graph_ms((graph_forms or {}).get(form, fn)))
    for form in forms:
        row[f"{form}_kernel_ms"] = statistics.median(eager[form])
        row[f"{form}_kernel_ms_turns"] = eager[form]
        if graph:
            row[f"{form}_kernel_graph_ms"] = statistics.median(graphs[form])
            row[f"{form}_kernel_graph_ms_turns"] = graphs[form]


def _mla_fwd_yardstick(b: int, s: int, h: int, rng, hw, failures: list[str]) -> dict:
    """The flash forward at MLA's prefill shape (bf16, causal, G = 1,
    (192, 128)): the split entry on MLA's parts (k_rope one channel: the
    main path's call) and ``flash_attention`` on the concatenated 192-wide
    q and k (the call earlier PRs timed), each against the plain version,
    timed in eager calls and in a CUDA graph beside the plain version, SDPA
    (the backend it picks, or ``library_refused``) and the bounds: the
    split form's, where k's rope channel is read once (``shared_k``), and
    the concatenated form's.  Without ``flash_attention_split`` (a tree
    from before it) the concatenated form alone.  Emits the row, records
    it in FLASH_ROWS and returns it."""
    import torch

    from repro_torch.core import roofline
    from repro_torch.kernels import flash_attention as fa

    bf16 = torch.bfloat16
    d, dv = 192, 128
    atol, rtol = fa.kernel_tolerance(bf16)
    parts = _mla_parts(rng, b, s, s, h, 1, bf16)
    split = hasattr(fa, "flash_attention_split")
    q = torch.cat(parts[:2], dim=-1)
    k = torch.cat([parts[2], parts[3].expand(b, s, h, 64)], dim=-1)
    v = parts[4]
    want = fa.flash_attention_plain(q, k, v)
    forms = {"concat": lambda: fa.flash_attention(q, k, v)}
    if split:
        forms["split"] = lambda: fa.flash_attention_split(*parts)
    row = {"yardstick": f"flash_attention bf16 causal B={b} S={s} H={h} G=1 D={d} Dv={dv}"}
    ok = True
    for form, fn in forms.items():
        diff = (fn().float() - want.float()).abs()
        good = bool((diff <= atol + rtol * want.float().abs()).all())
        ok = ok and good
        row[f"{form}_max_abs_err"] = diff.max().item()
    _timed_in_turns(row, forms, reps=20, graph=True)
    main = "split" if split else "concat"
    row["kernel_ms"], row["kernel_graph_ms"] = row[f"{main}_kernel_ms"], \
        row[f"{main}_kernel_graph_ms"]
    row["plain_ms"] = _time_ms(lambda: fa.flash_attention_plain(q, k, v), reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    row.update(library_ms=None, library_graph_ms=None, library_backend=None,
               library_max_abs_diff=None, library_refused=None)
    try:
        out_lib = sdpa()
    except RuntimeError as e:  # SDPA may refuse a value head other than the key head's
        row["library_refused"] = str(e)[:300]
    else:
        # the backend SDPA dispatches these inputs to (PyTorch's own choice)
        backend = torch._fused_sdp_choice(qt, kt, vt, None, 0.0, True)
        row.update(library_ms=_time_ms(sdpa, reps=20), library_graph_ms=_graph_ms(sdpa),
                   library_backend=torch.nn.attention.SDPBackend(backend).name,
                   library_max_abs_diff=(out_lib.transpose(1, 2).float()
                                         - want.float()).abs().max().item())
        del out_lib
    row["library_call"] = "F.scaled_dot_product_attention(is_causal=True) on (B, H, S, D|Dv)"
    if hw is not None:
        for form, shared in (("concat", 0), ("split", 64))[:len(forms)]:
            extra = {"shared_k": shared} if shared else {}
            bound = roofline.attention_bound(batch=b, sq=s, skv=s, hq=h, hkv=h, d=d, dv=dv,
                                             dtype=bf16, hw=hw, **extra)
            row[f"{form}_bytes"], row[f"{form}_bound_ms"] = bound.bytes, bound.bound_s * 1e3
            row[f"{form}_bound_by"] = bound.bound_by
        row["flops"], row["ops_bound_ms"] = bound.flops, bound.compute_s * 1e3
    row["bound_ms"] = row.get(f"{main}_bound_ms")
    row["bound_by"] = row.get(f"{main}_bound_by")
    row["bound_share"] = None if row["bound_ms"] is None else row["bound_ms"] / row["kernel_ms"]
    executed = fa.executed_flops(b, s, s, h, h, d, dv=dv)
    row.update(executed_flops=executed, executed_TFLOPs=executed / row["kernel_ms"] / 1e9,
               ok=ok, timing="*_ms: eager calls; *_graph_ms: CUDA graph of 20 calls")
    _emit(row)
    FLASH_ROWS["5-mla"] = {key: row.get(key) for key in FLASH_ROW_KEYS + (
        "split_kernel_ms", "concat_kernel_ms", "concat_bound_ms") if key in row}
    if not ok:
        failures.append(f"flash_attention at {row['yardstick']}: {row}")
    return row


def _mla_bwd_yardstick(b: int, s: int, h: int, rng, hw, failures: list[str]) -> dict:
    """The flash backward at MLA's training shape (bf16, causal, G = 1,
    (192, 128)): the split entry on MLA's parts (the main path's call) and
    ``flash_attention_bwd`` on the concatenated q and k (the call earlier
    PRs timed), each against the plain backward within
    ``kernel_tolerance`` of each gradient's max and the same bits twice;
    timed in eager calls (the split entry also in a CUDA graph) beside the
    plain version, SDPA's backward (by backend) and the bounds (the split
    form's, k's rope channel and its gradient moved once); the three
    kernels' device ms by name (delta, dK/dV, dQ).  Without the split entry
    the concatenated form alone.  Emits the row, records it in FLASH_ROWS
    and returns it."""
    import torch

    from repro_torch.core import roofline
    from repro_torch.kernels import flash_attention as fa

    bf16 = torch.bfloat16
    d, dv = 192, 128
    atol, rtol = fa.kernel_tolerance(bf16)
    *parts, dout = _mla_parts(rng, b, s, s, h, 1, bf16, dout=True)
    split = hasattr(fa, "flash_attention_split")
    q = torch.cat(parts[:2], dim=-1)
    k = torch.cat([parts[2], parts[3].expand(b, s, h, 64)], dim=-1)
    v = parts[4]
    o, lse = fa._forward(q, k, v, causal=True, q_chunk=512, kv_chunk=1024, q_offset=0,
                         with_lse=True)
    dq, dk, dv_want = fa.flash_attention_bwd_plain(q, k, v, o, dout, lse)
    forms = {"concat": (lambda: fa.flash_attention_bwd(q, k, v, o, dout, lse),
                        (dq, dk, dv_want))}
    if split:
        forms["split"] = (lambda: fa.flash_attention_split_bwd(*parts, o, dout, lse),
                          (*fa._split_grads(dq, dk.float(), 64, 1), dv_want))
    row = {"yardstick": f"flash_attention_bwd bf16 causal B={b} S={s} H={h} G=1 D={d} Dv={dv}"}
    ok = True
    for form, (fn, want) in forms.items():
        got, again = fn(), fn()
        shares = [(g.float() - w.float()).abs().max().item()
                  / (atol + rtol * w.float().abs().max().item()) for g, w in zip(got, want)]
        twice = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = ok and max(shares) <= 1.0 and twice
        row[f"{form}_share_of_limit"], row[f"{form}_bitwise_twice"] = shares, twice
        del got, again
    _timed_in_turns(row, {form: fn for form, (fn, _) in forms.items()}, reps=30, graph=False)
    main = "split" if split else "concat"
    fn = forms[main][0]
    row["kernel_ms"], row["kernel_graph_ms"] = row[f"{main}_kernel_ms"], _graph_ms(fn)
    split_ms = _profile(lambda: [fn() for _ in range(10)], top=3)["top_kernels"]
    row["kernel_split_ms"] = {name: ms / count for name, ms, count in split_ms}
    row["plain_ms"] = _time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, dout, lse),
                               reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    backend = torch.nn.attention.SDPBackend(torch._fused_sdp_choice(
        qt, kt, vt, None, 0.0, True)).name
    o_lib = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(o_lib, (qt, kt, vt), dout.transpose(1, 2),  # noqa: E731
                                           retain_graph=True)
    row.update(library_ms=_time_ms(sdpa_bwd, reps=50), library_backend=backend,
               library_call="backward of F.scaled_dot_product_attention(is_causal=True) "
                            "(torch.autograd.grad)")
    if hw is not None:
        for form, shared in (("concat", 0), ("split", 64))[:len(forms)]:
            extra = {"shared_k": shared} if shared else {}
            bound = roofline.attention_bwd_bound(batch=b, sq=s, skv=s, hq=h, hkv=h, d=d, dv=dv,
                                                 dtype=bf16, hw=hw, **extra)
            row[f"{form}_bytes"], row[f"{form}_bound_ms"] = bound.bytes, bound.bound_s * 1e3
            row[f"{form}_bytes_ms"] = bound.memory_s * 1e3
            row[f"{form}_bound_by"] = bound.bound_by
        row["flops"], row["ops_bound_ms"] = bound.flops, bound.compute_s * 1e3
    row["bound_ms"] = row.get(f"{main}_bound_ms")
    row["bound_by"] = row.get(f"{main}_bound_by")
    row["bound_share"] = None if row["bound_ms"] is None else row["bound_ms"] / row["kernel_ms"]
    executed = fa.bwd_executed_flops(b, s, s, h, h, d, dv=dv)
    row.update(executed_flops=executed, executed_TFLOPs=executed / row["kernel_ms"] / 1e9,
               own_floor_ms=None if hw is None else executed / hw.peak_flops_bf16 * 1e3,
               kernel_vs_library=row["kernel_ms"] / row["library_ms"], ok=ok,
               timing="*_ms: eager calls; kernel_graph_ms: CUDA graph of 20 calls")
    _emit(row)
    FLASH_ROWS["5b-mla"] = {key: row.get(key) for key in FLASH_ROW_KEYS + (
        "split_kernel_ms", "concat_kernel_ms", "concat_bound_ms") if key in row}
    if not ok:
        failures.append(f"flash_attention_bwd at {row['yardstick']}: {row}")
    return row


def _pipeline_phase(seed: int, failures: list[str]) -> dict[str, float]:
    """GPipe on the card (``distributed.pipeline``): first the flash kernels
    against their plain versions at the stages' shape (``_flash_checks``,
    ``_bwd_checks``: one PIPE_SEQ-token sequence, qwen3-4b's heads, bf16,
    causal), since the pipeline against the sequential pass runs the same
    kernels on both sides and witnesses the schedule alone; then qwen3-4b's
    36 layers at full width in PIPE_STAGES stages of 9 (stacked bf16
    leaves, matrices at std 0.02), PIPE_MICRO microbatches of one
    PIPE_SEQ-token sequence (bf16); the outputs and the gradient of every
    leaf of a sum-of-squares loss through ``pipeline_forward`` against
    ``sequential_reference``, bitwise; the flash launches of each (one
    forward and one backward a layer and microbatch); peak memory and wall
    time.  One unmeasured pass of each warms both; each measured pass's
    outputs and gradients go to the host before the other runs, so neither
    peak holds the other's.  Returns the pipeline's forward and backward
    launches (``fwd``, ``bwd``) and the kernels' largest errors against
    their plain versions (``fwd_err``, ``bwd_err``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import pipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, transformer

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = dataclasses.replace(get_config(LM_ARCH), dtype="bfloat16")
    rng = np.random.default_rng(seed + 29)
    form = [("gpipe stage bf16 causal", 1, PIPE_SEQ, PIPE_SEQ, cfg.n_heads, cfg.n_kv_heads,
             cfg.head_dim, True, 0, "bfloat16")]
    fwd_err, bwd_err = _flash_checks(rng, failures, form), _bwd_checks(rng, failures, form)
    per_stage = cfg.n_layers // PIPE_STAGES
    spec = common.stack_specs(common.stack_specs(transformer.layer_spec(cfg, moe_layer=False),
                                                 per_stage), PIPE_STAGES)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params: dict = {}
    for path, s in common.tree_leaves(spec):
        x = (torch.ones(s.shape, dtype=bf16, device=dev) if s.init == "ones"
             else torch.randn(s.shape, generator=gen, device=dev).mul_(0.02).to(bf16))
        common.tree_set(params, path, x.requires_grad_())
    leaves = [t for _, t in common.tree_leaves(params)]
    n_params = sum(t.numel() for t in leaves)
    x = torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model), generator=gen, device=dev).to(bf16)
    pos = torch.arange(PIPE_SEQ, device=dev)[None]

    def stage(p, h):
        for i in range(per_stage):
            h = transformer.layer_apply(_index_tree(p, i), h, cfg, positions=pos,
                                        moe_layer=False)[0]
        return h

    schedules = (("pipeline", pipeline.pipeline_forward, {"stages": PIPE_STAGES}),
                 ("sequential", pipeline.sequential_reference, {}))
    for _, fn, kw in schedules:  # warm-up, unmeasured
        torch.autograd.grad(fn(params, x, stage, **kw).float().square().sum(), leaves)
    found = {}
    for name, fn, kw in schedules:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        out = fn(params, x, stage, **kw)
        grads = torch.autograd.grad(out.float().square().sum(), leaves)
        torch.cuda.synchronize()
        wall_s, counts = time.perf_counter() - t0, _counts()
        found[name] = {"out": out.detach().cpu(), "grads": [g.cpu() for g in grads],
                       "wall_s": wall_s,
                       "peak_memory_GB": torch.cuda.max_memory_allocated() / 1e9,
                       "launches": [counts[fa.LAUNCHES.name], counts[fa.BWD_LAUNCHES.name]],
                       "by_kernel": _by_kernel()}
        del out, grads
    pipe, seq = found["pipeline"], found["sequential"]
    same_out = torch.equal(pipe["out"], seq["out"])
    same_grads = all(torch.equal(a, b) for a, b in zip(pipe["grads"], seq["grads"]))
    expected = PIPE_MICRO * cfg.n_layers
    row = {"row": "gpipe", "arch": cfg.name, "n_layers": cfg.n_layers, "stages": PIPE_STAGES,
           "layers_per_stage": per_stage, "microbatches": PIPE_MICRO, "seq": PIPE_SEQ,
           "dtype": "bfloat16", "params": n_params, "ticks": PIPE_MICRO + PIPE_STAGES - 1,
           "outputs_bitwise": same_out, "grads_bitwise": same_grads,
           "finite": bool(torch.isfinite(pipe["out"].float()).all()),
           "launches": pipe["launches"], "sequential_launches": seq["launches"],
           "expected_launches": [expected, expected], "launches_by_kernel": pipe["by_kernel"],
           "peak_memory_GB": pipe["peak_memory_GB"],
           "sequential_peak_memory_GB": seq["peak_memory_GB"],
           "wall_s": pipe["wall_s"], "sequential_wall_s": seq["wall_s"]}
    row["ok"] = (same_out and same_grads and row["finite"]
                 and pipe["launches"] == seq["launches"] == [expected, expected]
                 and pipe["by_kernel"] == {D128_FWD_KERNEL: expected, D128_BWD_KERNEL: expected})
    _emit(row)
    if not row["ok"]:
        failures.append(f"gpipe: {row}")
    del found, pipe, seq, params, leaves, x
    torch.cuda.empty_cache()
    return {"fwd": row["launches"][0], "bwd": row["launches"][1], "fwd_err": fwd_err,
            "bwd_err": bwd_err, "by_kernel": row["launches_by_kernel"]}


def _index_tree(tree: dict, i: int) -> dict:
    """Every leaf of a nested dict at index ``i`` of its leading dim."""
    return {k: _index_tree(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _dryrun_phase(failures: list[str]) -> None:
    """The dry run through its CLI on the card's machine: DRYRUN_CASES (the
    four at once, one process each; ``meta`` tensors, nothing allocated)
    into ``build/dryrun_torch``, each ``[ok]`` with a JSON of positive flops
    and bytes and a dominant term; then the fig7 launch (DRYRUN_FIG7: two
    controller processes on the card over 1, 2 and 4 t-slabs of PAPER_L32's
    lattice), which exits non-zero on any divergence."""
    import os

    out_dir = ROOT / "build" / "dryrun_torch"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    t0 = time.perf_counter()
    procs = [(case, subprocess.Popen(
        cli + ["--arch", case[0], "--shape", case[1], "--mesh", case[2], "--results-dir",
               str(out_dir)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for case in DRYRUN_CASES]
    for (arch, shape, mesh), proc in procs:
        try:
            log, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        path = out_dir / f"{arch}__{shape}__{mesh}.json"
        result = json.loads(path.read_text()) if path.is_file() else {}
        r = result.get("roofline", {})
        row = {"row": "dryrun cell", "cell": f"{arch}/{shape}/{mesh}", "rc": proc.returncode,
               "status": result.get("status"), "traced_s": result.get("lower_s"),
               "traced_ops": result.get("traced_ops"), "device": result.get("device"),
               "flops_per_device": r.get("flops_per_device"),
               "bytes_per_device": r.get("bytes_per_device"), "dominant": r.get("dominant"),
               "compute_ms": None if not r else r["compute_s"] * 1e3,
               "memory_ms": None if not r else r["memory_s"] * 1e3,
               "model_flops": r.get("model_flops"),
               "analytic_GiB": result.get("memory_analytic", {}).get("total_bytes", 0) / 2**30,
               "fits_h100_80g": result.get("memory_analytic", {}).get("fits_h100_80g")}
        row["ok"] = (proc.returncode == 0 and "[ok]" in log and row["status"] == "ok"
                     and (row["flops_per_device"] or 0) > 0 and (row["bytes_per_device"] or 0) > 0
                     and row["dominant"] in ("compute", "memory", "collective"))
        _emit(row)
        if not row["ok"]:
            failures.append(f"dryrun {row['cell']}: {row} {log[-1500:]}")
    cells_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(cli + DRYRUN_FIG7, env=env, capture_output=True, text=True, timeout=600)
    rows = json.loads(proc.stdout) if proc.returncode == 0 else []
    row = {"row": "dryrun su3 fig7", "args": DRYRUN_FIG7, "rc": proc.returncode,
           "points": [r["name"] for r in rows], "verified": [r["verified"] for r in rows],
           "hosts": [r["hosts"] for r in rows], "GBYTES": [r["GBYTES"] for r in rows],
           "plans": [r["plan"] for r in rows], "devices": sorted({r["device"] for r in rows}),
           "controllers": sorted({r["controllers"] for r in rows}),
           "cells_s": cells_s, "fig7_s": time.perf_counter() - t0}
    row["ok"] = (proc.returncode == 0 and len(rows) == 6 and all(row["verified"])
                 and row["controllers"] == [2] and "[DIVERGENCE]" not in proc.stderr)
    _emit(row)
    if not row["ok"]:
        failures.append(f"dryrun su3 fig7: {row} {proc.stderr[-1500:]}")


def _zamba_phase(seed: int, hw, failures: list[str]) -> dict[str, int]:
    """The zamba hybrid on the card at zamba2-1.2b's full width, cut to ZAMBA_DEPTH:
    serving (``_zamba_serve``), training (``_zamba_train``) and the flash
    kernels at its shared block's heads, D=64, G = 1 (``_head_yardsticks``:
    the forward at the prefill shape, the backward at the training shape).
    Returns the flash launches of its main paths: ``serve``,
    ``train_fwd``, ``train_bwd``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 21)
    serve = _zamba_serve(seed, rng, failures)
    torch.cuda.empty_cache()
    train_fwd, train_bwd = _zamba_train(seed, failures)
    torch.cuda.empty_cache()
    _head_yardsticks(ZAMBA_ARCH, rng, hw, failures)
    return {"serve": serve, "train_fwd": train_fwd, "train_bwd": train_bwd}


def _teacher_gap(served, teacher) -> dict:
    """Served decode logits (B, T, V) against a teacher-forced pass's on the
    same positions."""
    import torch

    diff = torch.abs(served - teacher)
    return {"finite": bool(torch.isfinite(served).all()) and bool(torch.isfinite(teacher).all()),
            "max_abs_diff": diff.max().item(), "mean_abs_diff": diff.mean().item(),
            "max_abs_diff_by_position": diff.amax(dim=(0, 2)).tolist(),
            "scale": torch.abs(teacher).max().item(),
            "token_agreement": float((served.argmax(-1) == teacher.argmax(-1)).float().mean())}


def _zamba_teacher(engine, toks_d) -> dict:
    """The engine's prefill of the LM_PROMPT-token prompts, then its 31
    decode steps on the served tokens ``toks_d``, each counted from 0,
    against one cache-less teacher forward over the 1,055 served tokens
    padded to 1,152 (9 chunks of 128): every layer is causal, so the
    padding moves no logit at positions 1,023 .. 1,054.  A prefill with a
    state over the 31 decoded tokens is no teacher: the shared block's
    attention given a cache and more than one token attends over those
    tokens alone (the reference's ``attention.apply`` does the same), and
    one forward over 1,055 tokens is refused (no multiple of 128)."""
    import torch

    from repro_torch.models import mamba2, zamba

    # (B, 32, V): positions 1023 .. 1054
    served, prefill_launches, decode_launches = _served_decode(engine, toks_d, LM_PROMPT)
    n_real = LM_PROMPT + LM_NEW - 1
    padded = torch.zeros((LM_BATCH, -(-n_real // mamba2.CHUNK) * mamba2.CHUNK), dtype=torch.int32,
                         device=toks_d.device)
    padded[:, :n_real] = toks_d[:, :n_real]
    x, _ = zamba.forward(engine.params, {"tokens": padded}, engine.cfg)
    teacher = zamba._logits(engine.params, x[:, LM_PROMPT - 1:n_real], engine.cfg).float()
    found = {"dtype": engine.cfg.dtype, "teacher": f"one forward over {n_real} tokens padded "
                                                  f"to {padded.shape[1]}",
             "prefill_launches": prefill_launches, "decode_launches": decode_launches,
             **_teacher_gap(served, teacher)}
    del x, served, teacher, padded
    torch.cuda.empty_cache()
    return found


def _zamba_serve(seed: int, rng, failures: list[str]) -> int:
    """``ServeEngine`` on full-width zamba2-1.2b cut to ZAMBA_DEPTH (random bf16
    weights from the seed, matrices at std 0.02, f32 Mamba2 states and KV
    caches) over 4 x 1,024-token prompts + 32 greedy tokens, the counters
    set to 0 just before and read just after (one flash launch per shared
    application in prefill, 0 in decode); decode logits against a
    teacher-forced pass (``_zamba_teacher``); the launches of one Mamba2
    layer and of one shared application in prefill and in decode; a
    profile of one prefill and 4 decode steps.  Then the same teacher check
    at the reference's init rule in f32, held to the same tolerance; then
    the card against the port's CPU path on ZAMBA_CUT in f32 (matrices at
    std 0.02), logits and states.  Returns the flash launches of the
    served generate.

    Why std 0.02 for the served weights, as the MoE and MLA phases draw
    them: at the reference's rule (1/sqrt(38) on the stacked Mamba2
    leaves) decode parts from its teacher in bf16 by more than 0.1 of the
    logits' range at the whole depth, in the reference as in the port
    (tests/test_torch_bf16_teacher_gap.py measures both on the CPU at 13
    of the 38 layers: the port's gap is at most the reference's, and f32
    closes it in both)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, mamba2, registry, zamba
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(ZAMBA_ARCH), **ZAMBA_DEPTH)
    print(f"reduced: {json.dumps(ZAMBA_REDUCED)}")
    n_groups, k, tail = zamba._counts(cfg)
    t0 = time.perf_counter()
    model = _matrices_at(registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                                                cfg, torch.bfloat16), 0.02, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, model, ServeConfig(max_len=LM_MAX_LEN), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    tokens, counts, speed = _generate_twice(engine, prompts)
    launches = counts[fa.LAUNCHES.name]
    toks_d = torch.from_numpy(tokens).to(dev)
    teacher = _zamba_teacher(engine, toks_d)
    # the launches of one Mamba2 layer and one shared application, prefill and decode
    lp, sp = engine.params["mamba_layers"][0], engine.params["shared_attn"]
    h = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), device=dev).to(torch.bfloat16)
    st = mamba2.init_state(cfg, LM_BATCH, device=dev)
    cache = engine.init_state(LM_BATCH)["attn"][0]
    pos = torch.arange(LM_PROMPT, device=dev).expand(LM_BATCH, LM_PROMPT)
    per_call = {
        "mamba2_layer": {
            "prefill": _profile(lambda: zamba._mamba_block(lp, h, cfg, st))["kernel_launches"],
            "decode": _profile(lambda: zamba._mamba_block(lp, h[:, :1], cfg, st))[
                "kernel_launches"]},
        "shared_application": {
            "prefill": _profile(lambda: zamba._shared_block(sp, h, cfg, pos, cache, 0))[
                "kernel_launches"],
            "decode": _profile(lambda: zamba._shared_block(
                sp, h[:, :1], cfg, pos[:, :1] + LM_PROMPT, cache, LM_PROMPT))["kernel_launches"]}}
    del h, st, cache, pos
    prof_prefill, prof_decode = _serving_profiles("zamba", engine, toks_d, LM_PROMPT,
                                                  "4 x 1,024 tokens")
    n_params = common.count_params(engine.params)
    del engine, model
    torch.cuda.empty_cache()
    # the same teacher check at the reference's init rule in f32, on the served tokens
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ref32 = _zamba_teacher(ServeEngine(cfg32, registry.get(cfg32).init(
        torch.Generator(device=dev).manual_seed(seed), cfg32), ServeConfig(max_len=LM_MAX_LEN),
        device=dev), toks_d)
    torch.cuda.empty_cache()
    row = {"row": "zamba serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "groups_size_tail": [n_groups, k, tail], "d_model": cfg.d_model,
           "mamba2_dims": list(mamba2.dims(cfg)), "ssm_conv": cfg.ssm_conv,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "params": n_params,
           "reduced": ZAMBA_REDUCED, "dtype": "bfloat16", "matrices_std": 0.02,
           "state_dtype": "float32",
           "cache_dtype": "float32", "batch": LM_BATCH, "prompt": LM_PROMPT,
           "new_tokens": LM_NEW, "max_len": LM_MAX_LEN, "init_s": init_s,
           "flash_launches": launches, "expected_launches": n_groups,
           "prefill_launches": teacher["prefill_launches"],
           "decode_launches": teacher["decode_launches"],
           "other_launches": sum(counts.values()) - launches,
           "prefill_kernel_launches": prof_prefill["kernel_launches"],
           "decode_kernel_launches_per_step": prof_decode["kernel_launches"] / 4,
           "kernel_launches_per_call": per_call, **speed,
           "prefill_idle_share": prof_prefill["idle_share"],
           "decode_idle_share": prof_decode["idle_share"],
           "teacher": teacher, "teacher_tol_of_scale": LM_TEACHER_TOL,
           "reference_rule_f32_teacher": ref32}
    row["ok"] = (launches == n_groups and teacher["prefill_launches"] == n_groups
                 and teacher["decode_launches"] == 0 and row["other_launches"] == 0
                 and tokens.shape == (LM_BATCH, LM_PROMPT + LM_NEW)
                 and all(t["finite"] and t["max_abs_diff"] <= LM_TEACHER_TOL * t["scale"]
                         for t in (teacher, ref32)))
    _emit(row)
    if not row["ok"]:
        failures.append(f"zamba serve main path: {row}")
    del toks_d
    torch.cuda.empty_cache()

    # -- the card against the port's CPU path: full width, ZAMBA_CUT, f32 ---------------
    # (the weights are drawn on the card, which is fast, and copied to the CPU)
    cfg2 = dataclasses.replace(cfg, dtype="float32", **ZAMBA_CUT)
    _serve_cross_device("zamba cross-device", cfg2, _matrices_at(
        registry.get(cfg2).init(torch.Generator(device=dev).manual_seed(seed), cfg2), 0.02, seed),
        rng, failures)
    return launches


def _zamba_train(seed: int, failures: list[str]) -> tuple[int, int]:
    """``train.loop.train`` on full-width zamba2-1.2b cut to ZAMBA_DEPTH (f32 master
    weights and moments, bf16 compute, each Mamba2 layer rematted) for
    TRAIN_STEPS steps through ``_train_main_path`` (one flash forward and
    one backward launch per shared application a step: the shared block is
    not rematted, as in the reference); one step's loss and gradients, the
    card against the CPU on ZAMBA_CUT in f32 (matrices at std 0.02); 4
    steps straight against 2 + checkpoint + restore + 2, bitwise.  Returns
    the flash forward and backward launches of the training run."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common, registry, zamba
    from repro_torch.optim.adamw import AdamWConfig

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(ZAMBA_ARCH), **ZAMBA_DEPTH)
    n_groups = zamba._counts(cfg)[0]
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    ok, _, fields = _train_main_path("zamba", cfg, opt, seed, TRAIN_STEPS, TRAIN_SEQ, failures)
    fwd, bwd = fields["flash_launches"], fields["flash_bwd_launches"]
    row = {"row": "zamba train", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size, "reduced": ZAMBA_REDUCED,
           "remat": "each Mamba2 layer", **fields, "expected_per_step": [n_groups, n_groups]}
    row["ok"] = ok and fwd == n_groups * TRAIN_STEPS and bwd == n_groups * TRAIN_STEPS
    _emit(row)
    if not row["ok"]:
        failures.append(f"zamba train main path: {row}")

    # -- one step's loss and gradients: the card against the CPU, ZAMBA_CUT, f32 --------
    cfg2 = dataclasses.replace(cfg, dtype="float32", **ZAMBA_CUT)
    _train_cross_device("zamba train cross-device", cfg2, common.trainable(_matrices_at(
        registry.get(cfg2).init(torch.Generator(device=dev).manual_seed(seed), cfg2), 0.02,
        seed).cpu()), seed, failures)

    # -- resume: 4 steps straight against 2 + checkpoint + restore + 2, on the card ----
    _resume_check("zamba train resume", cfg2, seed, failures)
    return fwd, bwd


def _xlstm_phase(seed: int, hw, failures: list[str], twins: dict) -> None:
    """The xLSTM family on the card at xlstm-125m's full width, cut to
    XLSTM_DEPTH: serving (``_xlstm_serve``) and training (``_xlstm_train``).  It reaches
    no kernel of the port: both cells are plain PyTorch, one time step at a
    time (the reference's ``lax.scan``), so each phase's launches per block
    and its idle share are what it reports."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 22)
    twin = twins.setdefault(XLSTM_ARCH, {})
    _xlstm_serve(seed, rng, failures, twin.setdefault("serve", {}))
    torch.cuda.empty_cache()
    _xlstm_train(seed, failures, twin.setdefault("train", {}))
    torch.cuda.empty_cache()


def _xlstm_serve(seed: int, rng, failures: list[str], keep: dict) -> None:
    """``ServeEngine`` on full-width xlstm-125m cut to XLSTM_DEPTH (random bf16
    weights by the reference's rule, f32 states) over 4 x 1,024-token
    prompts + 32 greedy tokens, the counters set to 0 just before and read
    just after (no kernel of the port launches); decode logits against one
    state-less teacher forward over the 1,055 served tokens; the launches
    of one mLSTM and one sLSTM block in prefill and in decode; profiles of
    one prefill and 4 decode steps; then the card against the port's CPU
    path on XLSTM_CUT in f32, logits and every state leaf.  ``keep`` takes
    the prompts, tokens, prefill logits and timings (``_keep_served``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common, registry, xlstm, xlstm_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(XLSTM_ARCH), **XLSTM_DEPTH)
    print(f"reduced: {json.dumps(XLSTM_REDUCED)}")
    t0 = time.perf_counter()
    model = registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed), cfg,
                                   torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, model, ServeConfig(max_len=LM_MAX_LEN), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    tokens, counts, speed = _generate_twice(engine, prompts)
    toks_d = torch.from_numpy(tokens).to(dev)
    # the teacher: one state-less forward over the served tokens
    n_real = LM_PROMPT + LM_NEW - 1
    served = _served_decode(engine, toks_d, LM_PROMPT)[0]
    _keep_served(keep, prompts, tokens, served, speed, LM_MAX_LEN)
    x, _ = xlstm_model.forward(engine.params, {"tokens": toks_d[:, :n_real]}, cfg)
    teacher = _teacher_gap(served, xlstm_model._logits(engine.params, x[:, LM_PROMPT - 1:],
                                                       cfg).float())
    del x, served
    # the launches of one block of each kind, prefill and decode
    h = torch.randn((LM_BATCH, LM_PROMPT, cfg.d_model), device=dev).to(torch.bfloat16)
    per_call = {}
    for kind, i in (("mlstm_block", 0), ("slstm_block", cfg.slstm_layers[0])):
        bp = engine.params["blocks"][i]
        st = (xlstm.slstm_init_state if kind == "slstm_block" else xlstm.mlstm_init_state)(
            cfg, LM_BATCH, device=dev)
        per_call[kind] = {
            "prefill": _profile(lambda: xlstm_model._block(bp, h, cfg, i, st))["kernel_launches"],
            "decode": _profile(lambda: xlstm_model._block(bp, h[:, :1], cfg, i, st))[
                "kernel_launches"]}
    del h
    prof_prefill, prof_decode = _serving_profiles("xlstm", engine, toks_d, LM_PROMPT,
                                                  "4 x 1,024 tokens", cpu=False)
    n_params = common.count_params(engine.params)
    del engine, model
    torch.cuda.empty_cache()
    row = {"row": "xlstm serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "slstm_layers": list(cfg.slstm_layers), "d_model": cfg.d_model,
           "xlstm_dims": list(xlstm._dims(cfg)), "ssm_conv": cfg.ssm_conv,
           "vocab": cfg.vocab_size, "params": n_params, "reduced": XLSTM_REDUCED,
           "dtype": "bfloat16",
           "init": "the reference's rule", "state_dtype": "float32", "batch": LM_BATCH,
           "prompt": LM_PROMPT, "new_tokens": LM_NEW, "max_len": LM_MAX_LEN, "init_s": init_s,
           "port_kernel_launches": sum(counts.values()),
           "prefill_kernel_launches": prof_prefill["kernel_launches"],
           "decode_kernel_launches_per_step": prof_decode["kernel_launches"] / 4,
           "kernel_launches_per_call": per_call, **speed,
           "prefill_idle_share": prof_prefill["idle_share"],
           "decode_idle_share": prof_decode["idle_share"],
           "teacher": dict(teacher, against=f"one state-less forward over {n_real} tokens"),
           "teacher_tol_of_scale": LM_TEACHER_TOL}
    row["ok"] = (row["port_kernel_launches"] == 0 and row["same_tokens_twice"]
                 and tokens.shape == (LM_BATCH, LM_PROMPT + LM_NEW) and teacher["finite"]
                 and teacher["max_abs_diff"] <= LM_TEACHER_TOL * teacher["scale"])
    _emit(row)
    if not row["ok"]:
        failures.append(f"xlstm serve main path: {row}")
    del toks_d
    torch.cuda.empty_cache()

    # -- the card against the port's CPU path: full width, XLSTM_CUT, f32 ---------------
    # (the weights are drawn on the card, which is fast, and copied to the CPU)
    cfg2 = dataclasses.replace(cfg, dtype="float32", **XLSTM_CUT)
    _serve_cross_device("xlstm cross-device", cfg2, registry.get(cfg2).init(
        torch.Generator(device=dev).manual_seed(seed), cfg2), rng, failures)


def _xlstm_train(seed: int, failures: list[str], keep: dict) -> None:
    """``train.loop.train`` on full-width xlstm-125m cut to XLSTM_DEPTH (f32 master
    weights and moments, bf16 compute, each block rematted) for
    XLSTM_TRAIN_STEPS steps (XLSTM_CUTS) through ``_train_main_path`` (no
    kernel of the port launches), its step twice and its profiled step on
    2 x XLSTM_PROFILE_SEQ tokens; one step's loss and gradients over
    XLSTM_CROSS_SEQ tokens, the card against the CPU on XLSTM_CUT in f32; 4
    steps straight against 2 + checkpoint + restore + 2, bitwise."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common, registry
    from repro_torch.optim.adamw import AdamWConfig

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(XLSTM_ARCH), **XLSTM_DEPTH)
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=XLSTM_TRAIN_STEPS)
    ok, _, fields = _train_main_path("xlstm", cfg, opt, seed, XLSTM_TRAIN_STEPS, TRAIN_SEQ,
                                     failures, profile_seq=XLSTM_PROFILE_SEQ, keep=keep)
    row = {"row": "xlstm train", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size, "reduced": XLSTM_REDUCED,
           "cut": XLSTM_CUTS,
           "remat": "each block", **fields}
    row["ok"] = ok and fields["flash_launches"] == fields["flash_bwd_launches"] == 0
    _emit(row)
    if not row["ok"]:
        failures.append(f"xlstm train main path: {row}")

    # -- one step's loss and gradients: the card against the CPU, XLSTM_CUT, f32 --------
    cfg2 = dataclasses.replace(cfg, dtype="float32", **XLSTM_CUT)
    _train_cross_device("xlstm train cross-device", cfg2, common.trainable(registry.get(
        cfg2).init(torch.Generator(device=dev).manual_seed(seed), cfg2).cpu()), seed, failures,
        seq=XLSTM_CROSS_SEQ)

    # -- resume: 4 steps straight against 2 + checkpoint + restore + 2, on the card ----
    _resume_check("xlstm train resume", cfg2, seed, failures)


def _whisper_phase(seed: int, hw, failures: list[str], twins: dict) -> dict[str, int]:
    """The whisper family on the card at whisper-tiny's full width and
    depth: the flash kernels at its shapes against their plain versions
    (``_flash_checks`` over WHISPER_FORMS, ``_bwd_checks`` over
    WHISPER_BWD_FORMS: non-causal over 1,500 frames, a
    ragged 23 x 64 + 28; cross-attention with Sq != Skv = 1,500; the
    decoder's causal self-attention; every shape that serving's prefill and
    training launch; D=64, G = 1), serving
    (``_whisper_serve``), training (``_whisper_train``), then the kernels'
    yardsticks at the encoder's and the cross-attention's serving shapes
    and at the training shapes.  Returns the flash launches of its main
    paths (``serve``, ``train_fwd``, ``train_bwd``) and the kernels' largest
    errors against their plain versions (``fwd_err``; ``bwd_err`` in bf16,
    ``bwd_f32_err`` in f32)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    rng = np.random.default_rng(seed + 23)
    fwd_err = _flash_checks(rng, failures, WHISPER_FORMS)
    # bf16 (flash_bwd_d64) and f32 (the CUDA-core kernels): each kernel's error
    bwd_err = _bwd_checks(rng, failures, [f for f in WHISPER_BWD_FORMS if f[-1] == "bfloat16"])
    bwd_f32_err = _bwd_checks(rng, failures,
                              [f for f in WHISPER_BWD_FORMS if f[-1] == "float32"])
    torch.cuda.empty_cache()
    twin = twins.setdefault(WHISPER_ARCH, {})
    serve = _whisper_serve(seed, rng, failures, twin.setdefault("serve", {}))
    torch.cuda.empty_cache()
    train_fwd, train_bwd = _whisper_train(seed, failures, twin.setdefault("train", {}))
    torch.cuda.empty_cache()
    cfg = get_config(WHISPER_ARCH)
    h, d, f = cfg.n_heads, cfg.head_dim, cfg.encoder_len
    for sq in (f, WHISPER_PROMPT):  # the encoder's and the cross-attention's prefill
        _fwd_yardstick(WHISPER_ARCH, LM_BATCH, sq, f, h, h, d, False, rng, hw, failures)
    for sq, skv, causal in ((f, f, False), (WHISPER_TRAIN_SEQ, f, False),
                            (WHISPER_TRAIN_SEQ, WHISPER_TRAIN_SEQ, True)):  # training's three
        _bwd_yardstick(WHISPER_ARCH, TRAIN_BATCH, sq, skv, h, h, d, causal, rng, hw, failures)
    return {"serve": serve, "train_fwd": train_fwd, "train_bwd": train_bwd,
            "fwd_err": fwd_err, "bwd_err": bwd_err, "bwd_f32_err": bwd_f32_err}


def _whisper_serve(seed: int, rng, failures: list[str], keep: dict) -> int:
    """``ServeEngine`` on full-width, full-depth whisper-tiny (random bf16
    weights from the seed, matrices at std 0.02 (``_matrices_at``), f32
    caches) over 4 x (1,500 seeded frames, a WHISPER_PROMPT-token prompt) +
    32 greedy tokens, the counters set to 0 just before and read just
    after (prefill: one flash launch per encoder layer and two per decoder
    layer, self and cross; none in decode); decode logits against one
    cache-less teacher pass over the served tokens on the same frames; the
    launches of the encoder and of one decoder layer in prefill; profiles of one prefill and 4 decode steps; then the card
    against the port's CPU path on the whole model in f32 (matrices at std
    0.02).  ``keep`` takes the prompts, frames, tokens, prefill logits and
    timings (``_keep_served``).  Returns the flash launches of the served
    generate.

    Why std 0.02, as the MoE, MLA and zamba phases serve: the reference's
    rule takes 1/sqrt(4) for every stacked matrix (std 0.5 at d_model 384),
    which saturates the softmax (scores of ~100), whose near-ties two bf16
    passes break differently."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, registry, whisper
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    dev = torch.device("cuda")
    cfg = get_config(WHISPER_ARCH)
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    t0 = time.perf_counter()
    model = _matrices_at(registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                                                cfg, torch.bfloat16), 0.02, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, model, ServeConfig(max_len=WHISPER_MAX_LEN), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, WHISPER_PROMPT), dtype=np.int32)
    frames = torch.from_numpy(rng.standard_normal((LM_BATCH, cfg.encoder_len, cfg.d_model),
                                                  dtype=np.float32)).to(dev, torch.bfloat16)
    extras = {"frames": frames}
    tokens, counts, speed = _generate_twice(engine, prompts, extras)
    launches = counts[fa.LAUNCHES.name]
    toks_d = torch.from_numpy(tokens).to(dev)
    # the served path again, counted phase by phase, then the teacher
    served, prefill_launches, decode_launches = _served_decode(engine, toks_d, WHISPER_PROMPT,
                                                               extras)
    _keep_served(keep, prompts, tokens, served, speed, WHISPER_MAX_LEN, frames=frames.cpu())
    n_real = WHISPER_PROMPT + LM_NEW - 1
    x = whisper.forward_train(engine.params, {"tokens": toks_d[:, :n_real], **extras}, cfg)
    teacher = _teacher_gap(served, whisper._logits(engine.params, x[:, WHISPER_PROMPT - 1:],
                                                   cfg).float())
    del x, served
    # the launches of the encoder (4 layers and its norm) and of one decoder layer
    enc = whisper.encode(engine.params, frames, cfg)
    dp = engine.params["dec_layers"][0]
    per_call = {
        "encode": _profile(lambda: whisper.encode(engine.params, frames, cfg))["kernel_launches"],
        "decoder_layer_prefill": _profile(lambda: whisper._dec_layer(
            dp, enc[:, :WHISPER_PROMPT], enc, cfg, 512, 1024))["kernel_launches"]}
    del enc
    prof_prefill, prof_decode = _serving_profiles(
        "whisper", engine, toks_d, WHISPER_PROMPT,
        f"4 x ({cfg.encoder_len} frames, {WHISPER_PROMPT} tokens)", extras)
    n_params = common.count_params(engine.params)
    del engine, model, frames, extras
    torch.cuda.empty_cache()
    expected = n_enc + 2 * n_dec
    row = {"row": "whisper serve", "arch": cfg.name, "encoder_layers": n_enc,
           "decoder_layers": n_dec, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "frames": cfg.encoder_len, "params": n_params,
           "reduced": {}, "dtype": "bfloat16", "matrices_std": 0.02, "cache_dtype": "float32",
           "batch": LM_BATCH, "prompt": WHISPER_PROMPT, "new_tokens": LM_NEW,
           "max_len": WHISPER_MAX_LEN, "init_s": init_s,
           "flash_launches": launches, "expected_launches": expected,
           "prefill_launches": prefill_launches, "decode_launches": decode_launches,
           "other_launches": sum(counts.values()) - launches,
           "prefill_kernel_launches": prof_prefill["kernel_launches"],
           "decode_kernel_launches_per_step": prof_decode["kernel_launches"] / 4,
           "kernel_launches_per_call": per_call, **speed,
           "prefill_idle_share": prof_prefill["idle_share"],
           "decode_idle_share": prof_decode["idle_share"],
           "teacher": dict(teacher, against=f"one cache-less pass over {n_real} tokens"),
           "teacher_tol_of_scale": LM_TEACHER_TOL}
    row["ok"] = (launches == expected and prefill_launches == expected and decode_launches == 0
                 and row["other_launches"] == 0 and row["same_tokens_twice"]
                 and tokens.shape == (LM_BATCH, WHISPER_PROMPT + LM_NEW) and teacher["finite"]
                 and teacher["max_abs_diff"] <= LM_TEACHER_TOL * teacher["scale"])
    _emit(row)
    if not row["ok"]:
        failures.append(f"whisper serve main path: {row}")
    del toks_d
    torch.cuda.empty_cache()

    # -- the card against the port's CPU path: the whole model, f32 ---------------------
    cfg2 = dataclasses.replace(cfg, dtype="float32")
    _serve_cross_device("whisper cross-device", cfg2, _matrices_at(
        registry.get(cfg2).init(torch.Generator(device=dev).manual_seed(seed), cfg2), 0.02, seed),
        rng, failures)
    return launches


def _whisper_train(seed: int, failures: list[str], keep: dict) -> tuple[int, int]:
    """``train.loop.train`` on full-width, full-depth whisper-tiny (f32 master
    weights and moments, bf16 compute, each decoder layer rematted; the
    reference's init rule) for TRAIN_STEPS steps of TRAIN_BATCH x (1,500
    frames, WHISPER_TRAIN_SEQ tokens) through ``_train_main_path`` (a step:
    the encoder's 4 flash forwards, the decoder's 8 twice (remat), 12
    backwards); one step's loss and gradients, the card against the CPU on
    the whole model in f32 (matrices at std 0.02); 4 steps straight against
    2 + checkpoint + restore + 2, bitwise.  Returns the flash forward and
    backward launches of the training run."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import common, registry
    from repro_torch.optim.adamw import AdamWConfig

    dev = torch.device("cuda")
    cfg = get_config(WHISPER_ARCH)
    n_enc, n_dec = cfg.n_encoder_layers, cfg.n_layers
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    ok, _, fields = _train_main_path("whisper", cfg, opt, seed, TRAIN_STEPS, WHISPER_TRAIN_SEQ,
                                     failures, keep=keep)
    fwd, bwd = fields["flash_launches"], fields["flash_bwd_launches"]
    per_step = [n_enc + 4 * n_dec, n_enc + 2 * n_dec]
    row = {"row": "whisper train", "arch": cfg.name, "encoder_layers": n_enc,
           "decoder_layers": n_dec, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "frames": cfg.encoder_len, "reduced": {}, "remat": "each decoder layer", **fields,
           "expected_per_step": per_step}
    row["ok"] = ok and fwd == per_step[0] * TRAIN_STEPS and bwd == per_step[1] * TRAIN_STEPS
    _emit(row)
    if not row["ok"]:
        failures.append(f"whisper train main path: {row}")

    # -- one step's loss and gradients: the card against the CPU, the whole model, f32 --
    cfg2 = dataclasses.replace(cfg, dtype="float32")
    _train_cross_device("whisper train cross-device", cfg2, common.trainable(_matrices_at(
        registry.get(cfg2).init(torch.Generator(device=dev).manual_seed(seed), cfg2), 0.02,
        seed).cpu()), seed, failures)

    # -- resume: 4 steps straight against 2 + checkpoint + restore + 2, on the card ----
    _resume_check("whisper train resume", cfg2, seed, failures)
    return fwd, bwd


def _wide_phase(seed: int, failures: list[str]) -> dict[str, dict]:
    """The D=128 architectures of WIDE_ARCHS on the card at full width:
    each served (``_serve_full_width``) at its depth and trained
    (``_train_full_width``) at a cut depth, each cut in its rows'
    ``reduced``.  Returns, by tag, the flash launches of its main paths
    (``serve``, ``train_fwd``, ``train_bwd``) and those of them by kernel
    (``serve_by_kernel``, ``train_by_kernel``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config

    found = {}
    for i, (tag, arch, serve_layers, serve_cut, train_layers, train_cut,
            cross_seq) in enumerate(WIDE_ARCHS):
        base = get_config(arch)
        rng = np.random.default_rng(seed + 29 + i)
        t0 = time.perf_counter()
        serve, serve_by_kernel = _serve_full_width(
            tag, dataclasses.replace(base, n_layers=serve_layers), serve_cut, seed, rng, failures)
        torch.cuda.empty_cache()
        _emit({"phase": f"{tag} serve", "seconds": time.perf_counter() - t0})
        t0 = time.perf_counter()
        train_fwd, train_bwd, train_by_kernel = _train_full_width(
            tag, dataclasses.replace(base, n_layers=train_layers), train_cut, seed, failures,
            cross_seq)
        torch.cuda.empty_cache()
        _emit({"phase": f"{tag} train", "seconds": time.perf_counter() - t0})
        found[tag] = {"serve": serve, "train_fwd": train_fwd, "train_bwd": train_bwd,
                      "serve_by_kernel": serve_by_kernel, "train_by_kernel": train_by_kernel}
    return found


def _serve_peak_gb(cfg) -> dict[str, float]:
    """The predicted peak of serving ``cfg`` in bf16 (GB): the weights, the
    f32 KV cache of LM_BATCH x LM_MAX_LEN positions, and one layer's
    activations in prefill (bf16: the input, q and the attention's output
    of d_model each, k and v of n_kv_heads x head_dim, the SwiGLU's gate,
    up and product of d_ff each, over LM_BATCH x LM_PROMPT tokens)."""
    kv = cfg.n_kv_heads * cfg.head_dim
    parts = {"weights": 2 * cfg.n_params() / 1e9,
             "kv_cache": 4 * 2 * cfg.n_layers * LM_BATCH * LM_MAX_LEN * kv / 1e9,
             "layer_activations": 2 * LM_BATCH * LM_PROMPT
             * (3 * cfg.d_model + 2 * kv + 3 * cfg.d_ff) / 1e9}
    return dict(parts, total=sum(parts.values()))


def _train_peak_gb(cfg) -> list[float]:
    """The predicted peak of training ``cfg`` (GB, low and high): 16.2 to
    16.9 bytes a parameter (f32 master weights, gradients and AdamW
    moments, and the activations beside them), the rates measured for
    internvl2-26b at 6 layers (56.30 GB for 3.48 B parameters) and
    qwen3-4b (67.8 GB for 4.02 B) on an H100 80GB HBM3; a vocabulary wider
    than qwen3-4b's 151,936 adds two to three f32 copies of its TRAIN_BATCH
    x TRAIN_SEQ logits (the logits, their log-softmax and their gradient:
    4.2-6.3 GB at minitron-8b's 256,000)."""
    n = cfg.n_params()
    wide = 4 * TRAIN_BATCH * TRAIN_SEQ * cfg.vocab_size if cfg.vocab_size > 151_936 else 0
    return [(16.2 * n + 2 * wide) / 1e9, (16.9 * n + 3 * wide) / 1e9]


def _host_rss_gb() -> float:
    """This process's resident memory (GB)."""
    import resource

    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize() / 1e9


def _watch_host_memory():
    """Starts sampling this process's resident memory every 10 ms.  Returns
    a function that stops it and gives the memory at the start, at the end
    and the largest sample (GB)."""
    import threading

    done = threading.Event()
    start = peak = _host_rss_gb()

    def sample():
        nonlocal peak
        while not done.wait(0.01):
            peak = max(peak, _host_rss_gb())

    watcher = threading.Thread(target=sample, daemon=True)
    watcher.start()

    def stop() -> dict[str, float]:
        done.set()
        watcher.join()
        end = _host_rss_gb()
        return {"host_rss_GB_at_start": start, "host_rss_GB_at_end": end,
                "host_peak_rss_GB": max(peak, end)}

    return stop


def _serve_full_width(tag: str, cfg, reduced: dict, seed: int, rng,
                      failures: list[str]) -> tuple[int, dict[str, int]]:
    """``ServeEngine`` on ``cfg`` at full width and its depth (random bf16
    weights from the seed, matrices at std 0.02 (``_matrices_at``), f32 KV
    cache) over 4 x 1,024-token prompts (a VLM's first ``n_patches``
    positions take seeded random patch embeddings drawn on the CPU and
    moved) + 32 greedy tokens, the counters set to 0 just before and read
    just after (prefill: one launch of ``flash_group_fwd<128>`` per layer;
    none in decode); decode logits against one cache-less teacher pass over
    the served tokens (and patches); the peak memory beside its prediction
    (``_serve_peak_gb``); then the card against the port's CPU path at 2
    layers of full width in f32 (matrices at std 0.02).  Returns the flash
    launches of the served generate, and by kernel.

    Why std 0.02, as the MoE, MLA, zamba and whisper phases serve: the
    reference's rule takes 1/sqrt(n_layers) for every stacked matrix, and
    none of these architectures has qk-norm, so its attention scores have a
    std of ~100: a saturated softmax whose near-ties two bf16 passes break
    differently."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import common, registry, transformer
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    dev = torch.device("cuda")
    if reduced:
        print(f"reduced: {json.dumps(reduced)}")
    predicted = _serve_peak_gb(cfg)
    _emit({"prediction": f"{tag} serve peak memory (GB)", "arch": cfg.name, **predicted})
    t0 = time.perf_counter()
    model = _matrices_at(registry.get(cfg).init(torch.Generator(device=dev).manual_seed(seed),
                                                cfg, torch.bfloat16), 0.02, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(cfg, model, ServeConfig(max_len=LM_MAX_LEN), device=dev)
    prompts = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT), dtype=np.int32)
    extras = {}
    if cfg.n_patches:
        extras["patches"] = torch.from_numpy(rng.standard_normal(
            (LM_BATCH, cfg.n_patches, cfg.d_model), dtype=np.float32)).to(dev, torch.bfloat16)
    tokens, counts, speed = _generate_twice(engine, prompts, extras)
    launches, by_kernel = counts[fa.LAUNCHES.name], speed["flash_launches_by_kernel"]
    toks_d = torch.from_numpy(tokens).to(dev)
    served, prefill_launches, decode_launches = _served_decode(engine, toks_d, LM_PROMPT, extras)
    x, _, _ = transformer.forward(engine.params, {"tokens": toks_d[:, :-1], **extras}, cfg,
                                  q_chunk=512, kv_chunk=1024)
    teacher = _teacher_gap(served, transformer._logits(engine.params, x[:, LM_PROMPT - 1:],
                                                       cfg).float())
    del x, served
    what = "4 x 1,024 tokens"
    if cfg.n_patches:
        what += f", the first {cfg.n_patches} positions patches"
    prof_prefill, prof_decode = _serving_profiles(tag, engine, toks_d, LM_PROMPT, what, extras)
    n_params = common.count_params(engine.params)
    del engine, model, extras, toks_d
    torch.cuda.empty_cache()
    row = {"row": f"{tag} serve", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "group": cfg.n_heads // cfg.n_kv_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
           "patches": cfg.n_patches, "params": n_params, "reduced": reduced,
           "dtype": "bfloat16", "matrices_std": 0.02, "cache_dtype": "float32",
           "batch": LM_BATCH, "prompt": LM_PROMPT, "new_tokens": LM_NEW, "max_len": LM_MAX_LEN,
           "init_s": init_s, "flash_launches": launches, "expected_launches": cfg.n_layers,
           "prefill_launches": prefill_launches, "decode_launches": decode_launches,
           "other_launches": sum(counts.values()) - launches,
           "prefill_kernel_launches": prof_prefill["kernel_launches"],
           "decode_kernel_launches_per_step": prof_decode["kernel_launches"] / 4, **speed,
           "predicted_peak_memory_GB": predicted["total"],
           "prefill_idle_share": prof_prefill["idle_share"],
           "decode_idle_share": prof_decode["idle_share"],
           "teacher": dict(teacher, against=f"one cache-less pass over "
                                            f"{LM_PROMPT + LM_NEW - 1} tokens"
                                            + (", the same patches" if cfg.n_patches else "")),
           "teacher_tol_of_scale": LM_TEACHER_TOL}
    row["ok"] = (launches == cfg.n_layers and prefill_launches == cfg.n_layers
                 and decode_launches == 0 and by_kernel == {D128_FWD_KERNEL: cfg.n_layers}
                 and row["other_launches"] == 0 and row["same_tokens_twice"]
                 and tokens.shape == (LM_BATCH, LM_PROMPT + LM_NEW) and teacher["finite"]
                 and teacher["max_abs_diff"] <= LM_TEACHER_TOL * teacher["scale"])
    _emit(row)
    if not row["ok"]:
        failures.append(f"{tag} serve main path: {row}")

    # -- the card against the port's CPU path: full width, 2 layers, f32 ----------
    # (the weights are drawn on the card, which is fast; the CPU engine copies them)
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    _serve_cross_device(f"{tag} cross-device", cfg2, _matrices_at(
        registry.get(cfg2).init(torch.Generator(device=dev).manual_seed(seed), cfg2), 0.02, seed),
        rng, failures)
    torch.cuda.empty_cache()
    return launches, by_kernel


def _train_full_width(tag: str, cfg, reduced: dict, seed: int, failures: list[str],
                      cross_seq: int) -> tuple[int, int, dict[str, int]]:
    """``train.loop.train`` on ``cfg`` at full width and its (cut) depth
    (``reduced``; f32 master weights and moments, bf16 compute, remat, the
    reference's init rule; a VLM's patches from the data pipeline, drawn on
    the CPU and moved) for TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ
    tokens through ``_train_main_path`` (a step: ``flash_group_fwd<128>``
    twice a layer, forward and remat recompute, ``flash_bwd_d128`` once),
    the step's gradients twice bitwise, the peak memory beside its
    prediction (``_train_peak_gb``); one step's loss and gradients, the card
    against the CPU on 2 layers of full width in f32 over ``cross_seq``
    tokens (matrices at std 0.02).  Returns the flash forward and backward
    launches of the training run, and both by kernel."""
    import dataclasses

    import torch

    from repro_torch.models import common, registry
    from repro_torch.optim.adamw import AdamWConfig

    dev = torch.device("cuda")
    print(f"reduced: {json.dumps(reduced)}")
    predicted = _train_peak_gb(cfg)
    _emit({"prediction": f"{tag} train peak memory (GB)", "arch": cfg.name,
           "n_layers": cfg.n_layers, "params": cfg.n_params(), "low_high": predicted})
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    ok, _, fields = _train_main_path(tag, cfg, opt, seed, TRAIN_STEPS, TRAIN_SEQ, failures,
                                     grads_twice=True)
    fwd, bwd, by_kernel = (fields["flash_launches"], fields["flash_bwd_launches"],
                           fields["flash_launches_by_kernel"])
    per_step = [2 * cfg.n_layers, cfg.n_layers]
    row = {"row": f"{tag} train", "arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
           "group": cfg.n_heads // cfg.n_kv_heads, "vocab": cfg.vocab_size,
           "patches": cfg.n_patches, "remat": True, "reduced": reduced, **fields,
           "predicted_peak_memory_GB": predicted, "expected_per_step": per_step}
    row["ok"] = (ok and fwd == per_step[0] * TRAIN_STEPS and bwd == per_step[1] * TRAIN_STEPS
                 and by_kernel == {D128_FWD_KERNEL: fwd, D128_BWD_KERNEL: bwd})
    _emit(row)
    if not row["ok"]:
        failures.append(f"{tag} train main path: {row}")
    torch.cuda.empty_cache()

    # -- one step's loss and gradients: the card against the CPU, 2 layers, f32 -------
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    model2 = _matrices_at(registry.get(cfg2).init(torch.Generator(device=dev).manual_seed(seed),
                                                  cfg2), 0.02, seed).cpu()
    _train_cross_device(f"{tag} train cross-device", cfg2, common.trainable(model2), seed,
                        failures, seq=cross_seq)
    del model2
    torch.cuda.empty_cache()
    return fwd, bwd, by_kernel


# the port's examples and serving tools, run on the card through their
# ``main(argv)`` at small sizes: (label, file, argv, the launch counter that
# must move: a kernel of the card)
EXAMPLE_RUNS = [
    ("quickstart", "examples/torch/quickstart.py", [], "su3_mult_planar"),
    ("serve_batched vlm", "examples/torch/serve_batched.py",
     ["--arch", "internvl2-26b", "--tokens", "8"], "flash_attention"),
    ("serve_batched whisper", "examples/torch/serve_batched.py",
     ["--arch", "whisper-tiny", "--tokens", "8"], "flash_attention"),
    ("train_lm vlm", "examples/torch/train_lm.py",
     ["--arch", "internvl2-26b", "--steps", "4", "--batch", "2", "--seq-len", "64"],
     "flash_attention_bwd"),
    ("serve_lattices chain bf16", "examples/torch/serve_lattices.py",
     ["--batch", "5", "--L", "4", "--chain", "4", "--bf16"], "su3_mult_planar"),
]


def _load_file(path: str):
    """The module of the repository's file ``path``, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(pathlib.Path(path).stem, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_main(label: str, path: str, argv: list[str], failures: list[str]) -> tuple[int, str]:
    """``main(argv)`` of the file ``path`` (a module's name: of the module),
    its standard output kept and printed, the counters set to 0 just before
    and read just after; emits its row.  Returns its exit code and output;
    an exception is a failure, its traceback printed."""
    import importlib
    import io
    import traceback

    buf = io.StringIO()
    t0 = time.perf_counter()
    _reset_counts()
    try:
        with contextlib.redirect_stdout(buf):
            module = (_load_file(path) if path.endswith(".py")
                      else importlib.import_module(path))
            rc = module.main(argv)
    except Exception:  # the run goes on to its other phases, and fails at the end
        traceback.print_exc()
        rc = -1
    counts = _counts()
    out = buf.getvalue()
    print(out, end="")
    _emit({"row": f"run {label}", "file": path, "argv": argv, "rc": rc,
           "seconds": time.perf_counter() - t0, "launches": counts,
           "flash_launches_by_kernel": _by_kernel()})
    if rc != 0:
        failures.append(f"{label}: {path} {argv} exited {rc}")
    return rc, out


def _tools_phase(failures: list[str]) -> None:
    """The autotune CLI's sweeps at L=4 (``python -m repro_torch.core.autotune``
    in process, a fresh cache under ``build/``), each example of
    EXAMPLE_RUNS, ``serve_lattices.py --autotune`` twice (the second run
    starts tuned from the first's cache), then ``profile_dispatch.py --quick
    --trace`` and ``trace_report.py`` on that trace; each fails the run if it
    exits non-zero, and each example if its kernel never launched."""
    import shutil

    from repro_torch.core import roofline

    scratch = ROOT / "build" / "chip_smoke_tools"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    rc, out = _run_main("autotune cli", "repro_torch.core.autotune",
                        ["--L", "4", "--cache-dir", str(scratch / "autotune")], failures)
    sections = ["== tile sweep", "== k sweep", "== layout sweep", "== pipeline sweep",
                "best: TuneResult("]
    ok = (rc == 0 and all(x in out for x in sections) and "'verified': False" not in out
          and "v5e" not in out.lower() and "tpu" not in out.lower()
          and f"model: {roofline.current_hardware().name}" in out)
    _emit({"check": "autotune cli at L=4: every section, every row verified, no TPU constant",
           "ok": ok})
    if not ok:
        failures.append("autotune cli: a section is missing, a row failed or a TPU constant "
                        "was printed")
    for label, path, argv, counter in EXAMPLE_RUNS:
        rc, _ = _run_main(label, path, argv, failures)
        if rc == 0 and not _counts()[counter]:
            failures.append(f"{label}: ran no {counter} launch on the card")
    tuned = ["--batch", "5", "--L", "4", "--autotune", "--cache-dir", str(scratch / "lattices")]
    _, first = _run_main("serve_lattices autotune (measures)", "examples/torch/serve_lattices.py",
                         tuned, failures)
    _, second = _run_main("serve_lattices autotune (starts tuned)",
                          "examples/torch/serve_lattices.py", tuned, failures)
    plans = [next((line for line in text.splitlines() if line.startswith("plan:")), None)
             for text in (first, second)]
    if plans[0] is None or plans[0] != plans[1]:
        failures.append(f"serve_lattices --autotune: the second run's plan {plans[1]} is not "
                        f"the first's {plans[0]}")
    trace = scratch / "dispatch.json"
    _run_main("profile_dispatch", "scripts/torch/profile_dispatch.py",
              ["--quick", "--json", str(scratch / "dispatch_rows.json"), "--trace", str(trace)],
              failures)
    rc, out = _run_main("trace_report", "scripts/torch/trace_report.py", [str(trace)], failures)
    if rc == 0 and not ("profile.dispatch     20" in out and "backend=cuda" in out
                        and "attribution (measured vs the roofline of" in out):
        failures.append("trace_report: profile_dispatch's trace did not render its 20 spans, "
                        "the card's provenance and the attribution")


MULTISLAB_FORMS = [  # (label, hosts, layout, dtype, accum, compression)
    ("soa f32", 2, "soa", "float32", "", "none"),
    ("aosoa f32", 2, "aosoa", "float32", "", "none"),
    ("soa bf16+acc-f32", 2, "soa", "bfloat16", "float32", "none"),
    ("soa f32 two-row", 2, "soa", "float32", "", "two_row"),
    ("soa f32", 4, "soa", "float32", "", "none"),
    ("aosoa bf16 two-row", 4, "aosoa", "bfloat16", "", "two_row"),
]
MULTISLAB_TRACED_STEPS = 5  # traced steps per depth for the phase split
TUNE_TILES = (256, 512)  # the tuners' pruned tile grid


@contextlib.contextmanager
def _recording(name: str, sink: list, u_phys, keep: int = 4):
    """Record (cloned) the inputs of up to ``keep`` launches of stencil
    kernel ``name`` on links other than ``u_phys`` (the boundary and ring
    passes of the multi-slab schedules); every launch still runs."""
    from repro_torch.kernels import su3_stencil

    orig = getattr(su3_stencil, name)

    def rec(*args, **kw):
        if args[0].data_ptr() != u_phys.data_ptr() and len(sink) < keep:
            sink.append(([a.clone() for a in args], dict(kw)))
        return orig(*args, **kw)

    setattr(su3_stencil, name, rec)
    try:
        yield sink
    finally:
        setattr(su3_stencil, name, orig)


def _counted(fn, totals: dict[str, int]):
    """Run ``fn`` with every launch counter set to 0 just before and read
    just after; add the counts to ``totals``.  Returns (result, counts)."""
    import torch

    torch.cuda.synchronize()
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = _counts()
    for k in totals:
        totals[k] += counts[k]
    return out, counts


def _recorded_vs_plain(name: str, records: list, dtype: str, accum: str, comp: str) -> dict:
    """Each recorded launch's inputs through the kernel and its plain
    version: bitwise at f32, within ``verify_tolerance`` otherwise."""
    import torch

    from repro_torch.core.su3.plan import verify_tolerance
    from repro_torch.kernels import su3_stencil

    kernel = getattr(su3_stencil, name)
    plain = getattr(su3_stencil, f"{name}_plain")
    err, bitwise, shapes = 0.0, True, []
    for args, kw in records:
        got = kernel(*args, **kw)
        want = plain(*args, accum_dtype=kw.get("accum_dtype"),
                     compressed=kw.get("compressed", False))
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        torch.cuda.synchronize()
        shapes.append(list(args[0].shape))
        err = max(err, max(torch.max(torch.abs(g.float() - w.float())).item()
                           for g, w in zip(got, want)))
        bitwise &= all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))
    tol = verify_tolerance(dtype, accum, comp == "two_row")
    ok = bool(records) and (bitwise if dtype == "float32" else err <= tol)
    return {"kernel": name, "launches_checked": len(records), "link_shapes": shapes,
            "max_abs_err": err, "bitwise": bitwise, "ok": ok}


def _host_wall_ms(fn, reps: int) -> float:
    """Best host-clock ms of ``fn`` followed by a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _multislab_phase(u, seed: int, hw, failures: list[str]) -> dict[str, int]:
    """The lattice split into 2 and 4 t-slabs of PAPER_L32 on the card:
    first-touch init and the multiply against one slab; the overlapped
    stencil (depth 1 and 2) and the overlapped fused CG against the serial
    and one-slab paths, bitwise, with their boundary and ring launches held
    against the plain versions; the halo faults; the times and the phase
    split; the stencil and CG tuners at 2 slabs; attribution; provenance.
    Returns the counted main-path launches per kernel."""
    import numpy as np
    import torch

    from repro_torch.chaos import NULL_FAULT_PLAN, FaultPlan, FaultSpec
    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import autotune
    from repro_torch.core.autotune import _cg_measure_problem
    from repro_torch.core.su3.layouts import Layout
    from repro_torch.core.su3.plan import build_plan
    from repro_torch.kernels import su3_matmul, su3_stencil
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.obs import (NULL_TRACER, Tracer, attribution_report, overlap_efficiency,
                                 overlap_efficiency_from_spans, provenance_block,
                                 render_attribution)

    mult, sten, cgk = (su3_matmul.LAUNCHES.name, su3_stencil.STENCIL_LAUNCHES.name,
                       su3_stencil.CG_LAUNCHES.name)
    totals = {mult: 0, sten: 0, cgk: 0}

    def fail(what: str, row: dict) -> None:
        _emit(row)
        if not row["ok"]:
            failures.append(f"multislab {what}: {row}")

    # -- init and the multiply ----------------------------------------------------
    one = build_plan(PAPER_L32)
    a1, b1, init1, _ = one.init_data()
    c1 = one.step(a1, b1)
    for hosts in (2, 4):
        many = build_plan(PAPER_L32, MeshSpec(hosts=hosts))
        a2, b2, init2, _ = many.init_data()
        c2, counts = _counted(lambda: many.step(a2, b2), totals)
        row = {"row": "multislab init + step", "hosts": hosts, "plan": many.describe(),
               "first_touch_equals_one_slab": torch.equal(_bits(a2), _bits(a1)),
               "step_equals_one_slab": torch.equal(_bits(c2), _bits(c1)),
               "verified": many.verify(c2), "init_s": init2, "one_slab_init_s": init1,
               "launches": counts[mult], "expected_launches": 1}
        row["ok"] = (row["first_touch_equals_one_slab"] and row["step_equals_one_slab"]
                     and row["verified"] and counts[mult] == 1)
        fail("init", row)
        del many, a2, c2
    del one, a1, c1

    # -- the stencil schedules ------------------------------------------------------
    rng = np.random.default_rng(seed + 16)
    n_sites = PAPER_L32.shape.n_sites
    v_c = torch.from_numpy((rng.standard_normal((n_sites, 3))
                            + 1j * rng.standard_normal((n_sites, 3))).astype(np.complex64)).cuda()
    timing_plans = {}
    for label, hosts, layout, dtype, accum, comp in MULTISLAB_FORMS:
        cfg = dataclasses.replace(PAPER_L32, layout=Layout(layout), dtype=dtype,
                                  accum_dtype=accum, compression=comp)
        one, many = build_plan(cfg), build_plan(cfg, MeshSpec(hosts=hosts))
        u_phys, v_p = many.pack_gauge(u), many.pack_rhs(v_c)
        step, step2 = many.stencil_step(), many.stencil_step(depth=2)
        with _recording("su3_stencil_planar", [], u_phys) as records:
            (o1, o2), counts = _counted(lambda: (step(u_phys, v_p), step2(u_phys, v_p)), totals)
        s1 = one.stencil_step()(u_phys, v_p)
        s2 = one.stencil_step()(u_phys, s1)
        serial = many.stencil_step(overlap=False)(u_phys, v_p)
        row = {"row": "multislab stencil_step", "form": label, "hosts": hosts,
               "plan": many.describe(), "boundary_sites": many.stencil_halo().boundary_sites * hosts,
               "overlap_equals_serial": torch.equal(_bits(o1), _bits(serial)),
               "overlap_equals_one_slab": torch.equal(_bits(o1), _bits(s1)),
               "depth2_equals_two_steps": torch.equal(_bits(o2), _bits(s2)),
               "launches": counts[sten], "expected_launches": 2 + 5,
               "kernels_on_new_shapes": _recorded_vs_plain("su3_stencil_planar", records,
                                                           dtype, accum, comp)}
        row["ok"] = (row["overlap_equals_serial"] and row["overlap_equals_one_slab"]
                     and row["depth2_equals_two_steps"] and counts[sten] == 7
                     and counts[cgk] == 0 and row["kernels_on_new_shapes"]["ok"]
                     and len(records) == 4)
        fail("stencil", row)
        if label == "soa f32":
            timing_plans[hosts] = (one, many, u_phys, v_p)
        del records, o1, o2, s1, s2, serial

    # -- times, the phase split, overlap efficiency, the ghost copy -------------------
    card = _tool_line(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    tracer = Tracer()  # one tracer, so that span ids stay unique across the runs
    for hosts, (one, many, u_phys, v_p) in timing_plans.items():
        step, step2 = many.stencil_step(), many.stencil_step(depth=2)
        serial_one = one.stencil_step()
        parts = many._stencil_overlap_parts()
        halo = many.stencil_halo()
        ghost_bytes = autotune._exchange_bytes(halo, hosts, 1, 1)
        ghost_ms = _time_ms(lambda: parts["exchange"](v_p), reps=50)
        times = {
            "serial_ms": _best_ms(lambda: serial_one(u_phys, v_p), STENCIL_REPS),
            "overlapped_ms": _best_ms(lambda: step(u_phys, v_p), STENCIL_REPS),
            "depth2_ms_per_application": _best_ms(lambda: step2(u_phys, v_p), STENCIL_REPS) / 2,
            "serial_wall_ms": _host_wall_ms(lambda: serial_one(u_phys, v_p), STENCIL_REPS),
            "overlapped_wall_ms": _host_wall_ms(lambda: step(u_phys, v_p), STENCIL_REPS),
            "depth2_wall_ms_per_application":
                _host_wall_ms(lambda: step2(u_phys, v_p), STENCIL_REPS) / 2,
        }
        split = {}
        for depth, fn in ((1, step), (2, step2)):
            many.tracer = tracer
            for _ in range(MULTISLAB_TRACED_STEPS):
                fn(u_phys, v_p)
            many.tracer = NULL_TRACER
            spans = tracer.spans()
            steps = {x.span_id for x in spans if x.name == "stencil.step"
                     and (x.attrs["hosts"], x.attrs["depth"]) == (hosts, depth)}
            acct = overlap_efficiency_from_spans(
                [x for x in spans if x.span_id in steps or x.parent_id in steps])
            wall_s = times["overlapped_wall_ms" if depth == 1 else
                           "depth2_wall_ms_per_application"] * depth / 1e3
            split[f"depth{depth}"] = {
                "phase_ms": {k: v * 1e3 for k, v in acct["phase_s"].items()},
                "sum_phases_ms": acct["sum_phases_s"] * 1e3,
                "traced_wall_ms": acct["traced_wall_s"] * 1e3,
                "overlap_efficiency": overlap_efficiency(acct["sum_phases_s"], wall_s)}
        _emit({"row": "multislab times", "hosts": hosts, "card": card, "form": "soa f32 L=32",
               **times, "ghost_copy_ms": ghost_ms, "ghost_copy_bytes": ghost_bytes,
               "ghost_copy_bytes_ms": None if hw is None else ghost_bytes / hw.hbm_bw * 1e3,
               "exchange_latency_s": None if hw is None else
               ghost_ms / 1e3 - ghost_bytes / hw.hbm_bw,
               "boundary_sites": halo.boundary_sites * hosts, **split,
               "timing": "*_ms: CUDA events on the main stream, best of "
                         f"{STENCIL_REPS}; *_wall_ms: host clock to a synchronize"})
    del timing_plans

    # -- attribution of the traced steps ------------------------------------------------
    if hw is not None:
        rows = attribution_report(tracer.spans(), hw=hw)
        for r in rows:
            _emit({"attribution": r})
        print(render_attribution(rows))

    # -- the fused CG, overlapped ---------------------------------------------------------
    u_np, b_np = _cg_measure_problem(PAPER_L32.L)
    one = build_plan(PAPER_L32)
    u1, b1 = one.pack_gauge(u_np), one.pack_rhs(b_np)
    ref = one.cg_solve(u1, b1)
    for hosts in (2, 4):
        many = build_plan(PAPER_L32, MeshSpec(hosts=hosts))
        with _recording("su3_cg_fused_planar", [], u1, keep=2) as records:
            res, counts = _counted(lambda: many.cg_solve(u1, b1, fused=True, overlap=True),
                                   totals)
        comp = many.cg_solve(u1, b1, fused=False, overlap=True)
        dispatched = res.iterations + 1
        timed = {}
        for name, plan in (("one_slab", one), ("overlapped", many)):
            state = plan.cg_state_init(b1)
            for _ in range(2):
                state = plan.cg_iterate(u1, state)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CG_TIMED_ITERS):
                state = plan.cg_iterate(u1, state)
            end.record()
            torch.cuda.synchronize()
            timed[f"{name}_iteration_ms"] = start.elapsed_time(end) / CG_TIMED_ITERS
        row = {"row": "multislab cg_solve fused overlapped", "hosts": hosts,
               "iterations": res.iterations, "one_slab_iterations": ref.iterations,
               "converged": res.converged,
               "residuals_equal_one_slab": res.residuals == ref.residuals,
               "x_equals_one_slab_bitwise": torch.equal(_bits(res.x_p), _bits(ref.x_p)),
               "composed_equals_fused_bitwise": comp.residuals == res.residuals
               and torch.equal(_bits(comp.x_p), _bits(res.x_p)),
               "launches": counts[cgk], "expected_launches": 2 * dispatched, **timed,
               "kernels_on_new_shapes": _recorded_vs_plain("su3_cg_fused_planar", records,
                                                           "float32", "", "none")}
        row["ok"] = (res.converged and res.iterations == ref.iterations
                     and row["residuals_equal_one_slab"] and row["x_equals_one_slab_bitwise"]
                     and row["composed_equals_fused_bitwise"]
                     and counts[cgk] == 2 * dispatched and counts[sten] == 0
                     and row["kernels_on_new_shapes"]["ok"])
        fail("cg", row)
        del many, records, res, comp
    del one, u1, b1

    # -- the halo seam --------------------------------------------------------------------
    many = build_plan(PAPER_L32, MeshSpec(hosts=2))
    u_phys, v_p = many.pack_gauge(u), many.pack_rhs(v_c)
    step = many.stencil_step()
    clean = step(u_phys, v_p).clone()
    many.faults = FaultPlan(seed, {"halo": FaultSpec(probability=1.0, actions=("drop",))})
    dropped = step(u_phys, v_p)
    fired = many.faults.fired
    drop_changes = not torch.equal(dropped, clean)
    many.faults = FaultPlan(seed, {"halo": FaultSpec(probability=1.0, actions=("corrupt",))})
    poisoned = not bool(torch.isfinite(step(u_phys, v_p)).all())
    many.faults = NULL_FAULT_PLAN
    restored = torch.equal(_bits(step(u_phys, v_p)), _bits(clean))
    row = {"row": "multislab halo faults", "hosts": 2, "drop_fired": fired,
           "drop_changes_result": drop_changes, "corrupt_non_finite": poisoned,
           "null_plan_bitwise_clean": restored}
    row["ok"] = fired == 1 and drop_changes and poisoned and restored
    fail("halo", row)
    del many, u_phys, v_p, clean, dropped, v_c
    torch.cuda.empty_cache()

    # -- the tuners at 2 slabs, on a pruned grid ----------------------------------------------
    cache = str(ROOT / "build" / "chip_smoke_autotune")
    t0 = time.perf_counter()
    st = autotune.best_stencil_config(L=PAPER_L32.L, hosts=2, tiles=TUNE_TILES, refresh=True,
                                      cache_directory=cache, hw=hw)
    cg = autotune.best_cg_config(L=PAPER_L32.L, hosts=2, tiles=TUNE_TILES, refresh=True,
                                 cache_directory=cache, hw=hw)
    again = autotune.best_stencil_config(L=PAPER_L32.L, hosts=2, tiles=TUNE_TILES,
                                         cache_directory=cache, hw=hw)
    row = {"row": "multislab tuners", "hosts": 2, "stencil": st, "cg": cg,
           "stencil_cached_again": again["cached"], "seconds": time.perf_counter() - t0}
    row["ok"] = again["cached"] and again["tile"] == st["tile"] and not st["cached"]
    fail("tuners", row)

    _emit({"provenance": provenance_block(str(ROOT))})
    return totals


RANKED_REPS = 20  # timed stencil steps and CG iterations per plan, medians


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median ms of one call over ``reps`` calls, each between two CUDA events."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _ranked_slab_phase(u, seed: int, failures: list[str]) -> dict[str, int]:
    """PAPER_L32 on 2 and 4 t-slabs owned by one NCCL rank (a process group
    of one, started here and destroyed at the end): first-touch init,
    ``step``, ``fused_step``, the stencil overlapped and not at depth 1
    and 2, fused and composed CG on ``_cg_measure_problem(32)``, each
    against the one-process slab plan bitwise, ``verify`` true; the
    stencil-step and CG-iteration ms (CUDA events, medians) beside the
    one-process plan's.  On one card nothing crosses ranks: the faces go
    by local copy and the CG reductions through the group.  Returns the
    counted launches per kernel of the ranked runs."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core.autotune import _cg_measure_problem
    from repro_torch.core.su3.plan import build_plan
    from repro_torch.kernels import su3_matmul, su3_stencil
    from repro_torch.launch import mesh as meshes

    mult, sten, cgk = (su3_matmul.LAUNCHES.name, su3_stencil.STENCIL_LAUNCHES.name,
                       su3_stencil.CG_LAUNCHES.name)
    totals = {mult: 0, sten: 0, cgk: 0}
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 31)
    n_sites = PAPER_L32.shape.n_sites
    v_c = torch.from_numpy((rng.standard_normal((n_sites, 3))
                            + 1j * rng.standard_normal((n_sites, 3))).astype(np.complex64)).to(dev)
    u_cg, b_cg = _cg_measure_problem(PAPER_L32.L)
    card = _tool_line(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    (ROOT / "build").mkdir(exist_ok=True)
    store = tempfile.mkdtemp(dir=ROOT / "build")

    def run(plan) -> dict:
        out = {}
        a, b, out["init_s"], _ = plan.init_data()
        out["a_sites"] = plan._site_count(a)
        out["a"], out["step"] = a.clone(), plan.step(a, b)
        out["fused"] = plan.fused_step(FUSED_K)(a, b)  # in place: a is not read again
        out["verify"] = plan.verify(out["step"])
        tu, tv = plan.pack_gauge(u), plan.pack_rhs(v_c)
        for overlap in (True, False):
            for depth in (1, 2):
                out[f"stencil {overlap} {depth}"] = plan.stencil_step(overlap, depth)(tu, tv)
        cu, cb = plan.pack_gauge(u_cg), plan.pack_rhs(b_cg)
        for fused in (True, False):
            res = plan.cg_solve(cu, cb, fused=fused, overlap=True)
            out[f"cg {fused}"] = res
        return out

    def timed(plan) -> dict:
        tu, tv = plan.pack_gauge(u), plan.pack_rhs(v_c)
        step = plan.stencil_step(overlap=True)
        cu, cb = plan.pack_gauge(u_cg), plan.pack_rhs(b_cg)
        state = [plan.cg_state_init(cb)]

        def iterate():
            state[0] = plan.cg_iterate(cu, state[0])

        return {"stencil_ms": _median_ms(lambda: step(tu, tv), RANKED_REPS),
                "cg_iteration_ms": _median_ms(iterate, RANKED_REPS)}

    meshes.init_distributed("cuda", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        for hosts in (2, 4):
            one = build_plan(PAPER_L32, meshes.SlabMesh(hosts, 1, dev))  # no group: one process
            ranked = build_plan(PAPER_L32, meshes.MeshSpec(hosts=hosts).resolve())
            want = run(one)
            got, counts = _counted(lambda: run(ranked), totals)
            keys = ["a", "step", "fused"] + [f"stencil {o} {d}" for o in (True, False)
                                             for d in (1, 2)]
            equal = {k: torch.equal(_bits(got[k]), _bits(want[k])) for k in keys}
            for fused in (True, False):
                g, w = got[f"cg {fused}"], want[f"cg {fused}"]
                equal[f"cg {fused}"] = (g.iterations == w.iterations
                                        and g.residuals == w.residuals
                                        and torch.equal(_bits(g.x_p), _bits(w.x_p)))
            dispatched = got["cg True"].iterations + 1
            expected = {mult: 2, sten: 2 + 5 + 1 + 2 + 2 * dispatched, cgk: 2 * dispatched}
            times = {"ranked": timed(ranked), "one_process": timed(one)}
            row = {"row": "ranked slabs", "hosts": hosts, "world": ranked.world,
                   "backend": torch.distributed.get_backend(), "plan": ranked.describe(),
                   "site_range": list(ranked.site_range), "a_sites": got["a_sites"],
                   "first_touch": "first_touch_init over the rank's slabs",
                   "bitwise_equal_one_process": equal, "verified": got["verify"],
                   "cg_iterations": got["cg True"].iterations,
                   "launches": {k: counts[k] for k in expected}, "expected_launches": expected,
                   "init_s": got["init_s"], "one_process_init_s": want["init_s"],
                   "stencil_step_ms": times["ranked"]["stencil_ms"],
                   "one_process_stencil_step_ms": times["one_process"]["stencil_ms"],
                   "cg_iteration_ms": times["ranked"]["cg_iteration_ms"],
                   "one_process_cg_iteration_ms": times["one_process"]["cg_iteration_ms"],
                   "face_bytes_per_slab_step": one.stencil_halo().halo_bytes_per_exchange,
                   "bytes_across_ranks": 0, "card": card,
                   "timing": f"CUDA events, median of {RANKED_REPS}; overlapped stencil, "
                             "fused overlapped CG"}
            row["ok"] = (all(equal.values()) and got["verify"]
                         and got["a_sites"] == ranked.local_sites
                         and all(counts[k] == v for k, v in expected.items()))
            print(f"ranked slabs x{hosts}: stencil step {row['stencil_step_ms']:.4f} ms "
                  f"(one process {row['one_process_stencil_step_ms']:.4f}), CG iteration "
                  f"{row['cg_iteration_ms']:.4f} ms (one process "
                  f"{row['one_process_cg_iteration_ms']:.4f}); {card}")
            _emit(row)
            if not row["ok"]:
                failures.append(f"ranked slabs x{hosts}: {row}")
            del one, ranked, want, got
            torch.cuda.empty_cache()
    except Exception as e:  # a rank that fails fails the phase
        failures.append(f"ranked slabs: {type(e).__name__}: {e}")
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    _emit({"phase": "ranked slabs", "seconds": time.perf_counter() - t_phase})
    return totals


LATTICE_BATCH = 4  # the runner's request batch, whole PAPER_L32 lattices
LATTICE_SLOT_K = [0, 1, 3, 8, 2, 5, 1, 4]  # the 8-slot table's depths (max_k 8)
LATTICE_SERVICE_K = [3, 8, 1, 5, 2, 7, 4, 6]  # the service's 8 requests at L=32
LATTICE_REPS = 10  # timed calls per turn, medians


def _lattice_batch_phase(u, seed: int, hw, failures: list[str]) -> dict[str, int]:
    """Whole PAPER_L32 lattices split over a mesh's devices: on the
    oversubscribed list ``[card, card]`` (one process) and on one NCCL rank
    owning 2 slabs (a process group of one, started here and destroyed at
    the end), ``BatchedLatticeRunner.run`` on a batch of 4 at k=1 and 3
    and ``fused_batched_step`` on an 8-slot table, each in 2 blocks (one
    launch each), bitwise against the one-device runner, with the launches
    counted by kernel; ``multiply`` on the rank (one all-gather); their ms
    beside the one-launch path's (medians, in turns); ``SU3Service``'s
    megakernel mode on a host of 2 devices against one device; the ranked
    stencil and CG tuners at 2 slabs (served from the cache the second
    time); and the two CG reductions of a ranked iteration on the host's
    clock beside the one-process plan's.  Returns the counted launches per
    kernel."""
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs.su3_bench import PAPER_L32
    from repro_torch.core import autotune
    from repro_torch.core.su3 import layouts
    from repro_torch.core.su3.plan import BatchedLatticeRunner, build_plan
    from repro_torch.kernels import su3_matmul, su3_stencil
    from repro_torch.launch import mesh as meshes
    from repro_torch.serve.su3 import ServiceConfig, SU3Service

    mult, mega, sten, cgk = (su3_matmul.LAUNCHES.name, su3_matmul.MEGA_LAUNCHES.name,
                             su3_stencil.STENCIL_LAUNCHES.name, su3_stencil.CG_LAUNCHES.name)
    totals = {mult: 0, mega: 0, sten: 0, cgk: 0}
    dev = u.device
    t_phase = time.perf_counter()
    card = _tool_line(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    rng = np.random.default_rng(seed + 41)
    slots = len(LATTICE_SLOT_K)
    lattices = torch.stack(_slot_lattices(u, slots))
    b_c = torch.from_numpy(random_su3(rng, (slots, layouts.LINKS))).to(dev)
    one = BatchedLatticeRunner(PAPER_L32, dev)
    table, table_b = one.pack_batch(lattices), one.pack_b_batch(b_c)
    a, b = table[:LATTICE_BATCH], table_b[:LATTICE_BATCH]
    ks = torch.tensor(LATTICE_SLOT_K, dtype=torch.int32, device=dev)
    want = {k: one.run(a, b, k=k) for k in (1, 3)}
    one_mega = one.plan.fused_batched_step(slots, max_k=MAX_K, alias=False)
    want_mega = one_mega(table, table_b, ks)
    want_c = one.multiply(lattices[:LATTICE_BATCH], b_c[:LATTICE_BATCH], k=3)

    def split_rows(label: str, runner) -> None:
        step = runner.plan.fused_batched_step(slots, max_k=MAX_K, alias=False)

        def drive():
            runs = {k: runner.run(a, b, k=k) for k in (1, 3)}
            return runs, step(table, table_b, ks), runner.multiply(
                lattices[:LATTICE_BATCH], b_c[:LATTICE_BATCH], k=3)

        (got, got_mega, got_c), counts = _counted(drive, totals)
        equal = {f"run k={k}": torch.equal(_bits(got[k]), _bits(want[k])) for k in (1, 3)}
        equal["megakernel 8 slots"] = torch.equal(_bits(got_mega), _bits(want_mega))
        equal["multiply k=3"] = torch.equal(torch.view_as_real(got_c), torch.view_as_real(want_c))
        blocks = len(runner.blocks(LATTICE_BATCH))
        expected = {mult: 3 * blocks, mega: blocks}
        turns = {"one": [], "split": []}
        mega_turns = {"one": [], "split": []}
        for who in ("one", "split", "split", "one"):
            r, st = (one, one_mega) if who == "one" else (runner, step)
            turns[who].append(_median_ms(lambda: r.run(a, b, k=1), LATTICE_REPS))
            mega_turns[who].append(_median_ms(lambda: st(table, table_b, ks), LATTICE_REPS))
        row = {"row": "lattice batches", "mesh": label, "plan": runner.plan.describe(),
               "devices": [str(d) for d in runner.mesh.devices], "blocks": blocks,
               "bitwise_equal_one_device": equal, "launches": {k: counts[k] for k in expected},
               "expected_launches": expected,
               "run_k1_ms": turns["split"], "one_launch_run_k1_ms": turns["one"],
               "megakernel_ms": mega_turns["split"],
               "one_launch_megakernel_ms": mega_turns["one"], "card": card,
               "timing": f"CUDA events, median of {LATTICE_REPS} a turn; turns one, split, "
                         "split, one; batch of 4 (k=1) and an 8-slot table, PAPER_L32"}
        row["ok"] = all(equal.values()) and all(counts[k] == v for k, v in expected.items())
        print(f"lattice batches [{label}]: run k=1 {turns['split']} ms in {blocks} launches "
              f"(one launch {turns['one']}), megakernel {mega_turns['split']} ms (one launch "
              f"{mega_turns['one']}); {card}")
        _emit(row)
        if not row["ok"]:
            failures.append(f"lattice batches {label}: {row}")

    def host_median_ms(fn, reps: int = 50) -> float:
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    # -- one process: the card twice -------------------------------------------------------
    try:
        split_rows("[card, card]", BatchedLatticeRunner(
            PAPER_L32, meshes.MeshSpec(1, 2).resolve(devices=[dev, dev])))

        def serve(device):
            cfg = ServiceConfig(continuous=True, megakernel=True, autotune=False,
                                tile=PAPER_L32.tile, chain_slots=slots)
            svc = SU3Service(cfg, device=device)
            ids = [svc.submit(lattices[i], b_c[i], k=k) for i, k in enumerate(LATTICE_SERVICE_K)]
            svc.run_until_drained()
            torch.cuda.synchronize()
            return svc, [svc.pop_result(i) for i in ids]

        svc1, want_res = serve(dev)
        t0 = time.perf_counter()
        (svc2, got_res), counts = _counted(lambda: serve([dev, dev]), totals)
        wall_s = time.perf_counter() - t0
        snap1, snap2 = svc1.metrics.snapshot(), svc2.metrics.snapshot()
        row = {"row": "lattice batches service", "mode": "megakernel", "host_devices": 2,
               "requests": len(LATTICE_SERVICE_K), "dispatches": snap2["dispatches"],
               "one_device_dispatches": snap1["dispatches"],
               "launches": {mega: counts[mega]}, "expected_launches": {mega: 2 * snap2["dispatches"]},
               "table_parts": len(svc2._tables[0][1].a_parts),
               "bitwise_equal_one_device": all(
                   torch.equal(torch.view_as_real(x), torch.view_as_real(y))
                   for x, y in zip(got_res, want_res)),
               "dispatch_wall_ms": snap2["busy_s"] / max(1, snap2["dispatches"]) * 1e3,
               "one_device_dispatch_wall_ms": snap1["busy_s"] / max(1, snap1["dispatches"]) * 1e3,
               "stream_wall_s": wall_s, "card": card}
        row["ok"] = (row["bitwise_equal_one_device"] and counts[mega] == 2 * snap2["dispatches"]
                     and snap1["dispatches"] == snap2["dispatches"]
                     and snap2["completed"] == len(LATTICE_SERVICE_K))
        _emit(row)
        if not row["ok"]:
            failures.append(f"lattice batches service: {row}")
        del svc1, svc2, want_res, got_res
    except Exception as e:
        failures.append(f"lattice batches, one process: {type(e).__name__}: {e}")

    # -- one NCCL rank: its blocks, the ranked tuners, the CG reductions --------------------
    (ROOT / "build").mkdir(exist_ok=True)
    store = tempfile.mkdtemp(dir=ROOT / "build")
    meshes.init_distributed("cuda", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        split_rows("one NCCL rank, MeshSpec(2)", BatchedLatticeRunner(
            PAPER_L32, meshes.MeshSpec(hosts=2).resolve()))
        cache = str(pathlib.Path(store) / "autotune")
        t0 = time.perf_counter()

        def tune():
            return {name: [fn(L=PAPER_L32.L, hosts=2, tiles=TUNE_TILES, cache_directory=cache,
                              hw=hw) for _ in range(2)]
                    for name, fn in (("stencil", autotune.best_stencil_config),
                                     ("cg", autotune.best_cg_config))}

        tuned, counts = _counted(tune, totals)
        keys = sorted(autotune.load_cache(cache))
        row = {"row": "ranked tuners", "hosts": 2, "world": 1,
               "stencil": tuned["stencil"][0], "cg": tuned["cg"][0],
               "cached_again": [tuned[n][1]["cached"] for n in ("stencil", "cg")],
               "cache_keys": keys, "launches": {sten: counts[sten], cgk: counts[cgk]},
               "seconds": time.perf_counter() - t0}
        row["ok"] = (all(row["cached_again"]) and not tuned["stencil"][0]["cached"]
                     and all(tuned[n][1]["tile"] == tuned[n][0]["tile"] for n in tuned)
                     and len(keys) == 2 and all("|w1|" in k for k in keys)
                     and counts[sten] > 0)  # composed CG candidates launch the stencil only
        _emit(row)
        if not row["ok"]:
            failures.append(f"ranked tuners: {row}")
        ranked_plan = build_plan(PAPER_L32, meshes.MeshSpec(hosts=2).resolve())
        one_plan = build_plan(PAPER_L32, meshes.SlabMesh(2, 1, dev))
        x = torch.ones((2, 3, 1024), device=dev)
        walls = {}
        for who in ("one", "ranked", "ranked", "one"):
            h = (ranked_plan if who == "ranked" else one_plan)._cg_helpers()
            walls.setdefault(who, []).append(host_median_ms(lambda: (h["rr"](x),
                                                                     h["dot"](x, x))))
        reduce_ms = statistics.median(walls["ranked"]) - statistics.median(walls["one"])
        _emit({"row": "ranked CG reductions", "hosts": 2, "world": 1,
               "two_reductions_ms": walls["ranked"], "one_process_ms": walls["one"],
               "reduction_cost_ms": reduce_ms,
               "model_constant_ms": autotune.CG_REDUCTION_LATENCY_S * 1e3, "card": card,
               "timing": "host clock around rr + dot of a (2, 3, 1024) field and a "
                         "synchronize, median of 50 a turn; turns one, ranked, ranked, one"})
        print(f"ranked CG reductions: {reduce_ms:.4f} ms an iteration (host clock); {card}")
        del ranked_plan, one_plan
    except Exception as e:  # a rank that fails fails the phase
        failures.append(f"lattice batches, ranked: {type(e).__name__}: {e}")
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    del lattices, table, table_b, want, want_mega, want_c
    torch.cuda.empty_cache()
    _emit({"phase": "lattice batches", "seconds": time.perf_counter() - t_phase})
    return totals


def _drift_matches(engine, k: int, launches: int) -> bool:
    """Run ``launches`` fused k-chains from the uniform lattice and compare
    every stored word with the host's prediction: per launch an f32 chain of
    ``y = ((x*b + x*b) + x*b)`` with b = bf16(1/3), rounded to bf16 once."""
    import numpy as np
    import torch

    plan = engine.plan
    a, b, _, _ = plan.init_data()
    step = plan.fused_step(k)
    x = a
    for _ in range(launches):
        x = step(x, b)
    bw = np.float32(torch.tensor(1.0 / 3.0).to(torch.bfloat16).float().item())
    v = np.float32(1.0)
    for _ in range(launches):
        for _ in range(k):
            p = np.float32(v * bw)
            v = np.float32(np.float32(p + p) + p)
        v = np.float32(torch.tensor(float(v)).to(torch.bfloat16).float().item())
    c = plan.unpack(x)[:, :, : plan.codec.stored_rows, :]
    return bool(torch.all(c.real == float(v)).item() and torch.all(c.imag == 0).item())


if __name__ == "__main__":
    sys.exit(main())
