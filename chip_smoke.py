#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (apex_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--log FILE]

Run from the root of a checkout on a machine with a CUDA device and the
CUDA toolkit; it builds the kernels from ``apex_tpu_torch/csrc`` itself.
It prints one JSON line per phase and fails (non-zero exit, no result
line) on any failed check:

1. card: name and power limit (``nvidia-smi``), kernel build time;
2. kernels: each hand-written kernel against its plain PyTorch version
   on the card at the serving path's shapes (LayerNorm forward also at
   the GPT-2 small, BERT-large and GPT-2 medium training shapes, with
   O2's bf16 affine, which must take its warp design, and at rows that
   take its block and wide designs, with planted faults), with
   its time, the plain version's time, one PyTorch library call's time
   as a yardstick and the least time the card could take (``bound_ms``);
   paged attention at every case of :func:`paged_problems` (decode,
   speculative-verify and prefill sizes, each pool dtype, with and
   without the mask, rows on and next to the kernels' split boundaries,
   and the tree-verify blocks with their shared positions and branch
   masks, each running the design it must), each with two planted faults
   and the same bits on a second call;
3. parity: GPT-2 small at fp32 on the card against the same port on the
   CPU with the same seeded weights (one 64-token prefill chunk, one
   K=8 decode window, one more decode step);
4. engine: ``ServeEngine`` serving GPT-2 small (bf16 compute, bf16 page
   pool) through 16 seeded requests, with every kernel's launch count
   read from that run alone; profile: one decode window under
   ``torch.profiler``, with the paged-attention kernels' device time and
   calls (exactly 25 LayerNorms and 12 paged calls a step);
   speculative decoding and the contiguous cache: ``spec_parity``
   (GPT-2 small fp32, fp32 pages, TF32 off: a verify block of T = 4 and
   8 against T decode steps; four requests, one a period-2 repetition,
   through five engines — paged plain, paged n-gram D = 3, paged
   shallow D = 2 E = 6, contiguous plain, contiguous n-gram D = 3 — with
   the same greedy tokens as each other and as ``reference_generate``,
   the contiguous ones launching no paged or flash kernel, and the
   repetitive request accepting drafts), ``spec_engine`` (the engine
   mix through the bf16 n-gram spec engine at D = 3 and 7, each run's
   launches; bf16 verify blocks against their steps) and
   ``spec_profile`` (the profile set-up with the D = 3 spec window,
   beside the plain window); tree speculation and the draft auto-tuner:
   ``spec_tree_parity`` (fp32: a tree block's logits at each branch
   against that branch's chain block within 1e-3; the four requests
   through the tree engines at (W, D) = (2, 3) and (4, 2) and the
   auto-tuned chain and tree engines, with the paged engine's and
   ``reference_generate``'s tokens; the tree banking at least the
   chain's tokens a window; a poisoned history that branch 1 must win)
   and ``spec_tree_engine`` (bf16, the engine mix through the tree
   engines at (2, 3) and (3, 3) and the auto-tuned chain at D = 3, with
   exactly 25 LayerNorms and 12 paged calls a forward, the tuner's
   trajectory, and the profile set-up with the (2, 3) tree window);
5. training kernels: the LayerNorm backward, flash attention forward and
   backward and the fused cross-entropy forward and backward against
   their plain versions at the training shapes (GPT-2 small, batch
   16 x 1024; the LayerNorm backward and the cross-entropy also at
   BERT-large's 12 x 512, hidden 1024, vocabulary 30592) and, for flash
   attention, at a few other shapes, each with planted faults the check
   must reject, and the library yardsticks (``F.layer_norm``'s backward,
   ``F.scaled_dot_product_attention``, ``F.cross_entropy``).  bf16 flash
   attention runs on the tensor cores (``mma.sync``, fp32 p split into
   bf16 hi + lo) and is held to :data:`SPLIT_TOL`: 2 bf16 ulps plus 1e-4
   of max|want|, with at most 2 % of the elements different, a gate that
   the planted fault "the split's low half dropped" must fail; its
   ragged cases also plant the rows past a tile's end staged as NaN;
   fp32 flash attention runs the fp32 FMA kernels, within 1e-5;
6. train parity: GPT-2 small at fp32 (O0, TF32 off, no dropout), batch
   2 x 256, loss and gradients on the card against the port on the CPU;
7. train: O2 training of GPT-2 small at batch 16 x 1024 with dropout,
   ``AmpOptimizer(fused_adam(6e-4, weight_decay=0.1))`` driven by
   ``FusedTrainDriver`` at K = 10 steps per window: tokens/s, losses,
   peak memory, the launch counts of one window, and a planted overflow
   step that must be skipped; then one step under ``torch.profiler``;
8. BERT kernels: flash attention with an additive bias (BERT-large's
   shape with the expanded key-padding mask, causal fp32 300 x 450 with
   ``bias_grad`` and dbias, bf16 with a full bf16 bias) and LAMB stage 1
   (word table, FFN kernel, bias and a ragged leaf, skip 0 and 1; then
   one step over every BERT-large leaf, timed) against their plain
   versions, with planted faults (bias batch bh % B, dbias times scale,
   an unwritten skipped dbias tile, the ragged tail left out of the
   sums, skip ignored) and SDPA with the float mask as the yardstick;
9. BERT: BERT-large fp32 (O0) loss and four gradients, card against the
   port on the CPU, batch 2 x 256 padded to lengths 200 and 256; then
   O2 MLM training with ``AmpOptimizer(fused_lamb(1e-3,
   weight_decay=0.01))`` at batch 12 x 512 padded (lengths 128-512),
   K = 6: sequences/s and valid tokens/s, losses, peak memory, one
   window's launches (K x (LN 50, LN backward 50, flash bias forward and
   backward 24, cross-entropy 1 and 1, LAMB 297)), a planted overflow
   that must be skipped with LAMB's m, v and step unchanged, and one
   step under ``torch.profiler``;
10. conv+BN kernels: the wgmma operand descriptors (one tile product
    in each operand-major combination against ``torch.matmul``), the
    wgmma kernels' shared memory, registers, spills (none allowed) and
    blocks per SM; ``matmul_stats``, ``bn_relu_matmul`` and
    ``matmul_bwd_dual`` driven once each at RN50's eight 1x1 shapes
    (batch 128; the launch counts of that run alone), then held against
    their plain versions there, at three ragged shapes and at an fp32
    shape (every wgmma kernel launched by some case), each line naming
    the design that ran (the three bf16 entry points on the wgmma
    kernels where TMA can read the matrices, ``bn_relu_matmul`` with its
    BN prologue in shared memory; the rest on the mma.sync/FMA ones),
    with planted faults (stats of the unrounded products, the last row
    block out of the stats and of dw, the ReLU dropped, a BN bias off at
    one channel; in the wgmma kernels a ring stage's products dropped, a
    block's last row tile skipped and, after the BN prologue, the padded
    rows left unmasked), two calls bit for bit equal, timed
    beside their bounds and the library chains; the cross-entropy at
    RN50's (128, 1000) fp32 logits and at the ImageNet example's
    defaults, (64, 1000) bf16 (O1 autocast's logits);
11. ResNet-50: fp32 (O0) logits, loss and the updated running
    statistics, and four gradients with training-mode and eval-mode
    BatchNorm (within fixed limits above their fp32 rounding floor, which
    a TF32 control on the card must fail), card against the port on the
    CPU, batch 2 x 224^2; then O2 training with ``AmpOptimizer(fused_sgd(0.1,
    momentum=0.9, weight_decay=1e-4))`` at batch 128 x 224^2, K = 10
    (``bench.py``'s RN50 configuration): images/s, losses, peak memory,
    one window's launches (K x cross-entropy 1 and 1), a planted
    overflow that must be skipped with the masters, momentum buffers and
    step unchanged, and one step under ``torch.profiler``;
    data parallelism: ``ddp_resnet`` (the same set-up with
    ``sync_batchnorm=True`` and ``DistributedDataParallel()`` in an NCCL
    group of one process: its first window bit for bit the unsynced
    one's losses, masters, momentum and batch statistics; exactly 53
    BatchNorm all-reduces forward, 53 backward and one a gradient dtype
    (bf16 and fp32) a step; images/s, busy share, peak memory, the
    all-reduces' and flat copies' device ms; a planted inf skipped) and
    ``ddp_gloo_card`` (two processes on the one card through gloo on
    CUDA tensors, ResNet-50 O0 fp32, 32 images a rank, 3 steps with DDP
    + SyncBN, against one process on the 64 images; planted faults: a
    rank on local BatchNorm statistics, a rank that dies);
12. the dq-accumulating flash backward against the partials backward,
    bit for bit on five runs of each case (GPT-2 small and medium causal,
    BERT-large with its padding bias, fp32, a ragged Sq != Sk, the
    nq = 1 and nk = 1 edges, causal with more keys than queries) and
    against the plain version, with a NaN-poisoned running buffer and two
    planted faults of the kernel (a key tile's contribution dropped, the
    key order reversed), timed beside the partials kernel with the device
    memory one backward takes under each; ``probs_bf16`` in the forward
    and both backwards against their plain versions and against
    ``probs_bf16=False`` within the JAX package's contract (the identity
    at fp32), with the rounding left out as the planted fault;
    ``dropout_heads``: a head group equal to the whole call's slice;
    head_dim 128 (bf16): the flash kernels' shared memory, blocks per SM,
    registers and spills at head_dim 64 and 128, then the forward and
    both backwards against their plain versions causal with dropout,
    with a key-padding bias, with ``probs_bf16``, ragged both ways, with
    ``bias_grad`` and at nq = nk = 1, the acc backward bit for bit the
    partials one, with the split and staging faults; three cases timed
    beside SDPA and the bound;
13. GPT-2 medium: the LayerNorm and cross-entropy kernels at its shapes;
    fp32 card vs CPU with M = 2 microbatches, ``full_block`` remat and
    ``dq_acc``, and the three remat policies bit-equal on the card with
    dropout; O2 training with ``amp_microbatch_step`` (4 microbatches of
    8 x 1024 per step), ``full_block``, ``probs_bf16`` and ``dq_acc``,
    ``fused_adam(3e-4, weight_decay=0.1)``, K = 2: tokens/s, losses, peak
    memory, one window's launches (K x M x (LN 97, flash forward 48, the
    acc backward 24, the partials backward 0, LN backward 49,
    cross-entropy 1 and 1)), an inf in one microbatch that must skip the
    whole accumulated update; the peak memory and wall of one microbatch
    under each remat policy; and one step under ``torch.profiler``;
14. AMP O1, checkpoints and the stash route: ``o1_parity`` (GPT-2 small
    and BERT-large padded to lengths 200 and 256, fp32 parameters under
    ``amp_.autocast()``, batch 2 x 256, card against CPU: the loss within
    1e-2, the logits within 5e-2 of the largest, four gradients within
    2e-2 relative L2, every Dense, projection and head product on bf16
    operands by the ``amp.F`` product counts, and the launches);
    ``o1_train`` (GPT-2 small O1 at 8 x 1024, dropout 0.1,
    ``fused_adam(6e-4, weight_decay=0.1)``, K = 4: tokens/s beside the
    O2 window's, device-busy share, peak memory, one window's launches
    (K x (LN 25, LN backward 25, flash 12 + 12, cross-entropy 1 + 1)) and
    bf16 products, a planted overflow that must be skipped);
    ``checkpoint_resume`` (the O1 set-up with its dropout generator in
    the carry: one window, ``FusedTrainDriver.save``, ``restore`` into a
    carry from another seed, ``copy_to_model``, the second window, bit
    for bit the unbroken run's losses, scale state, masters, moments and
    generator state; a corrupted newest step falls back, and restoring
    it by number raises; save and restore wall, bytes on disk); and
    ``stash`` (GPT-2 small O2, two microbatches of 8 x 1024 through
    ``accumulate(update_scaler=False)`` and ``step`` with ``fused_sgd``,
    ``fused_adam`` and ``fused_lamb``: the stash within 1e-6 of the
    float64 sum, LAMB stage 1 on this route against its plain version,
    an inf in the second microbatch leaving every state bit for bit);
15. the rest of the library: ``novograd_adagrad`` (GPT-2 small O2 at
    16 x 1024, K = 4, through ``fused_novograd`` and ``fused_adagrad``:
    losses finite and falling, exact launches, the first update card
    against CPU within 1e-5, a planted overflow skipped with the state
    bit for bit); ``encdec_attn`` (``EncdecMultiheadAttn`` at
    Transformer-big widths, batch 16, 256 decoder over 384 encoder
    tokens with seeded key padding, bf16 O2, dropout 0.1, without and
    with ``include_norm_add``: forward and backward against the same
    module on the kernels' plain versions at the same dropout seed,
    exact launches, the Sq != Sk padded flash kernels timed beside SDPA,
    fp32 card against CPU at batch 2); ``bert_untied`` (BERT-large with
    the untied ``mlm_head``: fp32 card against CPU, ``BertEncoder`` with
    two token types card against CPU, O2 + ``fused_lamb`` at 12 x 512,
    K = 2, one LAMB launch a leaf of the untied tree); ``dcgan`` (the
    DCGAN example at nz 100, ngf = ndf = 64, batch 128, O1, three loss
    scalers: two windows of 5 iterations, images/s, a planted overflow
    in errD_fake skipping D's step alone and halving scaler 1 alone, one
    fp32 iteration at batch 8 card against CPU); ``library_modules``
    (``MLP`` at apex's test sizes card against CPU, fp32 and bf16;
    ``SoftmaxCrossEntropyLoss`` at (16384, 50304) bf16 against its plain
    version; ``BatchNorm2d_NHWC`` with the fused add + ReLU at RN50's
    (128, 56, 56, 256) bit for bit ``SyncBatchNorm`` + add + ReLU in an
    NCCL group of one; weight norm card against CPU; ``BF16_Optimizer``
    over ``fused_adam`` with a planted overflow);
16. the rest of the library, part 2: ``l2norm_card`` (after the BERT
    phases: ``multi_tensor_l2norm``'s one launch on GPT-2's word table
    within 1e-6 of the fp32 sum of squares); ``asp`` (BERT-large pruned
    2:4 by ``ASP().prune_trained_model`` with ``sparsify(fused_lamb)``
    through ``AmpOptimizer``'s unfused route at ``bert_train``'s
    configuration, one K = 6 window: exact launches, the pruned
    positions exactly 0 in the fp32 masters and the bf16 model, a
    planted overflow skipped with the masks unchanged, every sparse leaf
    half dense, the card's masks equal to the CPU's, the masks bit for
    bit through a checkpoint and a restore into masks of ``None``
    refused, ``m4n2_2d_best`` and ``m4n2_2d_greedy`` timed on a
    (1024, 1024) leaf, sequences/s beside ``bert_train``'s); and, last,
    ``rnn`` (the LSTM and GRU at the large PTB model's sizes and the
    byte-level mLSTM, fp32: card against CPU on 16 steps at batch 4,
    forward and backward timed at full size with the device-busy share,
    the mLSTM once in bf16 against its fp32 run);
17. scale-out: ``sp_world1`` (NCCL at world 1: ring and Ulysses attention
    on a mesh of one rank bit for bit ``flash_attention``, forward and
    gradients, at 12 heads x 2048 positions bf16 with dropout; one ZeRO
    and one FSDP boundary of the long-context recipe within 1e-5 relative
    L2 of ``amp_microbatch_step(fused_adam)``'s master movement; exact
    collectives), ``long_context_gang`` (four gloo processes on the one
    card, a (data 2, seq 2) mesh: ring and Ulysses attention at the
    model's attention shape against the unsharded kernels, every ring
    block's dropout mask bit for bit the unsharded one's, the first layer
    on the kernels against their plain versions; then
    ``examples/gpt_long_context`` at GPT-2 small's width, 12 layers,
    S 4096, M = 2, ``dots_saveable``, ZeRO, two O2 steps against the same
    model on one rank over the whole sequence and batch, beside that
    run's floor on the kernels' plain versions; exact launches, r + 1
    flash blocks a layer on seq rank r, and collectives; each rank's step
    wall and busy share; planted: a wrong column offset, the causal mask
    off the diagonal, a dead rank) and ``tp_pipeline_gang`` (four gloo
    processes, a (pipe 2, model 2) mesh: ``examples/transformer_parallel``
    at GPT-2 small's width, 12 blocks as two stages of 6, S 1024, M = 4
    of 2, two O2 steps against the unsharded model on one rank with the
    merged weights; exact launches and collectives; planted: a
    row-parallel backward without its cotangent sum);
18. scale-out, part 2: ``scale_out2_world1`` (NCCL at world 1: a
    tensor-parallel decoder at tp = 1 with the plain decoder's tokens and
    logits bit for bit; ``compress=None`` and Adasum bit for bit the plain
    step; the bf16 and int8 codecs on a GPT-2-small-sized flat gradient
    bit for bit the CPU's; ``MoEMLP`` at n = 1 against ``moe_mlp_ref``;
    exact collectives), the paged kernel at a rank's 3 heads against its
    plain version and bit for bit the 12-head call's slice, and one gang
    of four gloo processes on the card: ``tp_serve_gang`` (GPT-2 small
    over a (model 4) mesh, 3 heads a rank, the engine phase's mix with
    the one-rank engine's tokens and every logits tensor bit for bit, the
    fp32 mix with ``reference_generate``'s tokens, the chain, tree and
    int8 mixes with the one-rank engines', a quarter of the pool bytes,
    the one-rank launches, 12 head all-reduces a forward; the KV handoff
    both ways: a (model 4) prefill-only source's full-head containers
    adopted by a one-rank decode engine, and one-rank containers adopted
    by a (model 4) decode engine, each with the one-rank handoff's tokens
    and the one-rank containers bit for bit, the all-gathers under their
    own tag ``tp_handoff``; planted: a head block at the wrong offset, a
    dead rank) and ``moe_compress_gang``
    (Switch-Base-8's FFN over expert 4 against the same layer at n = 1;
    bf16 and int8 DDP, int8 ZeRO, bf16 FSDP and Adasum over data 4 at
    GPT-2 small's width, 2 layers, against the same policies on the CPU
    from the same state and gradients, exact collectives, the int8
    residual kept at a planted overflow; a ZeRO carry of data 4 restored
    as FSDP on (data 2, model 2) with the parameters bit for bit);
19. the obs plane: ``obs_serve`` (the engine phase's configuration
    under a seeded 32-request ``TrafficPlan`` on the load harness's
    virtual clock: two obs-on runs' ``LoadReport``s byte for byte, obs
    off the same tokens and launches, a warm window the same host syncs
    on and off with one device-to-host read, SLO-aware admission FIFO's
    tokens with a prefill yield or an overtake, the Chrome trace and
    the recorder's dump read back, no library built or loaded in a warm
    span; one wall-clock run's TTFT, ITL and tokens/s) and
    ``obs_train`` (one GPT-2 small O2 window bit for bit the obs-off
    one in losses, scales and launches, one ``train/dispatch`` span of
    K steps, the checkpoint spans and records in the reference's
    order);
20. the input pipeline, after the ResNet phases, in a fresh process
    (``--input-worker``: in a process that has run profiled training
    windows the profiler stops delivering some device events, and these
    phases read copies from it): ``data_loader`` (5,120
    records of 224 x 224 x 3 uint8 and an int32 label written by
    ``write_records``, 771 MB in a temporary directory: one epoch read
    with 2 workers, batches/s and GB/s from the page cache; every record
    once, the same order under 1 and 4 workers, another next epoch;
    each window ``DevicePrefetcher`` stages bit for bit a plain copy,
    its copies ``Memcpy HtoD (Pinned -> Device)`` on a stream apart
    from the kernels', and its two stream hazards planted: a held side
    stream read without ``wait_event`` and a held consumer's batch
    reused without ``record_stream`` must fail, the real prefetcher
    pass) and ``imagenet_example`` (the port's
    ``examples/imagenet`` in process: (a) O2, -b 128, K = 10 from the
    file, 4 windows: images/s beside ``resnet_train``'s, the host ms a
    window in the loader wait, ``window_batches``, ``train/prefetch``
    and ``train/dispatch``, window 2's busy share and gap, window 3's
    host syncs,
    peak memory, exact cross-entropy launches, falling losses; (b)
    window 0 from plain copies of JAX's host transform bit for bit; (c)
    the defaults: O1, -b 64, synthetic, 30 steps; (d) ``--sync_bn`` at
    world 1 bit for bit (a)'s window 0; (e) ``--prof 0``'s trace names
    the cross-entropy kernels);
21. disaggregated serving, after the obs phases: ``serve_handoff`` (GPT-2
    small, page_len 16, K = 8): (a) fp32, a prefill-only engine and a
    decode engine of 4 slots: an anchor, its duplicate (shared pages, a
    copy-on-written partial tail) and two more, each exported, through
    ``to_bytes``/``from_bytes``, adopted and detached: the tokens
    ``reference_generate``'s, the source's refcounts unchanged by the
    export and the anchor's again after the detach, the adopted pages of
    refcount 1 and bit for bit the containers', no window on the source
    and no chunk on the destination, the exact launches on each; (b)
    bf16, the engine mix disaggregated on 8 slots a side, every adopted
    page bit for bit (its tokens against the engine phase's reported,
    not gated), and four requests exported before any window whose
    source goes on in place: the same tokens as their adopted copies;
    (c) a 768-token prompt streamed in chunks of 128 tokens, each
    chunk's pages bit for bit, the commit with the whole handoff's
    tokens; planted: a flipped byte must raise and its abort put the
    pages back, a chunk out of order must be refused; (d) the mix's
    256-token prefix migrated: one hit of 256 tokens on the
    destination, the tokens of an engine that prefills it whole, the
    release back to the free count; (e) an identical-digest swap
    mid-decode (no requeue, the unswapped run's tokens, no library built
    or loaded), a wrong-shape leaf refused with the engine as it was,
    and a swap to reseeded weights at fp32 (the in-flight requests
    requeued, the registry empty, every later token
    ``reference_generate``'s under the new weights); (f) the timing
    line: payload bytes a request, export and adopt ms, the bytes' MB/s,
    the disaggregated wall beside the engine phase's.

Then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` summary and, as
the last line, ``{"ok": true, "device": {...}}``.  Without a CUDA
device it exits with status 1 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch import (
    MLP,
    BertConfig,
    BertEncoder,
    BertForMLM,
    Discriminator,
    FusedTrainDriver,
    GPTConfig,
    GPTDecoder,
    GPTLM,
    Generator,
    MicrobatchedStep,
    ServeEngine,
    amp,
    amp_microbatch_step,
    init_bert_params,
    init_dcgan_params,
    init_params,
    init_resnet_params,
    read_metrics,
    reference_generate,
    resnet50,
)
from apex_tpu_torch import checkpoint, obs
from apex_tpu_torch.bf16_utils import BF16_Optimizer
from apex_tpu_torch.RNN import GRU, LSTM, mLSTM
from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.contrib.multihead_attn import EncdecMultiheadAttn
from apex_tpu_torch.contrib.sparsity import ASP, sparse_masklib
from apex_tpu_torch.contrib.xentropy import SoftmaxCrossEntropyLoss
from apex_tpu_torch.examples import dcgan as dcgan_example
from apex_tpu_torch.examples import imagenet as imagenet_example
from apex_tpu_torch.models.gpt import tree_layout
from apex_tpu_torch.multi_tensor import multi_tensor_l2norm
from apex_tpu_torch.ops import _build, launch_counts, reset_launch_counts
from apex_tpu_torch.ops.attention import (
    _pack_seed,
    attention_ref,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_acc,
    flash_attention_bwd_ref,
    flash_attention_fwd,
    flash_attention_fwd_ref,
    paged_cached_attention,
    paged_fused_attention,
    quantize_kv,
)
from apex_tpu_torch.ops.conv_bn import (
    DUAL_DESIGNS,
    PRESENT,
    STATS_DESIGNS,
    TC_KERNELS,
    _RESIDENT_W,
    _conv_bn_design,
    bn_relu_matmul,
    bn_relu_matmul_ref,
    matmul_bwd_dual,
    matmul_bwd_dual_ref,
    matmul_stats,
    matmul_stats_ref,
    tc_kernel,
)
from apex_tpu_torch.ops.fused_optim import lamb_stage1, lamb_stage1_ref
from apex_tpu_torch.ops.layer_norm import (
    LN_BWD_DESIGNS,
    LN_BWD_WARP_KERNELS,
    LN_FWD_DESIGNS,
    LN_FWD_WARP,
    LN_FWD_WARP_KERNELS,
    _launch_fwd,
    _ln_fwd_design,
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_ref,
    layer_norm_ref,
    ln_bwd_blocks,
    ln_bwd_kernel,
    ln_fwd_kernel,
)
from apex_tpu_torch.ops.softmax_xentropy import (
    softmax_cross_entropy,
    softmax_cross_entropy_bwd,
    softmax_cross_entropy_bwd_ref,
    softmax_cross_entropy_fwd,
    softmax_cross_entropy_fwd_ref,
)
from apex_tpu_torch.optimizers import (
    fused_adagrad,
    fused_adam,
    fused_lamb,
    fused_novograd,
    fused_sgd,
)
from apex_tpu_torch.parallel import (
    DistributedDataParallel,
    MultiprocError,
    Reducer,
    SyncBatchNorm,
    collective_counts,
    data_parallel_group,
    init_distributed,
    launch,
    reset_collective_counts,
)
from apex_tpu_torch.parallel.multiproc import free_port
from apex_tpu_torch.reparameterization import apply_weight_norm, compute_weights
from apex_tpu_torch.serve import (HandoffError, KVHandoff, KVHandoffChunk,
                                  LoadGen, TrafficPlan)
from apex_tpu_torch.train import build_opt_step

# published H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12  # device memory
FP32_FLOPS = 67e12         # fp32 outside the tensor cores
BF16_FLOPS = 989e12        # bf16 on the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def fp32_precision(tf32: bool = False) -> None:
    """fp32 products and convolutions in full fp32 (the references'
    precision), or with ``tf32`` in TF32: the legacy switches and, where
    this PyTorch has them, the per-backend precisions ("ieee" or "tf32";
    cuDNN convolutions default to "tf32" there, which the legacy switch
    does not override on every version)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    for backend in (getattr(torch.backends.cuda, "matmul", None),
                    getattr(torch.backends.cudnn, "conv", None)):
        if backend is not None and hasattr(backend, "fp32_precision"):
            backend.fp32_precision = "tf32" if tf32 else "ieee"


def ptxas_by_function(log: str) -> list:
    """``nvcc -Xptxas -v``'s register and spill lines grouped under the
    entry function each belongs to (demangled where ``c++filt`` is
    installed)."""
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"function": m.group(1), "report": []}
            out.append(cur)
        elif cur is not None and ("registers" in ln or "spill" in ln):
            cur["report"].append(ln.strip())
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            r["function"] for r in out), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(out):
            for r, name in zip(out, names):
                r["function"] = name
    return out


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back runs
    (CUDA events around the whole run, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_events(prof):
    """The device-side events (kernels, copies, fills) of a trace.  Only
    these are summed: ``key_averages()`` also gives every aten op the
    device time of the kernels it launched, which would count them
    twice."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


#: the kernel ``torch.cuda._sleep`` launches, which no timed function does
SENTINEL = "spin_kernel"


def own_device_events(fn, iters: int):
    """``(events, calls)``: the device events of ``calls`` calls of
    ``fn()`` (after one untraced call), from a ``torch.profiler`` session
    in which a sentinel kernel runs before and after the calls.  The
    session is refused unless its device events are all the calls' own:
    both sentinels there, every other event between them, and each kernel
    name seen a whole number of times per call (a dropped or a foreign
    event breaks one of these).  The first session makes ``iters`` calls;
    a refused one is tried once more with a quarter of them.  None when
    both are refused."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for calls in (iters, max(2, iters // 4)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()  # every stream's work before the last
            torch.cuda._sleep(1000)
        events = _kernel_events(prof)
        marks = sorted((e for e in events if SENTINEL in e.name),
                       key=lambda e: e.time_range.start)
        own = [e for e in events if SENTINEL not in e.name]
        if len(marks) != 2 or not own:
            continue
        lo, hi = marks[0].time_range.end, marks[1].time_range.start
        counts: dict = {}
        for e in own:
            counts[e.name] = counts.get(e.name, 0) + 1
        if (all(lo <= e.time_range.start and e.time_range.end <= hi
                for e in own)
                and not any(n % calls for n in counts.values())):
            return own, calls
    return None


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one ``fn()``: the durations of its device-side
    events (host gaps excluded), or None when the profiler's sessions
    are refused (:func:`own_device_events`)."""
    got = own_device_events(fn, iters)
    if got is None:
        return None
    own, calls = got
    return sum(e.time_range.elapsed_us() for e in own) / calls / 1e3


def device_ms_by_kernel(fn, iters: int = 10) -> dict:
    """Device time of one ``fn()`` by kernel (the first 60 characters of
    its name) (:func:`own_device_events`); {} when the sessions are
    refused."""
    own, calls = own_device_events(fn, iters) or ([], 1)
    out = {}
    for e in own:
        out[e.name[:60]] = (out.get(e.name[:60], 0.0)
                            + e.time_range.elapsed_us() / calls / 1e3)
    return out


def timings(fn, iters: int = 50, prof_iters: int = 20) -> dict:
    """``ms``: device time per call (profiler, over ``prof_iters`` calls;
    the CUDA-event time when the profiler's sessions are refused);
    ``events_ms``: CUDA-event time per call over back-to-back calls, which
    includes the host's enqueue time wherever the host is the slower
    side."""
    ev = time_ms(fn, iters=iters)
    dev = device_ms(fn, iters=prof_iters)
    return {"ms": ev if dev is None else dev, "events_ms": ev,
            "ms_source": "events" if dev is None else "profiler"}


def bf16_ulp_ok(got, want, ulps: int = 1, floor=0.0) -> bool:
    """Every element within ``ulps`` bf16 ulps of the larger magnitude,
    plus an absolute ``floor`` (a number, or a tensor of one an
    element)."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return bool(((g - w).abs() <= ulps * ulp + floor).all())


def _merge(kern: dict, plain: dict, lib: dict) -> dict:
    out = dict(kern)
    for prefix, d in (("plain_", plain), ("library_", lib)):
        out.update({prefix + k: v for k, v in d.items()})
    return out


def _bound(nbytes: float, ops: dict):
    """(bound_ms, bound_by): the bytes over the memory rate against the
    operations over the peak rate of their type (``ops`` maps a peak
    rate to the operations done at it; the times of the types add)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / rate for rate, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _close(got, want, rtol: float, ulps: int = 0) -> bool:
    """Every element within ``rtol`` times the largest magnitude of
    ``want`` (the order of fp32 sums over the reduced axis), plus, for a
    bf16 result, ``ulps`` bf16 ulps of the larger magnitude (one rounding
    on each side)."""
    floor = rtol * want.float().abs().max().item()
    if got.dtype == torch.bfloat16:
        return bf16_ulp_ok(got, want, ulps=ulps, floor=floor)
    return _err(got, want) <= floor


def _dt(t) -> str:
    return str(t).replace("torch.", "")


def _case_name(c: dict) -> str:
    """A kernel case's own name, or its LayerNorm shape and dtypes."""
    return c.get("case") or (f"rows={c['rows']} n={c['n']} "
                             f"{c.get('dtype') or c['x_dtype']}/"
                             f"{c['w_dtype']}")


# -- phase 2: kernels ------------------------------------------------------

def ln_fwd_cases():
    """The LayerNorm forward's cases: (rows, n, x dtype, weight dtype,
    bytes x's base lies past a 16-byte boundary).  The serving shapes (the
    decode step, 8 slots x 1 token, and the 128- and 512-token prefill
    chunks; fp32 and bf16 x with fp32 affine); GPT-2 small's training
    shape, (16384, 768) fp32 x with bf16 affine (O2 casts every GPT
    parameter, LayerNorm's included) and with fp32 affine (O0);
    BERT-large's (6144, 1024) and GPT-2 medium's (8192, 1024) likewise;
    then the warp instantiations no model shape reaches (bf16 x with bf16
    affine at n 520, its last vectors masked, and at 1024; bf16 x with
    fp32 affine at 1024); then the block design (a ragged n, and a base 4
    bytes off alignment) and the wide design (n 12288 and 16384); then the
    verify blocks of speculative decoding, 8 slots x 4 and x 8 tokens,
    and the tree verify blocks, 8 slots x 7 and x 10 nodes."""
    f32, bf = torch.float32, torch.bfloat16
    return ((8, 768, f32, f32, 0), (8, 768, bf, f32, 0),
            (128, 768, f32, f32, 0), (128, 768, bf, f32, 0),
            (512, 768, f32, f32, 0),
            (16384, 768, f32, bf, 0), (16384, 768, f32, f32, 0),
            (6144, 1024, f32, bf, 0), (6144, 1024, f32, f32, 0),
            (8192, 1024, f32, bf, 0),
            (4097, 520, bf, bf, 0), (3000, 1024, bf, bf, 0),
            (4097, 1024, bf, f32, 0),
            (4099, 1021, f32, bf, 0), (4096, 768, f32, bf, 4),
            (1024, 12288, f32, bf, 0), (1024, 16384, bf, f32, 0),
            (32, 768, f32, f32, 0), (64, 768, f32, f32, 0),
            (56, 768, f32, f32, 0), (80, 768, f32, f32, 0))


# the forward cases at a model's training shape, which must take the warp
# design: GPT-2 small, BERT-large, GPT-2 medium (fp32 x, as every model
# passes it)
LN_FWD_TRAIN_SHAPES = ((16384, 768), (6144, 1024), (8192, 1024))


def _json_err(got, want):
    """:func:`_err`, or "nan" where ``got`` holds NaN (JSON has no NaN)."""
    e = _err(got, want)
    return e if e == e else "nan"


def _offset_copy(t, nbytes: int):
    """A copy of ``t`` whose base lies ``nbytes`` past a 16-byte
    boundary."""
    es = t.element_size()
    buf = torch.empty(t.numel() + 16 // es, dtype=t.dtype, device=t.device)
    off = next(i for i in range(16 // es)
               if (buf.data_ptr() + i * es) % 16 == nbytes)
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def ln_fwd_slack(x, w, b):
    """Per element of a LayerNorm forward's y, the fp32 rounding that row
    sums taken in another order can leave in it before its one rounding
    to bf16: 4 fp32 ulps (2^-21) of (|x| + |mean|) rstd |w| + |b|, the
    magnitudes y is formed from.  Where y cancels to near 0 that is many
    of y's own bf16 ulps; elsewhere it is far below one."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) - mean * mean
                       + 1e-5)
    return 2.0 ** -21 * ((x32.abs() + mean.abs()) * rstd * w.float().abs()
                         + b.float().abs())


def phase_layer_norm(dev):
    """LayerNorm forward at each of :func:`ln_fwd_cases` (the port of
    ``_ln_fwd_kernel``), each line naming the design the wrapper picked
    (``_ln_fwd_design``) and the instantiation it launched.  fp32 output
    within 1e-5, bf16 within 1 bf16 ulp of the larger magnitude plus
    :func:`ln_fwd_slack` of the plain version (``within_1_ulp`` says
    whether the bare ulp held as well); a second call into a y filled
    with NaN must give the same bits (every row written, the same sums on
    every run).  Planted faults the check must reject: the variance
    without its -mean^2 term, the affine dropped (the kernel without
    weight and bias) and the last row left unwritten in a y filled with
    NaN.  The training shapes of :data:`LN_FWD_TRAIN_SHAPES` must take
    the warp design and every entry of ``LN_FWD_WARP_KERNELS`` must be
    launched by some case."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for rows, n, dtype, w_dt, misalign in ln_fwd_cases():
        w = (1 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(w_dt)
        b = (0.1 * torch.randn(n, device=dev, generator=gen)).to(w_dt)
        x = (2 * torch.randn(rows, n, device=dev, generator=gen)
             + 0.5).to(dtype)
        if misalign:
            x = _offset_copy(x, misalign)
        design = _ln_fwd_design(x)
        got = layer_norm(x, w, b)
        want = layer_norm_ref(x, w, b)
        poisoned = _launch_fwd(x, w, b, 1e-5,
                               out=torch.full_like(x, float("nan")))
        torch.cuda.synchronize()
        err = _err(got, want)
        slack = ln_fwd_slack(x, w, b)

        def ok(y):
            if dtype == torch.float32:
                return _err(y, want) <= 1e-5
            return bf16_ulp_ok(y, want, ulps=1, floor=slack)

        name = (f"layer_norm rows={rows} n={n} {_dt(dtype)}/{_dt(w_dt)} "
                f"misalign={misalign}")
        check(ok(got), f"{name}: {err}")
        check(_bitwise(poisoned, got),
              f"{name}: a call into a NaN-filled y differs from the first")
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        no_msq = ((x32 - mean) * torch.rsqrt((x32 * x32).mean(
            -1, keepdim=True) + 1e-5) * w.float() + b.float()).to(dtype)
        unwritten = torch.full_like(x, float("nan"))
        _launch_fwd(x[:-1], w, b, 1e-5, out=unwritten[:-1])
        faults = {"var_without_mean_sq": no_msq,
                  "affine_dropped": layer_norm(x),
                  "last_row_unwritten": unwritten}
        torch.cuda.synchronize()
        for fault, y in faults.items():
            check(not ok(y), f"{name}: the check misses the planted fault "
                  f"{fault}")
        kern = timings(lambda: layer_norm(x, w, b))
        plain = timings(lambda: layer_norm_ref(x, w, b))
        wd, bd = w.to(dtype), b.to(dtype)
        lib = timings(lambda: F.layer_norm(x, (n,), wd, bd))
        bound, by = _bound(2 * x.numel() * x.element_size()
                           + 2 * n * w.element_size(),
                           {FP32_FLOPS: 8 * x.numel()})
        case = {"rows": rows, "n": n, "dtype": _dt(dtype),
                "w_dtype": _dt(w_dt), "misalign_bytes": misalign,
                "design": LN_FWD_DESIGNS[design],
                "kernel_instance": ln_fwd_kernel(dtype, w_dt, n, design),
                "max_abs_err": err,
                "tol": "1e-5" if dtype == torch.float32
                else "1 bf16 ulp + 2^-21 (|x| + |mean|) rstd |w| + |b|",
                "within_1_ulp": None if dtype == torch.float32
                else bf16_ulp_ok(got, want),
                "planted_fault_errs": {k: _json_err(y, want)
                                       for k, y in faults.items()},
                **_merge(kern, plain, lib), "bound_ms": bound,
                "bound_by": by}
        emit({"phase": "kernel", "kernel": "layer_norm", **case})
        out.append(case)
        del (x, w, b, got, want, poisoned, x32, mean, no_msq, unwritten,
             faults, slack)
    warp = LN_FWD_DESIGNS[LN_FWD_WARP]
    off = [(c["rows"], c["n"], c["design"]) for c in out
           if (c["rows"], c["n"]) in LN_FWD_TRAIN_SHAPES
           and c["dtype"] == "float32" and c["design"] != warp]
    check(not off, f"layer_norm: training shapes off the warp design {off}")
    missed = sorted(set(LN_FWD_WARP_KERNELS)
                    - {c["kernel_instance"] for c in out})
    check(not missed, f"layer_norm: no case launched the warp kernels "
          f"{missed}")
    torch.cuda.empty_cache()
    return out


def _paged_problem(dev, gen, t, pool_dtype, masked, lengths=None, tree=None):
    """GPT-2-small paged read: B=8, H=12, D=64, page_len 16, 64 pages per
    slot, lengths across partial pages (or the given ``lengths``), the
    full 12-layer pool read at layer 5.  ``tree=(W, D)`` makes it a tree
    verify block (T = 1 + W * D): the positions ``lengths + depth(node)``
    and the branch mask of :func:`tree_layout`.  bf16/int8 pools go with bf16 q
    (int8 with fp32 dequantized new keys, as the model passes them);
    fp32 with fp32.  q ~ 2·N(0, 1) and k, v ~ N(0, 1) make scores of std
    2: a peaked softmax whose outputs are of order 1, so that one key
    more or less moves them by far more than the check's tolerance."""
    b, h, d, page_len, pps, layers = 8, 12, 64, 16, 64, 12
    num_pages = 1 + b * pps
    shape = (num_pages, layers, h, page_len, d)
    pool_k = torch.randn(shape, device=dev, generator=gen)
    pool_v = torch.randn(shape, device=dev, generator=gen)
    ks = vs = None
    if pool_dtype == torch.int8:
        pool_k, ks = quantize_kv(pool_k)
        pool_v, vs = quantize_kv(pool_v)
    else:
        pool_k, pool_v = pool_k.to(pool_dtype), pool_v.to(pool_dtype)
    qdt = torch.float32 if pool_dtype == torch.float32 else torch.bfloat16
    perm = torch.randperm(num_pages - 1, device=dev, generator=gen) + 1
    table = perm.reshape(b, pps).to(torch.int32)
    rand_lengths = torch.randint(1, pps * page_len - t + 1, (b,),
                                 device=dev, generator=gen,
                                 dtype=torch.int32)
    lengths = (rand_lengths if lengths is None else
               torch.tensor(lengths, device=dev, dtype=torch.int32))
    positions = (lengths[:, None]
                 + torch.arange(t, device=dev, dtype=torch.int32))
    if tree is not None:
        depths, tree_mask = tree_layout(*tree, dev)
        check(t == depths.shape[1], f"tree {tree} has {depths.shape[1]} "
              f"nodes, not T = {t}")
        positions = lengths[:, None] + depths
    q = (2 * torch.randn(b, h, t, d, device=dev, generator=gen)).to(qdt)
    kn = torch.randn(b, h, t, d, device=dev, generator=gen)
    vn = torch.randn(b, h, t, d, device=dev, generator=gen)
    if pool_dtype == torch.int8:
        kq, kqs = quantize_kv(kn)
        vq, vqs = quantize_kv(vn)
        kn, vn = kq.float() * kqs[..., None], vq.float() * vqs[..., None]
    else:
        kn, vn = kn.to(qdt), vn.to(qdt)
    mask = None if tree is None else tree_mask
    if masked:
        mask = torch.rand(t, t, device=dev, generator=gen) < 0.6
        mask.fill_diagonal_(True)
    return dict(q=q, k_new=kn, v_new=vn, positions=positions.contiguous(),
                pool_k=pool_k, pool_v=pool_v, page_table=table,
                cache_lengths=lengths, pool_k_scale=ks, pool_v_scale=vs,
                layer=5, block_mask=mask)


def _sdpa_yardstick(p):
    """The same attention as one ``F.scaled_dot_product_attention`` call
    on the gathered view (built outside the timed call)."""
    q = p["q"]
    b, h, t, d = q.shape
    table = p["page_table"].long()
    pk, pv = p["pool_k"][:, p["layer"]], p["pool_v"][:, p["layer"]]
    n_pages, page_len = table.shape[1], pk.shape[2]
    s = n_pages * page_len

    def view(pool, sc):
        g = pool[table].permute(0, 2, 1, 3, 4).reshape(b, h, s, d).float()
        if sc is not None:
            scl = sc[:, p["layer"]][table].permute(0, 2, 1, 3).reshape(b, h, s)
            g = g * scl[..., None]
        return g

    k = torch.cat([view(pk, p["pool_k_scale"]), p["k_new"].float()], 2)
    v = torch.cat([view(pv, p["pool_v_scale"]), p["v_new"].float()], 2)
    pos = p["positions"]
    j = torch.arange(s, device=q.device)
    vis_c = (j < p["cache_lengths"][:, None, None]) & (j <= pos[:, :, None])
    vis_n = pos[:, None, :] <= pos[:, :, None]
    if p["block_mask"] is not None:
        vis_n = vis_n & p["block_mask"][None]
    mask = torch.cat([vis_c, vis_n], -1)[:, None]
    k, v = k.to(q.dtype), v.to(q.dtype)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def _paged_bound(p):
    """Least time for this call's work: each visible K/V element (and
    scale) read once, q/k_new/v_new read and the output written once;
    QK and PV dots over the visible keys at the peak rate of q's type
    (bf16 tensor cores for bf16, fp32 outside them for fp32)."""
    q = p["q"]
    b, h, t, d = q.shape
    lens = p["cache_lengths"].long()
    pos = p["positions"].long()
    vis = torch.minimum(lens, pos.max(dim=1).values + 1)
    n_keys = int(vis.sum())
    per_tok = 2 * h * d * p["pool_k"].element_size()
    if p["pool_k_scale"] is not None:
        per_tok += 2 * h * 4
    nbytes = n_keys * per_tok
    nbytes += q.numel() * q.element_size() * 2  # q in, out
    nbytes += 2 * p["k_new"].numel() * p["k_new"].element_size()
    # scores: each query's visible cache keys plus its visible new keys
    vis_c = torch.minimum(lens[:, None], pos + 1)
    vis_n = pos[:, None, :] <= pos[:, :, None]
    if p["block_mask"] is not None:
        vis_n = vis_n & p["block_mask"][None]
    flops = 4 * h * d * (int(vis_c.sum()) + int(vis_n.sum()))
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _paged_close(got, want) -> bool:
    """fp32 output: within 2e-5 (the order of fp32 sums).  bf16 output:
    each element within 2 bf16 ulps of the larger magnitude plus 1e-5
    (fp32 summation order near zero), and within 2e-2 overall."""
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.float32:
        return err <= 2e-5
    return err <= 2e-2 and bf16_ulp_ok(got, want, ulps=2, floor=1e-5)


# planted faults the check must catch: the kernel skipping the last,
# partial page of the history, and a key mask one key short
_FAULTS = {
    "drop_last_partial_page": lambda lens: lens - lens % 16,
    "mask_one_key_short": lambda lens: lens - 1,
}


#: the edge problem's rows: an empty history, histories ending on the
#: first two split boundaries of the decode kernel (64 keys a split at
#: page_len 16) and on the first of the tensor-core kernel (512 keys),
#: and one key past each (both checked in phase_paged_attention), and one
#: filling all 64 pages
EDGE_SPLIT_KEYS = (64, 512)
EDGE_LENGTHS = (0, 64, 65, 128, 129, 1024, 512, 513)


#: the chain-verify cases (T, pool dtype, masked, lengths), after the
#: others so that their random data stays as it was
CHAIN_VERIFY = [(t, pd, False, None) for t in (2, 4)
                for pd in (torch.bfloat16, torch.int8)]
CHAIN_VERIFY += [(8, torch.bfloat16, False, None),
                 (4, torch.bfloat16, False, EDGE_LENGTHS)]

#: the tree-verify cases ((W, D), pool dtype, lengths, the design the
#: wrapper must pick), after the chain's: positions lengths + depth(node)
#: and the branch mask; T = 7 runs the decode kernel, T = 10 and 17 bf16
#: the tensor-core kernel, T = 17 fp32 the FMA kernel
TREE_VERIFY = [((2, 3), torch.bfloat16, None, "split-K decode"),
               ((2, 3), torch.int8, None, "split-K decode"),
               ((3, 3), torch.bfloat16, None, "tensor cores"),
               ((4, 4), torch.bfloat16, None, "tensor cores"),
               ((4, 4), torch.float32, None, "fp32 FMA"),
               ((2, 3), torch.bfloat16, EDGE_LENGTHS, "split-K decode")]


def _tree_case_name(tree, pool_dtype, lengths) -> str:
    w, d = tree
    name = f"T={1 + w * d} pool={_dt(pool_dtype)} tree=W{w}xD{d}"
    return name + (" edge_lengths" if lengths is not None else "")


def paged_problems(dev):
    """The cases of :func:`phase_paged_attention`, in order, from one
    seeded generator: ``(name, problem)``.  T = 1 (decode) and 128 (a
    prefill chunk) with bf16 and int8 pools, with and without the mask,
    fp32 at T = 1 and 128; T = 8 masked bf16 (a speculative verify
    block: the tensor-core kernel) and T = 4 (the decode kernel's rows
    past the first); then :data:`EDGE_LENGTHS` at T = 1 bf16 and fp32,
    T = 8 int8 masked and T = 128 bf16 masked; then the chain-verify
    blocks of speculative decoding, causal by position with no mask
    (:data:`CHAIN_VERIFY`): T = 2 and 4 with bf16 and int8 pools, T = 8
    bf16 (the draft of 7: the tensor-core kernel) and T = 4 bf16 at
    :data:`EDGE_LENGTHS`; then the tree-verify blocks
    (:data:`TREE_VERIFY`)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    grid = [(t, pd, m, None) for t in (1, 128)
            for pd in (torch.bfloat16, torch.int8) for m in (False, True)]
    grid += [(1, torch.float32, False, None), (128, torch.float32, True, None),
             (8, torch.bfloat16, True, None), (4, torch.bfloat16, True, None)]
    grid += [(1, torch.bfloat16, False, EDGE_LENGTHS),
             (1, torch.float32, False, EDGE_LENGTHS),
             (8, torch.int8, True, EDGE_LENGTHS),
             (128, torch.bfloat16, True, EDGE_LENGTHS)]
    grid += CHAIN_VERIFY
    for t, pool_dtype, masked, lengths in grid:
        name = f"T={t} pool={_dt(pool_dtype)} masked={masked}"
        if lengths is not None:
            name += " edge_lengths"
        yield name, _paged_problem(dev, gen, t, pool_dtype, masked, lengths)
    for tree, pool_dtype, lengths, _ in TREE_VERIFY:
        yield (_tree_case_name(tree, pool_dtype, lengths),
               _paged_problem(dev, gen, 1 + tree[0] * tree[1], pool_dtype,
                              False, lengths, tree=tree))


def phase_paged_attention(dev):
    """Each case of :func:`paged_problems` against the plain version,
    with both planted faults, the same bits on a second call, and times
    beside the plain version, the SDPA yardstick and the bound."""
    from apex_tpu_torch.ops.attention import (_paged_design, _paged_split,
                                              _prefill_split)

    designs = {0: "fp32 FMA", 1: "split-K decode",
               2: "split-K tensor cores (mma.sync bf16)"}

    tree_design = {_tree_case_name(tr, pd, ln): want
                   for tr, pd, ln, want in TREE_VERIFY}
    splits = (_paged_split(page_len=16, n_pages=64)[0] * 16,
              _prefill_split(page_len=16, n_pages=64)[0] * 64)
    check(splits == EDGE_SPLIT_KEYS,
          f"the kernels' splits are {splits} keys, not the "
          f"{EDGE_SPLIT_KEYS} the edge problem's lengths are set at")
    cases = []
    for name, p in paged_problems(dev):
        q, kn, vn = p["q"], p["k_new"], p["v_new"]
        t = q.shape[2]
        kw = {k: v for k, v in p.items() if k not in ("q", "k_new", "v_new")}
        got = paged_fused_attention(q, kn, vn, **kw)
        again = paged_fused_attention(q, kn, vn, **kw)
        want = paged_cached_attention(q, kn, vn, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = ("2e-5" if q.dtype == torch.float32
               else "2 bf16 ulps + 1e-5, and 2e-2")
        check(_paged_close(got, want),
              f"paged attention {name}: max abs err {err}")
        check(torch.equal(got, again),
              f"paged attention {name}: two calls differ")
        faults = {}
        for fault, lens_of in _FAULTS.items():
            bad = paged_fused_attention(
                q, kn, vn, **dict(kw, cache_lengths=lens_of(
                    p["cache_lengths"]).contiguous()))
            faults[fault] = (bad.float() - want.float()).abs().max().item()
            check(not _paged_close(bad, want),
                  f"paged attention {name}: the check misses {fault}")
        kern = timings(lambda: paged_fused_attention(q, kn, vn, **kw))
        plain = timings(lambda: paged_cached_attention(q, kn, vn, **kw),
                        iters=20)
        lib = timings(_sdpa_yardstick(p), iters=20)
        bound, by = _paged_bound(p)
        design = designs[_paged_design(t, q.dtype, p["pool_k"].dtype)]
        check(tree_design.get(name, "") in design,
              f"paged attention {name}: ran the {design} kernel, not the "
              f"{tree_design.get(name)} one")
        case = {"case": name, "B": q.shape[0], "H": q.shape[1], "T": t,
                "D": q.shape[3], "mean_len": float(p["cache_lengths"]
                                                   .float().mean()),
                "design": design,
                "max_abs_err": err, "tol": tol, "same_bits_twice": True,
                "planted_fault_errs": faults, **_merge(kern, plain, lib),
                "bound_ms": bound, "bound_by": by}
        emit({"phase": "kernel", "kernel": "paged_fused_attention", **case})
        cases.append(case)
    return cases


# -- phase 3: parity ---------------------------------------------------------

def phase_parity(params):
    cfg = GPTConfig.small(compute_dtype=torch.float32)
    rng = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, 50257, (1, 64), generator=rng,
                           dtype=torch.int32)
    out = {}
    for where in ("cuda", "cpu"):
        dec = GPTDecoder(cfg, params, cache_dtype=torch.float32,
                         tokens_per_dispatch=8, device=where)
        cache = dec.init_paged_cache(num_pages=65, slots=1, page_len=16)
        table = torch.arange(1, 65, dtype=torch.int32)[None]
        logits = dec.prefill_chunk(cache, table, [0], prompt, [0], [64])
        first = torch.argmax(logits, -1).to(torch.int32)
        toks = dec.paged_decode_window(cache, table, first, [True])
        with torch.no_grad():
            step = dec.model.paged_decode_step(
                toks[-1], cache.k, cache.v, table.to(dec.device),
                cache.lengths)
        out[where] = (logits.cpu(), toks.cpu()[:, 0], step.cpu(),
                      [int(first[0])] + toks.cpu()[:, 0].tolist())
        del dec, cache
    err_prefill = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    err_step = (out["cuda"][2] - out["cpu"][2]).abs().max().item()
    emit({"phase": "parity", "model": "GPT-2 small fp32",
          "prefill_logits_max_abs_err": err_prefill,
          "decode_logits_max_abs_err": err_step,
          "greedy_tokens_cuda": out["cuda"][3],
          "greedy_tokens_cpu": out["cpu"][3]})
    check(err_prefill <= 1e-3, f"prefill logits differ by {err_prefill}")
    check(err_step <= 1e-3, f"decode logits differ by {err_step}")
    check(out["cuda"][3] == out["cpu"][3], "greedy tokens differ")


# -- phase 4: engine ---------------------------------------------------------

SERVING = ("layer_norm", "paged_fused_attention")


def _engine_mix_prompts() -> list:
    """The engine phase's 16 seeded prompts: a 256-token shared prefix
    (the first prompt is it and 8 more tokens; the second extends the
    first through its partial tail page by 40 tokens) and 14 prompts of
    64-768 tokens."""
    rng = torch.Generator().manual_seed(4)

    def toks(n):
        return torch.randint(0, 50257, (n,), generator=rng).tolist()

    shared = toks(256)
    first = shared + toks(8)
    second = first + toks(40)
    lens = torch.randint(64, 769, (14,), generator=rng).tolist()
    return [first, second] + [toks(n) for n in lens]


def _run_engine_mix(eng, vocab: int):
    """The engine phase's 16 seeded requests (:func:`_engine_mix_prompts`)
    through ``eng``, 64 new tokens each: the first lands its pages before
    the rest are submitted, so the second maps the shared pages and its
    first write copy-on-writes the shared tail.  The launch counts are
    set to 0 just before.  Returns (prompt lengths, tokens by request,
    wall seconds, launches)."""
    prompts = _engine_mix_prompts()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    uids = [eng.submit(prompts[0], max_new_tokens=64)]
    while eng._prefilling or eng._queue:  # the first prompt's pages land
        eng.step()
    uids += [eng.submit(p, max_new_tokens=64) for p in prompts[1:]]
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    got = [out[u] for u in uids]
    check(all(len(t) == 64 for t in got), "a request fell short")
    check(all(0 <= t < vocab for r in got for t in r), "token out of range")
    stats = eng.stats()
    check(stats["prefix_hits"] >= 1 and stats["cow_copies"] >= 1,
          "no prefix reuse / copy-on-write")
    check(all(launches[n] > 0 for n in SERVING),
          f"a serving kernel never launched: {launches}")
    check(all(c == 0 for n, c in launches.items() if n not in SERVING),
          f"a training kernel launched while serving: {launches}")
    return [len(p) for p in prompts], got, wall, launches


def _engine_record(stats, n_tok, wall):
    return {"generated_tokens": n_tok, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "windows": stats["decode_dispatches"],
            "chunks": stats["prefill_dispatches"],
            "prefix_hits": stats["prefix_hits"],
            "prefix_hit_tokens": stats["prefix_hit_tokens"],
            "cow_copies": stats["cow_copies"],
            "preemptions": stats["preemptions"],
            "peak_pages_in_use": stats["peak_pages_in_use"]}


def phase_engine(dev, params):
    cfg = GPTConfig.small()
    dec = GPTDecoder(cfg, params, compute_dtype=torch.bfloat16,
                     cache_dtype=torch.bfloat16, tokens_per_dispatch=8,
                     device=dev)
    eng = ServeEngine(dec, slots=8, max_len=1024, page_len=16,
                      prefill_chunk=128, seed=0)
    lens, got, wall, launches = _run_engine_mix(eng, cfg.vocab_size)
    emit({"phase": "engine", "model": "GPT-2 small bf16, bf16 pages",
          "requests": len(got), "prompt_lens": lens,
          **_engine_record(eng.stats(), sum(map(len, got)), wall),
          "launches": launches})
    return launches, dec, {"tokens": got, "wall_s": wall}


def _profile_window(dec, steps: int) -> dict:
    """The profile set-up: 8 slots with 512-token histories, K=8; one warm
    window, one timed without the profiler and one under
    ``torch.profiler`` — wall, device-busy share, the tokens the window
    emitted, the paged-attention kernels' device time and launches, and
    the kernels that take the most device time.  The profiled window's
    launch counts must be ``steps`` verify forwards (decode steps without
    speculation) of 25 LayerNorms and 12 paged-attention calls each."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServeEngine(dec, slots=8, max_len=1024, page_len=16,
                      prefill_chunk=512, seed=1)
    rng = torch.Generator().manual_seed(5)
    for _ in range(8):
        eng.submit(torch.randint(0, 50257, (512,), generator=rng).tolist(),
                   max_new_tokens=32)
    while eng._prefilling or eng._queue or not eng._active:
        eng.step()
    eng.step()  # one warm window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()  # one window without the profiler's own host cost
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    check(len(eng._active) == 8, "a request retired before the profiled "
          "window")
    decoded0 = int(eng.cache.decoded)
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    want = {"layer_norm": 25 * steps, "paged_fused_attention": 12 * steps}
    check(launches == {n: want.get(n, 0) for n in launches},
          f"one window of GPT-2 small launched {launches}, not {steps} "
          "forwards of 25 LayerNorms and 12 paged-attention calls")
    by_name = {}
    for e in _kernel_events(prof):
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    # the paged-attention kernels' device time and launches in the window
    # (every kernel of csrc/paged_attention.cu has "paged" in its name)
    paged = [(ms, n) for k, ms, n in rows if "paged" in k]
    return {"wall_ms": wall_ms, "unprofiled_wall_ms": plain_wall_ms,
            "device_busy_ms": busy_ms if busy_ms > 0 else None,
            "device_busy_share": busy_ms / wall_ms if busy_ms > 0 else None,
            "tokens_emitted": int(eng.cache.decoded) - decoded0,
            "launches": {n: c for n, c in launches.items() if c},
            "paged_attention_calls": launches["paged_fused_attention"],
            "paged_attention_kernel_launches": sum(n for _, n in paged),
            "paged_attention_device_ms": (sum(ms for ms, _ in paged)
                                          if paged else None),
            "top_kernels": [{"name": k[:90], "device_ms": ms, "calls": n}
                            for k, ms, n in rows[:8]]}


def phase_profile(dec):
    """Where a decode window's time goes (:func:`_profile_window`)."""
    rec = _profile_window(dec, steps=8)
    emit({"phase": "profile", "what": "one K=8 decode window, 8 slots, "
          "512-token histories, GPT-2 small bf16", **rec})
    return rec


# -- phase 4b: speculative decoding and the contiguous cache ------------------

def _block_vs_steps(dec, t: int, slots: int = 4, prompt: int = 64) -> dict:
    """One ``paged_decode_block`` of T tokens against T successive
    ``paged_decode_step`` calls on a copy of the pools, after 64-token
    prefills of ``slots`` rows: the largest logit and K/V differences."""
    pps = dec.cfg.max_position // 16
    cache = dec.init_paged_cache(1 + slots * pps, slots, 16)
    tables = torch.arange(1, 1 + slots * pps, dtype=torch.int32,
                          device=dec.device).reshape(slots, pps)
    rng = torch.Generator().manual_seed(40 + t)
    ids = torch.randint(0, 50257, (slots, prompt), generator=rng)
    dec.prefill_chunk(cache, tables, list(range(slots)), ids, [0] * slots,
                      [prompt] * slots)
    block = torch.randint(0, 50257, (slots, t), generator=rng).to(dec.device)
    pk, pv = cache.k.clone(), cache.v.clone()
    lengths = cache.lengths.clone()
    with torch.no_grad():
        got = dec.model.paged_decode_block(block, cache.k, cache.v, tables,
                                           lengths)
        want = torch.stack([
            dec.model.paged_decode_step(block[:, i].contiguous(), pk, pv,
                                        tables, lengths + i)
            for i in range(t)], dim=1)
    torch.cuda.synchronize()
    out = {"T": t, "logits_max_abs_err": (got - want).abs().max().item(),
           "kv_max_abs_err": max(
               (cache.k.float() - pk.float()).abs().max().item(),
               (cache.v.float() - pv.float()).abs().max().item())}
    del cache, pk, pv
    torch.cuda.empty_cache()
    return out


def _spec_stats(eng) -> dict:
    s = eng.stats()
    return {**s["spec"], "windows": s["decode_dispatches"],
            "decoded_tokens": s["decoded_tokens"]}


def phase_spec_parity(dev, params):
    """GPT-2 small fp32 (TF32 off) with fp32 pages and the parity phase's
    weights: (a) a verify block of T = 4 and 8 against T decode steps
    (logits within the parity phase's 1e-3, K/V within 1e-5); (b) four
    requests (64-token prompts, 48 new tokens, one a period-2
    repetition) through five engines — paged without speculation, paged
    n-gram (D = 3), paged shallow (D = 2, E = 6), contiguous without
    speculation, contiguous n-gram (D = 3), K = 8 — that must give the
    same greedy tokens as each other and as ``reference_generate``; the
    contiguous engines launch no paged or flash kernel; the repetitive
    request alone through each n-gram engine accepts drafts and emits
    more tokens a window than verify steps.  Returns the prompts, the
    paged engine's tokens, ``reference_generate``'s and the paged n-gram
    engine's spec statistics, for :func:`phase_spec_tree_parity`."""
    cfg = GPTConfig.small(compute_dtype=torch.float32)

    def decoder(**kw):
        return GPTDecoder(cfg, params, cache_dtype=torch.float32,
                          tokens_per_dispatch=8, device=dev, **kw)

    decs = {"plain": decoder(), "ngram": decoder(spec_tokens=3),
            "shallow": decoder(spec_tokens=2, spec_proposer="shallow",
                               spec_exit_layers=6)}
    blocks = [_block_vs_steps(decs["plain"], t) for t in (4, 8)]
    rng = torch.Generator().manual_seed(41)
    prompts = [torch.randint(0, 50257, (64,), generator=rng).tolist()
               for _ in range(3)]
    prompts.insert(1, torch.randint(0, 50257, (2,), generator=rng).tolist()
                   * 32)
    engines = {"paged": ("plain", True), "paged_ngram": ("ngram", True),
               "paged_shallow": ("shallow", True),
               "contiguous": ("plain", False),
               "contiguous_ngram": ("ngram", False)}
    tokens, stats, launches, alone = {}, {}, {}, {}
    for name, (d, paged) in engines.items():
        eng = ServeEngine(decs[d], slots=4, max_len=128, page_len=16,
                          prefill_chunk=64, paged=paged)
        torch.cuda.synchronize()
        reset_launch_counts()
        uids = [eng.submit(p, max_new_tokens=48) for p in prompts]
        out = eng.run()
        torch.cuda.synchronize()
        launches[name] = launch_counts()
        tokens[name] = [out[u] for u in uids]
        if d != "plain":
            stats[name] = _spec_stats(eng)
        if d == "ngram":  # the repetitive request alone
            eng = ServeEngine(decs[d], slots=1, max_len=128, page_len=16,
                              prefill_chunk=64, paged=paged)
            uid = eng.submit(prompts[1], max_new_tokens=48)
            alone[name] = {"same_tokens": eng.run()[uid] == tokens[name][1],
                           **_spec_stats(eng)}
    ref = [reference_generate(cfg, params, p, 48, device=dev)
           for p in prompts]
    same = {n: t == tokens["paged"] for n, t in tokens.items()}
    emit({"phase": "spec_parity", "model": "GPT-2 small fp32, fp32 "
          "pages/cache, TF32 off", "blocks_vs_steps": blocks,
          "identical_to_paged": same, "identical_to_reference":
          tokens["paged"] == ref, "greedy_tokens": tokens["paged"],
          "spec_stats": stats, "repetitive_request_alone": alone,
          "launches": launches})
    for b in blocks:
        check(b["logits_max_abs_err"] <= 1e-3,
              f"fp32 verify block T={b['T']}: logits differ from the steps "
              f"by {b['logits_max_abs_err']}")
        check(b["kv_max_abs_err"] <= 1e-5,
              f"fp32 verify block T={b['T']}: K/V differ from the steps by "
              f"{b['kv_max_abs_err']}")
    check(all(same.values()), f"greedy tokens differ across engines: {same}")
    check(tokens["paged"] == ref, "greedy tokens differ from "
          "reference_generate")
    for name, s in alone.items():
        check(s["same_tokens"] and s["accepted_draft_tokens"] > 0
              and s["mean_tokens_per_dispatch"] > s["steps_per_dispatch"],
              f"{name}: the repetitive request alone: {s}")
    for name in ("contiguous", "contiguous_ngram"):
        lc = launches[name]
        check(lc["layer_norm"] > 0 and all(
            c == 0 for n, c in lc.items() if n != "layer_norm"),
              f"{name}: the contiguous engine launched {lc}")
    del decs
    torch.cuda.empty_cache()
    return prompts, tokens["paged"], ref, stats["paged_ngram"]


def _tree_vs_chains(dec, width: int, depth: int, slots: int = 4,
                    prompt: int = 64) -> dict:
    """One ``paged_decode_tree_block`` of (W, D) after 64-token prefills
    of ``slots`` rows, against W ``paged_decode_block`` chains, one per
    branch (the root and that branch's tokens), each on its own copy of
    the pools: the largest difference of the logits at (root, branch r)
    for every r."""
    pps = dec.cfg.max_position // 16
    cache = dec.init_paged_cache(1 + slots * pps, slots, 16)
    tables = torch.arange(1, 1 + slots * pps, dtype=torch.int32,
                          device=dec.device).reshape(slots, pps)
    rng = torch.Generator().manual_seed(50 + 10 * width + depth)
    ids = torch.randint(0, 50257, (slots, prompt), generator=rng)
    dec.prefill_chunk(cache, tables, list(range(slots)), ids, [0] * slots,
                      [prompt] * slots)
    block = torch.randint(0, 50257, (slots, 1 + width * depth),
                          generator=rng).to(dec.device)
    lengths = cache.lengths.clone()
    errs = []
    with torch.no_grad():
        tree = dec.model.paged_decode_tree_block(
            block, cache.k.clone(), cache.v.clone(), tables, lengths,
            width=width, depth=depth)
        for r in range(width):
            nodes = [0] + list(range(1 + r * depth, 1 + (r + 1) * depth))
            want = dec.model.paged_decode_block(
                block[:, nodes].contiguous(), cache.k.clone(),
                cache.v.clone(), tables, lengths)
            errs.append((tree[:, nodes] - want).abs().max().item())
    torch.cuda.synchronize()
    del cache, tree, want
    torch.cuda.empty_cache()
    return {"W": width, "D": depth, "per_branch_logits_max_abs_err": errs}


def _forced_branch_win(cfg, params, dev, prompt) -> dict:
    """The card's run of the JAX package's forced-branch-win test: a
    poisoned history makes branch 0 (the chain's draft) propose a wrong
    token after the root while branch 1 proposes the model's own greedy
    continuation; branch 1 must win with 3 tokens accepted, and the next
    step, which reads the compacted slots, must still give the
    reference's tokens."""
    dec = GPTDecoder(cfg, params, cache_dtype=torch.float32,
                     tokens_per_dispatch=4, spec_tokens=2, spec_tree=2,
                     device=dev)
    want = reference_generate(cfg, params, prompt, 10, device=dev)
    slots, pps = 2, 4
    cache = dec.init_paged_cache(1 + slots * pps, slots, 16)
    tables = torch.arange(1, 1 + slots * pps,
                          dtype=torch.int32).reshape(slots, pps)
    logits = dec.prefill_chunk(cache, tables[:1], [0], [prompt], [0],
                               [len(prompt)])
    tok0 = int(torch.argmax(logits[0]))
    wrong = (want[1] + 1) % cfg.vocab_size
    poison = [prompt[-1], tok0, want[1], want[2],
              prompt[-1], tok0, wrong, prompt[-1], tok0]
    hist = torch.full((slots, dec.spec_hist), -1, dtype=torch.int32)
    hist[0, -len(poison):] = torch.tensor(poison, dtype=torch.int32)
    buf = dec.paged_tree_spec_decode_window(
        cache, tables, [tok0, 0], [True, False], hist).cpu()
    out = [tok0]
    for i in range(buf.shape[0]):
        out += buf[i, 0, :int(buf[i, 0, -2])].tolist()
    rec = {"first_token_is_reference": tok0 == want[0],
           "winning_branches": buf[:, 0, -1].tolist(),
           "accepted": buf[:, 0, -2].tolist(), "tokens": out,
           "reference": want[:len(out)]}
    del dec, cache
    return rec


def phase_spec_tree_parity(dev, params, prompts, plain, ref, chain_stats):
    """Tree speculation at GPT-2 small fp32 (TF32 off) with fp32 pages and
    the parity phase's weights: (a) a tree block of (W, D) = (2, 3) and
    (4, 2) against one chain block per branch, the logits at (root,
    branch r) within the parity phase's 1e-3 for every r; (b)
    :func:`phase_spec_parity`'s four requests (48 new tokens, K = 8)
    through the tree engines at (2, 3) and (4, 2) and the auto-tuned
    chain (D = 3) and tree ((2, 3)) engines: the same greedy tokens as
    the paged engine there and as ``reference_generate``; (c) the tree
    engine at (2, 3) banks at least the paged n-gram chain engine's
    (D = 3) mean tokens a window on the same requests; (d)
    :func:`_forced_branch_win`."""
    cfg = GPTConfig.small(compute_dtype=torch.float32)
    base = GPTDecoder(cfg, params, cache_dtype=torch.float32,
                      tokens_per_dispatch=8, device=dev)
    blocks = [_tree_vs_chains(base, w, d) for w, d in ((2, 3), (4, 2))]
    del base
    runs = {"tree_w2d3": (dict(spec_tokens=3, spec_tree=2), False),
            "tree_w4d2": (dict(spec_tokens=2, spec_tree=4), False),
            "autotune_chain_d3": (dict(spec_tokens=3), True),
            "autotune_tree_w2d3": (dict(spec_tokens=3, spec_tree=2), True)}
    tokens, stats = {}, {}
    for name, (kw, auto) in runs.items():
        dec = GPTDecoder(cfg, params, cache_dtype=torch.float32,
                         tokens_per_dispatch=8, device=dev, **kw)
        eng = ServeEngine(dec, slots=4, max_len=128, page_len=16,
                          prefill_chunk=64, spec_autotune=auto)
        uids = [eng.submit(p, max_new_tokens=48) for p in prompts]
        out = eng.run()
        tokens[name] = [out[u] for u in uids]
        stats[name] = _spec_stats(eng)
        del eng, dec
    forced = _forced_branch_win(cfg, params, dev, prompts[0][:8])
    torch.cuda.empty_cache()
    same = {n: t == plain for n, t in tokens.items()}
    emit({"phase": "spec_tree_parity", "model": "GPT-2 small fp32, fp32 "
          "pages, TF32 off", "tree_vs_chain_blocks": blocks,
          "tol": 1e-3, "identical_to_paged": same,
          "identical_to_reference": {n: t == ref for n, t in tokens.items()},
          "spec_stats": stats, "chain_d3_stats": chain_stats,
          "forced_branch_win": forced})
    for b in blocks:
        check(max(b["per_branch_logits_max_abs_err"]) <= 1e-3,
              f"tree block W={b['W']} D={b['D']}: logits differ from the "
              f"branches' chain blocks by {b['per_branch_logits_max_abs_err']}")
    check(all(same.values()), f"tree/auto-tuned greedy tokens differ from "
          f"the paged engine's: {same}")
    check(plain == ref, "the paged engine's tokens differ from "
          "reference_generate")
    check(stats["tree_w2d3"]["mean_tokens_per_dispatch"]
          >= chain_stats["mean_tokens_per_dispatch"],
          f"the tree engine banks fewer tokens a window than the chain: "
          f"{stats['tree_w2d3']} vs {chain_stats}")
    for name in ("autotune_chain_d3", "autotune_tree_w2d3"):
        traj = stats[name]["autotune"]["trajectory"]
        check(all(1 <= d <= 3 for _, d in traj), f"{name}: {traj}")
    check(forced["first_token_is_reference"]
          and forced["winning_branches"][0] == 1
          and forced["accepted"][0] == 3
          and forced["tokens"] == forced["reference"],
          f"forced branch win: {forced}")


def _verify_forwards(eng) -> int:
    """Verify forwards the engine's spec windows ran: each window runs
    ``_spec_steps_for`` its depth, which the auto-tuner's trajectory
    (window number, new depth) changes after that window."""
    dec = eng.decoder
    moves = dict(eng._auto_traj)
    d, total = dec.spec_tokens, 0
    for w in range(1, eng.decode_dispatches + 1):
        total += dec._spec_steps_for(d)
        d = moves.get(w, d)
    return total


def phase_spec_tree_engine(dev, params):
    """GPT-2 small bf16 with bf16 pages, the engine phase's 16 requests
    (K = 8) through the tree engines at (W, D) = (2, 3) (verify blocks of
    T = 7: the decode kernel) and (3, 3) (T = 10: the tensor-core kernel)
    and the auto-tuned n-gram chain engine at D = 3, each run with its
    own launch counts, which must be exactly 25 LayerNorms and 12
    paged-attention calls a forward (every prefill chunk and verify
    forward of the run; the tuner's walk sets each window's forwards);
    every step of the trajectory within [1, D].  Then the profile
    set-up with the (2, 3) tree window.  Returns each run's launches."""
    cfg = GPTConfig.small()
    runs = {"tree_w2d3": dict(spec_tokens=3, spec_tree=2),
            "tree_w3d3": dict(spec_tokens=3, spec_tree=3),
            "autotune_chain_d3": dict(spec_tokens=3)}
    out = {}
    for name, kw in runs.items():
        dec = GPTDecoder(cfg, params, compute_dtype=torch.bfloat16,
                         cache_dtype=torch.bfloat16, tokens_per_dispatch=8,
                         device=dev, **kw)
        auto = name.startswith("autotune")
        eng = ServeEngine(dec, slots=8, max_len=1024, page_len=16,
                          prefill_chunk=128, seed=0, spec_autotune=auto)
        lens, got, wall, launches = _run_engine_mix(eng, cfg.vocab_size)
        st = eng.stats()
        forwards = st["prefill_dispatches"] + _verify_forwards(eng)
        want = {"layer_norm": 25 * forwards,
                "paged_fused_attention": 12 * forwards}
        out[name] = launches
        emit({"phase": "spec_tree_engine", "model": "GPT-2 small bf16, "
              "bf16 pages", "run": name, "requests": len(got),
              **_engine_record(st, sum(map(len, got)), wall),
              "spec": st["spec"], "forwards": forwards,
              "launches": launches})
        check(launches == {n: want.get(n, 0) for n in launches},
              f"{name}: launched {launches}, not {forwards} forwards of 25 "
              "LayerNorms and 12 paged-attention calls")
        if auto:
            traj = st["spec"]["autotune"]["trajectory"]
            check(all(1 <= d <= dec.spec_tokens for _, d in traj),
                  f"{name}: trajectory {traj}")
        if name == "tree_w2d3":
            rec = _profile_window(dec, steps=dec.spec_steps)
            emit({"phase": "spec_tree_profile", "what": "one K=8 tree "
                  "window (W=2, D=3: 2 verify forwards of 7 nodes), 8 "
                  "slots, 512-token histories, GPT-2 small bf16", **rec})
        del eng, dec
        torch.cuda.empty_cache()
    return out


def phase_spec_engine(dev, params):
    """GPT-2 small bf16 with bf16 pages, the engine phase's 16 requests
    through the n-gram spec engine at D = 3 (verify blocks of T = 4: the
    decode kernel) and D = 7 (T = 8: the tensor-core kernel), K = 8,
    each run with its own launch counts; then a verify block of T = 4
    and 8 against T decode steps, within the bf16 model-logit rule 5e-2.
    Returns each run's launches by draft."""
    cfg = GPTConfig.small()
    out = {}
    for draft in (3, 7):
        dec = GPTDecoder(cfg, params, compute_dtype=torch.bfloat16,
                         cache_dtype=torch.bfloat16, tokens_per_dispatch=8,
                         spec_tokens=draft, device=dev)
        eng = ServeEngine(dec, slots=8, max_len=1024, page_len=16,
                          prefill_chunk=128, seed=0)
        lens, got, wall, launches = _run_engine_mix(eng, cfg.vocab_size)
        out[draft] = launches
        emit({"phase": "spec_engine", "model": "GPT-2 small bf16, bf16 "
              "pages", "draft": draft, "requests": len(got),
              "prompt_lens": lens,
              **_engine_record(eng.stats(), sum(map(len, got)), wall),
              "spec": _spec_stats(eng), "launches": launches})
        del eng
    blocks = [_block_vs_steps(dec, t) for t in (4, 8)]
    emit({"phase": "spec_engine", "what": "bf16 verify block against "
          "decode steps", "blocks_vs_steps": blocks, "tol": 5e-2})
    for b in blocks:
        check(b["logits_max_abs_err"] <= 5e-2,
              f"bf16 verify block T={b['T']}: logits differ from the steps "
              f"by {b['logits_max_abs_err']}")
    del dec
    torch.cuda.empty_cache()
    return out


def phase_spec_profile(dev, params, plain: dict):
    """The profile set-up with the n-gram spec engine at D = 3 (2 verify
    forwards a K = 8 window), beside the plain window of
    :func:`phase_profile` from the same run.  A record: no gain is
    claimed."""
    dec = GPTDecoder(GPTConfig.small(), params,
                     compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
                     tokens_per_dispatch=8, spec_tokens=3, device=dev)
    rec = _profile_window(dec, steps=dec.spec_steps)
    keys = ("unprofiled_wall_ms", "wall_ms", "device_busy_ms",
            "device_busy_share", "tokens_emitted", "paged_attention_calls",
            "paged_attention_device_ms")
    emit({"phase": "spec_profile", "what": "one K=8 n-gram spec window "
          "(D=3: 2 verify forwards of 4 positions), 8 slots, 512-token "
          "histories, GPT-2 small bf16", **rec,
          "plain_window": {k: plain[k] for k in keys}})
    del dec
    torch.cuda.empty_cache()


# -- phase 5: training kernels ------------------------------------------------

def ln_bwd_cases(rows: int = 16384, n: int = 768, bert_rows: int = 6144,
                 bert_n: int = 1024):
    """The LayerNorm backward's cases: (rows, n, x dtype, weight dtype or
    None).  GPT-2 small's training shape with bf16 (O2) and fp32 affine,
    a row count that is no multiple of anything, bf16 x, and no affine;
    BERT-large's with bf16 and fp32 affine; then two rows that the block
    design takes (a ragged n, and one wider than the warp design takes);
    then the warp instantiations no model shape reaches (bf16 x with an
    fp32 weight, and bf16 at n = 1024), two of them at an n short of
    the instantiation's width (its last vectors masked); then two rows
    wider than the block design takes (the wide design)."""
    f32, bf = torch.float32, torch.bfloat16
    return ((rows, n, f32, bf), (rows, n, f32, f32), (rows - 3, n, f32, bf),
            (rows, n, bf, bf), (rows, n, f32, None),
            (bert_rows, bert_n, f32, bf), (bert_rows, bert_n, f32, f32),
            (4099, 1021, f32, bf), (2050, 2304, bf, f32),
            (4097, 520, bf, f32), (4097, 1000, bf, f32), (3000, 1024, bf, bf),
            (1024, 12288, f32, bf), (1024, 16384, bf, f32))


def phase_layer_norm_bwd(dev, cases=None):
    """LayerNorm backward at each of :func:`ln_bwd_cases` (the port of
    ``_ln_bwd_dx_dwdb_kernel``; without a weight, of ``_ln_bwd_dx_kernel``:
    the same kernel), each line naming the design the wrapper picked
    (``_ln_bwd_design``: a warp a row with 16-byte vectors at every
    model shape) and its warp kernel; with the default cases, every entry
    of ``LN_BWD_WARP_KERNELS`` must be launched by some case.  dx within
    1e-5 of max|dx| (fp32) or 1 bf16 ulp; dgamma/dbeta within 1e-5 of
    their largest magnitude (fp32 sums over the rows in two orders), plus
    1 bf16 ulp for bf16 weights.  Planted fault: the last block's rows
    (the geometry the library reports) dropped from dgamma."""
    gen = torch.Generator(device=dev).manual_seed(6)
    cases_out = []
    launched = set()
    for r, n, x_dt, w_dt in (cases or ln_bwd_cases()):
        x = (2 * torch.randn(r, n, device=dev, generator=gen)
             + 0.5).to(x_dt)
        dy = torch.randn(r, n, device=dev, generator=gen).to(x_dt)
        w = None if w_dt is None else (
            1 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(w_dt)
        design, parts, rpb = ln_bwd_blocks(x, w, dy)
        kname = ln_bwd_kernel(x_dt, w_dt, n, design)
        launched.add(kname)
        got = layer_norm_bwd(x, w, dy)
        want = layer_norm_bwd_ref(x, w, dy)
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(got, want) if b is not None]
        errs = [_err(a, b) for a, b in pairs]
        check(_close(got[0], want[0], 1e-5, ulps=1),
              f"layer_norm_bwd dx rows={r} n={n} {x_dt}: {errs[0]}")
        faults = {}
        if w is not None:
            for name, a, b in (("dgamma", got[1], want[1]),
                               ("dbeta", got[2], want[2])):
                check(_close(a, b, 1e-5, ulps=1),
                      f"layer_norm_bwd {name} rows={r} n={n} {w_dt}: "
                      f"{_err(a, b)}")
            last = r - (parts - 1) * rpb
            bad = layer_norm_bwd(x[:r - last], w, dy[:r - last])[1]
            faults["last_block_rows_dropped"] = _err(bad, want[1])
            check(not _close(bad, want[1], 1e-5, ulps=1),
                  f"layer_norm_bwd rows={r} n={n}: the check misses the last "
                  f"block's {last} rows dropped from dgamma ({faults})")
        kern = timings(lambda: layer_norm_bwd(x, w, dy))
        plain = timings(lambda: layer_norm_bwd_ref(x, w, dy), iters=20)
        wl = torch.ones(n, device=dev, dtype=x_dt) if w is None \
            else w.to(x_dt)
        bl = torch.zeros(n, device=dev, dtype=x_dt)
        _, mean, rstd = torch.native_layer_norm(x, [n], wl, bl, 1e-5)
        mask = [True, w is not None, w is not None]
        lib = timings(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [n], mean, rstd, wl, bl, mask))
        w_bytes = 0 if w is None else 3 * n * w.element_size()
        bound, by = _bound(3 * x.numel() * x.element_size() + w_bytes,
                           {FP32_FLOPS: 12 * x.numel()})
        case = {"rows": r, "n": n, "x_dtype": _dt(x_dt),
                "w_dtype": _dt(w_dt) if w is not None else "none",
                "design": LN_BWD_DESIGNS[design], "warp_kernel": kname,
                "blocks": parts, "rows_per_block": rpb,
                "max_abs_err": max(errs), "errs_dx_dgamma_dbeta": errs,
                "tol": "1e-5 of max|want| (+1 bf16 ulp for bf16)",
                "planted_fault_errs": faults,
                **_merge(kern, plain, lib), "bound_ms": bound,
                "bound_by": by}
        emit({"phase": "kernel", "kernel": "layer_norm_bwd", **case})
        cases_out.append(case)
    missed = sorted(set(LN_BWD_WARP_KERNELS) - launched)
    check(cases is not None or not missed,
          f"layer_norm_bwd: no case launched the warp kernels {missed}")
    return cases_out


def _strict_causal_bias(s: int, dev):
    """The planted fault 'causal mask one key short': key j visible to
    query i iff j < i (row 0 sees none: all -1e30, a uniform softmax)."""
    i = torch.arange(s, device=dev)
    return torch.where(i[None, :] < i[:, None], 0.0, -1e30)


def _stored_bytes(t) -> int:
    """Bytes of the distinct elements of a (possibly broadcast) view."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _flash_bound(q, k, bias, backward: bool, causal: bool,
                 dbias: bool = False, probs_bf16: bool = False):
    """Visible query-key pairs; QK^T (and dO.V^T) at the rate of the
    inputs' type; the products with p, pd or ds (p.V; pd^T.dO, ds^T.Q,
    ds.K): fp32 inputs at the fp32 rate, bf16 inputs at the bf16 rate,
    counted twice without ``probs_bf16`` (fp32 p on the tensor cores is
    two bf16 products, its hi and lo parts: ``csrc/flash_attention.cu``)
    and once with it (p, pd and ds are then bf16 values); q, k, v, o (+
    do, dq, dk, dv), lse (+ delta), the bias's stored elements, if any,
    (and the fp32 per-batch*head dbias) moved once."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    rows = torch.arange(sq)[:, None]
    pairs = bh * int((rows >= torch.arange(sk)[None, :]).sum()) if causal \
        else bh * sq * sk
    el = q.element_size()
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    nbytes = (0 if bias is None else _stored_bytes(bias)) \
        + (2 * bh * sq + 2 * bh * sk) * d * el + bh * sq * 4
    products = 1
    if backward:
        nbytes += (2 * bh * sq + 2 * bh * sk) * d * el + bh * sq * 4
        products = 2
        if dbias:
            nbytes += bh * sq * sk * 4
    split = 1 if probs_bf16 or q.dtype == torch.float32 else 2
    products += (3 if backward else 1) * split
    return _bound(nbytes, {rate: products * 2 * pairs * d})


#: The default path's gate (fp32 p) for a bf16 tensor-core kernel against
#: its plain version, beside :func:`_close`'s bound: at most this share of
#: the elements differ at all.  The kernel's only departures are the
#: summation order and the split's dropped residual (2^-16 of p at most),
#: which moved 0.06-0.42 % of the bf16 outputs by an ulp on the H100;
#: dropping the split's low half (p, pd and ds rounded to bf16, about
#: 2^-9 of each term) moved 24-41 % of them and can stay within the
#: 2-ulp bound.
SPLIT_FRAC = 0.02
SPLIT_TOL = ("1e-4 of max|want| + 2 bf16 ulps, <= 2 % of the elements "
             "different")
#: What each design runs, for the summary rows.
FLASH_DESIGN = {torch.bfloat16: "mma.sync bf16 (tensor cores, fp32 p split "
                                "hi + lo; probs_bf16: one bf16 product)",
                torch.float32: "fp32 FMA (CUDA cores)"}


def _frac_differing(got, want) -> float:
    return float((got.float() != want.float()).float().mean())


def _split_close(got, want, rtol: float = 1e-4) -> bool:
    """A bf16 kernel's default-path result against its plain version:
    :func:`_close` with 2 bf16 ulps and at most :data:`SPLIT_FRAC` of the
    elements different."""
    return _close(got, want, rtol, ulps=2) \
        and _frac_differing(got, want) <= SPLIT_FRAC


def _low_half_dropped(fwd, bwd, o_ref, want, rtol: float = 1e-4) -> dict:
    """The planted fault of the split: the kernels with p, pd and ds
    rounded to bf16 (their ``probs_bf16`` path: the hi part alone) against
    the default path's plain results; the split gate must reject the
    output and every grad.  ``fwd``/``bwd`` run the kernels with
    ``probs_bf16=True``.  Returns the fractions of elements that differ
    (o, dq, dk, dv)."""
    bad_o = fwd()
    bad_g = bwd()
    torch.cuda.synchronize()
    fracs = [_frac_differing(bad_o, o_ref)] + [
        _frac_differing(a, w) for a, w in zip(bad_g[:3], want[:3])]
    check(not _split_close(bad_o, o_ref, rtol)
          and not any(_split_close(a, w, rtol)
                      for a, w in zip(bad_g[:3], want[:3])),
          f"flash: the split gate misses the split's low half dropped "
          f"{fracs}")
    return {"split_low_half_dropped_frac_o_dq_dk_dv": fracs}


def _nan_staging(fwd, bwd, o_ref, want, causal: bool,
                 rtol: float = 1e-4) -> dict:
    """The planted fault of the staging path: the tensor-core kernels with
    the rows past a ragged tile's end staged as NaN instead of zeros
    (``_fault=3``: what an unfilled stage can hold) must fail the check:
    the backward always (it multiplies every staged row, if by a zero
    probability), the forward where some query visits the ragged last key
    tile (its q rows past Sq feed no output, and a causal mask can hide
    the key tile)."""
    bad_o = fwd()
    bad_g = bwd()
    torch.cuda.synchronize()
    nans = [int(bad_o.isnan().sum())] + [int(a.isnan().sum())
                                         for a in bad_g[:3]]
    sq, sk = o_ref.shape[1], want[1].shape[1]
    fwd_reads = sk % 64 != 0 and (not causal or (sk - 1) // 64 * 64 < sq)
    check(not bad_o.is_cuda  # the plain versions on the CPU take no fault
          or ((not fwd_reads or not _split_close(bad_o, o_ref, rtol))
              and not all(_split_close(a, w, rtol)
                          for a, w in zip(bad_g[:3], want[:3]))),
          f"flash: the check misses the ragged tile's rows staged as NaN "
          f"{nans}")
    return {"ragged_rows_staged_nan_count_o_dq_dk_dv": nans}


def phase_flash(dev, b: int = 16, h: int = 12, s: int = 1024,
                d: int = 64):
    """Flash attention at the training shape (B 16, H 12, S 1024, D 64,
    causal), bf16 (the tensor-core kernels) and fp32 (the FMA kernels),
    dropout 0 and 0.1; q ~ 2 N(0, 1), k, v, dO ~ N(0, 1), a peaked
    softmax with outputs of order 1.  Forward O and backward dQ/dK/dV
    within 1e-5 (fp32) of max|want|, or at bf16 :data:`SPLIT_TOL`: 2 bf16
    ulps plus 1e-4 of max|want| (one rounding on each side, fp32 sums of
    up to 1024 terms in two orders) with at most 2 % of the elements
    different; lse within 1e-5 of max|lse|.  Planted faults: the causal
    mask one key short (the plain version with that mask), the dropout
    mask shifted by one column (the kernel with the seed's column offset
    1) and, at bf16, the split's low half dropped
    (:func:`_low_half_dropped`)."""
    gen = torch.Generator(device=dev).manual_seed(7)
    bh = b * h
    cases = []
    for dt, rate in ((torch.bfloat16, 0.1), (torch.bfloat16, 0.0),
                     (torch.float32, 0.0), (torch.float32, 0.1)):
        q = (2 * torch.randn(bh, s, d, device=dev, generator=gen)).to(dt)
        k = torch.randn(bh, s, d, device=dev, generator=gen).to(dt)
        v = torch.randn(bh, s, d, device=dev, generator=gen).to(dt)
        do = torch.randn(bh, s, d, device=dev, generator=gen).to(dt)
        seed_int = 123456789
        seed = _pack_seed(seed_int, device=dev)
        args = (seed, d ** -0.5, True, rate, (h, h))
        rtol_f, rtol_b = (1e-5, 1e-5) if dt == torch.float32 else (1e-4, 1e-4)
        o, lse = flash_attention_fwd(q, k, v, *args)
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, *args)
        grads = flash_attention_bwd(q, k, v, o, lse, do, *args)[:3]
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args)[:3]
        torch.cuda.synchronize()
        err_o, err_lse = _err(o, o_ref), _err(lse, lse_ref)
        errs_b = [_err(a, w) for a, w in zip(grads, want)]
        fracs = [_frac_differing(a, w)
                 for a, w in zip((o, *grads), (o_ref, *want))]
        name = f"{_dt(dt)} dropout={rate}"
        ok = _split_close if dt == torch.bfloat16 else \
            (lambda a, w, r: _close(a, w, r, ulps=2))
        check(ok(o, o_ref, rtol_f), f"flash fwd {name}: {err_o} {fracs}")
        check(_close(lse, lse_ref, 1e-5), f"flash lse {name}: {err_lse}")
        for gname, a, w, e in zip(("dq", "dk", "dv"), grads, want, errs_b):
            check(ok(a, w, rtol_b), f"flash {gname} {name}: {e} {fracs}")
        # planted faults
        q4, k4, v4 = (t.reshape(b, h, s, d) for t in (q, k, v))
        bias = _strict_causal_bias(s, dev).expand(b, s, s)
        faults = {}
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        bad = attention_ref(qg, kg, vg, bias=bias, causal=False,
                            dropout_rate=rate, dropout_seed=seed_int)
        bad_g = torch.autograd.grad(bad, (qg, kg, vg), do.reshape(b, h, s, d))
        bad = bad.detach().reshape(bh, s, d)
        faults["causal_one_key_short_fwd"] = _err(bad, o_ref)
        check(not _close(bad, o_ref, rtol_f, ulps=2),
              f"flash {name}: the check misses the causal mask one key short")
        faults["causal_one_key_short_bwd"] = _err(bad_g[0].reshape(bh, s, d),
                                                  want[0])
        check(not all(_close(a.reshape(bh, s, d), w, rtol_b, ulps=2)
                      for a, w in zip(bad_g, want)),
              f"flash {name}: the check misses the causal mask one key "
              f"short in the backward")
        del bad, bad_g, qg, kg, vg
        if rate > 0:
            shifted = (_pack_seed(seed_int, 0, 1, 0, device=dev),) + args[1:]
            bad_o, _ = flash_attention_fwd(q, k, v, *shifted)
            bad_g = flash_attention_bwd(q, k, v, o, lse, do, *shifted)[:3]
            torch.cuda.synchronize()
            faults["dropout_shifted_one_col_fwd"] = _err(bad_o, o_ref)
            faults["dropout_shifted_one_col_bwd"] = _err(bad_g[0], want[0])
            check(not _close(bad_o, o_ref, rtol_f, ulps=2),
                  f"flash {name}: the check misses the shifted dropout mask")
            check(not all(_close(a, w, rtol_b, ulps=2)
                          for a, w in zip(bad_g, want)),
                  f"flash {name}: the check misses the shifted dropout mask "
                  f"in the backward")
            del bad_o, bad_g
        if dt == torch.bfloat16:
            faults.update(_low_half_dropped(
                lambda: flash_attention_fwd(q, k, v, *args,
                                            probs_bf16=True)[0],
                lambda: flash_attention_bwd(q, k, v, o, lse, do, *args,
                                            probs_bf16=True),
                o_ref, want))
        kern_f = timings(lambda: flash_attention_fwd(q, k, v, *args), iters=20)
        plain_f = timings(lambda: flash_attention_fwd_ref(q, k, v, *args),
                          iters=5)
        kern_b = timings(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                     *args), iters=10)
        plain_b = timings(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                          *args), iters=3)
        lib_f = timings(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), iters=20)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        do4 = do.reshape(b, h, s, d)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
            torch.autograd.grad(out, (qg, kg, vg), do4)

        lib_fb = timings(sdpa_fwd_bwd, iters=10)
        base = {"case": name, "B": b, "H": h, "S": s, "D": d,
                "dtype": _dt(dt), "dropout": rate, "design": FLASH_DESIGN[dt],
                "frac_differing_o_dq_dk_dv": fracs,
                "planted_fault_errs": faults}
        bound, by = _flash_bound(q, k, None, backward=False, causal=True)
        fwd = {**base, "max_abs_err": max(err_o, err_lse),
               "errs_o_lse": [err_o, err_lse],
               "tol": SPLIT_TOL if dt == torch.bfloat16
               else f"{rtol_f} of max|want|",
               **_merge(kern_f, plain_f, lib_f), "bound_ms": bound,
               "bound_by": by,
               "library": "F.scaled_dot_product_attention(is_causal=True), "
                          "no dropout"}
        emit({"phase": "kernel", "kernel": "flash_attention_fwd", **fwd})
        bound, by = _flash_bound(q, k, None, backward=True, causal=True)
        bwd = {**base, "max_abs_err": max(errs_b), "errs_dq_dk_dv": errs_b,
               "tol": fwd["tol"], **_merge(kern_b, plain_b, lib_fb),
               "ms_by_kernel": device_ms_by_kernel(
                   lambda: flash_attention_bwd(q, k, v, o, lse, do, *args)),
               "bound_ms": bound, "bound_by": by,
               "library": "F.scaled_dot_product_attention forward + "
                          "backward, no dropout"}
        emit({"phase": "kernel", "kernel": "flash_attention_bwd", **bwd})
        cases.append((fwd, bwd))
        del q, k, v, do, o, lse, o_ref, lse_ref, grads, want, qg, kg, vg
        torch.cuda.empty_cache()
    return cases


def phase_flash_shapes(dev, h: int = 12, d: int = 64):
    """Flash attention off the main path's shape, checked but not timed:
    a sequence that is no multiple of the 64-row tile (S 1000, causal,
    bf16, dropout 0.1), different query and key lengths without the
    causal mask (300 x 450, fp32, dropout 0.1), and more queries than
    keys with it (450 x 300, bf16).  Tolerances as in
    :func:`phase_flash`; with dropout, the mask shifted by one column
    must be rejected, and at bf16 the ragged tile's rows staged as NaN
    (:func:`_nan_staging`)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    for b, sq, sk, causal, dt, rate in (
            (2, 1000, 1000, True, torch.bfloat16, 0.1),
            (2, 300, 450, False, torch.float32, 0.1),
            (2, 450, 300, True, torch.bfloat16, 0.0)):
        bh = b * h
        q = (2 * torch.randn(bh, sq, d, device=dev, generator=gen)).to(dt)
        k = torch.randn(bh, sk, d, device=dev, generator=gen).to(dt)
        v = torch.randn(bh, sk, d, device=dev, generator=gen).to(dt)
        do = torch.randn(bh, sq, d, device=dev, generator=gen).to(dt)
        args = (_pack_seed(987654321, device=dev), d ** -0.5, causal, rate,
                (h, h))
        rtol = 1e-5 if dt == torch.float32 else 1e-4
        o, lse = flash_attention_fwd(q, k, v, *args)
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, *args)
        grads = flash_attention_bwd(q, k, v, o, lse, do, *args)[:3]
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args)[:3]
        torch.cuda.synchronize()
        name = (f"B={b} H={h} Sq={sq} Sk={sk} causal={causal} {_dt(dt)} "
                f"dropout={rate}")
        errs = [_err(o, o_ref), _err(lse, lse_ref)] + [
            _err(a, w) for a, w in zip(grads, want)]
        ok = _split_close if dt == torch.bfloat16 else \
            (lambda a, w, r: _close(a, w, r, ulps=2))
        check(ok(o, o_ref, rtol) and _close(lse, lse_ref, 1e-5),
              f"flash fwd {name}: {errs[:2]}")
        check(all(ok(a, w, rtol) for a, w in zip(grads, want)),
              f"flash bwd {name}: {errs[2:]}")
        faults = {}
        if rate > 0:
            shifted = (_pack_seed(987654321, 0, 1, 0, device=dev),) + args[1:]
            bad_o, _ = flash_attention_fwd(q, k, v, *shifted)
            torch.cuda.synchronize()
            faults["dropout_shifted_one_col_fwd"] = _err(bad_o, o_ref)
            check(not _close(bad_o, o_ref, rtol, ulps=2),
                  f"flash {name}: the check misses the shifted dropout mask")
        if dt == torch.bfloat16:
            faults.update(_nan_staging(
                lambda: flash_attention_fwd(q, k, v, *args, _fault=3)[0],
                lambda: flash_attention_bwd(q, k, v, o, lse, do, *args,
                                            _fault=3),
                o_ref, want, causal))
        emit({"phase": "kernel_check", "kernel": "flash_attention",
              "case": name, "design": FLASH_DESIGN[dt],
              "errs_o_lse_dq_dk_dv": errs,
              "frac_differing_o_dq_dk_dv": [
                  _frac_differing(a, w)
                  for a, w in zip((o, *grads), (o_ref, *want))],
              "tol": SPLIT_TOL if dt == torch.bfloat16
              else f"{rtol} of max|want|",
              "planted_fault_errs": faults})


def phase_xent(dev, rows: int = 16384, v: int = 50304,
               bert_rows: int = 6144, bert_v: int = 30592):
    """Fused cross-entropy at the GPT training shape (16384 x 50304 bf16
    logits), a ragged vocab (50257, rows not 16-byte aligned), label
    smoothing, a row count that is no multiple of any tile, fp32 logits,
    and the BERT-large MLM shape (6144 x 30592 bf16, no smoothing);
    logits ~ 3 N(0, 1).  Loss and lse within 2e-6 of max|want|
    (fp32 sums of 50k exponentials in two orders); dlogits within 1 bf16
    ulp plus 1e-9 (bf16) or 1e-5 of max|want| (fp32).  Planted fault: the
    reference's last ragged vocab tile (past the last multiple of 2048)
    dropped from the lse (the kernel on that narrower view)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    cases = []
    ragged = v - 47  # 50257: GPT-2's own vocabulary
    for r, vv, dt, sm in ((rows, v, torch.bfloat16, 0.0),
                          (rows, ragged, torch.bfloat16, 0.1),
                          (rows // 4 + 1, ragged, torch.bfloat16, 0.0),
                          (rows, v, torch.float32, 0.1),
                          (bert_rows, bert_v, torch.bfloat16, 0.0)):
        logits = (3 * torch.randn(r, vv, device=dev, generator=gen)).to(dt)
        labels = torch.randint(0, vv, (r,), device=dev, generator=gen)
        g = torch.rand(r, device=dev, generator=gen)
        loss, lse = softmax_cross_entropy_fwd(logits, labels, sm)
        want_l, want_lse = softmax_cross_entropy_fwd_ref(logits, labels, sm)
        d = softmax_cross_entropy_bwd(logits, labels, lse, g, sm)
        want_d = softmax_cross_entropy_bwd_ref(logits, labels, lse, g, sm)
        torch.cuda.synchronize()
        errs = [_err(loss, want_l), _err(lse, want_lse), _err(d, want_d)]
        name = f"rows={r} V={vv} {_dt(dt)} smoothing={sm}"
        check(_close(loss, want_l, 2e-6), f"xent loss {name}: {errs[0]}")
        check(_close(lse, want_lse, 2e-6), f"xent lse {name}: {errs[1]}")
        d_ok = (bf16_ulp_ok(d, want_d, ulps=1, floor=1e-9)
                if dt == torch.bfloat16 else _close(d, want_d, 1e-5))
        check(d_ok, f"xent dlogits {name}: {errs[2]}")
        v_short = ((vv - 1) // 2048) * 2048
        bad_l, _ = softmax_cross_entropy_fwd(logits[:, :v_short],
                                             labels.clamp_max(v_short - 1), sm)
        torch.cuda.synchronize()
        fault = _err(bad_l, want_l)
        check(not _close(bad_l, want_l, 2e-6),
              f"xent {name}: the check misses the last vocab tile dropped")
        del bad_l
        kern_f = timings(lambda: softmax_cross_entropy_fwd(logits, labels, sm),
                         iters=20)
        plain_f = timings(lambda: softmax_cross_entropy_fwd_ref(logits, labels,
                                                                sm), iters=5)
        lib_f = timings(lambda: F.cross_entropy(
            logits, labels, reduction="none", label_smoothing=sm), iters=20)
        kern_b = timings(lambda: softmax_cross_entropy_bwd(logits, labels, lse,
                                                           g, sm), iters=20)
        plain_b = timings(lambda: softmax_cross_entropy_bwd_ref(
            logits, labels, lse, g, sm), iters=3)
        lg = logits.detach().requires_grad_()

        def ce_fwd_bwd():
            out = F.cross_entropy(lg, labels, reduction="none",
                                  label_smoothing=sm)
            torch.autograd.grad(out, lg, g)

        lib_fb = timings(ce_fwd_bwd, iters=10)
        el = logits.element_size()
        base = {"case": name, "rows": r, "V": vv, "dtype": _dt(dt),
                "smoothing": sm,
                "planted_fault_errs": {"last_vocab_tile_dropped": fault}}
        bound, by = _bound(r * vv * el + r * 16, {FP32_FLOPS: 4 * r * vv})
        fwd = {**base, "max_abs_err": max(errs[:2]),
               "errs_loss_lse": errs[:2], "tol": "2e-6 of max|want|",
               **_merge(kern_f, plain_f, lib_f), "bound_ms": bound,
               "bound_by": by,
               "library": "F.cross_entropy(reduction='none')"}
        emit({"phase": "kernel", "kernel": "softmax_xentropy_fwd", **fwd})
        bound, by = _bound(2 * r * vv * el + r * 16, {FP32_FLOPS: 4 * r * vv})
        bwd = {**base, "max_abs_err": errs[2],
               "tol": "1 bf16 ulp + 1e-9" if dt == torch.bfloat16
               else "1e-5 of max|want|",
               **_merge(kern_b, plain_b, lib_fb), "bound_ms": bound,
               "bound_by": by,
               "library": "F.cross_entropy forward + backward"}
        emit({"phase": "kernel", "kernel": "softmax_xentropy_bwd", **bwd})
        cases.append((fwd, bwd))
        del logits, labels, g, loss, lse, want_l, want_lse, d, want_d, lg
        torch.cuda.empty_cache()
    return cases


# -- phase 6: train parity ---------------------------------------------------

def phase_train_parity(params, b: int = 2, s: int = 256):
    """GPT-2 small at fp32 (O0, TF32 off, no dropout): the loss within
    1e-4 and the named gradients within 1e-3 relative L2 error, card
    against the port on the CPU, with the same weights and tokens."""
    cfg = GPTConfig.small(compute_dtype=torch.float32)
    rng = torch.Generator().manual_seed(9)
    ids = torch.randint(0, 50257, (b, s), generator=rng)
    labels = torch.cat([ids[:, 1:], torch.full((b, 1), -100)], dim=1)
    names = ("wte.weight", "layers.0.qkv.kernel", "layers.11.ffn_out.kernel",
             "ln_f.weight")
    out = {}
    for where in ("cuda", "cpu"):
        model = GPTLM(cfg)
        model.load_state_dict(params)
        model.to(where)
        _, loss = model(ids.to(where), labels.to(where))
        ps = dict(model.named_parameters())
        gs = torch.autograd.grad(loss, [ps[n] for n in names])
        out[where] = (float(loss.detach()), [g.cpu() for g in gs])
        del model, ps, gs
    rel = {n: float((a - c).norm() / c.norm())
           for n, a, c in zip(names, out["cuda"][1], out["cpu"][1])}
    err = abs(out["cuda"][0] - out["cpu"][0])
    emit({"phase": "train_parity", "model": "GPT-2 small fp32 O0",
          "batch": [b, s], "loss_cuda": out["cuda"][0],
          "loss_cpu": out["cpu"][0], "loss_abs_err": err,
          "grad_rel_l2": rel})
    check(err <= 1e-4, f"train parity: losses differ by {err}")
    check(all(r <= 1e-3 for r in rel.values()),
          f"train parity: gradients differ {rel}")


# -- phase 7: train ------------------------------------------------------------

def _train_setup(dev, params, b, s, tx=None, on_grads=None):
    """GPT-2 small O2 with ``tx`` (default ``fused_adam(6e-4,
    weight_decay=0.1)``); ``on_grads(grads, masters, state)`` sees each
    step's scaled grads before the optimizer does."""
    amp_ = amp.initialize("O2")
    cfg = GPTConfig.small(compute_dtype=amp_.policy.compute_dtype)
    model = GPTLM(cfg)
    model.load_state_dict(params)
    model.to(dev)
    opt = amp.AmpOptimizer(tx or fused_adam(6e-4, weight_decay=0.1), amp_)
    masters = opt.attach(model)
    state = opt.init(masters)
    data = torch.Generator(device=dev).manual_seed(10)
    ids = torch.randint(0, cfg.vocab_size, (b, s), device=dev, generator=data)
    labels = torch.cat([ids[:, 1:], torch.full((b, 1), -100, device=dev)],
                       dim=1)
    gen = torch.Generator(device=dev).manual_seed(11)
    names, ps = zip(*model.named_parameters())
    plant = {"inf": False}

    def step(carry, _batch):
        masters, state = carry
        _, loss = model(ids, labels, deterministic=False, generator=gen)
        grads = dict(zip(names, torch.autograd.grad(
            amp_.scale_loss(loss, state.scaler[0]), ps)))
        if plant["inf"]:
            g = grads["ln_f.weight"].clone()
            g[0] = float("inf")
            grads["ln_f.weight"] = g
        if on_grads is not None:
            on_grads(grads, masters, state)
        masters, state, stats = opt.step(grads, state, masters, model=model)
        return (masters, state), {"loss": loss.detach(),
                                  "loss_scale": stats.loss_scale,
                                  "skipped": stats.found_inf.float()}

    return cfg, step, (masters, state), plant


def phase_train(dev, params, b: int = 16, s: int = 1024, k: int = 10,
                timed: int = 3):
    """O2 training of GPT-2 small at batch 16 x 1024 with dropout 0.1
    (embedding, residual and attention), fused_adam(6e-4, weight decay
    0.1), FusedTrainDriver at K = 10: one warm window, then ``timed``
    windows, the first of them with the launch counts set to 0 before it
    and read after it.  Then one step with an inf planted in a gradient,
    which must be skipped."""
    cfg, step, carry, plant = _train_setup(dev, params, b, s)
    driver = FusedTrainDriver(step, steps_per_dispatch=k,
                              metrics={"loss": "last", "loss_scale": "last",
                                       "skipped": "sum"},
                              per_step=("loss",))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    carry, res = driver.run_window(carry)
    warm = read_metrics(res)
    warm_s = time.perf_counter() - t0
    walls, windows, counted = [], [], None
    for i in range(timed):
        torch.cuda.synchronize()
        if i == 0:
            reset_launch_counts()
        t0 = time.perf_counter()
        carry, res = driver.run_window(carry)
        host = read_metrics(res)  # the window's one host read
        walls.append(time.perf_counter() - t0)
        windows.append(host)
        if i == 0:
            counted = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = sorted(walls)[len(walls) // 2]
    layers = cfg.num_layers
    per_step = {n: 0 for n in counted}
    per_step.update({"layer_norm": 2 * layers + 1,
                     "layer_norm_bwd": 2 * layers + 1,
                     "flash_attention_fwd": layers,
                     "flash_attention_bwd": layers,
                     "softmax_xentropy_fwd": 1, "softmax_xentropy_bwd": 1})
    first, last = warm.per_step["loss"][0], windows[-1].metrics["loss"]
    emit({"phase": "train", "model": "GPT-2 small O2 (bf16 model, fp32 "
          "masters, dynamic loss scale), dropout 0.1, fused_adam(6e-4, "
          "wd 0.1)", "batch": [b, s], "steps_per_window": k,
          "warm_window_s": warm_s, "window_walls_s": walls,
          "median_window_s": med, "tokens_per_s": b * s * k / med,
          "loss_first_step": first, "loss_last_window": last,
          "losses_per_step": warm.per_step["loss"]
          + sum((w.per_step["loss"] for w in windows), []),
          "loss_scale": windows[-1].metrics["loss_scale"],
          "skipped_steps": warm.metrics["skipped"]
          + sum(w.metrics["skipped"] for w in windows),
          "max_memory_allocated_bytes": peak,
          "launches_one_window": counted,
          "launches_per_step_expected": per_step})
    tokens_per_s = b * s * k / med
    losses = warm.per_step["loss"] + sum((w.per_step["loss"]
                                          for w in windows), [])
    check(all(math.isfinite(x) for x in losses), "train: non-finite loss")
    check(last < first, f"train: loss did not fall ({first} -> {last})")
    check(counted == {n: k * c for n, c in per_step.items()},
          f"train: launch counts {counted} != K x {per_step}")
    # a planted overflow: masters, moments and step count unchanged, the
    # scale halved, the clean-step count reset
    masters, state = carry
    before = {n: t.clone() for n, t in masters.items()}
    m_before = {n: t.clone() for n, t in state.opt_state.m.items()}
    v_before = {n: t.clone() for n, t in state.opt_state.v.items()}
    step_before = int(state.opt_state.step)
    scale_before = float(state.scaler[0].loss_scale)
    plant["inf"] = True
    carry, m = step(carry, None)
    plant["inf"] = False
    masters, state = carry
    torch.cuda.synchronize()
    same = (all(torch.equal(masters[n], before[n]) for n in before)
            and all(torch.equal(state.opt_state.m[n], m_before[n])
                    for n in m_before)
            and all(torch.equal(state.opt_state.v[n], v_before[n])
                    for n in v_before)
            and int(state.opt_state.step) == step_before)
    scaler = state.scaler[0]
    emit({"phase": "train_overflow", "skipped": bool(m["skipped"]),
          "state_unchanged": same, "scale_before": scale_before,
          "scale_after": float(scaler.loss_scale),
          "unskipped_after": int(scaler.unskipped),
          "overflows": int(scaler.overflows)})
    check(bool(m["skipped"]) and same, "train: the overflow step was not "
          "skipped cleanly")
    check(float(scaler.loss_scale) == scale_before / 2
          and int(scaler.unskipped) == 0,
          "train: the overflow did not halve the scale and reset unskipped")
    return counted, step, carry, tokens_per_s


# -- phase 8: BERT kernels ----------------------------------------------------

def _padding_mask(dev, gen, b: int, s: int, lo: int = 128):
    """Seeded lengths in [lo, s] and the (B, 1, S) fp32 key bias BERT
    builds from them: 0 for a token, -1e9 for padding."""
    lengths = torch.randint(lo, s + 1, (b,), device=dev, generator=gen)
    keep = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    return ((1.0 - keep.float()) * -1e9)[:, None, :], lengths


def _dbias_ok(got, want, rtol: float, causal: bool) -> bool:
    """dbias within rtol of max|want| and, with the causal mask, exactly 0
    above the diagonal (the kernel zero-fills the tiles it skips)."""
    if not _close(got, want, rtol):
        return False
    if causal:
        sq, sk = got.shape[1:]
        upper = torch.ones(sq, sk, dtype=torch.bool,
                           device=got.device).triu(1)
        return bool((got[:, upper] == 0).all())
    return True


def phase_flash_bias(dev, b: int = 12, h: int = 16, s: int = 512,
                     d: int = 64):
    """Flash attention with an additive bias, three cases, each against
    the plain versions: (1) BERT-large's shape (B 12, H 16, S 512, bf16,
    dropout 0.1, no causal mask) with the key-padding bias from seeded
    lengths 128-512, passed as the (B, 1, S) mask expanded to (B, S, S)
    (row stride 0); (2) causal fp32 at 300 x 450 with a full N(0, 1) bias
    and ``bias_grad=True``, dbias held too; (3) bf16 with a full bf16
    (B, Sq, Sk) bias.  Tolerances as :func:`phase_flash`; dbias within
    1e-5 of max|want| and exactly 0 above a causal diagonal, written into
    a block that held NaN just before.  Planted faults: the bias read at
    batch bh % B instead of bh // H (the kernel given a per-batch*head
    bias so permuted), the split's low half dropped (case 1), dbias
    multiplied by the scale, and a causally skipped dbias tile left
    unwritten (NaN, as the poisoned block has it).  Case (1) is
    timed beside SDPA with the float mask (no dropout)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    bh = b * h
    seed_int = 246813579
    cases = {}

    def qkv(bh_, sq, sk, dt):
        q = (2 * torch.randn(bh_, sq, d, device=dev, generator=gen)).to(dt)
        k = torch.randn(bh_, sk, d, device=dev, generator=gen).to(dt)
        v = torch.randn(bh_, sk, d, device=dev, generator=gen).to(dt)
        do = torch.randn(bh_, sq, d, device=dev, generator=gen).to(dt)
        return q, k, v, do

    # (1) BERT-large
    dt, rate = torch.bfloat16, 0.1
    q, k, v, do = qkv(bh, s, s, dt)
    mask3, lengths = _padding_mask(dev, gen, b, s)
    bias = mask3.expand(b, s, s)
    args = (_pack_seed(seed_int, device=dev), d ** -0.5, False, rate, (h, h))
    o, lse = flash_attention_fwd(q, k, v, *args, bias=bias)
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, *args, bias=bias)
    grads = flash_attention_bwd(q, k, v, o, lse, do, *args, bias=bias)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args, bias=bias)
    torch.cuda.synchronize()
    check(grads[3] is None and want[3] is None, "dbias without bias_grad")
    rtol = 1e-4
    err_o, err_lse = _err(o, o_ref), _err(lse, lse_ref)
    errs_b = [_err(a, w) for a, w in zip(grads[:3], want[:3])]
    name = f"BERT-large bf16 dropout={rate} padding bias"
    fracs = [_frac_differing(a, w)
             for a, w in zip((o, *grads[:3]), (o_ref, *want[:3]))]
    check(_split_close(o, o_ref, rtol),
          f"flash bias fwd {name}: {err_o} {fracs}")
    check(_close(lse, lse_ref, 1e-5), f"flash bias lse {name}: {err_lse}")
    for gname, a, w, e in zip(("dq", "dk", "dv"), grads, want, errs_b):
        check(_split_close(a, w, rtol),
              f"flash bias {gname} {name}: {e} {fracs}")
    # planted fault: each batch*head reads the mask of batch bh % B
    perm = mask3[torch.arange(bh, device=dev) % b].expand(bh, s, s)
    bad_o, _ = flash_attention_fwd(q, k, v, *args, bias=perm)
    bad_g = flash_attention_bwd(q, k, v, o, lse, do, *args, bias=perm)
    torch.cuda.synchronize()
    faults = {"bias_batch_bh_mod_B_fwd": _err(bad_o, o_ref),
              "bias_batch_bh_mod_B_bwd": _err(bad_g[0], want[0])}
    check(not _close(bad_o, o_ref, rtol, ulps=2),
          f"flash bias {name}: the check misses the bias batch bh % B")
    check(not all(_close(a, w, rtol, ulps=2)
                  for a, w in zip(bad_g[:3], want[:3])),
          f"flash bias {name}: the check misses the bias batch bh % B in "
          f"the backward")
    del bad_o, bad_g, perm
    faults.update(_low_half_dropped(
        lambda: flash_attention_fwd(q, k, v, *args, bias=bias,
                                    probs_bf16=True)[0],
        lambda: flash_attention_bwd(q, k, v, o, lse, do, *args, bias=bias,
                                    probs_bf16=True),
        o_ref, want, rtol))
    kern_f = timings(lambda: flash_attention_fwd(q, k, v, *args, bias=bias),
                     iters=20)
    plain_f = timings(lambda: flash_attention_fwd_ref(q, k, v, *args,
                                                      bias=bias), iters=5)
    kern_b = timings(lambda: flash_attention_bwd(q, k, v, o, lse, do, *args,
                                                 bias=bias), iters=10)
    plain_b = timings(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                      *args, bias=bias),
                      iters=3)
    q4, k4, v4, do4 = (t.reshape(b, h, s, d) for t in (q, k, v, do))
    sdpa_mask = mask3.to(dt)[:, None]  # (B, 1, 1, S)
    lib_f = timings(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=sdpa_mask), iters=20)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask)
        torch.autograd.grad(out, (qg, kg, vg), do4)

    lib_fb = timings(sdpa_fwd_bwd, iters=10)
    base = {"case": name, "B": b, "H": h, "S": s, "D": d, "dtype": _dt(dt),
            "dropout": rate, "lengths": lengths.tolist(),
            "design": FLASH_DESIGN[dt], "frac_differing_o_dq_dk_dv": fracs,
            "planted_fault_errs": faults}
    tol = SPLIT_TOL
    bound, by = _flash_bound(q, k, bias, backward=False, causal=False)
    fwd = {**base, "max_abs_err": max(err_o, err_lse),
           "errs_o_lse": [err_o, err_lse], "tol": tol,
           **_merge(kern_f, plain_f, lib_f), "bound_ms": bound,
           "bound_by": by, "library": "F.scaled_dot_product_attention with "
           "the float key mask, no dropout"}
    emit({"phase": "kernel", "kernel": "flash_attention_fwd_bias", **fwd})
    bound, by = _flash_bound(q, k, bias, backward=True, causal=False)
    bwd = {**base, "max_abs_err": max(errs_b), "errs_dq_dk_dv": errs_b,
           "tol": tol, **_merge(kern_b, plain_b, lib_fb), "bound_ms": bound,
           "bound_by": by, "library": "F.scaled_dot_product_attention with "
           "the float key mask, forward + backward, no dropout"}
    emit({"phase": "kernel", "kernel": "flash_attention_bwd_bias", **bwd})
    # the bias_grad backward (the reference's two-pass path) at the same
    # shape: dq, dk, dv and the per-batch*head dbias against the plain
    # version, timed beside SDPA's forward + backward with the gradient
    # of a bf16 (B, 1, S, S) mask
    grads = flash_attention_bwd(q, k, v, o, lse, do, *args, bias=bias,
                                bias_grad=True)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args, bias=bias,
                                   bias_grad=True)
    torch.cuda.synchronize()
    errs_g = [_err(a, w) for a, w in zip(grads, want)]
    check(all(_split_close(a, w, rtol) for a, w in zip(grads[:3], want[:3]))
          and _dbias_ok(grads[3], want[3], rtol, causal=False),
          f"flash bias_grad {name}: {errs_g}")
    del grads, want
    kern_g = timings(lambda: flash_attention_bwd(q, k, v, o, lse, do, *args,
                                                 bias=bias, bias_grad=True),
                     iters=10)
    plain_g = timings(lambda: flash_attention_bwd_ref(
        q, k, v, o, lse, do, *args, bias=bias, bias_grad=True), iters=3)
    mask_g = sdpa_mask.expand(b, 1, s, s).contiguous().requires_grad_()

    def sdpa_fwd_bwd_mask():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask_g)
        torch.autograd.grad(out, (qg, kg, vg, mask_g), do4)

    lib_g = timings(sdpa_fwd_bwd_mask, iters=10)
    gbound, gby = _flash_bound(q, k, bias, backward=True, causal=False,
                               dbias=True)
    bwd["bias_grad"] = {
        "max_abs_err": max(errs_g), "errs_dq_dk_dv_dbias": errs_g,
        "tol": tol + "; dbias " + f"{rtol} of max|want|",
        **_merge(kern_g, plain_g, lib_g),
        "bound_ms": gbound, "bound_by": gby,
        "library": "F.scaled_dot_product_attention forward + backward with "
                   "the gradient of a bf16 (B, 1, S, S) mask, no dropout"}
    emit({"phase": "kernel", "kernel": "flash_attention_bwd_bias_grad",
          **base, **bwd["bias_grad"]})
    cases["bert"] = (fwd, bwd)
    del q, k, v, do, o, lse, o_ref, lse_ref, qg, kg, vg, mask_g
    torch.cuda.empty_cache()

    # (2) causal fp32 300 x 450, bias_grad: dbias held
    b2, sq, sk, dt = 2, 300, 450, torch.float32
    q, k, v, do = qkv(b2 * h, sq, sk, dt)
    bias = torch.randn(b2, sq, sk, device=dev, generator=gen)
    args = (_pack_seed(seed_int, device=dev), d ** -0.5, True, rate, (h, h))
    o, lse = flash_attention_fwd(q, k, v, *args, bias=bias)
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, *args, bias=bias)
    # poison the block that dbias will take (the wrapper allocates it
    # first, and the allocator hands back the block just freed): a tile
    # the kernel leaves unwritten then reads NaN and fails the check
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    poison = torch.full((b2 * h, sq, sk), float("nan"), device=dev)
    poison_ptr = poison.data_ptr()
    del poison
    grads = flash_attention_bwd(q, k, v, o, lse, do, *args, bias=bias,
                                bias_grad=True)
    check(dev.type != "cuda" or grads[3].data_ptr() == poison_ptr,
          "flash dbias: the poisoned block was not handed to dbias, so an "
          "unwritten tile would go unseen")
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args, bias=bias,
                                   bias_grad=True)
    # the autograd path: the head-summed dbias of flash_attention
    bl = bias.detach().requires_grad_()
    out = flash_attention(*(t.reshape(b2, h, -1, d) for t in (q, k, v)),
                          bias=bl, causal=True, dropout_rate=rate,
                          dropout_seed=seed_int, bias_grad=True)
    (dbias_sum,) = torch.autograd.grad(out, (bl,), do.reshape(b2, h, sq, d))
    want_sum = want[3].reshape(b2, h, sq, sk).sum(dim=1)
    torch.cuda.synchronize()
    name = f"B={b2} H={h} Sq={sq} Sk={sk} causal fp32 dropout={rate} " \
        f"bias_grad"
    errs = [_err(o, o_ref), _err(lse, lse_ref)] + [
        _err(a, w) for a, w in zip(grads, want)] + [
        _err(dbias_sum, want_sum)]
    check(_close(o, o_ref, 1e-5) and _close(lse, lse_ref, 1e-5),
          f"flash bias fwd {name}: {errs[:2]}")
    check(all(_close(a, w, 1e-5) for a, w in zip(grads[:3], want[:3])),
          f"flash bias bwd {name}: {errs[2:5]}")
    check(_dbias_ok(grads[3], want[3], 1e-5, causal=True),
          f"flash dbias {name}: {errs[5]}")
    check(_close(dbias_sum, want_sum, 1e-5),
          f"flash head-summed dbias {name}: {errs[6]}")
    bad = grads[3] * args[1]
    garbage = grads[3].clone()  # a skipped tile as the poisoned block had it
    garbage[:, :64, 64:128] = float("nan")
    upper = torch.ones(sq, sk, dtype=torch.bool, device=dev).triu(1)
    faults = {"dbias_times_scale": _err(bad, want[3]),
              "skipped_dbias_tile_unwritten_nonzero_above_diagonal":
                  int((garbage[:, upper] != 0).sum())}
    check(not _dbias_ok(bad, want[3], 1e-5, causal=True),
          f"flash {name}: the check misses dbias multiplied by scale")
    check(not _dbias_ok(garbage, want[3], 1e-5, causal=True),
          f"flash {name}: the check misses an unwritten skipped dbias tile")
    emit({"phase": "kernel_check", "kernel": "flash_attention_bias",
          "case": name, "errs_o_lse_dq_dk_dv_dbias_dbiassum": errs,
          "tol": "1e-5 of max|want|; dbias exactly 0 above the diagonal",
          "dbias_block_poisoned_nan": True, "planted_fault_errs": faults})
    cases["dbias"] = {"max_abs_err": max(errs), "planted_fault_errs": faults}
    del q, k, v, do, o, lse, grads, want, bad, garbage, out, dbias_sum

    # (3) bf16 with a full bf16 bias
    b3, dt = 2, torch.bfloat16
    q, k, v, do = qkv(b3 * h, s, s, dt)
    bias = torch.randn(b3, s, s, device=dev, generator=gen).to(dt)
    args = (_pack_seed(seed_int, device=dev), d ** -0.5, False, 0.0, (h, h))
    o, lse = flash_attention_fwd(q, k, v, *args, bias=bias)
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, *args, bias=bias)
    grads = flash_attention_bwd(q, k, v, o, lse, do, *args, bias=bias)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args, bias=bias)
    torch.cuda.synchronize()
    name = f"B={b3} H={h} S={s} bf16 full bf16 bias"
    errs = [_err(o, o_ref), _err(lse, lse_ref)] + [
        _err(a, w) for a, w in zip(grads[:3], want[:3])]
    check(_split_close(o, o_ref) and _close(lse, lse_ref, 1e-5),
          f"flash bias fwd {name}: {errs[:2]}")
    check(all(_split_close(a, w) for a, w in zip(grads[:3], want[:3])),
          f"flash bias bwd {name}: {errs[2:]}")
    emit({"phase": "kernel_check", "kernel": "flash_attention_bias",
          "case": name, "design": FLASH_DESIGN[dt],
          "errs_o_lse_dq_dk_dv": errs,
          "frac_differing_o_dq_dk_dv": [
              _frac_differing(a, w)
              for a, w in zip((o, *grads[:3]), (o_ref, *want[:3]))],
          "tol": SPLIT_TOL})
    torch.cuda.empty_cache()
    return cases


def _lamb_leaves(dev, gen, shapes, g_dtype=torch.bfloat16):
    """(g, p, m, v) per shape: g ~ 64 N(0, 1) in ``g_dtype`` (scaled grads),
    p ~ N(0, 0.02), m ~ 1e-3 N(0, 1), v ~ 1e-6 |N(0, 1)|."""
    out = []
    for shape in shapes:
        g = (64 * torch.randn(shape, device=dev, generator=gen)).to(g_dtype)
        p_ = 0.02 * torch.randn(shape, device=dev, generator=gen)
        m = 1e-3 * torch.randn(shape, device=dev, generator=gen)
        v = 1e-6 * torch.randn(shape, device=dev, generator=gen).abs()
        out.append((g, p_, m, v))
    return out


def _lamb_ok(got, want) -> bool:
    """m and v within 1 fp32 ulp of the plain version (each is rounded
    once per operation on both sides); the sums within 1e-5 relative
    (fp32 sums of up to 31 M positive terms in two orders)."""
    m, v, ps, us = got
    wm, wv, wps, wus = want
    ulp = lambda x: torch.finfo(torch.float32).eps * x.abs()  # noqa: E731
    return bool(((m - wm).abs() <= ulp(wm)).all()
                and ((v - wv).abs() <= ulp(wv)).all()
                and abs(float(ps) - float(wps)) <= 1e-5 * abs(float(wps))
                and abs(float(us) - float(wus)) <= 1e-5 * abs(float(wus)))


def phase_lamb(dev, leaf_shapes=None):
    """LAMB stage 1 against its plain version, with skip 0 and 1, on four
    leaves (BERT-large's 30592 x 1024 word table, a 1024 x 4096 FFN
    kernel, a 1024 bias, a ragged 1000-element leaf) with
    bf16 grads; then one step's pass over every BERT-large leaf, timed.
    Planted faults: the ragged tail (past the last multiple of 128, the
    reference's row width) left out of the sums, and skip ignored."""
    gen = torch.Generator(device=dev).manual_seed(14)
    hp = dict(b1=0.9, b2=0.999, eps=1e-6, wd=0.01, adam_w=True)
    shapes = ((30592, 1024), (1024, 4096), (1024,), (1000,))
    cases = []
    for (g, p_, m, v) in _lamb_leaves(dev, gen, shapes):
        for skip in (0.0, 1.0):
            scal = torch.tensor([2.0 ** -16 * 0.5, 1 - 0.9 ** 7,
                                 1 - 0.999 ** 7, skip], device=dev)
            got = lamb_stage1(g, p_, m.clone(), v.clone(), scal, **hp)
            want = lamb_stage1_ref(g, p_, m.clone(), v.clone(), scal, **hp)
            torch.cuda.synchronize()
            errs = [_err(a, w) for a, w in zip(got, want)]
            name = f"n={g.numel()} skip={int(skip)}"
            check(_lamb_ok(got, want), f"lamb_stage1 {name}: {errs}")
            if skip:
                check(torch.equal(got[0], m) and torch.equal(got[1], v),
                      f"lamb_stage1 {name}: skip changed m or v")
            faults = {}
            n = g.numel()
            if n % 128:
                cut = n - n % 128
                flat = [t.reshape(-1)[:cut] for t in (g, p_, m, v)]
                bad = lamb_stage1(flat[0], flat[1], flat[2].clone(),
                                  flat[3].clone(), scal, **hp)
                faults["ragged_tail_left_out"] = abs(float(bad[2])
                                                     - float(want[2]))
                check(not _lamb_ok((want[0], want[1], bad[2], bad[3]), want),
                      f"lamb_stage1 {name}: the check misses the ragged "
                      f"tail left out of the sums")
            if skip:
                noskip = scal.clone()
                noskip[3] = 0.0
                bad = lamb_stage1(g, p_, m.clone(), v.clone(), noskip, **hp)
                faults["skip_ignored"] = _err(bad[0], want[0])
                check(not _lamb_ok(bad, want),
                      f"lamb_stage1 {name}: the check misses skip ignored")
            case = {"case": name, "n": n, "g_dtype": "bfloat16",
                    "skip": bool(skip), "errs_m_v_psq_usq": errs,
                    "max_abs_err": max(errs[:2]),
                    "tol": "m, v 1 fp32 ulp; sums 1e-5 relative",
                    "planted_fault_errs": faults}
            emit({"phase": "kernel_check", "kernel": "lamb_stage1", **case})
            cases.append(case)
    del g, p_, m, v
    # one step's stage 1 over every leaf of BERT-large (one launch pair each)
    if leaf_shapes is None:
        with torch.device("meta"):
            leaf_shapes = [t.shape for t in
                           BertForMLM(BertConfig.large()).parameters()]
    leaves = _lamb_leaves(dev, gen, leaf_shapes)
    scal = torch.tensor([2.0 ** -16, 0.1, 0.001, 0.0], device=dev)

    def step(fn):
        return lambda: [fn(g, p_, m, v, scal, **hp) for g, p_, m, v in leaves]

    kern = timings(step(lamb_stage1), iters=5, prof_iters=3)
    plain = timings(step(lamb_stage1_ref), iters=2, prof_iters=1)
    n = sum(g.numel() for g, *_ in leaves)
    bound, by = _bound(22 * n, {FP32_FLOPS: 20 * n})
    summary = {"case": f"one step, {len(leaves)} BERT-large leaves, bf16 g",
               "leaves": len(leaves), "elements": n,
               "max_abs_err": max(c["max_abs_err"] for c in cases),
               "tol": cases[0]["tol"],
               "planted_fault_errs": {k: v for c in cases
                                      for k, v in c["planted_fault_errs"]
                                      .items()},
               **_merge(kern, plain, {}), "library_ms": None,
               "library": "none: no single PyTorch call computes LAMB "
                          "stage 1", "bound_ms": bound, "bound_by": by}
    emit({"phase": "kernel", "kernel": "lamb_stage1", **summary})
    del leaves
    torch.cuda.empty_cache()
    return summary


# -- phase 9: BERT-large MLM --------------------------------------------------

BERT_GRADS = ("encoder.layers.0.self_attn.in_proj_weight",
              "encoder.layers.23.ffn_out.kernel", "mlm_bias",
              "encoder.word_embeddings.weight")


def _mlm_batch(dev, gen, b: int, s: int, vocab: int, lengths=None):
    """Padded MLM data: token ids in [1000, vocab), lengths (seeded in
    [128, s] unless given), labels on 15 % of the valid positions (their
    inputs replaced by the [MASK] id 103), -100 elsewhere."""
    if lengths is None:
        lengths = torch.randint(128, s + 1, (b,), device=dev, generator=gen)
    lengths = torch.as_tensor(lengths, device=dev)
    ids = torch.randint(1000, vocab, (b, s), device=dev, generator=gen)
    mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None]).long()
    picked = (torch.rand(b, s, device=dev, generator=gen) < 0.15) & (mask == 1)
    labels = torch.where(picked, ids, -100)
    ids = torch.where(picked, 103, ids)
    return ids, labels, mask


def phase_bert_parity(params, cfg=None, b: int = 2, s: int = 256,
                      lengths=(200, 256), devices=("cuda", "cpu"),
                      names=BERT_GRADS, phase: str = "bert_parity"):
    """BERT-large at fp32 (O0, TF32 off, no dropout) with a padding mask,
    batch 2 x 256 with lengths 200 and 256: the MLM loss within 1e-4 and
    four gradients within 1e-3 relative L2 error, card against the port
    on the CPU, with the same weights and tokens."""
    cfg = cfg or BertConfig.large(compute_dtype=torch.float32)
    ids, labels, mask = _mlm_batch("cpu", torch.Generator().manual_seed(15),
                                   b, s, cfg.vocab_size, lengths)
    out = {}
    for where in devices:
        model = BertForMLM(cfg)
        model.load_state_dict(params)
        model.to(where)
        _, loss = model(ids.to(where), labels.to(where),
                        attention_mask=mask.to(where))
        ps = dict(model.named_parameters())
        gs = torch.autograd.grad(loss, [ps[n] for n in names])
        out[where] = (float(loss.detach()), [g.cpu() for g in gs])
        del model, ps, gs
    a, c = devices
    rel = {n: float((x - y).norm() / y.norm())
           for n, x, y in zip(names, out[a][1], out[c][1])}
    err = abs(out[a][0] - out[c][0])
    emit({"phase": phase, "model": "BERT-large fp32 O0, padded",
          "tie_word_embeddings": cfg.tie_word_embeddings,
          "batch": [b, s], "lengths": list(lengths),
          "loss_cuda": out[a][0], "loss_cpu": out[c][0],
          "loss_abs_err": err, "grad_rel_l2": rel})
    check(err <= 1e-4, f"{phase}: losses differ by {err}")
    check(all(r <= 1e-3 for r in rel.values()),
          f"{phase}: gradients differ {rel}")


def _bert_setup(dev, params, b, s, cfg=None, sparse=False):
    """BERT-large O2 under ``fused_lamb(1e-3, weight_decay=0.01)``; with
    ``sparse``, pruned first on the card by
    ``ASP().prune_trained_model``, whose ``sparsify`` transform takes
    ``AmpOptimizer``'s unfused route."""
    amp_ = amp.initialize("O2", keep_batchnorm_fp32=True)
    cfg = cfg or BertConfig.large(compute_dtype=amp_.policy.compute_dtype)
    model = BertForMLM(cfg)
    model.to(dev)
    tx = fused_lamb(1e-3, weight_decay=0.01)
    if sparse:
        params, tx, sparse_state = ASP().prune_trained_model(
            {n: t.to(dev) for n, t in params.items()}, tx)
    model.load_state_dict(params)
    opt = amp.AmpOptimizer(tx, amp_)
    masters = opt.attach(model)
    state = (amp.AmpOptState(opt_state=sparse_state,
                             scaler=amp_.init_state(dev)) if sparse
             else opt.init(masters))
    del params
    ids, labels, mask = _mlm_batch(dev, torch.Generator(device=dev)
                                   .manual_seed(16), b, s, cfg.vocab_size)
    gen = torch.Generator(device=dev).manual_seed(17)
    names, ps = zip(*model.named_parameters())
    plant = {"inf": False}

    def step(carry, _batch):
        masters, state = carry
        _, loss = model(ids, labels, attention_mask=mask,
                        deterministic=False, generator=gen)
        grads = dict(zip(names, torch.autograd.grad(
            amp_.scale_loss(loss, state.scaler[0]), ps)))
        if plant["inf"]:
            g = grads["mlm_ln.weight"].clone()
            g[0] = float("inf")
            grads["mlm_ln.weight"] = g
        masters, state, stats = opt.step(grads, state, masters, model=model)
        return (masters, state), {"loss": loss.detach(),
                                  "loss_scale": stats.loss_scale,
                                  "skipped": stats.found_inf.float()}

    return cfg, step, (masters, state), plant, mask, model


def _lamb_state(opt_state):
    """FusedLAMB's state, inside a ``sparsify`` state or not."""
    return getattr(opt_state, "inner", opt_state)


def _pruned_nonzero(masks, tensors) -> int:
    """How many positions that a mask prunes are not exactly 0."""
    return sum(int((tensors[n][m == 0] != 0).sum())
               for n, m in masks.items() if m is not None)


def phase_bert_train(dev, params, b: int = 12, s: int = 512, k: int = 6,
                     timed: int = 3, cfg=None, phase: str = "bert_train",
                     sparse: bool = False):
    """O2 (bf16 model, fp32 masters, dynamic loss scale, keep_batchnorm_fp32)
    BERT-large MLM with fused_lamb(1e-3, weight decay 0.01) at batch
    12 x 512 (the JAX bench's BERT_BATCH, BERT_SEQ, BERT_SCAN = 12, 512, 6),
    padded with seeded lengths 128-512, labels on 15 % of the valid
    positions, dropout and attention dropout 0.1, FusedTrainDriver at
    K = 6: one warm window, then ``timed`` windows, the first with the
    launch counts set to 0 before it and read after it.  Then one step
    with an inf planted in a gradient, which must be skipped with LAMB's
    m, v and step unchanged.  With ``sparse`` (the model pruned 2:4 by
    ASP, see :func:`_bert_setup`) every pruned position must also be
    exactly 0 in the fp32 masters and the bf16 model after the windows,
    and the overflow step must leave the masks as they were.  Returns
    the launch counts, the step, the carry and the emitted record."""
    cfg, step, carry, plant, mask, model = _bert_setup(dev, params, b, s,
                                                       cfg, sparse)
    driver = FusedTrainDriver(step, steps_per_dispatch=k,
                              metrics={"loss": "last", "loss_scale": "last",
                                       "skipped": "sum"},
                              per_step=("loss",))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    carry, res = driver.run_window(carry)
    warm = read_metrics(res)
    warm_s = time.perf_counter() - t0
    walls, windows, counted = [], [], None
    for i in range(timed):
        torch.cuda.synchronize()
        if i == 0:
            reset_launch_counts()
        t0 = time.perf_counter()
        carry, res = driver.run_window(carry)
        host = read_metrics(res)  # the window's one host read
        walls.append(time.perf_counter() - t0)
        windows.append(host)
        if i == 0:
            counted = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = sorted(walls)[len(walls) // 2]
    layers = cfg.num_layers
    n_leaves = sum(1 for _ in carry[0])
    per_step = {n: 0 for n in counted}
    per_step.update({"layer_norm": 2 * layers + 2,
                     "layer_norm_bwd": 2 * layers + 2,
                     "flash_attention_fwd": layers,
                     "flash_attention_bwd": layers,
                     "softmax_xentropy_fwd": 1, "softmax_xentropy_bwd": 1,
                     "lamb_stage1": n_leaves})
    valid = int(mask.sum())
    first, last = warm.per_step["loss"][0], windows[-1].metrics["loss"]
    losses = warm.per_step["loss"] + sum((w.per_step["loss"]
                                          for w in windows), [])
    rec = {"phase": phase, "model": "BERT-large MLM O2 (bf16 model, "
           "fp32 masters, dynamic loss scale), dropout 0.1, "
           + ("sparsify(fused_lamb(1e-3, wd 0.01)), pruned 2:4 by ASP "
              "(m4n2_1d)" if sparse else "fused_lamb(1e-3, wd 0.01)"),
           "tie_word_embeddings": cfg.tie_word_embeddings, "batch": [b, s],
           "valid_tokens_per_step": valid, "steps_per_window": k,
           "warm_window_s": warm_s, "window_walls_s": walls,
           "median_window_s": med, "sequences_per_s": b * k / med,
           "valid_tokens_per_s": valid * k / med,
           "loss_first_step": first, "loss_last_window": last,
           "losses_per_step": losses,
           "loss_scale": windows[-1].metrics["loss_scale"],
           "skipped_steps": warm.metrics["skipped"]
           + sum(w.metrics["skipped"] for w in windows),
           "max_memory_allocated_bytes": peak,
           "launches_one_window": counted,
           "launches_per_step_expected": per_step}
    emit(rec)
    check(all(math.isfinite(x) for x in losses), f"{phase}: non-finite loss")
    check(last < first, f"{phase}: loss did not fall ({first} -> {last})")
    check(counted == {n: k * c for n, c in per_step.items()},
          f"{phase}: launch counts {counted} != K x {per_step}")
    masters, state = carry
    if sparse:
        masks = state.opt_state.masks
        model_params = dict(model.named_parameters())
        rec["pruned_nonzero_masters"] = _pruned_nonzero(masks, masters)
        rec["pruned_nonzero_model"] = _pruned_nonzero(masks, model_params)
        rec["model_dtype"] = _dt(model_params[next(
            n for n, m in masks.items() if m is not None)].dtype)
        emit({"phase": phase + "_pruned",
              **{n: rec[n] for n in ("pruned_nonzero_masters",
                                     "pruned_nonzero_model", "model_dtype")}})
        check(rec["pruned_nonzero_masters"] == 0
              and rec["pruned_nonzero_model"] == 0,
              f"{phase}: pruned positions moved off 0")
        masks_before = {n: m.clone() for n, m in masks.items()
                        if m is not None}
    lamb = _lamb_state(state.opt_state)
    before = {n: t.clone() for n, t in masters.items()}
    m_before = {n: t.clone() for n, t in lamb.m.items()}
    v_before = {n: t.clone() for n, t in lamb.v.items()}
    step_before = int(lamb.step)
    scale_before = float(state.scaler[0].loss_scale)
    plant["inf"] = True
    carry, m = step(carry, None)
    plant["inf"] = False
    masters, state = carry
    lamb = _lamb_state(state.opt_state)
    torch.cuda.synchronize()
    same = (all(torch.equal(masters[n], before[n]) for n in before)
            and all(torch.equal(lamb.m[n], m_before[n]) for n in m_before)
            and all(torch.equal(lamb.v[n], v_before[n]) for n in v_before)
            and int(lamb.step) == step_before)
    if sparse:
        same = same and all(torch.equal(state.opt_state.masks[n], mb)
                            for n, mb in masks_before.items())
    scaler = state.scaler[0]
    emit({"phase": phase.replace("train", "overflow"),
          "skipped": bool(m["skipped"]),
          "state_unchanged": same, "lamb_step": int(lamb.step),
          "scale_before": scale_before,
          "scale_after": float(scaler.loss_scale),
          "unskipped_after": int(scaler.unskipped),
          "overflows": int(scaler.overflows)})
    check(bool(m["skipped"]) and same, f"{phase}: the overflow step was not "
          "skipped cleanly")
    check(float(scaler.loss_scale) == scale_before / 2
          and int(scaler.unskipped) == 0,
          f"{phase}: the overflow did not halve the scale and reset "
          "unskipped")
    del before, m_before, v_before
    return counted, step, carry, rec


def phase_step_profile(step, carry, phase: str, what: str,
                       kernel_groups=None):
    """Where one training step's time goes: wall time, device-busy share
    and the kernels that take the most device time; ``kernel_groups``
    ({label: name substring}) adds each group's device ms and calls."""
    from torch.profiler import ProfilerActivity, profile

    carry, _ = step(carry, None)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = step(carry, None)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, _ = step(carry, None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in _kernel_events(prof):
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()),
                  key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    rec = {"phase": phase, "what": what,
           "wall_ms": wall_ms, "unprofiled_wall_ms": plain_wall_ms,
           "device_busy_ms": busy_ms if busy_ms > 0 else None,
           "device_busy_share": busy_ms / wall_ms if busy_ms > 0 else None,
           "device_busy_share_unprofiled":
               busy_ms / plain_wall_ms if busy_ms > 0 else None,
           "top_kernels": [{"name": k[:90], "device_ms": ms, "calls": n}
                           for k, ms, n in rows[:12]]}
    for label, sub in (kernel_groups or {}).items():
        rec[f"{label}_device_ms"] = sum(r[1] for r in rows if sub in r[0])
        rec[f"{label}_calls"] = sum(r[2] for r in rows if sub in r[0])
    emit(rec)
    return rec


# -- phase 10: the conv+BN matmul kernels --------------------------------------

# (M, K, N): RN50 at batch 128, the bottleneck 1x1 convolutions
# (tools/bench_conv_bn.py's shapes)
RN50_1X1 = ((128 * 56 * 56, 256, 64), (128 * 56 * 56, 64, 256),
            (128 * 28 * 28, 512, 128), (128 * 28 * 28, 128, 512),
            (128 * 14 * 14, 1024, 256), (128 * 14 * 14, 256, 1024),
            (128 * 7 * 7, 2048, 512), (128 * 7 * 7, 512, 2048))


CONV_BN_TOL = ("1e-5 of the |x|.|w| term sums + 1 bf16 ulp (bf16 out); "
               "BN in bf16 + 2^-8 of |a|.|w| (vs the rounded operand: "
               "without); stats 2e-6 of sum|y|, sum y^2 + the outputs' "
               "differences")
CONV_BN_KERNELS = ("matmul_stats", "bn_relu_matmul", "matmul_bwd_dual")
# the wgmma kernels' planted faults: (_fault code, key, what it does)
KERNEL_FAULTS = ((1, "stage_dropped", "a ring stage's products dropped"),
                 (2, "last_tile_skipped", "each block's last row tile "
                  "skipped"))
# bn_relu_matmul's wgmma kernel adds one: rows past M (and k past K) of
# its tiles not zeroed after the prologue (checked where M leaves padded
# rows: padded k meet w's zero rows and change nothing)
BN_FAULT = (3, "padding_unmasked", "the padded rows and k left unmasked "
            "after the prologue")
CONV_BN_LIBRARY = {
    "matmul_stats": "torch.matmul + fp32 column sums",
    "bn_relu_matmul": "unfused BN + ReLU + cast, torch.matmul, column sums",
    "matmul_bwd_dual": "two torch.matmul (dy w^T, x^T dy)"}


def _conv_bn_inputs(dev, gen, m, k, n, dtype):
    """x ~ 0.5 N(0, 1), w ~ 0.05 N(0, 1) (bench_conv_bn.py's scales), the
    BN parameters, dy ~ 0.1 N(0, 1)."""
    x = (0.5 * torch.randn(m, k, device=dev, generator=gen)).to(dtype)
    w = (0.05 * torch.randn(k, n, device=dev, generator=gen)).to(dtype)
    bn = (0.1 * torch.randn(k, device=dev, generator=gen),
          1.0 + torch.rand(k, device=dev, generator=gen),
          1.0 + 0.1 * torch.randn(k, device=dev, generator=gen),
          0.1 * torch.randn(k, device=dev, generator=gen))
    dy = (0.1 * torch.randn(m, n, device=dev, generator=gen)).to(dtype)
    return x, w, bn, dy


def _out_ok(got, want, absw, extra=None) -> bool:
    """``got`` within 1e-5 of the term magnitudes ``absw`` (sums of one
    dot product in two orders) plus ``extra``, plus one bf16 ulp for a
    bf16 result (one rounding may flip)."""
    tol = 1e-5 * absw
    if extra is not None:
        tol = tol + extra
    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        tol = tol + torch.exp2(torch.floor(torch.log2(big)) - 7)
    return bool(((g - w).abs() <= tol).all())


def _stats_ok(s, ss, y, y_plain=None, s_plain=None, ss_plain=None) -> bool:
    """The stats against the float64 column sums of the kernel's own
    stored y, within 2e-6 of sum|y| and sum y^2 (fp32 partials added in
    two orders); and, given the plain version's, within the sums of the
    two stored outputs' differences (the stats of different stored
    values) plus that."""
    y64 = y.double()
    tol_s = 2e-6 * y64.abs().sum(0)
    tol_ss = 2e-6 * (y64 * y64).sum(0)
    ok = bool(((s.double() - y64.sum(0)).abs() <= tol_s).all()
              and ((ss.double() - (y64 * y64).sum(0)).abs() <= tol_ss).all())
    if y_plain is not None:
        p64 = y_plain.double()
        d = (y64 - p64).abs()
        ok = ok and bool(
            ((s.double() - s_plain.double()).abs()
             <= d.sum(0) + tol_s).all()
            and ((ss.double() - ss_plain.double()).abs()
                 <= (d * (y64.abs() + p64.abs())).sum(0) + tol_ss).all())
    return ok


def _conv_bn_bounds(m, k, n, x, w):
    """(forward bound, its kind, dual bound, its kind): each input read
    once and each output written once; the products at the bf16
    tensor-core rate for bf16 operands, else at the fp32 rate."""
    ex, ew = x.element_size(), w.element_size()
    rate = BF16_FLOPS if ex == ew == 2 else FP32_FLOPS
    fwd = _bound(m * k * ex + k * n * ew + m * n * ex + 2 * n * 4,
                 {rate: 2 * m * k * n})
    fwd_bn = _bound(m * k * ex + k * n * ew + m * n * ex + 2 * n * 4
                    + 4 * k * 4, {rate: 2 * m * k * n})
    dual = _bound((2 * m * k + m * n + k * n) * ex + k * n * 4,
                  {rate: 4 * m * k * n})
    return fwd, fwd_bn, dual


def _bn_lhs(x, bn, relu):
    mean, rstd, gamma, beta = bn
    a = (x.float() - mean) * (rstd * gamma) + beta
    return a.clamp_min(0.0) if relu else a


def _conv_bn_path(dev, shapes):
    """The second path of this slice: each of the three entry points at
    each RN50 1x1 shape, once, with the launch counts set to 0 just
    before and read just after."""
    gen = torch.Generator(device=dev).manual_seed(21)
    reset_launch_counts()
    finite = True
    for m, k, n in shapes:
        x, w, bn, dy = _conv_bn_inputs(dev, gen, m, k, n, torch.bfloat16)
        y, s, ss = matmul_stats(x, w)
        z, s2, ss2 = bn_relu_matmul(x, *bn, w)
        dx, dw = matmul_bwd_dual(x, dy, w)
        finite = finite and all(bool(torch.isfinite(t.float()).all())
                                for t in (y, s, ss, z, s2, ss2, dx, dw))
        del x, w, bn, dy, y, z, dx, dw
    torch.cuda.synchronize()
    counts = launch_counts()
    torch.cuda.empty_cache()
    launches = {k: counts[k] for k in CONV_BN_KERNELS}
    emit({"phase": "conv_bn_path", "shapes": [list(s) for s in shapes],
          "launches": launches, "finite": finite})
    check(finite, "conv_bn path: non-finite output")
    check(all(n == len(shapes) for n in launches.values()),
          f"conv_bn path: launches {launches}, want {len(shapes)} each "
          f"(one a shape)")
    return counts


def _conv_bn_lib():
    from apex_tpu_torch.ops.conv_bn import _lib

    return _lib()


def phase_conv_bn_tile_check(dev):
    """The wgmma operand descriptors: one 128 x 64 x 64 tile product
    through TMA and ``wgmma`` in each of the four operand-major
    combinations (A K-major with B MN-major: the stats kernel; both
    K-major: dx; both MN-major: dw; A MN-major with B K-major), against
    ``torch.matmul`` in fp32 on the same bf16 values, within 1e-5 of the
    |A|.|B| sums (exact products, fp32 sums in another order).  Planted
    fault: B taken with the other major-ness (its transpose) must fail."""
    gen = torch.Generator(device=dev).manual_seed(23)
    lib = _conv_bn_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    used = {(0, 1): "stats", (0, 0): "dx", (1, 1): "dw", (1, 0): "none"}
    out = []
    for a_mn in (0, 1):
        for b_mn in (0, 1):
            a = torch.randn((64, 128) if a_mn else (128, 64), device=dev,
                            generator=gen).to(torch.bfloat16)
            b = torch.randn(64, 64, device=dev,
                            generator=gen).to(torch.bfloat16)
            d = torch.full((128, 64), float("nan"), device=dev)
            err = lib.apex_conv_bn_tile_check(a.data_ptr(), b.data_ptr(),
                                              d.data_ptr(), a_mn, b_mn,
                                              stream)
            check(err == 0, f"conv_bn tile check: CUDA error {err}")
            torch.cuda.synchronize()
            aa = (a.T if a_mn else a).float()
            bb = (b if b_mn else b.T).float()
            want = aa @ bb
            tol = 1e-5 * (aa.abs() @ bb.abs())
            ok = bool(((d - want).abs() <= tol).all())
            bad = aa @ bb.T
            fault_ok = bool(((bad - want).abs() <= tol).all())
            rec = {"A": "MN-major" if a_mn else "K-major",
                   "B": "MN-major" if b_mn else "K-major",
                   "used_by": used[(a_mn, b_mn)], "max_abs_err": _err(d, want),
                   "planted_fault_errs": {"B_other_major": _err(bad, want)}}
            out.append(rec)
            emit({"phase": "kernel_check", "kernel": "conv_bn_tile_check",
                  "tol": "1e-5 of |A|.|B|", **rec})
            check(ok, f"conv_bn tile check {rec}: wrong product")
            check(not fault_ok, f"conv_bn tile check {rec}: the check misses "
                  f"B read with the other major-ness")
    return out


def phase_conv_bn_tc_info():
    """Each wgmma conv_bn kernel's shared memory a block (a resident-w
    kernel's at the largest w the design rule keeps), resident blocks per
    SM, registers and spilled bytes a thread, as ``cudaFuncGetAttributes``
    and the occupancy query report them; every one must spill nothing."""
    import ctypes

    lib = _conv_bn_lib()
    info = {}
    for i, name in enumerate(TC_KERNELS):
        out = (ctypes.c_int * 4)()
        err = lib.apex_conv_bn_tc_info(i, _RESIDENT_W,
                                       ctypes.addressof(out))
        check(err == 0, f"apex_conv_bn_tc_info({i}): CUDA error {err}")
        info[name] = {"smem_bytes": out[0], "blocks_per_sm": out[1],
                      "registers": out[2], "spill_bytes": out[3]}
    emit({"phase": "conv_bn_tc_info", "kernels": info})
    spilled = {k: v["spill_bytes"] for k, v in info.items()
               if v["spill_bytes"]}
    check(not spilled, f"conv_bn wgmma kernels spill: {spilled}")
    return info


def phase_conv_bn(dev, shapes=RN50_1X1,
                  ragged=((1000, 72, 200), (999, 70, 197),
                          (1000, 1088, 64)),
                  fp32=(6272, 512, 512)):
    """The three conv+BN kernels against their plain versions: at RN50's
    eight 1x1 shapes in bf16 (``bn_relu_matmul`` with ReLU, and without
    at the first), at three ragged bf16 shapes (K and N whole 16-byte
    vectors, and not: the kernels' element-by-element loads; and N = 64
    with a w too large to keep in shared memory) and at one fp32 shape
    (each with ReLU on and off).  Every wgmma kernel of
    ``TC_KERNELS`` must be launched by some case.  Tolerances: outputs within 1e-5 of the
    |x|.|w| term sums plus 1 bf16 ulp for a bf16 output (and, for the BN
    kernel in bf16, 2^-8 of the |a|.|w| sums: it rounds the normalised
    operand to bf16, the plain version does not; against an inline
    reference that rounds the operand as the TPU kernel does, 1e-5 of
    |a|.|w| plus 1 bf16 ulp); dw (fp32) within 1e-5 of |x|^T.|dy|; stats
    per ``_stats_ok``.  Planted faults the check must reject: stats of the
    unrounded products (bf16 cases), the last row block (128 rows) left
    out of the stats and out of dw, the ReLU dropped, and beta off by 0.1
    at the last k (against the rounded-operand reference); in the cases
    the wgmma kernels take, their planted faults (``_fault`` 1: a ring
    stage's products dropped, 2: each block's last row tile skipped; for
    ``bn_relu_matmul`` also 3: the padded rows and k left unmasked after
    its prologue, wherever M leaves padded rows) must fail the same
    checks.  bf16 cases: two calls give the same bits (y, z, sum, sqsum,
    dx, dw).  Each line names the design that ran (``_conv_bn_design``)
    and the wgmma kernel it launched.  Each case timed beside its bound with the plain version and
    the library chain (``torch.matmul`` + column sums; the unfused BN,
    ReLU, cast, matmul and sums, as ``tools/bench_conv_bn.py``'s XLA arm;
    two ``torch.matmul`` s for the dual backward)."""
    path = _conv_bn_path(dev, shapes)
    gen = torch.Generator(device=dev).manual_seed(22)
    cases = [(s, torch.bfloat16, (True, False) if i == 0 else (True,))
             for i, s in enumerate(shapes)]
    cases += [(r, torch.bfloat16, (True, False)) for r in ragged]
    cases += [(fp32, torch.float32, (True, False))]
    out = []
    launched = set()
    for (m, k, n), dt, relus in cases:
        x, w, bn, dy = _conv_bn_inputs(dev, gen, m, k, n, dt)
        name = f"M={m} K={k} N={n} {_dt(dt)}"
        bf16 = dt == torch.bfloat16
        absw = x.float().abs() @ w.float().abs()
        faults, errs = {}, {}
        sd = _conv_bn_design("stats", x, w)
        dd = _conv_bn_design("dual", x, w, dy)
        design = {"matmul_stats": STATS_DESIGNS[sd],
                  "bn_relu_matmul": STATS_DESIGNS[sd],
                  "matmul_bwd_dual": DUAL_DESIGNS[dd]}
        tc = {"matmul_stats": tc_kernel("stats", sd, n),
              "bn_relu_matmul": tc_kernel("bn", sd, n),
              "matmul_bwd_dual": tc_kernel("dual", dd, n)}
        launched.update(v for v in tc.values() if v is not None)
        # matmul_stats
        y, s, ss = matmul_stats(x, w)
        yp, sp, ssp = matmul_stats_ref(x, w)
        torch.cuda.synchronize()
        errs["matmul_stats"] = [_err(y, yp), _err(s, sp), _err(ss, ssp)]
        check(_out_ok(y, yp, absw), f"matmul_stats {name}: y {errs}")
        check(_stats_ok(s, ss, y, yp, sp, ssp),
              f"matmul_stats {name}: stats {errs}")
        if bf16:
            acc = x.float() @ w.float()
            bad_s, bad_ss = acc.sum(0), (acc * acc).sum(0)
            faults["stats_of_unrounded_values"] = _err(bad_s, sp)
            check(not _stats_ok(bad_s, bad_ss, y),
                  f"matmul_stats {name}: the check misses stats of the "
                  f"unrounded values")
            del acc
        if bf16:
            y2, s2, ss2 = matmul_stats(x, w)
            check(torch.equal(y, y2) and torch.equal(s, s2)
                  and torch.equal(ss, ss2),
                  f"matmul_stats {name}: two calls differ")
            del y2, s2, ss2
        if sd != PRESENT:
            for f, key, what in KERNEL_FAULTS:
                yf, sf, ssf = matmul_stats(x, w, _fault=f)
                torch.cuda.synchronize()
                faults[f"stats_kernel_{key}"] = _err(sf, sp)
                check(not (_out_ok(yf, yp, absw)
                           and _stats_ok(sf, ssf, yf, yp, sp, ssp)),
                      f"matmul_stats {name}: the check misses {what}")
                del yf, sf, ssf
        cut = m - 128
        _, bad_s, bad_ss = matmul_stats(x[:cut], w)
        faults["last_row_block_out_of_stats"] = _err(bad_s, sp)
        check(not _stats_ok(bad_s, bad_ss, y),
              f"matmul_stats {name}: the check misses the last row block "
              f"left out of the stats")
        # bn_relu_matmul
        for relu in relus:
            z, s2, ss2 = bn_relu_matmul(x, *bn, w, relu=relu)
            zp, s2p, ss2p = bn_relu_matmul_ref(x, *bn, w, relu=relu)
            torch.cuda.synchronize()
            a = _bn_lhs(x, bn, relu)
            a_absw = a.abs() @ w.float().abs()
            # the TPU kernel's rounding: the normalised operand in w's dtype
            zr = (a.to(w.dtype).float() @ w.float()).to(x.dtype)
            del a
            extra = 2.0 ** -8 * a_absw if bf16 else None
            key = f"bn_relu_matmul relu={relu}"
            errs[key] = [_err(z, zp), _err(s2, s2p), _err(ss2, ss2p)]
            errs[f"{key} vs rounded operand"] = [_err(z, zr)]
            check(_out_ok(z, zp, a_absw, extra), f"{key} {name}: {errs}")
            check(_out_ok(z, zr, a_absw),
                  f"{key} {name}: against the rounded operand {errs}")
            check(_stats_ok(s2, ss2, z, zp, s2p, ss2p),
                  f"{key} {name}: stats {errs}")
            if relu:
                bad = bn_relu_matmul(x, *bn, w, relu=False, with_stats=False)
                faults["relu_dropped"] = _err(bad, zp)
                check(not _out_ok(bad, zp, a_absw, extra),
                      f"{key} {name}: the check misses the ReLU dropped")
                mean, rstd, gamma, beta = bn
                beta_off = beta.clone()
                beta_off[-1] += 0.1
                bad = bn_relu_matmul(x, mean, rstd, gamma, beta_off, w,
                                     with_stats=False)
                faults["beta_off_at_last_k"] = _err(bad, zr)
                check(not _out_ok(bad, zr, a_absw),
                      f"{key} {name}: the check misses beta off by 0.1 at "
                      f"the last k")
                del bad, beta_off
            if bf16:
                z2, s22, ss22 = bn_relu_matmul(x, *bn, w, relu=relu)
                check(torch.equal(z, z2) and torch.equal(s2, s22)
                      and torch.equal(ss2, ss22),
                      f"{key} {name}: two calls differ")
                del z2, s22, ss22
            if sd != PRESENT and relu:
                for f, fkey, what in KERNEL_FAULTS + (BN_FAULT,):
                    zf, sf, ssf = bn_relu_matmul(x, *bn, w, relu=relu,
                                                 _fault=f)
                    torch.cuda.synchronize()
                    faults[f"bn_kernel_{fkey}"] = max(_err(zf, zr),
                                                      _err(sf, s2p))
                    caught = not (_out_ok(zf, zr, a_absw)
                                  and _stats_ok(sf, ssf, zf, zp, s2p, ss2p))
                    if f == BN_FAULT[0] and m % 128 == 0:
                        # no padded rows: the fault changes nothing here
                        faults[f"bn_kernel_{fkey}"] = "no padded rows"
                    else:
                        check(caught, f"{key} {name}: the check misses "
                              f"{what}")
                    del zf, sf, ssf
            del z, zp, zr, a_absw, extra
        # matmul_bwd_dual
        dx, dw = matmul_bwd_dual(x, dy, w)
        dxp, dwp = matmul_bwd_dual_ref(x, dy, w)
        torch.cuda.synchronize()
        dx_absw = dy.float().abs() @ w.float().abs().T
        dw_absw = x.float().abs().T @ dy.float().abs()
        errs["matmul_bwd_dual"] = [_err(dx, dxp), _err(dw, dwp)]
        check(_out_ok(dx, dxp, dx_absw) and _out_ok(dw, dwp, dw_absw),
              f"matmul_bwd_dual {name}: {errs}")
        _, bad_dw = matmul_bwd_dual(x[:cut], dy[:cut], w)
        faults["last_row_block_out_of_dw"] = _err(bad_dw, dwp)
        check(not _out_ok(bad_dw, dwp, dw_absw),
              f"matmul_bwd_dual {name}: the check misses the last row block "
              f"left out of dw")
        if bf16:
            dx2, dw2 = matmul_bwd_dual(x, dy, w)
            check(torch.equal(dx, dx2) and torch.equal(dw, dw2),
                  f"matmul_bwd_dual {name}: two calls differ")
            del dx2, dw2
        if dd != PRESENT:
            for f, key, what in KERNEL_FAULTS:
                dxf, dwf = matmul_bwd_dual(x, dy, w, _fault=f)
                torch.cuda.synchronize()
                faults[f"dual_kernel_{key}"] = max(_err(dxf, dxp),
                                                   _err(dwf, dwp))
                check(not (_out_ok(dxf, dxp, dx_absw)
                           and _out_ok(dwf, dwp, dw_absw)),
                      f"matmul_bwd_dual {name}: the check misses {what}")
                del dxf, dwf
        del dx_absw, dw_absw, bad_dw, absw
        torch.cuda.synchronize()
        # times: kernel, plain version, library chain
        relu = relus[0]

        def lib_stats():
            yl = torch.matmul(x, w)
            y32 = yl.float()
            return yl, y32.sum(0), (y32 * y32).sum(0)

        def lib_bn():
            a = _bn_lhs(x, bn, True).to(w.dtype)
            yl = torch.matmul(a, w)
            y32 = yl.float()
            return yl, y32.sum(0), (y32 * y32).sum(0)

        def lib_dual():
            return torch.matmul(dy, w.T), torch.matmul(x.T, dy)

        it = dict(iters=10, prof_iters=5)
        pit = dict(iters=3, prof_iters=2)
        t = {"matmul_stats": _merge(
                timings(lambda: matmul_stats(x, w), **it),
                timings(lambda: matmul_stats_ref(x, w), **pit),
                timings(lib_stats, **it)),
             "bn_relu_matmul": _merge(
                timings(lambda: bn_relu_matmul(x, *bn, w, relu=relu), **it),
                timings(lambda: bn_relu_matmul_ref(x, *bn, w, relu=relu),
                        **pit),
                timings(lib_bn, **it)),
             "matmul_bwd_dual": _merge(
                timings(lambda: matmul_bwd_dual(x, dy, w), **it),
                timings(lambda: matmul_bwd_dual_ref(x, dy, w), **pit),
                timings(lib_dual, **it))}
        (fb, fby), (fbb, fbby), (db, dby) = _conv_bn_bounds(m, k, n, x, w)
        bounds = {"matmul_stats": (fb, fby), "bn_relu_matmul": (fbb, fbby),
                  "matmul_bwd_dual": (db, dby)}
        case = {"case": name, "M": m, "K": k, "N": n, "dtype": _dt(dt),
                "errs": errs, "planted_fault_errs": faults}
        for kern in CONV_BN_KERNELS:
            # the outputs' error (y, or dx and dw); the stats' in errs
            mine = {key: e for key, e in errs.items()
                    if key.split()[0] == kern}
            row = {"case": name, "design": design[kern],
                   "tc_kernel": tc[kern], "max_abs_err": max(
                       e[0] if kern != "matmul_bwd_dual" else max(e)
                       for e in mine.values()), "errs": mine,
                   "tol": CONV_BN_TOL, **t[kern],
                   "bound_ms": bounds[kern][0], "bound_by": bounds[kern][1],
                   "library": CONV_BN_LIBRARY[kern]}
            case[kern] = row
            emit({"phase": "kernel", "kernel": kern, **row,
                  "planted_fault_errs": faults})
        out.append(case)
        del x, w, bn, dy, y, s, ss, yp, sp, ssp, dx, dw, dxp, dwp
        torch.cuda.empty_cache()
    missed = sorted(set(TC_KERNELS) - launched)
    check(not missed, f"conv_bn: no case launched the wgmma kernels {missed}")
    return path, out


def phase_xent_rn50(dev, v: int = 1000):
    """The fused cross-entropy at RN50's loss shapes, logits ~ 3 N(0, 1),
    no smoothing: (128, 1000) fp32 (the O2 paths) and (64, 1000) bf16
    (the ImageNet example's defaults: O1 autocast leaves the classifier's
    logits in bf16, at a vocabulary shorter than one 2048-wide tile);
    rows 4000 and 2000 bytes apart, the kernels' 16-byte vector path.
    Loss and lse within 2e-6 of max|want|, dlogits within 1e-5 of
    max|want| (fp32) or 1 bf16 ulp plus 1e-9 (bf16).  Planted fault: the
    last 8 classes left out of the lse.  Returns ``[(fwd, bwd)]`` in
    that order."""
    gen = torch.Generator(device=dev).manual_seed(23)
    cases = []
    for rows, dt in ((128, torch.float32), (64, torch.bfloat16)):
        logits = (3 * torch.randn(rows, v, device=dev, generator=gen)).to(dt)
        labels = torch.randint(0, v - 8, (rows,), device=dev, generator=gen)
        g = torch.rand(rows, device=dev, generator=gen)
        loss, lse = softmax_cross_entropy_fwd(logits, labels, 0.0)
        want_l, want_lse = softmax_cross_entropy_fwd_ref(logits, labels, 0.0)
        d = softmax_cross_entropy_bwd(logits, labels, lse, g, 0.0)
        want_d = softmax_cross_entropy_bwd_ref(logits, labels, lse, g, 0.0)
        bad_l, _ = softmax_cross_entropy_fwd(logits[:, :v - 8], labels, 0.0)
        torch.cuda.synchronize()
        errs = [_err(loss, want_l), _err(lse, want_lse), _err(d, want_d)]
        name = f"rows={rows} V={v} {_dt(dt)} smoothing=0.0"
        check(_close(loss, want_l, 2e-6) and _close(lse, want_lse, 2e-6),
              f"xent {name}: {errs}")
        bf16 = dt == torch.bfloat16
        d_ok = (bf16_ulp_ok(d, want_d, ulps=1, floor=1e-9) if bf16
                else _close(d, want_d, 1e-5))
        check(d_ok, f"xent dlogits {name}: {errs}")
        fault = _err(bad_l, want_l)
        check(not _close(bad_l, want_l, 2e-6),
              f"xent {name}: the check misses the last classes dropped")
        base = {"case": name, "rows": rows, "V": v, "dtype": _dt(dt),
                "smoothing": 0.0,
                "planted_fault_errs": {"last_8_classes_dropped": fault}}
        lg = logits.clone().requires_grad_()

        def ce_fwd_bwd():
            out = F.cross_entropy(lg, labels, reduction="none")
            torch.autograd.grad(out, lg, g)

        el = logits.element_size()
        bound, by = _bound(rows * v * el + rows * 16,
                           {FP32_FLOPS: 4 * rows * v})
        fwd = {**base, "max_abs_err": max(errs[:2]),
               "tol": "2e-6 of max|want|",
               **_merge(timings(lambda: softmax_cross_entropy_fwd(
                   logits, labels, 0.0)),
                   timings(lambda: softmax_cross_entropy_fwd_ref(
                       logits, labels, 0.0), iters=10),
                   timings(lambda: F.cross_entropy(logits, labels,
                                                   reduction="none"))),
               "bound_ms": bound, "bound_by": by,
               "library": "F.cross_entropy(reduction='none')"}
        emit({"phase": "kernel", "kernel": "softmax_xentropy_fwd", **fwd})
        bound, by = _bound(2 * rows * v * el + rows * 16,
                           {FP32_FLOPS: 4 * rows * v})
        bwd = {**base, "max_abs_err": errs[2],
               "tol": "1 bf16 ulp + 1e-9" if bf16 else "1e-5 of max|want|",
               **_merge(timings(lambda: softmax_cross_entropy_bwd(
                   logits, labels, lse, g, 0.0)),
                   timings(lambda: softmax_cross_entropy_bwd_ref(
                       logits, labels, lse, g, 0.0), iters=10),
                   timings(ce_fwd_bwd)),
               "bound_ms": bound, "bound_by": by,
               "library": "F.cross_entropy forward + backward"}
        emit({"phase": "kernel", "kernel": "softmax_xentropy_bwd", **bwd})
        cases.append((fwd, bwd))
    return cases


# -- phase 11: ResNet-50 ---------------------------------------------------------

RN50_GRADS = ("conv1.kernel", "stage3_block2.conv2.kernel",
              "stage2_block1.bn2.scale", "fc.kernel")


def _images(gen, b: int, hw: int, dev=None):
    x = torch.randn(b, hw, hw, 3, generator=gen, device=dev)
    y = torch.randint(0, 1000, (b,), generator=gen, device=dev)
    return x, y


def _resnet_grads(params, batch_stats, x, y, where, train, names, make,
                  conv_dtype=torch.float32):
    """(loss, logits, updated running statistics, the named gradients) of
    one fp32 forward and backward on ``where``; ``conv_dtype`` float64
    runs the convolutions in float64 (BatchNorm stays fp32)."""
    model = make(compute_dtype=conv_dtype)
    model.load_state_dict(params)
    model.to(where).to(conv_dtype)
    stats = {k: v.to(where) for k, v in batch_stats.items()}
    logits, new = model(x.to(where).to(conv_dtype), stats, train=train)
    loss = softmax_cross_entropy(logits.float(), y.to(where)).mean()
    ps = dict(model.named_parameters())
    gs = torch.autograd.grad(loss, [ps[n] for n in names])
    return (float(loss.detach()), logits.detach().float().cpu(),
            {k: v.cpu() for k, v in new.items()},
            [g.double().cpu() for g in gs])


def _rel_l2(got, want, names):
    return {n: float((a - b).norm() / b.norm())
            for n, a, b in zip(names, got, want)}


# fixed limits on the four gradients' relative L2 error, card against CPU,
# with BatchNorm in training mode and in eval mode: above the fp32 rounding
# floor (the CPU against the CPU with float64 convolutions) and below the
# TF32 control's readings (PERF.md, Findings PR 4); the classifier's is the
# 1e-3 the other models are held to
RN50_GRAD_LIMITS = {"train_bn": 3.5e-2, "eval_bn": 5e-3}
RN50_FC_LIMIT = 1e-3


def _parity_verdict(card, cpu, names):
    """The readings and the checks of one card run against the CPU:
    ``card`` and ``cpu`` map "train_bn"/"eval_bn" to ``_resnet_grads``'s
    output (the running statistics from the training run)."""
    (lc, zc, sc, _), (lw, zw, sw, _) = card["train_bn"], cpu["train_bn"]
    top = zw.abs().max().item()
    r = {"loss_cuda": lc, "loss_cpu": lw, "loss_abs_err": abs(lc - lw),
         "logits_max_abs_err": _err(zc, zw), "logits_max_abs": top,
         "running_stats_rel_err": max(
             _err(sc[k], w) / max(1.0, w.abs().max().item())
             for k, w in sw.items())}
    ok = {"loss": r["loss_abs_err"] <= 1e-4,
          "logits": r["logits_max_abs_err"] <= 1e-4 * top,
          "running_stats": r["running_stats_rel_err"] <= 1e-4}
    for mode, lim in RN50_GRAD_LIMITS.items():
        rel = _rel_l2(card[mode][3], cpu[mode][3], names)
        r[f"grad_rel_l2_{mode}"] = rel
        ok[f"grads_{mode}"] = all(
            rel[n] <= (RN50_FC_LIMIT if n == "fc.kernel" else lim)
            for n in names)
    return r, ok


def phase_resnet_parity(params, batch_stats, b: int = 2, hw: int = 224,
                        names=RN50_GRADS, devices=("cuda", "cpu"),
                        make=resnet50):
    """ResNet-50 at fp32 (O0, TF32 off), batch 2 x 224^2, card against the
    port on the CPU with the same weights and images.  Training mode: the
    logits within 1e-4 of the largest, the loss within 1e-4 and the
    updated running statistics within 1e-4 of max(1, |want|).  Four
    gradients (the stem, a 3x3 conv, a BN scale, the classifier), with
    BatchNorm in training mode and in eval mode (on the card's updated
    running statistics), each within the fixed ``RN50_GRAD_LIMITS`` of
    its mode (the classifier's within 1e-3) in relative L2 error.  At
    batch 2 fp32 rounding alone moves the training-mode gradients about
    2 % and the eval-mode stem's 3e-3, on either device; the phase reports
    that floor (the CPU against the CPU with float64 convolutions,
    BatchNorm's fp32 sums unchanged) beside the readings.  Control: the
    card run again with TF32 convolutions and products, which the checks
    must reject."""
    x, y = _images(torch.Generator().manual_seed(26), b, hw)
    a, c = devices

    def run(where, eval_stats=None, conv_dtype=torch.float32):
        train = _resnet_grads(params, batch_stats, x, y, where, True, names,
                              make, conv_dtype)
        ev = train[2] if eval_stats is None else eval_stats
        return {"train_bn": train,
                "eval_bn": _resnet_grads(params, ev, x, y, where, False,
                                         names, make, conv_dtype)}

    card = run(a)
    # eval mode on the card's updated statistics, the same on every side
    ev = card["train_bn"][2]
    cpu = run(c, ev)
    f64 = run(c, ev, torch.float64)
    readings, ok = _parity_verdict(card, cpu, names)
    fp32_precision(tf32=True)
    try:
        ctl_readings, ctl_ok = _parity_verdict(run(a, ev), cpu, names)
    finally:
        fp32_precision()
    emit({"phase": "resnet_parity", "model": "ResNet-50 fp32 O0",
          "batch": [b, hw, hw, 3], **readings,
          "grad_limits": {**RN50_GRAD_LIMITS, "fc.kernel": RN50_FC_LIMIT},
          **{f"grad_floor_rel_l2_{m}": _rel_l2(cpu[m][3], f64[m][3], names)
             for m in RN50_GRAD_LIMITS},
          "checks": ok, "tf32_control": ctl_readings,
          "tf32_control_checks": ctl_ok})
    check(all(ok.values()), f"resnet parity: {ok} {readings}")
    check(not all(ctl_ok.values()), f"resnet parity: the checks miss TF32 "
          f"on the card {ctl_readings}")


def _resnet_setup(dev, params, batch_stats, b, hw, make, ddp=None,
                  bn_group=None):
    """The O2 step of ``bench.py``'s RN50 configuration; with ``ddp`` its
    gradients are reduced (a planted inf goes in before), and with
    ``bn_group`` every BatchNorm syncs over that group."""
    amp_ = amp.initialize("O2")
    model = make(compute_dtype=amp_.policy.compute_dtype,
                 sync_batchnorm=bn_group is not None, bn_group=bn_group)
    model.load_state_dict(params)
    model.to(dev)
    opt = amp.AmpOptimizer(fused_sgd(0.1, momentum=0.9, weight_decay=1e-4),
                           amp_)
    masters = opt.attach(model)
    state = opt.init(masters)
    x, y = _images(torch.Generator(device=dev).manual_seed(27), b, hw, dev)
    stats = {k: v.to(dev) for k, v in batch_stats.items()}
    names, ps = zip(*model.named_parameters())

    def grads_of(carry):
        """This rank's scaled gradients, the loss, the new statistics."""
        masters, stats, state = carry
        logits, new_stats = model(x, stats, train=True)
        loss = softmax_cross_entropy(logits, y).mean()
        grads = dict(zip(names, torch.autograd.grad(
            amp_.scale_loss(loss, state.scaler[0]), ps)))
        return grads, loss, new_stats

    plant = {"inf": False}

    def step(carry, _batch):
        masters, stats, state = carry
        grads, loss, new_stats = grads_of(carry)
        if plant["inf"]:
            g = grads["fc.bias"].clone()
            g[0] = float("inf")
            grads["fc.bias"] = g
        if ddp is not None:
            grads = ddp.allreduce(grads)
        masters, state, st = opt.step(grads, state, masters, model=model)
        # the new batch statistics are kept on a skipped step too, as
        # bench.py's step keeps them
        return (masters, new_stats, state), {
            "loss": loss.detach(), "loss_scale": st.loss_scale,
            "skipped": st.found_inf.float()}

    return step, (masters, stats, state), plant, grads_of


def _clone_carry(carry) -> dict:
    """A copy of a ResNet carry's masters, statistics and momentum."""
    masters, stats, state = carry
    return {"masters": {n: t.clone() for n, t in masters.items()},
            "stats": {n: t.clone() for n, t in stats.items()},
            "momentum": {n: t.clone() for n, t in
                         state.opt_state.momentum_buf.items()}}


def phase_resnet_train(dev, params, batch_stats, b: int = 128,
                       hw: int = 224, k: int = 10, timed: int = 3,
                       make=resnet50):
    """O2 (bf16 convolutions, fp32 BatchNorm and masters, dynamic loss
    scale) ResNet-50 with fused_sgd(0.1, momentum 0.9, weight decay 1e-4)
    on one fixed seeded batch of 128 x 224^2 x 3 images and labels,
    FusedTrainDriver at K = 10 (bench.py's RN50 configuration): one warm
    window, then ``timed`` windows, the first with the launch counts set
    to 0 before it and read after it.  Then one step with an inf planted
    in a gradient, which must be skipped with the masters, the momentum
    buffers and the step count unchanged."""
    step, carry, plant, _ = _resnet_setup(dev, params, batch_stats, b, hw,
                                          make)
    driver = FusedTrainDriver(step, steps_per_dispatch=k,
                              metrics={"loss": "last", "loss_scale": "last",
                                       "skipped": "sum"},
                              per_step=("loss",))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    carry, res = driver.run_window(carry)
    warm = read_metrics(res)
    warm_s = time.perf_counter() - t0
    # the first window, which phase_ddp_resnet must match bit for bit
    first_window = {"losses": warm.per_step["loss"], **_clone_carry(carry)}
    walls, windows, counted = [], [], None
    for i in range(timed):
        torch.cuda.synchronize()
        if i == 0:
            reset_launch_counts()
        t0 = time.perf_counter()
        carry, res = driver.run_window(carry)
        host = read_metrics(res)  # the window's one host read
        walls.append(time.perf_counter() - t0)
        windows.append(host)
        if i == 0:
            counted = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = sorted(walls)[len(walls) // 2]
    per_step = {n: 0 for n in counted}
    per_step.update({"softmax_xentropy_fwd": 1, "softmax_xentropy_bwd": 1})
    first, last = warm.per_step["loss"][0], windows[-1].metrics["loss"]
    losses = warm.per_step["loss"] + sum((w.per_step["loss"]
                                          for w in windows), [])
    rates = sorted(b * k / w for w in walls)
    emit({"phase": "resnet_train", "model": "ResNet-50 O2 (bf16 convs, fp32 "
          "BN and masters, dynamic loss scale), fused_sgd(0.1, momentum "
          "0.9, wd 1e-4)", "batch": [b, hw, hw, 3], "steps_per_window": k,
          "warm_window_s": warm_s, "window_walls_s": walls,
          "median_window_s": med, "images_per_s": b * k / med,
          "images_per_s_windows": rates,
          "loss_first_step": first, "loss_last_window": last,
          "losses_per_step": losses,
          "loss_scale": windows[-1].metrics["loss_scale"],
          "skipped_steps": warm.metrics["skipped"]
          + sum(w.metrics["skipped"] for w in windows),
          "max_memory_allocated_bytes": peak,
          "launches_one_window": counted,
          "launches_per_step_expected": per_step})
    check(all(math.isfinite(x) for x in losses), "resnet: non-finite loss")
    check(last < first, f"resnet: loss did not fall ({first} -> {last})")
    check(counted == {n: k * c for n, c in per_step.items()},
          f"resnet: launch counts {counted} != K x {per_step}")
    masters, stats, state = carry
    before = {n: t.clone() for n, t in masters.items()}
    buf_before = {n: t.clone() for n, t in state.opt_state.momentum_buf
                  .items()}
    step_before = int(state.opt_state.step)
    scale_before = float(state.scaler[0].loss_scale)
    plant["inf"] = True
    carry, m = step(carry, None)
    plant["inf"] = False
    masters, stats, state = carry
    torch.cuda.synchronize()
    same = (all(torch.equal(masters[n], before[n]) for n in before)
            and all(torch.equal(state.opt_state.momentum_buf[n],
                                buf_before[n]) for n in buf_before)
            and int(state.opt_state.step) == step_before)
    scaler = state.scaler[0]
    emit({"phase": "resnet_overflow", "skipped": bool(m["skipped"]),
          "state_unchanged": same, "sgd_step": int(state.opt_state.step),
          "scale_before": scale_before,
          "scale_after": float(scaler.loss_scale),
          "unskipped_after": int(scaler.unskipped),
          "overflows": int(scaler.overflows)})
    check(bool(m["skipped"]) and same, "resnet: the overflow step was not "
          "skipped cleanly")
    check(float(scaler.loss_scale) == scale_before / 2
          and int(scaler.unskipped) == 0,
          "resnet: the overflow did not halve the scale and reset unskipped")
    del before, buf_before
    first_window["images_per_s"] = b * k / med
    return counted, step, carry, first_window


# -- phase 11b: data parallelism (DDP + cross-process SyncBatchNorm) ----------

def _tensors_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(_bitwise(a[n], b[n]) for n in a)


def phase_ddp_resnet(dev, params, batch_stats, first_window,
                     b: int = 128, hw: int = 224, k: int = 10,
                     timed: int = 2, make=resnet50):
    """``resnet_train``'s set-up with ``sync_batchnorm=True`` over the
    world group and ``DistributedDataParallel()`` (the JAX example's
    defaults), in an NCCL group of one process (one card: world 1).  Its
    first window must be ``resnet_train``'s first window bit for bit:
    the per-step losses, the masters, the momentum buffers and the batch
    statistics (at world 1 each all-reduce sums one operand and the
    average divides by 1.0).  Each step must make exactly one all-reduce
    a BatchNorm forward and one backward and one a gradient dtype, and
    the cross-entropy kernels' launches are counted for the summary.
    Then ``timed`` windows (images/s beside ``resnet_train``'s), one
    profiled step (busy share, the NCCL kernels' device ms), the device
    ms of one ``ddp.allreduce`` of the step's gradients by kernel (the
    all-reduces and the flat copies) and a planted inf, which must be
    skipped."""
    group_ok = init_distributed(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout_s=120)
    check(group_ok and dist.get_backend() == "nccl",
          "ddp_resnet: no NCCL group")
    try:
        return _ddp_resnet(dev, params, batch_stats, first_window, b, hw, k,
                           timed, make)
    finally:
        dist.destroy_process_group()


def _ddp_resnet(dev, params, batch_stats, first_window, b, hw, k, timed,
                make):
    ddp = DistributedDataParallel()
    step, carry, plant, grads_of = _resnet_setup(
        dev, params, batch_stats, b, hw, make, ddp=ddp,
        bn_group=data_parallel_group())
    driver = FusedTrainDriver(step, steps_per_dispatch=k,
                              metrics={"loss": "last", "loss_scale": "last",
                                       "skipped": "sum"},
                              per_step=("loss",))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    reset_collective_counts()
    carry, res = driver.run_window(carry)
    host = read_metrics(res)
    launches, colls = launch_counts(), collective_counts()
    mine = {"losses": host.per_step["loss"], **_clone_carry(carry)}
    bitwise = {"losses": mine["losses"] == first_window["losses"],
               **{part: _tensors_equal(mine[part], first_window[part])
                  for part in ("masters", "momentum", "stats")}}
    differing = {part: sum(_differing(mine[part][n], first_window[part][n])
                           for n in mine[part])
                 for part in ("masters", "momentum", "stats")}
    del mine
    walls = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, res = driver.run_window(carry)
        read_metrics(res)
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    med = sorted(walls)[len(walls) // 2]
    prof = phase_step_profile(step, carry, "ddp_resnet_profile",
                              "one O2 step, ResNet-50, batch 128 x 224^2, "
                              "DDP + SyncBN, NCCL at world 1",
                              kernel_groups={"nccl": "nccl"})
    # one step's local gradients: their dtypes, and one reduction of
    # them by kernel (the NCCL all-reduces, and the flat copies and
    # divisions around them)
    grads = grads_of(carry)[0]
    grad_dtypes = sorted({str(g.dtype) for g in grads.values()})
    by_kernel = device_ms_by_kernel(lambda: ddp.allreduce(grads))
    del grads
    n_bn = sum(n.endswith(".scale") for n in carry[0])
    per_step = {"sync_bn_fwd": n_bn, "sync_bn_bwd": n_bn,
                "ddp": len(grad_dtypes)}
    allreduce_ms = sum(v for n, v in by_kernel.items() if "nccl" in n)
    copies_ms = sum(v for n, v in by_kernel.items() if "nccl" not in n)
    emit({"phase": "ddp_resnet", "world_size": 1, "backend": "nccl",
          "model": "ResNet-50 O2, sync_batchnorm over the world group, "
          "DistributedDataParallel(), fused_sgd(0.1, momentum 0.9, wd 1e-4)",
          "batch": [b, hw, hw, 3], "steps_per_window": k,
          "first_window_bitwise": bitwise, "differing_elements": differing,
          "grad_dtypes": grad_dtypes,
          "collectives_one_window": colls,
          "collectives_per_step_expected": per_step,
          "launches_one_window": launches,
          "window_walls_s": walls, "images_per_s": b * k / med,
          "resnet_train_images_per_s": first_window["images_per_s"],
          "device_busy_share": prof["device_busy_share"],
          "nccl_device_ms_one_step": prof["nccl_device_ms"],
          "nccl_kernels_one_step": prof["nccl_calls"],
          "ddp_allreduce_ms_by_kernel": by_kernel,
          "ddp_allreduce_nccl_ms": allreduce_ms,
          "ddp_allreduce_copies_ms": copies_ms,
          "max_memory_allocated_bytes": peak})
    check(all(bitwise.values()), f"ddp_resnet: the first window is not "
          f"resnet_train's bit for bit: {bitwise} {differing}")
    check(grad_dtypes == ["torch.bfloat16", "torch.float32"],
          f"ddp_resnet: O2 gradient dtypes {grad_dtypes}")
    check(colls == {n: k * c for n, c in per_step.items()},
          f"ddp_resnet: collectives {colls} != K x {per_step}")
    xent = {"softmax_xentropy_fwd": k, "softmax_xentropy_bwd": k}
    check(all(launches[n] == (xent.get(n, 0)) for n in launches),
          f"ddp_resnet: launches {launches} != {xent}")
    # a planted inf in one rank's gradients, before the all-reduce
    masters, _, state = carry
    before = {n: t.clone() for n, t in masters.items()}
    buf_before = {n: t.clone() for n, t in
                  state.opt_state.momentum_buf.items()}
    scale_before = float(state.scaler[0].loss_scale)
    plant["inf"] = True
    carry, m = step(carry, None)
    plant["inf"] = False
    masters, _, state = carry
    same = (_tensors_equal(masters, before)
            and _tensors_equal(state.opt_state.momentum_buf, buf_before))
    emit({"phase": "ddp_resnet_overflow", "world_size": 1,
          "skipped": bool(m["skipped"]), "state_unchanged": same,
          "scale_before": scale_before,
          "scale_after": float(state.scaler[0].loss_scale)})
    check(bool(m["skipped"]) and same
          and float(state.scaler[0].loss_scale) == scale_before / 2,
          "ddp_resnet: the planted inf was not skipped cleanly")
    return launches


GLOO_WORLD = 2
GLOO_IMAGES = 64
GLOO_HW = 224
GLOO_STEPS = 3
GLOO_TIMEOUT_S = 300


def _gloo_setup(seed: int = 24):
    """ResNet-50's seeded fp32 weights and statistics and the 64 images
    the two-process phase shares (on the CPU, the same in every rank)."""
    with torch.device("meta"):
        shapes = resnet50()
    params, stats = init_resnet_params(shapes, torch.Generator()
                                       .manual_seed(seed))
    x, y = _images(torch.Generator().manual_seed(28), GLOO_IMAGES, GLOO_HW)
    return params, stats, x, y


def _rel_l2_max(got: dict, want: dict) -> float:
    return max(float((got[n].double() - w.double()).norm()
                     / w.double().norm().clamp_min(1e-30))
               for n, w in want.items())


def _digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for t in tensors.values():
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def _local_sums(group):
    """The planted fault's BatchNorm sync: the all-reduce made on a copy,
    this rank's own sums kept."""
    from apex_tpu_torch.parallel import all_reduce

    def sync(t, tag):
        all_reduce(t.clone(), group, tag=tag)
        return t

    return sync


def _gloo_steps(dev, rank: int, local_stats: bool) -> dict:
    """GLOO_STEPS fp32 (O0, TF32 off) SGD steps of ResNet-50 in this
    gang against world 1: one process's model on all 64 images,
    BatchNorm over them, no DDP, computed in every rank alike
    (deterministic cuDNN).  Each step starts from world 1's state
    (masters, momentum, scaler, statistics) and takes three steps: the
    gang's (DDP + SyncBN on this rank's 32 images), world 1's on the 64
    images in another order (the halves swapped: the floor, how far
    rounding alone moves world 1), and world 1's own, which goes on.
    From random weights at lr 0.1 a step's rounding differences grow to
    a different trajectory within two steps, so each step is held
    against world 1 alone.  ``local_stats`` (the planted fault) makes
    this rank's BatchNorms make their all-reduce on a copy and keep
    their own sums."""
    from apex_tpu_torch.multi_tensor import tree_map

    params, stats, x, y = _gloo_setup()
    n = GLOO_IMAGES // GLOO_WORLD
    rows = slice(rank * n, (rank + 1) * n)
    swap = torch.cat([torch.arange(n, GLOO_IMAGES), torch.arange(0, n)])
    amp_ = amp.initialize("O0")
    opt = amp.AmpOptimizer(fused_sgd(0.1, momentum=0.9, weight_decay=1e-4),
                           amp_)
    ref_model = resnet50()
    gang_model = resnet50(sync_batchnorm=True, bn_group=data_parallel_group())
    for model in (ref_model, gang_model):
        model.load_state_dict(params)
        model.to(dev)
    if local_stats:
        for mod in gang_model.modules():
            if isinstance(mod, SyncBatchNorm):
                mod._sync = lambda g=mod.group: _local_sums(g)
    masters = opt.attach(ref_model)
    opt.attach(gang_model)
    state = opt.init(masters)
    st = {k: v.to(dev) for k, v in stats.items()}
    x, y = x.to(dev), y.to(dev)
    ddp, mean = DistributedDataParallel(), Reducer(average=True)

    def one_step(model, xb, yb, reduce, copy):
        """One step of ``model`` from world 1's current state (a copy of
        it with ``copy``): loss, masters, statistics."""
        m, s_, stt = masters, state, st
        if copy:
            m, s_ = {k: v.clone() for k, v in m.items()}, tree_map(
                torch.clone, s_)
        opt.copy_to_model(model, m)
        names, ps = zip(*model.named_parameters())
        logits, stt = model(xb, stt, train=True)
        loss = softmax_cross_entropy(logits, yb).mean()
        grads = dict(zip(names, torch.autograd.grad(loss, ps)))
        if reduce:
            grads = ddp.allreduce(grads)
            loss = mean.reduce(loss.detach())
        m, s_, _ = opt.step(grads, s_, m, model=model)
        return float(loss.detach()), m, s_, stt

    steps = []
    for _ in range(GLOO_STEPS):
        g_loss, g_masters, _, g_st = one_step(gang_model, x[rows], y[rows],
                                              True, True)
        f_loss, f_masters, _, f_st = one_step(ref_model, x[swap], y[swap],
                                              False, True)
        loss, masters, state, st = one_step(ref_model, x, y, False, False)
        steps.append({
            "loss": g_loss, "world1_loss": loss,
            "loss_rel_err": abs(g_loss - loss) / abs(loss),
            "masters_max_rel_l2": _rel_l2_max(g_masters, masters),
            "stats_max_rel_l2": _rel_l2_max(g_st, st),
            "floor": {"loss_rel_err": abs(f_loss - loss) / abs(loss),
                      "masters_max_rel_l2": _rel_l2_max(f_masters, masters),
                      "stats_max_rel_l2": _rel_l2_max(f_st, st)},
            "masters_sha256": _digest(g_masters),
            "world1_sha256": _digest(masters)})
    return {"steps": steps, "ok": all(_gloo_ok(s) for s in steps)}


def _gloo_ok(step: dict) -> bool:
    """A step within the gate: the loss within 1e-4 relative of world
    1's and every statistic within 1e-3 relative L2 (forward quantities,
    rounding alone moves them about 1e-6); every master within 1e-3
    relative L2, or within twice the floor where rounding alone moves a
    master further (BatchNorm biases: their gradients cancel)."""
    return (step["loss_rel_err"] <= 1e-4 and step["stats_max_rel_l2"] <= 1e-3
            and step["masters_max_rel_l2"]
            <= max(1e-3, 2 * step["floor"]["masters_max_rel_l2"]))


def gloo_worker(out_dir: str) -> int:
    """One rank of ``ddp_gloo_card`` (``chip_smoke.py --gloo-worker DIR``,
    spawned by :func:`phase_ddp_gloo_card`): gloo on CUDA tensors, both
    ranks on the one card (the device named in DIR/device.json); the run
    and the planted fault (rank 1's BatchNorms on local statistics), each
    held against world 1; writes the readings to DIR/rank<r>.json."""
    fp32_precision()
    # world 1 is computed in each rank: the same bits in both
    torch.backends.cudnn.deterministic = True
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=GLOO_TIMEOUT_S)
    try:
        rank = dist.get_rank()
        with open(os.path.join(out_dir, "device.json")) as fh:
            dev = torch.device(json.load(fh))
        out = {"ddp": _gloo_steps(dev, rank, False),
               "fault_local_stats": _gloo_steps(dev, rank, rank == 1)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()
    return 0


def phase_ddp_gloo_card(dev):
    """Two processes on the one card, gloo on CUDA tensors (NCCL takes
    one rank a card): ResNet-50 at O0 fp32, DDP + SyncBN, 32 images a
    rank, 3 SGD steps, each against world 1 (one process, the same 64
    images, no DDP) from the same state (:func:`_gloo_steps`,
    :func:`_gloo_ok`): the mean of the ranks' losses within 1e-4
    relative, every statistic within 1e-3 relative L2, every master
    within 1e-3 relative L2 or twice world 1's own rounding floor, both
    ranks' masters (and their world 1) bit for bit the same.  Planted faults: rank 1's BatchNorms keeping their local
    statistics must fail that check, and a gang with a rank that raises
    must fail with that rank's stderr tail."""
    out_dir = tempfile.mkdtemp(prefix="apex_gloo_card_")
    try:
        with open(os.path.join(out_dir, "device.json"), "w") as fh:
            json.dump(str(dev), fh)
        t0 = time.perf_counter()
        launch([os.path.abspath(__file__), "--gloo-worker", out_dir],
               GLOO_WORLD, timeout_s=GLOO_TIMEOUT_S, echo_stderr=False,
               check=True)
        gang_s = time.perf_counter() - t0
        ranks = []
        for r in range(GLOO_WORLD):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    code = ("import os, time\n"
            "if os.environ['RANK'] == '1':\n"
            "    raise RuntimeError('planted: rank 1 died')\n"
            "time.sleep(60)\n")
    try:
        launch(["-c", code], GLOO_WORLD, timeout_s=60, echo_stderr=False,
               check=True)
        dead_rank = None
    except MultiprocError as err:
        dead_rank = {"guilty_ranks": err.guilty_ranks(),
                     "stderr_tail_names_it": "planted: rank 1 died"
                     in str(err)}
    good = [rk["ddp"] for rk in ranks]
    fault = [rk["fault_local_stats"] for rk in ranks]
    same = all(len({g["steps"][i][k] for g in good}) == 1
               for i in range(GLOO_STEPS)
               for k in ("masters_sha256", "world1_sha256"))
    emit({"phase": "ddp_gloo_card", "world_size": GLOO_WORLD,
          "backend": "gloo (CUDA tensors, both ranks on one card)",
          "model": "ResNet-50 O0 fp32 (TF32 off), DDP + SyncBN, "
          "fused_sgd(0.1, momentum 0.9, wd 1e-4)",
          "images_per_rank": GLOO_IMAGES // GLOO_WORLD,
          "steps": GLOO_STEPS, "gang_s": gang_s, "ranks": good,
          "ranks_masters_identical": same,
          "tol": "each step from world 1's state: the loss 1e-4 "
          "relative; statistics 1e-3 relative L2 each; masters 1e-3 "
          "relative L2 each, or twice the floor (world 1 on the images "
          "reordered) where that is larger",
          "planted_fault_local_stats": fault,
          "planted_dead_rank": dead_rank})
    check(all(g["ok"] for g in good), f"ddp_gloo_card: two ranks are not "
          f"world 1's steps: {good}")
    check(same, "ddp_gloo_card: the ranks' masters differ")
    check(not any(f["ok"] for f in fault), "ddp_gloo_card: the check "
          "misses a rank on local BatchNorm statistics")
    check(dead_rank == {"guilty_ranks": [1], "stderr_tail_names_it": True},
          f"ddp_gloo_card: a dead rank was not surfaced: {dead_rank}")


# -- phase 12: the dq-accumulating flash backward ------------------------------

def _bitwise(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int16 if a.element_size() == 2 else torch.int32),
        b.view(torch.int16 if b.element_size() == 2 else torch.int32))


def _differing(a, b) -> int:
    """Elements whose bits differ."""
    iv = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(iv) != b.view(iv)).sum())


def _peak_bytes(fn) -> int:
    """Device memory that one ``fn()`` takes above what was allocated
    before it, at its peak (its outputs and scratch)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def _probs_close(got, want):
    """The tolerance of a ``probs_bf16`` kernel against its plain version
    (bf16): every element within 2 bf16 ulps of the larger magnitude plus
    1e-3 of max|want|, and at most 2 % of the elements different at all.
    The two sum in other orders, so now and then a probability rounds to
    the neighbouring bf16 value; leaving the rounding out moves about a
    third of the elements.  Returns (ok, max error, fraction differing)."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    tol = 2 * ulp + 1e-3 * w.abs().max()
    frac = float((g != w).float().mean())
    ok = bool(((g - w).abs() <= tol).all()) and frac <= 0.02
    return ok, _err(got, want), frac


PROBS_TOL = ("2 bf16 ulps + 1e-3 of max|want|, <= 2 % of the elements "
             "different")


def _qkv(dev, gen, bh, sq, sk, dt, q_scale=2.0, kv_scale=1.0, d=64):
    q = (q_scale * torch.randn(bh, sq, d, device=dev, generator=gen)).to(dt)
    k = (kv_scale * torch.randn(bh, sk, d, device=dev, generator=gen)).to(dt)
    v = (kv_scale * torch.randn(bh, sk, d, device=dev, generator=gen)).to(dt)
    do = (kv_scale * torch.randn(bh, sq, d, device=dev,
                                 generator=gen)).to(dt)
    return q, k, v, do


# (name, B, H, Sq, Sk, causal, dtype, dropout, bias, probs_bf16, timed)
ACC_CASES = (
    ("GPT-2 medium", 8, 16, 1024, 1024, True, torch.bfloat16, 0.1, None,
     True, True),
    ("GPT-2 small", 16, 12, 1024, 1024, True, torch.bfloat16, 0.1, None,
     False, True),
    ("BERT-large padding bias", 12, 16, 512, 512, False, torch.bfloat16, 0.1,
     "padding", False, True),
    ("fp32 causal", 4, 12, 1024, 1024, True, torch.float32, 0.1, None, False,
     False),
    ("fp32 full bias", 2, 12, 384, 384, False, torch.float32, 0.0, "full",
     False, False),
    ("ragged Sq != Sk", 2, 12, 300, 450, False, torch.bfloat16, 0.1, None,
     False, False),
    ("nq = 1", 2, 12, 50, 300, False, torch.bfloat16, 0.1, None, False,
     False),
    ("nk = 1", 2, 12, 300, 40, False, torch.float32, 0.1, None, False,
     False),
    ("causal nk > nq", 2, 12, 100, 300, True, torch.bfloat16, 0.0, None,
     False, False),
    ("nq = nk = 1", 3, 4, 64, 64, True, torch.bfloat16, 0.1, None, False,
     False),
)


def phase_flash_acc(dev, cases=ACC_CASES, repeats: int = 5):
    """The dq-accumulating backward (``flash_attention_bwd_acc``) against
    the partials backward (``flash_attention_bwd``): dq, dk and dv equal
    bit for bit on each of ``repeats`` runs (a race in the turn protocol
    would show as a run that differs), and both against the plain version
    within row 7's tolerances (1e-5 of max|want| at fp32,
    :data:`SPLIT_TOL` at bf16; with ``probs_bf16``, :data:`PROBS_TOL`).  The GPT-2
    medium case hands the kernel a NaN-poisoned running buffer, and the
    check must reject two planted faults of the kernel: key tile 1's
    contribution dropped and the contributions added in reverse key
    order.  The timed cases report device ms of both kernels, the plain
    version and SDPA forward + backward (row 7's yardstick), row 7's
    bound, and the device memory one backward takes under each."""
    gen = torch.Generator(device=dev).manual_seed(40)
    seed_int = 246813579
    out = {}
    for (name, b, h, sq, sk, causal, dt, rate, bias_kind, probs,
         timed) in cases:
        bh = b * h
        q, k, v, do = _qkv(dev, gen, bh, sq, sk, dt)
        bias = None
        if bias_kind == "padding":
            bias = _padding_mask(dev, gen, b, sk)[0].expand(b, sq, sk)
        elif bias_kind == "full":
            bias = torch.randn(b, sq, sk, device=dev, generator=gen)
        args = (_pack_seed(seed_int, device=dev), 64 ** -0.5, causal, rate,
                (h, h))
        o, lse = flash_attention_fwd(q, k, v, *args, bias=bias,
                                     probs_bf16=probs)
        part = flash_attention_bwd(q, k, v, o, lse, do, *args, bias=bias,
                                   probs_bf16=probs, dq_acc=False)[:3]
        runs_equal = []
        for _ in range(repeats):
            acc = flash_attention_bwd_acc(q, k, v, o, lse, do, *args,
                                          bias=bias, probs_bf16=probs)[:3]
            torch.cuda.synchronize()
            runs_equal.append(all(_bitwise(a, p) for a, p in zip(acc, part)))
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args, bias=bias,
                                       probs_bf16=probs)[:3]
        torch.cuda.synchronize()
        label = (f"{name}: B={b} H={h} Sq={sq} Sk={sk} causal={causal} "
                 f"{_dt(dt)} dropout={rate} bias={bias_kind} "
                 f"probs_bf16={probs}")
        errs = [_err(a, w) for a, w in zip(acc, want)]
        check(all(runs_equal), f"flash acc {label}: not bit for bit the "
              f"partials backward on every run {runs_equal}")
        if probs and dt == torch.bfloat16:
            tol = PROBS_TOL
            ok = all(_probs_close(a, w)[0] for a, w in zip(acc, want))
        elif dt == torch.bfloat16:
            tol = SPLIT_TOL
            ok = all(_split_close(a, w) for a, w in zip(acc, want))
        else:
            tol = "1e-5 of max|want|"
            ok = all(_close(a, w, 1e-5) for a, w in zip(acc, want))
        check(ok, f"flash acc {label} vs the plain version: {errs}")
        rec = {"case": label, "design": FLASH_DESIGN[dt],
               "repeats_bitwise_equal": runs_equal,
               "max_abs_err": max(errs), "errs_dq_dk_dv": errs, "tol": tol,
               "frac_differing_dq_dk_dv": [_frac_differing(a, w)
                                           for a, w in zip(acc, want)]}
        if name == "GPT-2 medium":
            # a NaN-poisoned running buffer: the first contributor of each
            # query tile must write it, not read it
            floats = (bh * ((sq + 63) // 64)) * 64 * q.shape[2]
            poison = torch.full((floats,), float("nan"), device=dev)
            got = flash_attention_bwd_acc(q, k, v, o, lse, do, *args,
                                          probs_bf16=probs, _run=poison)[:3]
            torch.cuda.synchronize()
            check(all(_bitwise(a, p) for a, p in zip(got, part)),
                  f"flash acc {label}: a NaN-poisoned running buffer "
                  f"changed the result")
            rec["nan_poisoned_running_buffer_bitwise_equal"] = True
            del poison, got
            faults = {}
            for fault, what in ((1, "key_tile_1_dropped"),
                                (2, "reverse_key_order")):
                bad = flash_attention_bwd_acc(q, k, v, o, lse, do, *args,
                                              probs_bf16=probs,
                                              _fault=fault)[:3]
                torch.cuda.synchronize()
                faults[what + "_dq_elements_differing"] = _differing(
                    bad[0], part[0])
                check(not all(_bitwise(a, p) for a, p in zip(bad, part)),
                      f"flash acc {label}: the bitwise check misses the "
                      f"planted fault {what}")
                del bad
            rec["planted_fault_errs"] = faults
        if timed:
            kern = timings(lambda: flash_attention_bwd_acc(
                q, k, v, o, lse, do, *args, bias=bias, probs_bf16=probs),
                iters=10)
            kern_part = timings(lambda: flash_attention_bwd(
                q, k, v, o, lse, do, *args, bias=bias, probs_bf16=probs,
                dq_acc=False), iters=10)
            plain = timings(lambda: flash_attention_bwd_ref(
                q, k, v, o, lse, do, *args, bias=bias, probs_bf16=probs),
                iters=3, prof_iters=3)
            q4, k4, v4 = (t.reshape(b, h, -1, 64).detach().requires_grad_()
                          for t in (q, k, v))
            do4 = do.reshape(b, h, sq, 64)
            mask4 = None if bias is None else bias[:, None].to(dt)

            def sdpa_fwd_bwd():
                res = F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask4, is_causal=causal)
                torch.autograd.grad(res, (q4, k4, v4), do4)

            lib = timings(sdpa_fwd_bwd, iters=10)
            bound, by = _flash_bound(q, k, bias, backward=True,
                                     causal=causal, probs_bf16=probs)
            tiles = int(_flash_lib_tiles(sq, sk, causal))
            rec.update({
                **_merge(kern, plain, lib),
                "partials_ms": kern_part["ms"],
                "partials_events_ms": kern_part["events_ms"],
                "ms_by_kernel": device_ms_by_kernel(
                    lambda: flash_attention_bwd_acc(
                        q, k, v, o, lse, do, *args, bias=bias,
                        probs_bf16=probs)),
                "acc_over_partials": kern["ms"] / kern_part["ms"],
                "bound_ms": bound, "bound_by": by,
                "bound_of": "row 7's: the products of bf16 values at the "
                            "bf16 rate, the fp32 ones at the fp32 rate",
                "library": "F.scaled_dot_product_attention forward + "
                           "backward" + ("" if bias is None else
                                         " with the bf16 mask")
                           + ", no dropout",
                "peak_bytes_acc": _peak_bytes(lambda: flash_attention_bwd_acc(
                    q, k, v, o, lse, do, *args, bias=bias,
                    probs_bf16=probs)),
                "peak_bytes_partials": _peak_bytes(
                    lambda: flash_attention_bwd(
                        q, k, v, o, lse, do, *args, bias=bias,
                        probs_bf16=probs, dq_acc=False)),
                "scratch_bytes_acc": bh * ((sq + 63) // 64) * 64 * 64 * 4
                + (bh * ((sq + 63) // 64) + 1) * 4,
                "scratch_bytes_partials": bh * tiles * 64 * 64 * 4,
                "blocks_per_sm_acc_partials": [
                    _flash_tc_info(2, 64, probs)["blocks_per_sm"],
                    _flash_tc_info(1, 64, probs)["blocks_per_sm"]]
                if dt == torch.bfloat16 else None})
            del q4, k4, v4, do4, mask4
        emit({"phase": "flash_acc", **rec})
        out[name] = rec
        del q, k, v, do, o, lse, part, acc, want, bias
        torch.cuda.empty_cache()
    return out


def _flash_tc_info(kernel: int, d: int, probs: bool = False) -> dict:
    """A tensor-core flash kernel's resources (0: forward, 1: partials
    backward, 2: acc backward; the instantiation with ``probs_bf16`` when
    ``probs``) at head_dim d, as the CUDA runtime reports them for the
    built kernel: shared memory a block (static plus the dynamic size
    allowed), resident blocks per SM, registers and spilled bytes a
    thread."""
    import ctypes

    from apex_tpu_torch.ops.attention import _flash_lib

    out = (ctypes.c_int * 4)()
    err = _flash_lib().apex_flash_tc_info(kernel, d, int(probs),
                                          ctypes.addressof(out))
    check(err == 0, f"apex_flash_tc_info({kernel}, {d}, {probs}): CUDA "
          f"error {err}")
    return {"smem_bytes": out[0], "blocks_per_sm": out[1],
            "registers": out[2], "spill_bytes": out[3]}


def _flash_lib_tiles(sq, sk, causal) -> int:
    """Tiles of the partials buffer per batch*head (the kernel's own
    count)."""
    from apex_tpu_torch.ops.attention import _flash_lib

    return _flash_lib().apex_flash_dq_tiles(sq, sk, int(causal))


def phase_flash_probs_bf16(dev, medium=(8, 16, 1024), bert=(12, 16, 512)):
    """``probs_bf16`` in the forward, the partials backward and the
    dq-accumulating backward, against their plain versions
    (:data:`PROBS_TOL`) and against ``probs_bf16=False`` within the JAX
    package's contract (2e-2 forward, 5e-2 grads,
    ``tests/test_attention_probs_bf16.py``), at GPT-2 medium's causal
    shape and BERT-large's with its padding bias, bf16, dropout 0.1,
    q, k, v, dO ~ 0.5 N(0, 1) as that test draws them.  The planted fault:
    the kernels without the rounding against the plain versions with it
    must be rejected.  At fp32 (GPT-2 medium's shape) the option must be
    the identity: the three kernels' results equal those without it bit
    for bit."""
    gen = torch.Generator(device=dev).manual_seed(41)
    seed_int = 97531
    cases = {}
    for name, (b, h, s), causal, bias_kind in (
            ("GPT-2 medium", medium, True, None),
            ("BERT-large padding bias", bert, False, "padding")):
        bh = b * h
        dt = torch.bfloat16
        q, k, v, do = _qkv(dev, gen, bh, s, s, dt, 0.5, 0.5)
        bias = None
        if bias_kind:
            bias = _padding_mask(dev, gen, b, s)[0].expand(b, s, s)
        args = (_pack_seed(seed_int, device=dev), 64 ** -0.5, causal, 0.1,
                (h, h))
        kw = dict(bias=bias, probs_bf16=True)
        o, lse = flash_attention_fwd(q, k, v, *args, **kw)
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, *args, **kw)
        part = flash_attention_bwd(q, k, v, o, lse, do, *args, dq_acc=False,
                                   **kw)[:3]
        acc = flash_attention_bwd_acc(q, k, v, o, lse, do, *args, **kw)[:3]
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args, **kw)[:3]
        # probs_bf16=False, the JAX contract's other side
        o_off, lse_off = flash_attention_fwd(q, k, v, *args, bias=bias)
        g_off = flash_attention_bwd(q, k, v, o_off, lse_off, do, *args,
                                    bias=bias, dq_acc=False)[:3]
        torch.cuda.synchronize()
        label = f"{name}: B={b} H={h} S={s} causal={causal} bf16 dropout=0.1"
        res_o = _probs_close(o, o_ref)
        res_part = [_probs_close(a, w) for a, w in zip(part, want)]
        res_acc = [_probs_close(a, w) for a, w in zip(acc, want)]
        check(res_o[0] and _close(lse, lse_ref, 1e-5),
              f"probs_bf16 fwd {label}: {res_o}")
        check(all(r[0] for r in res_part), f"probs_bf16 partials bwd "
              f"{label}: {res_part}")
        check(all(r[0] for r in res_acc), f"probs_bf16 acc bwd {label}: "
              f"{res_acc}")
        check(all(_bitwise(a, p) for a, p in zip(acc, part)),
              f"probs_bf16 {label}: acc and partials backwards differ")
        vs_off = [_err(o, o_off)] + [_err(a, w) for a, w in zip(part, g_off)]
        check(vs_off[0] <= 2e-2 and max(vs_off[1:]) <= 5e-2,
              f"probs_bf16 {label}: beyond the JAX contract against "
              f"probs_bf16=False: {vs_off}")
        # planted fault: the rounding left out
        faults = {"rounding_left_out_fwd_frac": _probs_close(o_off, o_ref)[2],
                  "rounding_left_out_bwd_frac": min(
                      _probs_close(a, w)[2] for a, w in zip(g_off, want))}
        check(not _probs_close(o_off, o_ref)[0]
              and not any(_probs_close(a, w)[0] for a, w in zip(g_off, want)),
              f"probs_bf16 {label}: the check misses the rounding left out "
              f"{faults}")
        kern_f = timings(lambda: flash_attention_fwd(q, k, v, *args, **kw),
                         iters=20)
        plain_f = timings(lambda: flash_attention_fwd_ref(q, k, v, *args,
                                                          **kw),
                          iters=3, prof_iters=3)
        kern_b = timings(lambda: flash_attention_bwd(
            q, k, v, o, lse, do, *args, dq_acc=False, **kw), iters=10)
        kern_acc = timings(lambda: flash_attention_bwd_acc(
            q, k, v, o, lse, do, *args, **kw), iters=10)
        plain_b = timings(lambda: flash_attention_bwd_ref(
            q, k, v, o, lse, do, *args, **kw), iters=3, prof_iters=3)
        # the same kernels without the option, timed in the same run
        off_f = timings(lambda: flash_attention_fwd(q, k, v, *args,
                                                    bias=bias), iters=20)
        off_b = timings(lambda: flash_attention_bwd(
            q, k, v, o_off, lse_off, do, *args, bias=bias, dq_acc=False),
            iters=10)
        off_acc = timings(lambda: flash_attention_bwd_acc(
            q, k, v, o_off, lse_off, do, *args, bias=bias), iters=10)
        q4, k4, v4 = (t.reshape(b, h, s, 64).detach().requires_grad_()
                      for t in (q, k, v))
        mask4 = None if bias is None else bias[:, None].to(dt)
        lib_f = timings(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask4, is_causal=causal), iters=20)

        def sdpa_fwd_bwd():
            r = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask4,
                                               is_causal=causal)
            torch.autograd.grad(r, (q4, k4, v4), do.reshape(b, h, s, 64))

        lib_b = timings(sdpa_fwd_bwd, iters=10)
        fb, fby = _flash_bound(q, k, bias, backward=False, causal=causal,
                               probs_bf16=True)
        bb, bby = _flash_bound(q, k, bias, backward=True, causal=causal,
                               probs_bf16=True)
        base = {"case": label + " probs_bf16", "tol": PROBS_TOL,
                "bound_of": "all products of bf16 values at the bf16 rate",
                "planted_fault_errs": faults,
                "vs_probs_bf16_false_o_dq_dk_dv": vs_off,
                "jax_contract": "2e-2 forward, 5e-2 grads"}
        fwd = {**base, "max_abs_err": max(res_o[1], _err(lse, lse_ref)),
               "frac_differing": res_o[2], **_merge(kern_f, plain_f, lib_f),
               "ms_probs_bf16_false": off_f["ms"],
               "bound_ms": fb, "bound_by": fby,
               "library": "F.scaled_dot_product_attention, no dropout"}
        bwd = {**base, "max_abs_err": max(r[1] for r in res_part),
               "frac_differing_dq_dk_dv": [r[2] for r in res_part],
               **_merge(kern_b, plain_b, lib_b),
               "ms_probs_bf16_false": off_b["ms"], "bound_ms": bb,
               "bound_by": bby,
               "library": "F.scaled_dot_product_attention forward + "
                          "backward, no dropout"}
        acc_rec = {**bwd, "max_abs_err": max(r[1] for r in res_acc),
                   "frac_differing_dq_dk_dv": [r[2] for r in res_acc],
                   "ms": kern_acc["ms"], "events_ms": kern_acc["events_ms"],
                   "ms_source": kern_acc["ms_source"],
                   "ms_probs_bf16_false": off_acc["ms"],
                   "bitwise_equal_to_partials": True}
        for kernel, rec in (("flash_attention_fwd", fwd),
                            ("flash_attention_bwd", bwd),
                            ("flash_attention_bwd_acc", acc_rec)):
            emit({"phase": "flash_probs_bf16", "kernel": kernel, **rec})
        cases[name] = (fwd, bwd, acc_rec)
        del q, k, v, do, o, lse, o_ref, lse_ref, part, acc, want, o_off
        del g_off, q4, k4, v4, mask4
        torch.cuda.empty_cache()
    # fp32: the identity
    b, h, s = medium
    q, k, v, do = _qkv(dev, gen, b * h, s, s, torch.float32, 0.5, 0.5)
    args = (_pack_seed(seed_int, device=dev), 64 ** -0.5, True, 0.1, (h, h))
    same = []
    for probs in (False, True):
        o, lse = flash_attention_fwd(q, k, v, *args, probs_bf16=probs)
        same.append((o, lse) + flash_attention_bwd(
            q, k, v, o, lse, do, *args, probs_bf16=probs, dq_acc=False)[:3]
            + flash_attention_bwd_acc(q, k, v, o, lse, do, *args,
                                      probs_bf16=probs)[:3])
    torch.cuda.synchronize()
    eq = [_bitwise(a, b_) for a, b_ in zip(*same)]
    emit({"phase": "flash_probs_bf16", "case": f"fp32 B={b} H={h} S={s} "
          "causal dropout=0.1: probs_bf16 on == off",
          "bitwise_equal_o_lse_part_dq_dk_dv_acc_dq_dk_dv": eq})
    check(all(eq), f"probs_bf16 at fp32 is not the identity: {eq}")
    del q, k, v, do, same
    torch.cuda.empty_cache()
    return cases


def phase_dropout_heads(dev, b: int = 2, h: int = 16, s: int = 512,
                        group=(4, 8)):
    """``dropout_heads``: a call on the head group [4, 8) of 16 heads with
    ``dropout_heads=(16, 4)`` equals the same head slice of the whole
    call bit for bit, output and grads, through ``flash_attention`` with
    each backward (causal, bf16, dropout 0.1).  Planted fault: the group
    keyed on its local heads (no ``dropout_heads``) must differ."""
    gen = torch.Generator(device=dev).manual_seed(42)
    q, k, v, do = (t.reshape(b, h, s, 64) for t in _qkv(
        dev, gen, b * h, s, s, torch.bfloat16))
    lo, hi = group
    seed = torch.tensor(13579, dtype=torch.int32, device=dev)
    res = {}
    for dq_acc in (False, True):
        def run(qq, kk, vv, dd, heads):
            qq, kk, vv = (t.detach().requires_grad_() for t in (qq, kk, vv))
            o = flash_attention(qq, kk, vv, causal=True, dropout_rate=0.1,
                                dropout_seed=seed, dropout_heads=heads,
                                dq_acc=dq_acc)
            return (o,) + torch.autograd.grad(o, (qq, kk, vv), dd)

        whole = run(q, k, v, do, None)
        sl = lambda t: t[:, lo:hi].contiguous()  # noqa: E731
        part = run(sl(q), sl(k), sl(v), sl(do), (h, lo))
        local = run(sl(q), sl(k), sl(v), sl(do), None)
        torch.cuda.synchronize()
        eq = [_bitwise(p, sl(w)) for p, w in zip(part, whole)]
        fault = _differing(local[0], sl(whole[0]))
        res[f"dq_acc={dq_acc}"] = {"bitwise_equal_o_dq_dk_dv": eq,
                                   "local_heads_o_elements_differing": fault}
        check(all(eq), f"dropout_heads dq_acc={dq_acc}: the head group "
              f"differs from the whole call's slice {eq}")
        check(fault > 0, "dropout_heads: the check misses the mask keyed on "
              "local heads")
    emit({"phase": "kernel_check", "kernel": "flash_attention dropout_heads",
          "case": f"B={b} H={h} S={s} causal bf16 dropout=0.1, heads "
          f"[{lo}, {hi}) of {h}", **res})


# (name, B, H, Sq, Sk, causal, dropout, bias, probs_bf16, timed)
D128_CASES = (
    ("causal", 16, 8, 1024, 1024, True, 0.1, None, False, True),
    ("padding bias", 12, 8, 512, 512, False, 0.1, "padding", False, True),
    ("probs_bf16", 8, 8, 1024, 1024, True, 0.1, None, True, True),
    ("ragged Sq != Sk", 2, 8, 300, 450, False, 0.1, None, False, False),
    ("ragged causal Sq > Sk", 2, 8, 450, 300, True, 0.0, None, False, False),
    ("bias_grad", 2, 8, 300, 450, True, 0.1, "full", False, False),
    ("nq = nk = 1", 3, 4, 64, 64, True, 0.1, None, False, False),
)


def phase_flash_d128(dev, cases=D128_CASES, d: int = 128):
    """head_dim 128, bf16 (the tensor-core kernels' other instantiation;
    fp32 at 128 raises): the forward, the partials backward and the
    dq-accumulating backward against their plain versions, causal with
    dropout 0.1 (16 x 8 x 1024, GPT-2 medium's width in 8 heads), with
    BERT-large's key-padding bias (12 x 8 x 512), with ``probs_bf16``
    (:data:`PROBS_TOL`), ragged Sq != Sk both ways, ``bias_grad`` (dbias
    as in :func:`phase_flash_bias`) and the nq = nk = 1 edge; the rest
    within :data:`SPLIT_TOL`, lse within 1e-5 of max|lse|, and the acc
    backward bit for bit the partials one.  Planted faults: the split's
    low half dropped (causal case) and the ragged tiles' rows staged as
    NaN (ragged cases).  The first three cases are timed beside SDPA and
    the bound.  First the kernels' shared memory, resident blocks per SM,
    registers and spills at head_dim 64 and 128, and a check that an fp32
    call at head_dim 128 and a bf16 one at 96 raise before any launch."""
    info = {f"d{dd}": {kind + ("_probs_bf16" if probs else ""):
                       _flash_tc_info(i, dd, probs)
                       for i, kind in enumerate(("fwd", "bwd_partials",
                                                 "bwd_acc"))
                       for probs in (False, True)}
            for dd in (64, d)}
    emit({"phase": "flash_tc_info", **info})
    # what no kernel takes raises before any launch: no fallback
    refused = {}
    for dt, dd in ((torch.float32, d), (torch.bfloat16, 96)):
        x = torch.zeros(4, 64, dd, dtype=dt, device=dev)
        try:
            flash_attention_fwd(x, x, x, _pack_seed(0, device=dev),
                                dd ** -0.5, True, 0.0, (2, 2))
            refused[f"{_dt(dt)} head_dim {dd}"] = False
        except ValueError:
            refused[f"{_dt(dt)} head_dim {dd}"] = True
    check(dev.type != "cuda" or all(refused.values()),
          f"flash: a call no kernel takes did not raise {refused}")
    gen = torch.Generator(device=dev).manual_seed(43)
    seed_int = 135792468
    out = {"tc_info": info}
    emit({"phase": "kernel_check", "kernel": "flash_attention",
          "case": "calls no kernel takes raise ValueError", **refused})
    for (name, b, h, sq, sk, causal, rate, bias_kind, probs,
         timed) in cases:
        bh = b * h
        q, k, v, do = _qkv(dev, gen, bh, sq, sk, torch.bfloat16, d=d)
        bias = None
        if bias_kind == "padding":
            bias = _padding_mask(dev, gen, b, sk)[0].expand(b, sq, sk)
        elif bias_kind == "full":
            bias = torch.randn(b, sq, sk, device=dev, generator=gen)
        bias_grad = bias_kind == "full"
        args = (_pack_seed(seed_int, device=dev), d ** -0.5, causal, rate,
                (h, h))
        kw = dict(bias=bias, probs_bf16=probs)
        o, lse = flash_attention_fwd(q, k, v, *args, **kw)
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, *args, **kw)
        part = flash_attention_bwd(q, k, v, o, lse, do, *args,
                                   bias_grad=bias_grad, dq_acc=False, **kw)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, *args,
                                       bias_grad=bias_grad, **kw)
        acc = flash_attention_bwd_acc(q, k, v, o, lse, do, *args, **kw)[:3]
        torch.cuda.synchronize()
        label = (f"head_dim 128 {name}: B={b} H={h} Sq={sq} Sk={sk} "
                 f"causal={causal} bf16 dropout={rate} bias={bias_kind} "
                 f"probs_bf16={probs}")
        if probs:
            tol = PROBS_TOL
            close = lambda a, w: _probs_close(a, w)[0]  # noqa: E731
        else:
            tol = SPLIT_TOL
            close = _split_close
        errs = [_err(o, o_ref), _err(lse, lse_ref)] + [
            _err(a, w) for a, w in zip(part[:3], want[:3])]
        fracs = [_frac_differing(a, w)
                 for a, w in zip((o, *part[:3]), (o_ref, *want[:3]))]
        check(close(o, o_ref) and _close(lse, lse_ref, 1e-5),
              f"flash d128 fwd {label}: {errs[:2]} {fracs}")
        check(all(close(a, w) for a, w in zip(part[:3], want[:3])),
              f"flash d128 bwd {label}: {errs[2:]} {fracs}")
        eq = [_bitwise(a, p) for a, p in zip(acc, part[:3])]
        check(all(eq), f"flash d128 {label}: the acc backward is not bit "
              f"for bit the partials one {eq}")
        rec = {"case": label, "D": d, "probs_bf16": probs,
               "design": FLASH_DESIGN[torch.bfloat16],
               "errs_o_lse_dq_dk_dv": errs, "frac_differing_o_dq_dk_dv": fracs,
               "tol": tol, "acc_bitwise_equal_dq_dk_dv": eq}
        if bias_grad:
            rec["err_dbias"] = _err(part[3], want[3])
            check(_dbias_ok(part[3], want[3], 1e-4, causal=causal),
                  f"flash d128 dbias {label}: {rec['err_dbias']}")
        faults = {}
        if name == "causal":
            faults.update(_low_half_dropped(
                lambda: flash_attention_fwd(q, k, v, *args, bias=bias,
                                            probs_bf16=True)[0],
                lambda: flash_attention_bwd(q, k, v, o, lse, do, *args,
                                            bias=bias, probs_bf16=True),
                o_ref, want))
        if sq % 64 or sk % 64:
            faults.update(_nan_staging(
                lambda: flash_attention_fwd(q, k, v, *args, _fault=3,
                                            **kw)[0],
                lambda: flash_attention_bwd(q, k, v, o, lse, do, *args,
                                            _fault=3, **kw),
                o_ref, want, causal))
        rec["planted_fault_errs"] = faults
        if timed:
            kern_f = timings(lambda: flash_attention_fwd(q, k, v, *args,
                                                         **kw), iters=20)
            plain_f = timings(lambda: flash_attention_fwd_ref(
                q, k, v, *args, **kw), iters=3, prof_iters=3)
            kern_b = timings(lambda: flash_attention_bwd(
                q, k, v, o, lse, do, *args, dq_acc=False, **kw), iters=10)
            kern_acc = timings(lambda: flash_attention_bwd_acc(
                q, k, v, o, lse, do, *args, **kw), iters=10)
            plain_b = timings(lambda: flash_attention_bwd_ref(
                q, k, v, o, lse, do, *args, **kw), iters=3, prof_iters=3)
            q4, k4, v4 = (t.reshape(b, h, -1, d).detach().requires_grad_()
                          for t in (q, k, v))
            do4 = do.reshape(b, h, sq, d)
            mask4 = None if bias is None else bias[:, None].to(q.dtype)
            lib_f = timings(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask4, is_causal=causal), iters=20)

            def sdpa_fwd_bwd():
                res = F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask4, is_causal=causal)
                torch.autograd.grad(res, (q4, k4, v4), do4)

            lib_b = timings(sdpa_fwd_bwd, iters=10)
            fb, fby = _flash_bound(q, k, bias, backward=False, causal=causal,
                                   probs_bf16=probs)
            bb, bby = _flash_bound(q, k, bias, backward=True, causal=causal,
                                   probs_bf16=probs)
            lib = ("F.scaled_dot_product_attention" + (
                "" if bias is None else " with the bf16 mask")
                + ", no dropout")
            rec["fwd"] = {**_merge(kern_f, plain_f, lib_f),
                          "max_abs_err": max(errs[:2]), "bound_ms": fb,
                          "bound_by": fby, "library": lib}
            rec["bwd"] = {**_merge(kern_b, plain_b, lib_b),
                          "max_abs_err": max(errs[2:]), "bound_ms": bb,
                          "bound_by": bby,
                          "library": lib.replace(",", " forward + backward,",
                                                 1)}
            rec["bwd_acc"] = {**rec["bwd"], "ms": kern_acc["ms"],
                              "events_ms": kern_acc["events_ms"],
                              "ms_source": kern_acc["ms_source"],
                              "acc_over_partials":
                                  kern_acc["ms"] / kern_b["ms"]}
            del q4, k4, v4, do4, mask4
        emit({"phase": "flash_d128", **rec})
        out[name] = rec
        del q, k, v, do, o, lse, o_ref, lse_ref, part, want, acc, bias
        torch.cuda.empty_cache()
    return out


# -- phase 13: GPT-2 medium, microbatched O2 training with remat ---------------

def _grad_step(model, names_out, gen=None, deterministic=True):
    """A ``MicrobatchedStep`` whose update returns the accumulated grads
    of ``names_out`` (or of every parameter) as the carry: the loss meaned
    over the microbatches and the grads summed, through
    ``train.accum.build_opt_step``."""
    ps = dict(model.named_parameters())
    names = list(ps) if names_out is None else list(names_out)

    def grad_fn(carry, mb):
        _, loss = model(mb[0], mb[1], deterministic=deterministic,
                        generator=gen)
        grads = torch.autograd.grad(loss, [ps[n] for n in names])
        return dict(zip(names, grads)), {"loss": loss.detach()}

    return MicrobatchedStep(grad_fn, lambda carry, acc: (acc, {}), 2)


def phase_medium_parity(params, dev, b: int = 2, s: int = 256):
    """GPT-2 medium at fp32 (O0, TF32 off), batch 2 x 256 as M = 2
    microbatches of 1 x 256 accumulated by ``train.accum``,
    ``full_block`` remat, ``dq_acc`` on, no dropout: the microbatch-mean
    loss within 1e-4 and four accumulated grads within 1e-3 relative L2,
    card against the port on the CPU.  Then on the card with dropout 0.1:
    the ``none``, ``dots_saveable`` and ``full_block`` policies give the
    same loss and every grad bit for bit."""
    cfg = GPTConfig.medium(compute_dtype=torch.float32,
                           remat_policy="full_block", dq_acc=True)
    names = ("wte.weight", "layers.0.qkv.kernel",
             f"layers.{cfg.num_layers - 1}.ffn_out.kernel", "ln_f.weight")
    rng = torch.Generator().manual_seed(31)
    ids = torch.randint(0, min(50257, cfg.vocab_size), (b, s), generator=rng)
    labels = torch.cat([ids[:, 1:], torch.full((b, 1), -100)], dim=1)
    mbs = (ids.reshape(2, b // 2, s), labels.reshape(2, b // 2, s))
    res = {}
    for where in ("card", "cpu"):
        model = GPTLM(cfg)
        model.load_state_dict(params)
        model.to(dev if where == "card" else "cpu")
        step = build_opt_step(_grad_step(model, names))
        acc, m = step(None, tuple(t.to(model.wte.weight.device)
                                  for t in mbs))
        res[where] = (float(m["loss"]), {n: g.cpu() for n, g in acc.items()})
        del model, step, acc
    rel = {n: float((res["card"][1][n] - res["cpu"][1][n]).norm()
                    / res["cpu"][1][n].norm()) for n in names}
    err = abs(res["card"][0] - res["cpu"][0])
    # the policies on the card, with dropout: bit for bit
    same, losses = {}, {}
    ref = None
    for policy in ("none", "dots_saveable", "full_block"):
        model = GPTLM(dataclasses.replace(cfg, remat_policy=policy))
        model.load_state_dict(params)
        model.to(dev)
        gen = torch.Generator(device=dev).manual_seed(32)
        step = build_opt_step(_grad_step(model, None, gen,
                                         deterministic=False))
        acc, m = step(None, tuple(t.to(dev) for t in mbs))
        torch.cuda.synchronize()
        got = (m["loss"], acc, gen.get_state())
        losses[policy] = float(m["loss"])
        if ref is None:
            ref = got
        else:
            same[policy] = (torch.equal(got[0], ref[0])
                            and all(torch.equal(got[1][n], ref[1][n])
                                    for n in ref[1])
                            and torch.equal(got[2], ref[2]))
        del model, step, acc, got
    del ref
    torch.cuda.empty_cache()
    emit({"phase": "medium_parity", "model": "GPT-2 medium fp32 O0, "
          "full_block, dq_acc, M = 2", "batch": [b, s],
          "loss_cuda": res["card"][0], "loss_cpu": res["cpu"][0],
          "loss_abs_err": err, "grad_rel_l2": rel,
          "policies_bitwise_equal_to_none_with_dropout": same,
          "policy_losses_with_dropout": losses})
    check(err <= 1e-4, f"medium parity: losses differ by {err}")
    check(all(r <= 1e-3 for r in rel.values()),
          f"medium parity: gradients differ {rel}")
    check(all(same.values()), f"medium: remat policies differ with dropout "
          f"{same}")


def _medium_setup(dev, params, b, s, m, k, policy="full_block"):
    amp_ = amp.initialize("O2")
    cfg = GPTConfig.medium(compute_dtype=amp_.policy.compute_dtype,
                           remat_policy=policy, probs_bf16=True, dq_acc=True)
    model = GPTLM(cfg)
    model.load_state_dict(params)
    model.to(dev)
    opt = amp.AmpOptimizer(fused_adam(3e-4, weight_decay=0.1), amp_)
    masters = opt.attach(model)
    state = opt.init(masters)
    data = torch.Generator(device=dev).manual_seed(33)
    ids = torch.randint(0, cfg.vocab_size, (k * m, b, s), device=dev,
                        generator=data)
    labels = torch.cat([ids[..., 1:],
                        torch.full((k * m, b, 1), -100, device=dev)], dim=-1)
    gen = torch.Generator(device=dev).manual_seed(34)
    names, ps = zip(*model.named_parameters())
    plant = {"at": None, "calls": 0}

    def grad_fn(carry, mb):
        _, state = carry
        _, loss = model(mb[0], mb[1], deterministic=False, generator=gen)
        grads = dict(zip(names, torch.autograd.grad(
            amp_.scale_loss(loss, state.scaler[0]), ps)))
        plant["calls"] += 1
        if plant["calls"] == plant["at"]:
            g = grads["ln_f.weight"].clone()
            g[0] = float("inf")
            grads["ln_f.weight"] = g
        return grads, {"loss": loss.detach()}

    mstep = amp_microbatch_step(grad_fn, opt, microbatches=m, model=model)
    return cfg, model, mstep, (masters, state), (ids, labels), plant


def phase_medium_train(dev, params, b: int = 8, s: int = 1024, m: int = 4,
                       k: int = 2, timed: int = 3):
    """O2 training of GPT-2 medium (seeded random weights) with
    ``fused_adam(3e-4, weight_decay=0.1)``: each optimizer step
    accumulates M = 4 microbatches of 8 x 1024 (``amp_microbatch_step``),
    dropout 0.1, ``full_block`` remat, ``probs_bf16`` and ``dq_acc``, run
    by ``FusedTrainDriver`` at K = 2 steps per window over one fixed window
    of K x M seeded microbatches: one warm window, then ``timed`` windows,
    the first with the launch counts set to 0 before it and read after it
    (exactly K x M x the per-microbatch counts: LayerNorm 4L + 1 and flash
    forward 2L with the recompute, the dq-accumulating backward L, the
    partials backward 0, LayerNorm backward 2L + 1, cross-entropy 1 + 1).
    Then an inf planted in the second microbatch of a step: the whole
    accumulated update is skipped (masters, Adam moments and step
    unchanged) and the scale halves."""
    cfg, model, mstep, carry, (ids, labels), plant = _medium_setup(
        dev, params, b, s, m, k)
    driver = FusedTrainDriver(mstep, steps_per_dispatch=k,
                              metrics={"loss": "mean", "scale": "last",
                                       "skipped": "sum"},
                              per_step=("loss",))
    check(driver.microbatches == m, "medium: driver microbatches")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    carry, res = driver.run_window(carry, (ids, labels))
    warm = read_metrics(res)
    warm_s = time.perf_counter() - t0
    walls, windows, counted = [], [], None
    for i in range(timed):
        torch.cuda.synchronize()
        if i == 0:
            reset_launch_counts()
        t0 = time.perf_counter()
        carry, res = driver.run_window(carry, (ids, labels))
        host = read_metrics(res)  # the window's one host read
        walls.append(time.perf_counter() - t0)
        windows.append(host)
        if i == 0:
            counted = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    med = sorted(walls)[len(walls) // 2]
    layers = cfg.num_layers
    per_mb = {n: 0 for n in counted}
    per_mb.update({"layer_norm": 4 * layers + 1,
                   "flash_attention_fwd": 2 * layers,
                   "flash_attention_bwd_acc": layers,
                   "layer_norm_bwd": 2 * layers + 1,
                   "softmax_xentropy_fwd": 1, "softmax_xentropy_bwd": 1})
    losses = warm.per_step["loss"] + sum((w.per_step["loss"]
                                          for w in windows), [])
    first, last = losses[0], windows[-1].metrics["loss"]
    tokens = k * m * b * s
    emit({"phase": "medium_train", "model": "GPT-2 medium O2 (bf16 model, "
          "fp32 masters, dynamic loss scale), dropout 0.1, fused_adam(3e-4, "
          "wd 0.1), full_block remat, probs_bf16, dq_acc",
          "microbatch": [b, s], "microbatches": m, "steps_per_window": k,
          "warm_window_s": warm_s, "window_walls_s": walls,
          "median_window_s": med, "tokens_per_s": tokens / med,
          "loss_first_step": first, "loss_last_window": last,
          "losses_per_step": losses,
          "loss_scale": windows[-1].metrics["scale"],
          "skipped_steps": warm.metrics["skipped"]
          + sum(w.metrics["skipped"] for w in windows),
          "max_memory_allocated_bytes": peak,
          "launches_one_window": counted,
          "launches_per_microbatch_expected": per_mb})
    check(all(math.isfinite(x) for x in losses), "medium: non-finite loss")
    check(last < first, f"medium: loss did not fall ({first} -> {last})")
    check(counted == {n: k * m * c for n, c in per_mb.items()},
          f"medium: launch counts {counted} != K x M x {per_mb}")
    # the planted overflow in the second microbatch of one step
    masters, state = carry
    before = {n: t.clone() for n, t in masters.items()}
    m_before = {n: t.clone() for n, t in state.opt_state.m.items()}
    v_before = {n: t.clone() for n, t in state.opt_state.v.items()}
    step_before = int(state.opt_state.step)
    scale_before = float(state.scaler[0].loss_scale)
    one = FusedTrainDriver(mstep, steps_per_dispatch=1,
                           metrics={"skipped": "sum"})
    plant["calls"], plant["at"] = 0, 2
    carry, res = one.run_window(carry, (ids[:m], labels[:m]))
    plant["at"] = None
    skipped = read_metrics(res.metrics)["skipped"]
    masters, state = carry
    same = (all(torch.equal(masters[n], before[n]) for n in before)
            and all(torch.equal(state.opt_state.m[n], m_before[n])
                    for n in m_before)
            and all(torch.equal(state.opt_state.v[n], v_before[n])
                    for n in v_before)
            and int(state.opt_state.step) == step_before)
    scaler = state.scaler[0]
    emit({"phase": "medium_overflow", "planted_in_microbatch": 2,
          "skipped": skipped, "state_unchanged": same,
          "scale_before": scale_before,
          "scale_after": float(scaler.loss_scale),
          "unskipped_after": int(scaler.unskipped),
          "overflows": int(scaler.overflows)})
    check(skipped == 1.0 and same, "medium: the overflow step was not "
          "skipped cleanly")
    check(float(scaler.loss_scale) == scale_before / 2
          and int(scaler.unskipped) == 0,
          "medium: the overflow did not halve the scale and reset unskipped")
    opt_step = build_opt_step(mstep)

    def step(c, _batch):
        return opt_step(c, (ids[:m], labels[:m]))

    del before, m_before, v_before
    return counted, step, carry, model


def phase_remat_memory(dev, model, b: int = 8, s: int = 1024):
    """Peak device memory and wall of one O2 microbatch (forward and
    backward of GPT-2 medium at 8 x 1024, dropout on) under each remat
    policy, with the model of :func:`phase_medium_train` (its bf16
    weights): the memory above what was allocated before it, and the wall
    of the second of two runs."""
    data = torch.Generator(device=dev).manual_seed(35)
    ids = torch.randint(0, model.cfg.vocab_size, (b, s), device=dev,
                        generator=data)
    labels = torch.cat([ids[:, 1:], torch.full((b, 1), -100, device=dev)],
                       dim=1)
    gen = torch.Generator(device=dev).manual_seed(36)
    ps = [p for p in model.parameters()]
    cfg0 = model.cfg
    rows = {}
    for policy in ("none", "dots_saveable", "full_block"):
        model.cfg = dataclasses.replace(cfg0, remat_policy=policy)
        for _ in range(2):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _, loss = model(ids, labels, deterministic=False, generator=gen)
            grads = torch.autograd.grad(loss, ps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            del loss, grads
        rows[policy] = {"peak_bytes_above_weights": peak, "wall_s": wall}
    model.cfg = cfg0
    emit({"phase": "remat_memory", "what": "one O2 microbatch of GPT-2 "
          "medium, 8 x 1024, forward + backward, dropout 0.1, probs_bf16, "
          "dq_acc", "policies": rows,
          "full_block_vs_none_wall": rows["full_block"]["wall_s"]
          / rows["none"]["wall_s"],
          "none_minus_full_block_bytes":
              rows["none"]["peak_bytes_above_weights"]
              - rows["full_block"]["peak_bytes_above_weights"]})
    check(rows["full_block"]["peak_bytes_above_weights"]
          < rows["none"]["peak_bytes_above_weights"],
          f"remat: full_block saved no memory {rows}")
    return rows


def phase_medium_kernels(dev, rows: int = 8192, n: int = 1024,
                         v: int = 50304):
    """The LayerNorm and cross-entropy kernels at the shapes GPT-2
    medium's microbatch gives them (8 x 1024 tokens): LayerNorm forward and
    backward at (8192, 1024) fp32 x with bf16 (O2) affine, the
    cross-entropy forward and backward at (8192, 50304) bf16 logits, each
    against its plain version with the tolerances of their own phases,
    timed beside the bound and the library call."""
    gen = torch.Generator(device=dev).manual_seed(43)
    x = (2 * torch.randn(rows, n, device=dev, generator=gen) + 0.5)
    dy = torch.randn(rows, n, device=dev, generator=gen)
    w = (1 + 0.1 * torch.randn(n, device=dev, generator=gen)).to(
        torch.bfloat16)
    b = (0.1 * torch.randn(n, device=dev, generator=gen)).to(torch.bfloat16)
    out = {}
    got, want = layer_norm(x, w, b), layer_norm_ref(x, w, b)
    gb, wb = layer_norm_bwd(x, w, dy), layer_norm_bwd_ref(x, w, dy)
    torch.cuda.synchronize()
    errs_b = [_err(a, c) for a, c in zip(gb, wb)]
    check(_err(got, want) <= 1e-5, f"medium layer_norm: {_err(got, want)}")
    check(_close(gb[0], wb[0], 1e-5, ulps=1)
          and all(_close(a, c, 1e-5, ulps=1) for a, c in zip(gb[1:], wb[1:])),
          f"medium layer_norm_bwd: {errs_b}")
    wf, bf = w.float(), b.float()
    bound, by = _bound(2 * x.numel() * 4 + 2 * n * 2,
                       {FP32_FLOPS: 8 * x.numel()})
    out["layer_norm"] = {
        "case": f"rows={rows} n={n} float32/bfloat16",
        "design": LN_FWD_DESIGNS[_ln_fwd_design(x)],
        "max_abs_err": _err(got, want), "tol": "1e-5",
        **_merge(timings(lambda: layer_norm(x, w, b)),
                 timings(lambda: layer_norm_ref(x, w, b)),
                 timings(lambda: F.layer_norm(x, (n,), wf, bf))),
        "bound_ms": bound, "bound_by": by}
    _, mean, rstd = torch.native_layer_norm(x, [n], wf, bf, 1e-5)
    bound, by = _bound(3 * x.numel() * 4 + 3 * n * 2,
                       {FP32_FLOPS: 12 * x.numel()})
    out["layer_norm_bwd"] = {
        "case": f"rows={rows} n={n} float32/bfloat16",
        "design": LN_BWD_DESIGNS[ln_bwd_blocks(x, w, dy)[0]],
        "max_abs_err": max(errs_b),
        "tol": "1e-5 of max|want| (+1 bf16 ulp for bf16)",
        **_merge(timings(lambda: layer_norm_bwd(x, w, dy)),
                 timings(lambda: layer_norm_bwd_ref(x, w, dy), iters=20),
                 timings(lambda: torch.ops.aten.native_layer_norm_backward(
                     dy, x, [n], mean, rstd, wf, bf, [True, True, True]))),
        "bound_ms": bound, "bound_by": by}
    del x, dy, got, want, gb, wb, mean, rstd
    logits = (3 * torch.randn(rows, v, device=dev, generator=gen)).to(
        torch.bfloat16)
    labels = torch.randint(0, v, (rows,), device=dev, generator=gen)
    g = torch.rand(rows, device=dev, generator=gen)
    loss, lse = softmax_cross_entropy_fwd(logits, labels, 0.0)
    want_l, want_lse = softmax_cross_entropy_fwd_ref(logits, labels, 0.0)
    d = softmax_cross_entropy_bwd(logits, labels, lse, g, 0.0)
    want_d = softmax_cross_entropy_bwd_ref(logits, labels, lse, g, 0.0)
    torch.cuda.synchronize()
    errs = [_err(loss, want_l), _err(lse, want_lse), _err(d, want_d)]
    check(_close(loss, want_l, 2e-6) and _close(lse, want_lse, 2e-6)
          and bf16_ulp_ok(d, want_d, ulps=1, floor=1e-9),
          f"medium xent: {errs}")
    lg = logits.detach().requires_grad_()

    def ce_fwd_bwd():
        r = F.cross_entropy(lg, labels, reduction="none")
        torch.autograd.grad(r, lg, g)

    case = f"rows={rows} V={v} bfloat16 smoothing=0.0"
    bound, by = _bound(rows * v * 2 + rows * 16, {FP32_FLOPS: 4 * rows * v})
    out["softmax_xentropy_fwd"] = {
        "case": case, "max_abs_err": max(errs[:2]),
        "tol": "2e-6 of max|want|",
        **_merge(timings(lambda: softmax_cross_entropy_fwd(logits, labels,
                                                           0.0), iters=20),
                 timings(lambda: softmax_cross_entropy_fwd_ref(
                     logits, labels, 0.0), iters=5),
                 timings(lambda: F.cross_entropy(logits, labels,
                                                 reduction="none"),
                         iters=20)),
        "bound_ms": bound, "bound_by": by}
    bound, by = _bound(2 * rows * v * 2 + rows * 16,
                       {FP32_FLOPS: 4 * rows * v})
    out["softmax_xentropy_bwd"] = {
        "case": case, "max_abs_err": errs[2], "tol": "1 bf16 ulp + 1e-9",
        **_merge(timings(lambda: softmax_cross_entropy_bwd(
                     logits, labels, lse, g, 0.0), iters=20),
                 timings(lambda: softmax_cross_entropy_bwd_ref(
                     logits, labels, lse, g, 0.0), iters=3),
                 timings(ce_fwd_bwd, iters=10)),
        "bound_ms": bound, "bound_by": by}
    for name, c in out.items():
        emit({"phase": "kernel", "kernel": name, "path": "GPT-2 medium", **c})
    del logits, labels, g, loss, lse, d, want_l, want_lse, want_d, lg
    torch.cuda.empty_cache()
    return out


# -- phase 14: AMP O1, checkpoint resume, the stash route ---------------------

O1_GRADS = ("wte.weight", "layers.0.qkv.kernel", "layers.11.ffn_out.kernel",
            "ln_f.weight")
O1_TOL = ("loss 1e-2; logits 5e-2 of max|logit|; grads 2e-2 relative L2 "
          "(ROADMAP's bf16-compute rules)")


def _products() -> dict:
    """The products run through ``amp.F`` since its reset, by op and
    operand dtype."""
    return {f"{op} {dt}": n for (op, dt), n in
            sorted(amp.F.product_counts().items())}


def _o1_parity_case(what, make, params, run, names, products, launches,
                    devices):
    """One O1 forward and backward under ``amp_.autocast()`` on the card
    and on the CPU (plain versions), from the same weights and tokens."""
    amp_ = amp.initialize("O1")
    out = {}
    for where in devices:
        model = make()
        model.load_state_dict(params)
        model.to(where)
        amp.F.reset_product_counts()
        reset_launch_counts()
        with amp_.autocast():
            logits, loss = run(model, where)
        ps = dict(model.named_parameters())
        gs = torch.autograd.grad(loss, [ps[n] for n in names])
        if where == devices[0]:
            torch.cuda.synchronize()
        out[where] = dict(
            loss=float(loss.detach()), logits=logits.detach().float().cpu(),
            grads=[g.float().cpu() for g in gs], products=_products(),
            launches={n: c for n, c in launch_counts().items() if c})
        del model, ps, gs, logits, loss
    card, cpu = (out[d] for d in devices)
    rel = {n: float((a - c).norm() / c.norm())
           for n, a, c in zip(names, card["grads"], cpu["grads"])}
    loss_err = abs(card["loss"] - cpu["loss"])
    logit_err = float((card["logits"] - cpu["logits"]).abs().max())
    top = float(cpu["logits"].abs().max())
    rec = {"phase": "o1_parity", "model": what, "loss_cuda": card["loss"],
           "loss_cpu": cpu["loss"], "loss_abs_err": loss_err,
           "logits_max_abs_err": logit_err, "logits_max_abs": top,
           "grad_rel_l2": rel, "tol": O1_TOL,
           "products_cuda": card["products"],
           "products_cpu": cpu["products"],
           "products_expected": products, "launches": card["launches"],
           "launches_expected": launches}
    emit(rec)
    check(loss_err <= 1e-2, f"o1 parity {what}: losses differ by {loss_err}")
    check(logit_err <= 5e-2 * top,
          f"o1 parity {what}: logits differ by {logit_err} (max {top})")
    check(all(r <= 2e-2 for r in rel.values()),
          f"o1 parity {what}: gradients differ {rel}")
    check(card["products"] == cpu["products"] == products,
          f"o1 parity {what}: products {card['products']} != {products}")
    check(card["launches"] == launches,
          f"o1 parity {what}: launches {card['launches']} != {launches}")
    return rec


def phase_o1_parity(gpt_params, bert_params, b: int = 2, s: int = 256,
                    devices=("cuda", "cpu")):
    """AMP O1 (fp32 parameters, an fp32 compute dtype, ``amp_.autocast()``)
    one forward and backward on the card against the port on the CPU:
    GPT-2 small and BERT-large (padded to lengths 200 and 256, so flash
    attention takes bf16 q, k, v beside the fp32 padding bias), batch
    2 x 256, no dropout.  Every Dense, MHA projection and head product
    must run on bf16 operands (the ``amp.F`` product counts), and the
    kernels launch as the path needs them."""
    cfg = GPTConfig.small(compute_dtype=torch.float32)
    rng = torch.Generator().manual_seed(40)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=rng)
    labels = torch.cat([ids[:, 1:], torch.full((b, 1), -100)], dim=1)
    layers = cfg.num_layers
    gpt = _o1_parity_case(
        "GPT-2 small O1", lambda: GPTLM(cfg), gpt_params,
        lambda m, w: m(ids.to(w), labels.to(w)), O1_GRADS,
        {"dense bfloat16": 4 * layers, "matmul bfloat16": 1},
        {"layer_norm": 2 * layers + 1, "layer_norm_bwd": 2 * layers + 1,
         "flash_attention_fwd": layers, "flash_attention_bwd": layers,
         "softmax_xentropy_fwd": 1, "softmax_xentropy_bwd": 1}, devices)
    bcfg = BertConfig.large(compute_dtype=torch.float32)
    bids, blabels, mask = _mlm_batch("cpu", torch.Generator().manual_seed(41),
                                     b, s, bcfg.vocab_size, (200, 256))
    blayers = bcfg.num_layers
    bert = _o1_parity_case(
        "BERT-large O1, padded", lambda: BertForMLM(bcfg), bert_params,
        lambda m, w: m(bids.to(w), blabels.to(w), attention_mask=mask.to(w)),
        BERT_GRADS,
        {"dense bfloat16": 4 * blayers + 1, "matmul bfloat16": 1},
        {"layer_norm": 2 * blayers + 2, "layer_norm_bwd": 2 * blayers + 2,
         "flash_attention_fwd": blayers, "flash_attention_bwd": blayers,
         "softmax_xentropy_fwd": 1, "softmax_xentropy_bwd": 1}, devices)
    return gpt, bert


def _o1_setup(dev, params, b, s, gen_seed: int = 43):
    """GPT-2 small O1 with dropout 0.1, ``fused_adam(6e-4, weight_decay
    =0.1)``, dynamic scale: the carry is (masters, AmpOptState, the
    dropout generator), and the step draws its dropout from the carry's
    generator."""
    amp_ = amp.initialize("O1")
    cfg = GPTConfig.small(compute_dtype=torch.float32)
    model = GPTLM(cfg)
    model.load_state_dict(params)
    model.to(dev)
    opt = amp.AmpOptimizer(fused_adam(6e-4, weight_decay=0.1), amp_)
    masters = opt.attach(model)
    data = torch.Generator(device=dev).manual_seed(42)
    ids = torch.randint(0, cfg.vocab_size, (b, s), device=dev, generator=data)
    labels = torch.cat([ids[:, 1:], torch.full((b, 1), -100, device=dev)],
                       dim=1)
    names, ps = zip(*model.named_parameters())
    plant = {"inf": False}

    def step(carry, _batch):
        masters, state, gen = carry
        with amp_.autocast():
            _, loss = model(ids, labels, deterministic=False, generator=gen)
        grads = dict(zip(names, torch.autograd.grad(
            amp_.scale_loss(loss, state.scaler[0]), ps)))
        if plant["inf"]:
            g = grads["ln_f.weight"].clone()
            g[0] = float("inf")
            grads["ln_f.weight"] = g
        masters, state, stats = opt.step(grads, state, masters, model=model)
        return (masters, state, gen), {"loss": loss.detach(),
                                       "loss_scale": stats.loss_scale,
                                       "skipped": stats.found_inf.float()}

    carry = (masters, opt.init(masters),
             torch.Generator(device=dev).manual_seed(gen_seed))
    return cfg, model, opt, step, carry, plant


def phase_o1_train(dev, params, o2_tokens_per_s: float, b: int = 8,
                   s: int = 1024, k: int = 4, timed: int = 2):
    """O1 training of GPT-2 small at full width and depth, batch 8 x 1024,
    dropout 0.1, ``fused_adam(6e-4, weight_decay=0.1)``, dynamic scale,
    ``FusedTrainDriver`` at K = 4: one warm window, then ``timed``
    windows, the first with the launch and product counts set to 0
    before it (exactly K x (LN 25, LN backward 25, flash 12 + 12,
    cross-entropy 1 + 1), and K x 49 bf16 products); a planted overflow
    that must be skipped (masters, Adam moments and step unchanged, the
    scale halved, no host read in the step); then one step under the
    profiler.  Reported beside the O2 window's tokens/s of this run.
    Claims nothing."""
    cfg, model, opt, step, carry, plant = _o1_setup(dev, params, b, s)
    driver = FusedTrainDriver(step, steps_per_dispatch=k,
                              metrics={"loss": "last", "loss_scale": "last",
                                       "skipped": "sum"},
                              per_step=("loss",))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    carry, res = driver.run_window(carry)
    warm = read_metrics(res)
    walls, windows, counted, products = [], [], None, None
    for i in range(timed):
        torch.cuda.synchronize()
        if i == 0:
            reset_launch_counts()
            amp.F.reset_product_counts()
        t0 = time.perf_counter()
        carry, res = driver.run_window(carry)
        host = read_metrics(res)  # the window's one host read
        walls.append(time.perf_counter() - t0)
        windows.append(host)
        if i == 0:
            counted, products = launch_counts(), _products()
    peak = torch.cuda.max_memory_allocated()
    layers = cfg.num_layers
    per_step = {n: 0 for n in counted}
    per_step.update({"layer_norm": 2 * layers + 1,
                     "layer_norm_bwd": 2 * layers + 1,
                     "flash_attention_fwd": layers,
                     "flash_attention_bwd": layers,
                     "softmax_xentropy_fwd": 1, "softmax_xentropy_bwd": 1})
    want_products = {"dense bfloat16": k * 4 * layers, "matmul bfloat16": k}
    losses = warm.per_step["loss"] + sum((w.per_step["loss"]
                                          for w in windows), [])
    first, last = losses[0], windows[-1].metrics["loss"]
    check(all(math.isfinite(x) for x in losses), "o1 train: non-finite loss")
    check(last < first, f"o1 train: loss did not fall ({first} -> {last})")
    check(counted == {n: k * c for n, c in per_step.items()},
          f"o1 train: launch counts {counted} != K x {per_step}")
    check(products == want_products,
          f"o1 train: products {products} != {want_products}")
    masters, state, gen = carry
    before = {n: t.clone() for n, t in masters.items()}
    m_before = {n: t.clone() for n, t in state.opt_state.m.items()}
    v_before = {n: t.clone() for n, t in state.opt_state.v.items()}
    step_before = int(state.opt_state.step)
    scale_before = float(state.scaler[0].loss_scale)
    plant["inf"] = True
    carry, m = step(carry, None)
    plant["inf"] = False
    masters, state, gen = carry
    torch.cuda.synchronize()
    same = (all(torch.equal(masters[n], before[n]) for n in before)
            and all(torch.equal(state.opt_state.m[n], m_before[n])
                    for n in m_before)
            and all(torch.equal(state.opt_state.v[n], v_before[n])
                    for n in v_before)
            and int(state.opt_state.step) == step_before)
    scaler = state.scaler[0]
    overflow = {"skipped": bool(m["skipped"]), "state_unchanged": same,
                "scale_before": scale_before,
                "scale_after": float(scaler.loss_scale),
                "unskipped_after": int(scaler.unskipped)}
    check(overflow["skipped"] and same,
          "o1 train: the overflow step was not skipped cleanly")
    check(overflow["scale_after"] == scale_before / 2
          and overflow["unskipped_after"] == 0,
          "o1 train: the overflow did not halve the scale")
    del before, m_before, v_before
    prof = phase_step_profile(step, carry, "o1_profile", "one O1 step, "
                              "GPT-2 small, batch 8 x 1024, dropout 0.1, "
                              "fused_adam")
    med = sorted(walls)[len(walls) // 2]
    emit({"phase": "o1_train", "model": "GPT-2 small O1 (fp32 parameters, "
          "bf16 products through the cast tables), dropout 0.1, "
          "fused_adam(6e-4, wd 0.1), dynamic loss scale",
          "batch": [b, s], "steps_per_window": k, "window_walls_s": walls,
          "median_window_s": med, "tokens_per_s": b * s * k / med,
          "o2_tokens_per_s_this_run": o2_tokens_per_s,
          "o2_batch": [16, 1024],
          "device_busy_share": prof["device_busy_share"],
          "device_busy_share_unprofiled":
              prof["device_busy_share_unprofiled"],
          "loss_first_step": first, "loss_last_window": last,
          "losses_per_step": losses,
          "max_memory_allocated_bytes": peak,
          "launches_one_window": counted,
          "launches_per_step_expected": per_step,
          "products_one_window": products, "overflow": overflow})
    return counted


def _leaves(tree) -> dict:
    """Every tensor of a tree (a carry, an optimizer state) by its
    checkpoint path; a generator by its ``get_state()``."""
    return {p: x.get_state() if isinstance(x, torch.Generator) else x
            for p, x in checkpoint._flatten(tree)}


def phase_checkpoint_resume(dev, params, b: int = 8, s: int = 1024,
                            k: int = 4):
    """``FusedTrainDriver.save``/``restore`` on the O1 training set-up
    (dropout on, its generator in the carry): two windows of K = 4 run
    unbroken; separately one window, ``save``, ``restore`` into a carry
    built from another seed (masters, generator), ``copy_to_model`` (the
    resume step: the model's copy is derived state), the second window.
    The losses, scale state, masters, Adam moments and generator state
    must equal the unbroken run's bit for bit.  Then a second save, the
    newest step's file corrupted: ``restore(step=None)`` falls back to
    the step before and restoring the corrupted step by number raises.
    Save and restore wall and the bytes on disk are reported; the files
    live in a temporary directory, removed at the end."""
    from apex_tpu_torch.checkpoint import (STATE_FILE,
                                           CheckpointIntegrityError)

    metrics = {"loss": "last", "loss_scale": "last", "skipped": "sum"}
    _, model, opt, step, carry, _ = _o1_setup(dev, params, b, s)
    driver = FusedTrainDriver(step, steps_per_dispatch=k, metrics=metrics,
                              per_step=("loss",))
    carry, r1 = driver.run_window(carry)
    carry, r2 = driver.run_window(carry)
    ref_losses = read_metrics(r1).per_step["loss"] + read_metrics(
        r2).per_step["loss"]
    ref = {n: t.clone() for n, t in _leaves(carry).items()}
    del model, opt, step, carry, driver
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="apex_tpu_torch_ckpt_")
    try:
        _, model, opt, step, carry, _ = _o1_setup(dev, params, b, s)
        driver = FusedTrainDriver(step, steps_per_dispatch=k,
                                  metrics=metrics, per_step=("loss",))
        carry, r1 = driver.run_window(carry)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        driver.save(tmp, carry, k)
        save_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(tmp, str(k), f))
                   for f in os.listdir(os.path.join(tmp, str(k))))
        del model, opt, step, carry, driver
        torch.cuda.empty_cache()
        # the template: another seed's masters and generator
        _, model, opt, step, fresh, _ = _o1_setup(dev, params, b, s,
                                                  gen_seed=99)
        other = torch.Generator(device=dev).manual_seed(98)
        masters = {n: 0.02 * torch.randn(t.shape, device=dev, generator=other)
                   for n, t in fresh[0].items()}
        template = (masters, opt.init(masters), fresh[2])
        driver = FusedTrainDriver(step, steps_per_dispatch=k,
                                  metrics=metrics, per_step=("loss",))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, got_step = driver.restore(tmp, template)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(got_step == k, f"checkpoint: restored step {got_step} != {k}")
        opt.copy_to_model(model, carry[0])  # the resume step
        carry, r2 = driver.run_window(carry)
        losses = read_metrics(r1).per_step["loss"] + read_metrics(
            r2).per_step["loss"]
        got = _leaves(carry)
        differing = sorted(n for n, t in ref.items()
                           if not (t.dtype == got[n].dtype
                                   and torch.equal(t, got[n])))
        # the second save, then the newest step's file corrupted
        driver.save(tmp, carry, 2 * k)
        path = os.path.join(tmp, str(2 * k), STATE_FILE)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(4096)
            f.seek(size // 2)
            f.write(bytes(x ^ 0xFF for x in chunk))
        t0 = time.perf_counter()
        _, fell_back_to = driver.restore(tmp, template)
        fallback_s = time.perf_counter() - t0
        try:
            driver.restore(tmp, template, step=2 * k)
            raised = False
        except CheckpointIntegrityError:
            raised = True
        rec = {"phase": "checkpoint_resume", "model": "GPT-2 small O1, "
               "dropout 0.1, the generator in the carry",
               "batch": [b, s], "steps_per_window": k,
               "losses_unbroken": ref_losses, "losses_resumed": losses,
               "leaves": len(ref), "leaves_differing": differing,
               "save_s": save_s, "restore_s": restore_s,
               "bytes_on_disk": disk, "corrupted_step": 2 * k,
               "fell_back_to": fell_back_to, "fallback_restore_s": fallback_s,
               "explicit_corrupted_step_raised": raised}
        emit(rec)
        check(losses == ref_losses,
              f"checkpoint: losses {losses} != unbroken {ref_losses}")
        check(not differing, f"checkpoint: leaves differ: {differing[:8]}")
        check(fell_back_to == k,
              f"checkpoint: fell back to {fell_back_to}, not {k}")
        check(raised, "checkpoint: the corrupted step restored by number "
              "did not raise")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del ref
    torch.cuda.empty_cache()
    return rec


STASH_OPTIMIZERS = (
    ("fused_sgd", lambda: fused_sgd(0.1, momentum=0.9, weight_decay=1e-4)),
    ("fused_adam", lambda: fused_adam(6e-4, weight_decay=0.1)),
    ("fused_lamb", lambda: fused_lamb(1e-3, weight_decay=0.01)))


def phase_stash(dev, params, b: int = 8, s: int = 1024):
    """The accumulate/stash route at GPT-2 small O2, full width: two
    microbatches of 8 x 1024 (dropout 0.1) through
    ``accumulate(update_scaler=False)`` and then ``step``, once each with
    ``fused_sgd``, ``fused_adam`` and ``fused_lamb``.  The merged stash
    must equal the sum of the two unscaled grads (in float64) within 1e-6
    relative L2; LAMB stage 1 on this route (g_scale 1/clip alone) must
    match its plain version under ``phase_lamb``'s gate at two leaves,
    and its launches are counted; then an inf in the second microbatch
    of the next step must leave the masters, every moment and the step
    count bit for bit unchanged and back off the scale."""
    import importlib

    # the module (the package's ``fused_lamb`` is the factory function)
    lamb_module = importlib.import_module(
        "apex_tpu_torch.optimizers.fused_lamb")

    cfg = GPTConfig.small(compute_dtype=torch.bfloat16)
    data = torch.Generator(device=dev).manual_seed(50)
    ids = torch.randint(0, cfg.vocab_size, (4, b, s), device=dev,
                        generator=data)
    labels = torch.cat([ids[..., 1:], torch.full((4, b, 1), -100,
                                                 device=dev)], dim=-1)
    out = {}
    for name, make in STASH_OPTIMIZERS:
        amp_ = amp.initialize("O2")
        model = GPTLM(cfg)
        model.load_state_dict(params)
        model.to(dev)
        opt = amp.AmpOptimizer(make(), amp_)
        masters = opt.attach(model)
        state = opt.init(masters)
        gen = torch.Generator(device=dev).manual_seed(51)
        names, ps = zip(*model.named_parameters())

        def grads(i, state):
            _, loss = model(ids[i], labels[i], deterministic=False,
                            generator=gen)
            return dict(zip(names, torch.autograd.grad(
                amp_.scale_loss(loss, state.scaler[0]), ps)))

        g1 = grads(0, state)
        state = opt.accumulate(g1, state, update_scaler=False)
        g2 = grads(1, state)
        scale = state.scaler[0].loss_scale
        merged, _ = amp_.scalers[0].unscale_with_stashed(g2, state.stash,
                                                         state.scaler[0])
        num = den = 0.0
        for n in names:
            want = (g1[n].double() + g2[n].double()) / scale.double()
            num += float((merged[n].double() - want).square().sum())
            den += float(want.square().sum())
        stash_err = math.sqrt(num / den)
        del merged, g1
        recorded = []
        real = lamb_module.lamb_stage1
        watch = {0, len(names) - 1}  # the first and the last leaf

        def recorder(g, p_, m, v, scalars, **hp):
            """LAMB stage 1 with the inputs and outputs of the watched
            leaves kept (their launches count as the path's)."""
            i = recorder.calls
            recorder.calls += 1
            if i in watch:
                inputs = (g.clone(), p_.clone(), m.clone(), v.clone(),
                          scalars.clone())
                got = real(g, p_, m, v, scalars, **hp)
                recorded.append((i, inputs, tuple(t.clone() for t in got),
                                 hp))
                return got
            return real(g, p_, m, v, scalars, **hp)

        recorder.calls = 0
        torch.cuda.synchronize()
        reset_launch_counts()
        lamb_module.lamb_stage1 = recorder
        try:
            masters, state, stats = opt.step(g2, state, masters, model=model)
        finally:
            lamb_module.lamb_stage1 = real
        torch.cuda.synchronize()
        step_launches = {n: c for n, c in launch_counts().items() if c}
        check(not bool(stats.found_inf) and state.stash is None,
              f"stash {name}: the clean step was skipped or kept its stash")
        lamb_cases = []
        for i, (g, p_, m, v, scal), got, hp in recorded:
            want = lamb_stage1_ref(g, p_, m.clone(), v.clone(), scal, **hp)
            errs = [_err(a, w) for a, w in zip(got, want)]
            lamb_cases.append({"leaf": names[i], "n": g.numel(),
                               "g_scale_bc1_bc2_skip": scal.tolist(),
                               "errs_m_v_psq_usq": errs,
                               "ok": _lamb_ok(got, want)})
        del recorded, g2
        # the next step, with an inf in its second microbatch
        g1 = grads(2, state)
        state = opt.accumulate(g1, state, update_scaler=False)
        g2 = grads(3, state)
        g = g2["ln_f.weight"].clone()
        g[0] = float("inf")
        g2["ln_f.weight"] = g
        before = {n: t.clone() for n, t in masters.items()}
        opt_before = {n: t.clone()
                      for n, t in _leaves(state.opt_state).items()}
        scale_before = float(state.scaler[0].loss_scale)
        masters, state, stats = opt.step(g2, state, masters, model=model)
        torch.cuda.synchronize()
        same = (all(torch.equal(masters[n], before[n]) for n in before)
                and all(torch.equal(t, opt_before[n]) for n, t in
                        _leaves(state.opt_state).items()))
        rec = {"phase": "stash", "optimizer": name,
               "model": "GPT-2 small O2, two microbatches of 8 x 1024, "
               "accumulate(update_scaler=False) then step",
               "stash_rel_l2_vs_float64_sum": stash_err,
               "stash_tol": 1e-6, "launches_one_step": step_launches,
               "lamb_stage1_checks": lamb_cases,
               "lamb_tol": "m, v 1 fp32 ulp; sums 1e-5 relative",
               "overflow_skipped": bool(stats.found_inf),
               "overflow_state_unchanged": same,
               "scale_before": scale_before,
               "scale_after": float(state.scaler[0].loss_scale)}
        emit(rec)
        check(stash_err <= 1e-6, f"stash {name}: stash error {stash_err}")
        check(all(c["ok"] for c in lamb_cases),
              f"stash {name}: LAMB stage 1 differs {lamb_cases}")
        check(name != "fused_lamb" or (
            len(lamb_cases) == 2
            and step_launches.get("lamb_stage1") == len(names)),
              f"stash {name}: LAMB stage 1 launches {step_launches}")
        check(bool(stats.found_inf) and same,
              f"stash {name}: the overflow step was not skipped cleanly")
        check(float(state.scaler[0].loss_scale) == scale_before / 2,
              f"stash {name}: the overflow did not back off the scale")
        out[name] = rec
        del model, opt, masters, state, before, opt_before, g1, g2
        torch.cuda.empty_cache()
    return out


# -- phase 15: the rest of the library ----------------------------------------

#: the two sides of a card-against-CPU check: (key, device)
SIDES = (("card", "cuda"), ("cpu", "cpu"))


@contextlib.contextmanager
def _plain_kernels():
    """Every kernel wrapper takes its plain PyTorch version inside the
    block, on the card too: the dispatch rule of the wrappers' modules
    swapped for one that always answers no.  This is how a module's
    whole path is held against the same path without the kernels."""
    mods = [importlib.import_module(f"apex_tpu_torch.ops.{m}") for m in
            ("attention", "layer_norm", "softmax_xentropy", "fused_optim")]
    saved = [m.use_kernel for m in mods]
    for m in mods:
        m.use_kernel = lambda *tensors: False
    try:
        yield
    finally:
        for m, fn in zip(mods, saved):
            m.use_kernel = fn


def _rel(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


#: the module-level gate of a bf16 path with the kernels against the same
#: path on their plain versions: the output within 1e-3 of its largest
#: magnitude plus 2 bf16 ulps (the flash kernels move <= 2 % of their
#: outputs by <= 2 ulps, which the bf16 products after them spread), the
#: gradients within 1e-2 relative L2 error
MODULE_TOL = ("output 1e-3 of max|want| + 2 bf16 ulps; gradients 1e-2 "
              "relative L2")


def _encdec_run(mod, q, k, pad, cot, seed: int):
    """One training forward and backward of the cross-attention with
    dropout from ``seed``: the output and the grads of q, k and every
    parameter."""
    gen = torch.Generator(device=q.device).manual_seed(seed)
    qg, kg = q.detach().requires_grad_(), k.detach().requires_grad_()
    out = mod(qg, kg, key_padding_mask=pad, is_training=True, generator=gen)
    grads = torch.autograd.grad(out, [qg, kg, *mod.parameters()], cot)
    return out.detach(), grads


def phase_encdec_attn(dev, b: int = 16, sq: int = 256, sk: int = 384,
                      h: int = 1024, nh: int = 16, parity_b: int = 2):
    """``EncdecMultiheadAttn`` at Transformer-big widths (d_model 1024, 16
    heads of 64; Vaswani et al. 2017): batch 16, 256 decoder queries over
    384 encoder keys, per-row key lengths seeded in 192-384, bf16 under
    O2 (the module's parameters cast by ``amp.initialize("O2")``),
    ``impl="fast"``, dropout 0.1, without and with ``include_norm_add``.
    Each forward and backward is held against the same module on the
    kernels' plain versions (:func:`_plain_kernels`) at the same dropout
    seed, within :data:`MODULE_TOL` (the planted fault, another seed,
    must fail it); launches exactly flash 1 + 1 a call and, with
    norm-add, LayerNorm 1 + 1.  The flash kernels at this Sq != Sk
    padded shape are timed beside SDPA with the float mask and the
    bound.  Then fp32 (TF32 off, no dropout) card against CPU at batch
    2: the output within 1e-5 of its largest magnitude, the grads within
    1e-4 relative L2."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(60)
    amp_ = amp.initialize("O2")
    dt = amp_.policy.compute_dtype
    q = torch.randn(b, sq, h, device=dev, generator=gen).to(dt)
    k = torch.randn(b, sk, h, device=dev, generator=gen).to(dt)
    cot = torch.randn(b, sq, h, device=dev, generator=gen).to(dt)
    lengths = torch.randint(sk // 2, sk + 1, (b,), device=dev, generator=gen)
    pad = (torch.arange(sk, device=dev)[None, :] >= lengths[:, None]).int()
    names = ["query", "key"]
    launches, records = {}, {}
    for norm_add in (False, True):
        torch.manual_seed(61)
        mod = EncdecMultiheadAttn(h, nh, dropout=0.1, bias=True,
                                  include_norm_add=norm_add, impl="fast",
                                  dtype=dt)
        amp_.cast_module_(mod)
        mod.to(dev)
        pnames = names + [n for n, _ in mod.named_parameters()]
        torch.cuda.synchronize()
        reset_launch_counts()
        out, grads = _encdec_run(mod, q, k, pad, cot, 62)
        torch.cuda.synchronize()
        counted = launch_counts()
        with _plain_kernels():
            out_p, grads_p = _encdec_run(mod, q, k, pad, cot, 62)
            out_f, _ = _encdec_run(mod, q, k, pad, cot, 63)
        torch.cuda.synchronize()
        want = {n: 0 for n in counted}
        want.update({"flash_attention_fwd": 1, "flash_attention_bwd": 1})
        if norm_add:
            want.update({"layer_norm": 1, "layer_norm_bwd": 1})
        rel = {n: _rel(a, w) for n, a, w in zip(pnames, grads, grads_p)}
        case = "norm_add" if norm_add else "plain"
        rec = {"out_max_abs_err": _err(out, out_p),
               "out_frac_differing": _frac_differing(out, out_p),
               "grad_rel_l2": rel, "launches": counted,
               "planted_fault_other_seed_err": _err(out_f, out_p)}
        emit({"phase": "encdec_attn", "case": case, "batch": [b, sq, sk],
              "d_model": h, "heads": nh, "dtype": _dt(dt), "dropout": 0.1,
              "key_lengths": lengths.tolist(), "tol": MODULE_TOL, **rec})
        check(counted == want, f"encdec_attn {case}: launches {counted} "
              f"!= {want}")
        check(_close(out, out_p, 1e-3, ulps=2),
              f"encdec_attn {case}: output {rec['out_max_abs_err']}")
        check(all(r <= 1e-2 for r in rel.values()),
              f"encdec_attn {case}: gradients {rel}")
        check(not _close(out_f, out_p, 1e-3, ulps=2),
              f"encdec_attn {case}: the check misses another dropout seed")
        launches[case], records[case] = counted, rec
        del mod, out, grads, out_p, grads_p, out_f
    # the flash kernels alone at this shape: (B*H, S, 64) with the
    # broadcast (B, Sq, Sk) key-padding bias, dropout 0.1
    d = h // nh
    q3 = torch.randn(b * nh, sq, d, device=dev, generator=gen).to(dt)
    k3 = torch.randn(b * nh, sk, d, device=dev, generator=gen).to(dt)
    v3 = torch.randn(b * nh, sk, d, device=dev, generator=gen).to(dt)
    do = torch.randn(b * nh, sq, d, device=dev, generator=gen).to(dt)
    bias = torch.where(pad.bool(), -1e9, 0.0)[:, None, :].expand(b, sq, sk)
    args = (_pack_seed(97531, device=dev), d ** -0.5, False, 0.1, (nh, nh))
    o, lse = flash_attention_fwd(q3, k3, v3, *args, bias=bias)
    o_ref, lse_ref = flash_attention_fwd_ref(q3, k3, v3, *args, bias=bias)
    g = flash_attention_bwd(q3, k3, v3, o, lse, do, *args, bias=bias)
    g_ref = flash_attention_bwd_ref(q3, k3, v3, o, lse, do, *args, bias=bias)
    torch.cuda.synchronize()
    errs = [_err(o, o_ref), _err(lse, lse_ref)] + [
        _err(a, w) for a, w in zip(g[:3], g_ref[:3])]
    check(_split_close(o, o_ref) and _close(lse, lse_ref, 1e-5)
          and all(_split_close(a, w) for a, w in zip(g[:3], g_ref[:3])),
          f"encdec flash kernels: {errs}")
    q4, k4, v4, do4 = (t.reshape(b, nh, -1, d) for t in (q3, k3, v3, do))
    sdpa_mask = torch.where(pad.bool(), -1e9, 0.0).to(dt)[:, None, None, :]
    kern_f = timings(lambda: flash_attention_fwd(q3, k3, v3, *args,
                                                 bias=bias), iters=20)
    plain_f = timings(lambda: flash_attention_fwd_ref(q3, k3, v3, *args,
                                                      bias=bias), iters=5)
    lib_f = timings(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=sdpa_mask), iters=20)
    kern_b = timings(lambda: flash_attention_bwd(q3, k3, v3, o, lse, do,
                                                 *args, bias=bias), iters=10)
    plain_b = timings(lambda: flash_attention_bwd_ref(
        q3, k3, v3, o, lse, do, *args, bias=bias), iters=3)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=sdpa_mask)
        torch.autograd.grad(out, (qg, kg, vg), do4)

    lib_b = timings(sdpa_fwd_bwd, iters=10)
    name = (f"Transformer-big cross-attention B={b} H={nh} Sq={sq} Sk={sk} "
            f"bf16 dropout=0.1 padding bias")
    cases = {}
    for kind, kern, plain, lib, backward, err in (
            ("fwd", kern_f, plain_f, lib_f, False, max(errs[:2])),
            ("bwd", kern_b, plain_b, lib_b, True, max(errs[2:]))):
        bound, by = _flash_bound(q3, k3, bias, backward=backward,
                                 causal=False)
        cases[kind] = {"case": name, "design": FLASH_DESIGN[dt],
                       "max_abs_err": err, "tol": SPLIT_TOL,
                       **_merge(kern, plain, lib), "bound_ms": bound,
                       "bound_by": by,
                       "library": "F.scaled_dot_product_attention with the "
                       "float key mask, no dropout" + (
                           ", forward + backward" if backward else "")}
        emit({"phase": "kernel", "kernel": f"flash_attention_{kind}_bias",
              **cases[kind]})
    del q3, k3, v3, do, o, lse, g, g_ref, o_ref, lse_ref, qg, kg, vg
    torch.cuda.empty_cache()
    # fp32 card against CPU, TF32 off, no dropout
    cpu = torch.Generator().manual_seed(64)
    xq = torch.randn(parity_b, sq, h, generator=cpu)
    xk = torch.randn(parity_b, sk, h, generator=cpu)
    xc = torch.randn(parity_b, sq, h, generator=cpu)
    xpad = (torch.arange(sk)[None, :]
            >= torch.tensor([3 * sk // 4, sk])[:, None]).int()
    torch.manual_seed(65)
    ref_mod = EncdecMultiheadAttn(h, nh, bias=True, include_norm_add=True)
    with torch.no_grad():
        for p in ref_mod.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=cpu))
    res = {}
    for key, where in SIDES:
        mod = EncdecMultiheadAttn(h, nh, bias=True, include_norm_add=True)
        mod.load_state_dict(ref_mod.state_dict())
        mod.to(where)
        qg, kg = xq.to(where).requires_grad_(), xk.to(where).requires_grad_()
        out = mod(qg, kg, key_padding_mask=xpad.to(where), is_training=False)
        gs = torch.autograd.grad(out, [qg, kg, *mod.parameters()],
                                 xc.to(where))
        res[key] = (out.detach().cpu(), [t.cpu() for t in gs])
    pnames = names + [n for n, _ in ref_mod.named_parameters()]
    out_err = _err(res["card"][0], res["cpu"][0])
    rel = {n: _rel(a, w) for n, a, w in zip(pnames, res["card"][1],
                                            res["cpu"][1])}
    emit({"phase": "encdec_parity", "batch": [parity_b, sq, sk],
          "dtype": "float32", "include_norm_add": True,
          "out_max_abs_err": out_err,
          "out_max_abs": float(res["cpu"][0].abs().max()),
          "grad_rel_l2": rel, "phase_s": time.perf_counter() - t_phase,
          "tol": "output 1e-5 of max|want|; gradients 1e-4 relative L2"})
    check(_close(res["card"][0], res["cpu"][0], 1e-5),
          f"encdec parity: output differs by {out_err}")
    check(all(r <= 1e-4 for r in rel.values()),
          f"encdec parity: gradients differ {rel}")
    return launches, cases


UNTIED_GRADS = ("encoder.layers.0.self_attn.in_proj_weight",
                "encoder.layers.23.ffn_out.kernel", "mlm_head.kernel",
                "encoder.word_embeddings.weight")
TOKEN_TYPE_GRADS = ("token_type_embeddings.weight", "word_embeddings.weight",
                    "layers.0.self_attn.in_proj_weight",
                    "layers.23.ffn_out.kernel")


def phase_bert_untied(dev, b: int = 12, s: int = 512, k: int = 2,
                      parity_b: int = 2, parity_s: int = 256):
    """BERT-large with the untied MLM head (``tie_word_embeddings=False``:
    ``mlm_head`` (1024, 30592) in the compute dtype in place of the tied
    decoder and ``mlm_bias``): fp32 card against CPU at 2 x 256 (the
    BERT gate: loss 1e-4, four grads 1e-3 relative L2); ``BertEncoder``
    with ``token_type_ids`` (two types, the boundary seeded), fp32 card
    against CPU at the same size (sum(x * cot) within 1e-4 relative, four
    grads, the token-type table's among them, 1e-3 relative L2); then O2
    + ``fused_lamb(1e-3, weight_decay=0.01)`` training at 12 x 512
    padded, K = 2, through :func:`phase_bert_train`: losses finite and
    falling, a planted overflow skipped, and exactly K x (LN 50, LN
    backward 50, flash 24 + 24, cross-entropy 1 + 1, LAMB one a leaf)
    launches, the leaves counted from the tree: the tied model's, plus
    ``mlm_head``'s kernel and bias, less ``mlm_bias``."""
    t_phase = time.perf_counter()
    params = init_bert_params(BertConfig.large(tie_word_embeddings=False),
                              torch.Generator().manual_seed(20))
    phase_bert_parity(params, cfg=BertConfig.large(
        compute_dtype=torch.float32, tie_word_embeddings=False),
        b=parity_b, s=parity_s, devices=tuple(w for _, w in SIDES),
        names=UNTIED_GRADS, phase="bert_untied_parity")
    # token types: the encoder's own tree plus a seeded two-row table
    cfg = BertConfig.large(compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(21)
    enc_state = {n[len("encoder."):]: t for n, t in params.items()
                 if n.startswith("encoder.")}
    enc_state["token_type_embeddings.weight"] = torch.empty(
        cfg.type_vocab_size, cfg.hidden_size).normal_(0.0, 0.02,
                                                      generator=gen)
    ids, _, mask = _mlm_batch("cpu", gen, parity_b, parity_s, cfg.vocab_size,
                              (200, parity_s))
    cut = torch.randint(1, parity_s, (parity_b,), generator=gen)
    types = (torch.arange(parity_s)[None, :] >= cut[:, None]).long()
    cot = torch.randn(parity_b, parity_s, cfg.hidden_size, generator=gen)
    out = {}
    for key, where in SIDES:
        enc = BertEncoder(cfg)
        enc.load_state_dict(enc_state)
        enc.to(where)
        x = enc(ids.to(where), token_type_ids=types.to(where),
                attention_mask=mask.to(where))
        obj = (x * cot.to(where)).sum()
        ps = dict(enc.named_parameters())
        gs = torch.autograd.grad(obj, [ps[n] for n in TOKEN_TYPE_GRADS])
        out[key] = (float(obj.detach()), [t.cpu() for t in gs])
        del enc, x, ps, gs
    rel = {n: _rel(a, w) for n, a, w in zip(TOKEN_TYPE_GRADS,
                                            out["card"][1], out["cpu"][1])}
    obj_err = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    emit({"phase": "bert_token_types", "model": "BERT-large encoder fp32, "
          "two token types, padded", "batch": [parity_b, parity_s],
          "type_cut": cut.tolist(), "objective_card": out["card"][0],
          "objective_cpu": out["cpu"][0], "objective_rel_err": obj_err,
          "grad_rel_l2": rel})
    check(obj_err <= 1e-4, f"bert_token_types: objectives differ {obj_err}")
    check(all(r <= 1e-3 for r in rel.values()),
          f"bert_token_types: gradients differ {rel}")
    with torch.device("meta"):
        tied_leaves = sum(1 for _ in BertForMLM(BertConfig.large())
                          .parameters())
    counted, step, carry, _ = phase_bert_train(
        dev, params, b=b, s=s, k=k, timed=1,
        cfg=BertConfig.large(tie_word_embeddings=False),
        phase="bert_untied_train")
    n_leaves = len(carry[0])
    emit({"phase": "bert_untied_leaves", "lamb_leaves": n_leaves,
          "tied_leaves": tied_leaves, "phase_s": time.perf_counter()
          - t_phase})
    check(n_leaves == tied_leaves + 2 - 1 and "mlm_bias" not in carry[0],
          f"bert_untied: {n_leaves} leaves, tied {tied_leaves}")
    del step, carry, params
    torch.cuda.empty_cache()
    return counted


NOVOGRAD_ADAGRAD = (
    ("fused_novograd", "fused_novograd(1e-2, betas=(0.95, 0.98), "
     "weight_decay=1e-3, bias_correction=True)",
     lambda: fused_novograd(1e-2, betas=(0.95, 0.98), weight_decay=1e-3,
                            bias_correction=True)),
    ("fused_adagrad", "fused_adagrad(1e-2)", lambda: fused_adagrad(1e-2)),
)


def _state_leaves(opt_state) -> dict:
    """Every tensor of an optimizer state, by field and name."""
    out = {}
    for field, val in opt_state._asdict().items():
        if isinstance(val, dict):
            out.update({f"{field}.{n}": t for n, t in val.items()})
        else:
            out[field] = val
    return out


def phase_novograd_adagrad(dev, params, b: int = 16, s: int = 1024,
                           k: int = 4, windows: int = 2):
    """GPT-2 small O2 at 16 x 1024 with dropout (``_train_setup``) under
    ``fused_novograd`` and then ``fused_adagrad``, each through
    ``AmpOptimizer``'s fused route, ``windows`` windows of K = 4, one
    host read each, the launch counts reset before the first and read
    after it (K x (LN 25, LN backward 25, flash 12 + 12, cross-entropy
    1 + 1)): losses finite, the last window's last below the first step's
    (two windows: this set-up's loss jumps at step 4 under any of the
    optimizers, fused_adam's in ``train`` too, and falls again after).
    The first step's updates on the card within 1e-5 relative L2 of the
    same transform on the CPU over the same fp32 grads and masters.  A planted overflow: skipped, the
    masters and the whole optimizer state bit for bit, the scale
    halved."""
    out = {}
    for name, what, make in NOVOGRAD_ADAGRAD:
        first = {}

        def keep_first(grads, masters, state, first=first):
            if not first:
                first.update(
                    grads={n: g.float().clone() for n, g in grads.items()},
                    masters={n: t.clone() for n, t in masters.items()},
                    inv_scale=1.0 / state.scaler[0].loss_scale.clone())

        cfg, step, carry, plant = _train_setup(dev, params, b, s, tx=make(),
                                               on_grads=keep_first)
        driver = FusedTrainDriver(step, steps_per_dispatch=k,
                                  metrics={"loss": "last", "skipped": "sum",
                                           "loss_scale": "last"},
                                  per_step=("loss",))
        walls, reads = [], []
        for i in range(windows):
            torch.cuda.synchronize()
            if i == 0:
                reset_launch_counts()
            t0 = time.perf_counter()
            carry, res = driver.run_window(carry)
            reads.append(read_metrics(res))  # the window's one host read
            walls.append(time.perf_counter() - t0)
            if i == 0:
                counted = launch_counts()
        layers = cfg.num_layers
        per_step = {n: 0 for n in counted}
        per_step.update({"layer_norm": 2 * layers + 1,
                         "layer_norm_bwd": 2 * layers + 1,
                         "flash_attention_fwd": layers,
                         "flash_attention_bwd": layers,
                         "softmax_xentropy_fwd": 1,
                         "softmax_xentropy_bwd": 1})
        losses = sum((r.per_step["loss"] for r in reads), [])
        # the first step's update, card against CPU
        tx = make()
        upd = {}
        for key, where in SIDES:
            ms = {n: t.to(where) for n, t in first["masters"].items()}
            gs = {n: t.to(where) for n, t in first["grads"].items()}
            u, _ = tx.update(gs, tx.init(ms), ms,
                             inv_scale=first["inv_scale"].to(where),
                             found_inf=torch.tensor(False, device=where))
            upd[key] = u
        rel = max(_rel(upd["card"][n].cpu(), upd["cpu"][n])
                  for n in upd["cpu"] if upd["cpu"][n].any())
        del upd, first
        # a planted overflow
        masters, state = carry
        before = {n: t.clone() for n, t in masters.items()}
        st_before = {n: t.clone()
                     for n, t in _state_leaves(state.opt_state).items()}
        scale_before = float(state.scaler[0].loss_scale)
        plant["inf"] = True
        carry, m = step(carry, None)
        plant["inf"] = False
        masters, state = carry
        torch.cuda.synchronize()
        same = (all(torch.equal(masters[n], before[n]) for n in before)
                and all(torch.equal(t, st_before[n]) for n, t in
                        _state_leaves(state.opt_state).items()))
        scale_after = float(state.scaler[0].loss_scale)
        rec = {"optimizer": what, "batch": [b, s], "steps_per_window": k,
               "window_walls_s": walls, "tokens_per_s": b * s * k / walls[-1],
               "losses_per_step": losses,
               "loss_scale": reads[-1].metrics["loss_scale"],
               "launches_one_window": counted,
               "first_step_update_rel_l2_card_vs_cpu": rel,
               "overflow_skipped": bool(m["skipped"]),
               "overflow_state_unchanged": same,
               "scale_before_after": [scale_before, scale_after]}
        emit({"phase": "novograd_adagrad", "model": "GPT-2 small O2, "
              "dropout 0.1", **rec})
        check(all(math.isfinite(x) for x in losses),
              f"{name}: non-finite loss")
        check(losses[-1] < losses[0], f"{name}: loss did not fall {losses}")
        check(counted == {n: k * c for n, c in per_step.items()},
              f"{name}: launch counts {counted} != K x {per_step}")
        check(rel <= 1e-5, f"{name}: first update card vs CPU {rel}")
        check(bool(m["skipped"]) and same and scale_after
              == scale_before / 2, f"{name}: the overflow was not skipped "
              "cleanly")
        out[name] = counted
        del step, carry, masters, state, before, st_before
        torch.cuda.empty_cache()
    return out


DCGAN_KEYS = ("errD", "errG", "scale_d_real", "scale_d_fake", "scale_g")


def _bn_forward_f64(self, x, stats, train: bool = True):
    """``models.dcgan.BatchNorm.forward`` with its statistics and
    normalisation in float64 (the fp32 floor's reference)."""
    x64 = x.double()
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x64.mean(dims)
        var = torch.clamp_min((x64 * x64).mean(dims) - mean * mean, 0.0)
        m = self.momentum
        stats = (m * stats[0] + (1.0 - m) * mean.detach().float(),
                 m * stats[1] + (1.0 - m) * var.detach().float())
    else:
        mean, var = (t.double() for t in stats)
    mul = torch.rsqrt(var + self.eps) * self.scale.double()
    return (x64 - mean) * mul + self.bias.double(), stats


class _ContiguousConvs:
    """``torch.nn.functional`` with contiguous convolution operands (the
    CPU's float64 convolution backward refuses the channels-last views)."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def conv2d(x, w, **kw):
        return F.conv2d(x.contiguous(), w.contiguous(), **kw)

    @staticmethod
    def conv_transpose2d(x, w, **kw):
        return F.conv_transpose2d(x.contiguous(), w.contiguous(), **kw)


@contextlib.contextmanager
def _dcgan_float64(gan):
    """The DCGAN's convolutions and BatchNorms in float64 inside the block
    (parameters, activations, statistics; the masters and the optimizer
    stay fp32)."""
    from apex_tpu_torch.amp import functional as amp_fn
    from apex_tpu_torch.amp.layers import Conv, ConvTranspose
    from apex_tpu_torch.models import dcgan as dcgan_models
    for net in (gan.netG, gan.netD):
        net.to(torch.float64)
        net.compute_dtype = torch.float64
        for m in net.modules():
            if isinstance(m, (Conv, ConvTranspose)):
                m.dtype = torch.float64
    saved = dcgan_models.BatchNorm.forward, amp_fn.torch_F
    dcgan_models.BatchNorm.forward = _bn_forward_f64
    amp_fn.torch_F = _ContiguousConvs()
    try:
        yield
    finally:
        dcgan_models.BatchNorm.forward, amp_fn.torch_F = saved


#: the DCGAN parity's bound on each grad's relative L2 error, card against
#: CPU: a leaky-ReLU kink decided the other way at one element whose
#: input rounds across 0 moved D's real-loss grads 3.5e-3 at batch 8
#: (one of 131,072 elements of BN_1's output: tools/dcgan_probe.py)
DCGAN_GRAD_LIMIT = 1e-2


def _dcgan_parity(params, nz: int, b: int) -> dict:
    """One G+D iteration of the example's step at O0 (fp32), card against
    CPU, from the same weights and data: errD and errG within 1e-4, and
    the grads each optimizer was handed (D's two losses', then G's)
    within :data:`DCGAN_GRAD_LIMIT` relative L2.  G's grads are taken
    through the same D on both sides: the card's D is set to the CPU's
    after its step (D's first Adam step moves each weight by lr * sign(g),
    so where g rounds across 0 the two D's differ by 2 lr and G's grads
    through them by per cents).  Beside them, each side against the same
    iteration on the CPU with the convolutions and BatchNorms in float64
    (the fp32 floor)."""
    gen = torch.Generator().manual_seed(71)
    real = torch.rand((b, 64, 64, 3), generator=gen) * 2 - 1
    z = torch.randn((b, 1, 1, nz), generator=gen)
    out, d_after = {}, {}
    for key, where in (SIDES[1], ("f64", "cpu"), SIDES[0]):
        gan, carry = dcgan_example.build("O0", nz=nz, device=where,
                                         params=params)
        seen = {}

        def spy(opt, tag, method, net=None):
            fn = getattr(opt, method)

            def wrapped(grads, *a, **kw):
                seen[tag] = {n: g.detach().double().cpu()
                             for n, g in grads.items()}
                res = fn({n: g.float() for n, g in grads.items()}, *a, **kw)
                if net is not None:  # D's step: every side goes on from
                    dm = res[0]      # the CPU's D
                    if key == "cpu":
                        d_after.update({n: t.clone() for n, t in dm.items()})
                    else:
                        for n, t in dm.items():
                            t.copy_(d_after[n])
                        amp.AmpOptimizer.copy_to_model(net, dm)
                return res
            setattr(opt, method, wrapped)

        spy(gan.optD, "d_real", "accumulate")
        spy(gan.optD, "d_fake", "step", gan.netD)
        spy(gan.optG, "g", "step")
        ctx = _dcgan_float64(gan) if key == "f64" else contextlib.nullcontext()
        with ctx:
            _, m = dcgan_example.make_step(gan)(carry, (real.to(where),
                                                        z.to(where)))
        out[key] = ({n: float(m[n]) for n in ("errD", "errG")}, seen)
    (lc, gc), (lp, gp), (_, g64) = out["card"], out["cpu"], out["f64"]
    loss_err = max(abs(lc[n] - lp[n]) for n in lc)
    names = [(tag, n) for tag in gp for n in gp[tag]]
    rel = {f"{t}.{n}": _rel(gc[t][n], gp[t][n]) for t, n in names}
    card64 = {f"{t}.{n}": _rel(gc[t][n], g64[t][n]) for t, n in names}
    floor = {f"{t}.{n}": _rel(gp[t][n], g64[t][n]) for t, n in names}
    worst = sorted(rel, key=lambda k: -rel[k])[:4]
    by_loss = {t: max(v for k, v in rel.items() if k.startswith(t + "."))
               for t in gp}
    emit({"phase": "dcgan_parity", "batch": b, "dtype": "float32 (O0)",
          "losses_card": lc, "losses_cpu": lp, "loss_abs_err": loss_err,
          "grad_rel_l2_max_by_loss": by_loss,
          "worst_card_vs_cpu_f64_floor": {k: [rel[k], card64[k], floor[k]]
                                          for k in worst},
          "grad_rel_l2_cpu_vs_f64_max": max(floor.values()),
          "tol": f"losses 1e-4; every grad {DCGAN_GRAD_LIMIT} relative L2"})
    check(loss_err <= 1e-4, f"dcgan parity: losses differ by {loss_err}")
    check(all(r <= DCGAN_GRAD_LIMIT for r in rel.values()),
          f"dcgan parity: grads differ {by_loss}")
    return rel


def phase_dcgan(dev, b: int = 128, nz: int = 100, k: int = 5,
                windows: int = 2, parity_b: int = 8):
    """The DCGAN example (``apex_tpu_torch/examples/dcgan.py``) at the
    published widths (Radford et al. 2016: nz 100, ngf = ndf = 64,
    64 x 64 x 3, batch 128) under O1 with its three loss scalers:
    ``windows`` windows of K = 5 G+D iterations, each read once
    (losses finite, the three scales read there), images/s from the
    last; the hand-written kernels' launches over those windows (the
    path runs none: cuDNN convolutions, plain BatchNorm); then one
    iteration with an inf planted in D's errD_fake gradients, which must
    skip D's step alone (D's masters and state bit for bit, G's moved)
    and halve scaler 1 alone; one iteration under ``torch.profiler``;
    then :func:`_dcgan_parity` at batch 8."""
    t_phase = time.perf_counter()
    with torch.device("meta"):
        shapes_g, shapes_d = Generator(nz=nz), Discriminator()
    init = torch.Generator().manual_seed(70)
    params = (*init_dcgan_params(shapes_g, init),
              *init_dcgan_params(shapes_d, init))
    gan, carry = dcgan_example.build("O1", nz=nz, device=dev, params=params)
    plant = {"on": False}
    d_step = gan.optD.step

    def planted(grads, *a, **kw):
        if plant["on"]:
            g = grads["Conv_4.kernel"].clone()
            g[0, 0, 0, 0] = float("inf")
            grads = dict(grads, **{"Conv_4.kernel": g})
        return d_step(grads, *a, **kw)

    gan.optD.step = planted
    step = dcgan_example.make_step(gan)
    driver = FusedTrainDriver(step, steps_per_dispatch=k,
                              metrics=dcgan_example.METRICS)
    data = torch.Generator(device=dev).manual_seed(72)
    torch.cuda.synchronize()
    reset_launch_counts()
    amp.F.reset_product_counts()
    reads, walls = [], []
    for _ in range(windows):
        window = dcgan_example.synthetic_window(data, k, b, nz)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, res = driver.run_window(carry, window)
        reads.append(read_metrics(res.metrics))  # one host read a window
        walls.append(time.perf_counter() - t0)
    counted = launch_counts()
    products = {f"{op} {dt}": n for (op, dt), n
                in amp.F.product_counts().items()}
    gm, _, gstate, dm, _, dstate = carry
    g_before = {n: t.clone() for n, t in gm.items()}
    d_before = {n: t.clone() for n, t in dm.items()}
    d_state = {n: t.clone() for n, t in _state_leaves(dstate.opt_state)
               .items()}
    scales = [float(s.loss_scale) for s in (*dstate.scaler[:2],
                                            gstate.scaler[2])]
    real, z = dcgan_example.synthetic_window(data, 1, b, nz)
    plant["on"] = True
    carry, m = step(carry, (real[0], z[0]))
    plant["on"] = False
    gm, _, gstate, dm, _, dstate = carry
    torch.cuda.synchronize()
    after = [float(s.loss_scale) for s in (*dstate.scaler[:2],
                                           gstate.scaler[2])]
    d_kept = (all(torch.equal(dm[n], d_before[n]) for n in dm)
              and all(torch.equal(t, d_state[n]) for n, t in
                      _state_leaves(dstate.opt_state).items()))
    g_moved = any(not torch.equal(gm[n], g_before[n]) for n in gm)
    rec = {"batch": b, "nz": nz, "ngf": 64, "ndf": 64, "opt_level": "O1",
           "steps_per_window": k, "window_walls_s": walls,
           "images_per_s": b * k / walls[-1],
           "window_reads": reads, "launches_windows": counted,
           "products_windows": products,
           "overflow": {"scales_before": scales, "scales_after": after,
                        "d_state_unchanged": d_kept, "g_moved": g_moved}}
    emit({"phase": "dcgan", "model": "DCGAN 64 x 64, three loss scalers "
          "(errD_real 0, errD_fake 1, errG 2), fused_adam(2e-4, betas=(0.5, "
          "0.999))", **rec})
    check(all(math.isfinite(r[n]) for r in reads for n in DCGAN_KEYS),
          f"dcgan: non-finite meters {reads}")
    check(not any(counted.values()), f"dcgan: a kernel launched {counted}")
    check(d_kept and g_moved, "dcgan: the errD_fake overflow did not skip "
          "D's step alone")
    check(after == [scales[0], scales[1] / 2, scales[2]],
          f"dcgan: scales {scales} -> {after}: scaler 1 alone must halve")
    phase_step_profile(lambda c, _batch: step(c, (real[0], z[0])), carry,
                       "dcgan_profile", f"one O1 G+D iteration of the DCGAN "
                       f"example, batch {b}, three loss scalers")
    del gan, carry, gm, dm, g_before, d_before, d_state
    torch.cuda.empty_cache()
    _dcgan_parity(params, nz, parity_b)
    emit({"phase": "dcgan_done", "phase_s": time.perf_counter() - t_phase})
    return rec


MLP_SIZES = [480, 1024, 1024, 512, 256, 1]  # apex tests/L0/run_mlp


def phase_library_modules(dev, batch: int = 1024,
                          xent=(16384, 50304), bn=(128, 56, 56, 256)):
    """The remaining library modules at their own sizes: ``MLP`` at
    apex's test sizes ([480, 1024, 1024, 512, 256, 1], batch 1024; the
    sigmoid activation: with ReLU after every layer this seed's one output
    unit is dead for every row, and the check would hold zeros), fp32
    (TF32 off: output and grads within 1e-5 relative L2) and bf16 (5e-2
    of the largest magnitude), forward and backward against the CPU;
    ``SoftmaxCrossEntropyLoss`` at (16384, 50304) bf16 with smoothing 0.1
    and ``padding_idx`` 0 against the same module on the kernels' plain
    versions (losses 2e-6 of max, dlogits 1 bf16 ulp + 1e-9), its
    launches counted (1 + 1); ``BatchNorm2d_NHWC(fuse_relu=True)`` with
    ``z`` at RN50's (128, 56, 56, 256) fp32 in an NCCL group of one, bit
    for bit ``SyncBatchNorm`` over the group + add + ReLU, forward and
    backward, with no collective of its own; ``compute_weights`` of the
    weight-normed MLP, card against CPU within 1e-6 of the largest
    weight; ``BF16_Optimizer(fused_adam, dynamic_loss_scale=True)`` on
    the bf16 MLP, five steps, the third with a planted inf: losses
    finite and falling, the skip keeping the masters bit for bit, the
    scale 2^32 halved once."""
    t_phase = time.perf_counter()
    out = {}
    # MLP, fp32 and bf16, card against CPU
    torch.manual_seed(80)
    mlp = MLP(MLP_SIZES, activation="sigmoid")
    gen = torch.Generator().manual_seed(81)
    x = torch.randn(batch, MLP_SIZES[0], generator=gen)
    cot = torch.randn(batch, MLP_SIZES[-1], generator=gen)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 5e-2)):
        res = {}
        for key, where in SIDES:
            m = MLP(MLP_SIZES, activation="sigmoid").to(dtype=dt)
            m.load_state_dict(mlp.state_dict())
            m.to(where)
            xg = x.to(where, dt).requires_grad_()
            y = m(xg)
            gs = torch.autograd.grad(y, [xg, *m.parameters()],
                                     cot.to(where, dt))
            res[key] = [y.detach().cpu().float()] + [
                g.cpu().float() for g in gs]
        if dt == torch.float32:
            errs = [_rel(a, w) for a, w in zip(res["card"], res["cpu"])]
        else:
            errs = [_err(a, w) / float(w.abs().max().clamp_min(1e-30))
                    for a, w in zip(res["card"], res["cpu"])]
        out[f"mlp_{_dt(dt)}"] = max(errs)
        check(max(errs) <= tol, f"mlp {_dt(dt)}: card vs CPU {errs}")
        check(all(bool(t.any()) for t in res["cpu"]),
              f"mlp {_dt(dt)}: an output or gradient is all zero")
    # SoftmaxCrossEntropyLoss through the kernels and their plain versions
    rows, v = xent
    g = torch.Generator(device=dev).manual_seed(82)
    logits = (3 * torch.randn(rows, v, device=dev, generator=g)).to(
        torch.bfloat16)
    labels = torch.randint(0, v, (rows,), device=dev, generator=g)
    labels[::7] = 0
    loss_mod = SoftmaxCrossEntropyLoss(smoothing=0.1, padding_idx=0)

    def xe_run():
        lg = logits.detach().requires_grad_()
        loss = loss_mod(lg, labels)
        (dl,) = torch.autograd.grad(loss.sum(), lg)
        return loss.detach(), dl

    torch.cuda.synchronize()
    reset_launch_counts()
    loss, dl = xe_run()
    torch.cuda.synchronize()
    xe_counts = launch_counts()
    with _plain_kernels():
        want_l, want_d = xe_run()
    torch.cuda.synchronize()
    xe_errs = [_err(loss, want_l), _err(dl, want_d)]
    out["xentropy"] = {"launches": xe_counts, "errs_loss_dlogits": xe_errs,
                       "padded_rows_zero": bool((loss[::7] == 0).all()
                                                and (dl[::7] == 0).all())}
    check(_close(loss, want_l, 2e-6)
          and bf16_ulp_ok(dl, want_d, ulps=1, floor=1e-9),
          f"SoftmaxCrossEntropyLoss: {xe_errs}")
    check(out["xentropy"]["padded_rows_zero"],
          "SoftmaxCrossEntropyLoss: a padded row has a loss or a gradient")
    check(xe_counts["softmax_xentropy_fwd"] == 1
          and xe_counts["softmax_xentropy_bwd"] == 1
          and sum(xe_counts.values()) == 2,
          f"SoftmaxCrossEntropyLoss: launches {xe_counts}")
    del logits, labels, loss, dl, want_l, want_d
    torch.cuda.empty_cache()
    # BatchNorm2d_NHWC with the fused add + ReLU, NCCL world 1
    group_ok = init_distributed(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout_s=120)
    check(group_ok and dist.get_backend() == "nccl",
          "library_modules: no NCCL group")
    try:
        c = bn[-1]
        gb = torch.Generator(device=dev).manual_seed(83)
        xb = 2 + 1.5 * torch.randn(bn, device=dev, generator=gb)
        zb = torch.randn(bn, device=dev, generator=gb)
        cotb = torch.randn(bn, device=dev, generator=gb)
        scale = 1 + 0.1 * torch.randn(c, device=dev, generator=gb)
        shift = 0.1 * torch.randn(c, device=dev, generator=gb)
        runs = {}
        for kind in ("groupbn", "syncbn"):
            if kind == "groupbn":
                mod = BatchNorm2d_NHWC(c, fuse_relu=True, bn_group=1,
                                       world_size=1)
                inner = mod.bn
            else:
                mod = inner = SyncBatchNorm(c, group=data_parallel_group())
            inner.load_state_dict({"scale": scale, "bias": shift})
            mod.to(dev)
            xg, zg = xb.clone().requires_grad_(), zb.clone().requires_grad_()
            stats = inner.init_stats(dev)
            reset_collective_counts()
            if kind == "groupbn":
                y, new = mod(xg, zg, stats)
            else:
                y0, new = mod(xg, stats)
                y = torch.relu(y0 + zg)
            grads = torch.autograd.grad(
                y, [xg, zg, inner.scale, inner.bias], cotb)
            torch.cuda.synchronize()
            runs[kind] = ([y.detach(), *new, *grads], collective_counts())
        (a, ca), (w, cw) = runs["groupbn"], runs["syncbn"]
        bitwise = all(torch.equal(p, q) for p, q in zip(a, w))
        out["groupbn"] = {"bit_for_bit": bitwise, "collectives_groupbn": ca,
                          "collectives_syncbn": cw,
                          "max_abs_errs": [_err(p, q) for p, q in zip(a, w)]}
        check(bitwise, f"BatchNorm2d_NHWC: not bit for bit {out['groupbn']}")
        check(ca == {} and cw == {"sync_bn_fwd": 1, "sync_bn_bwd": 1},
              f"BatchNorm2d_NHWC: collectives {ca} / {cw}")
        del runs, a, w, xb, zb, cotb
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    # weight norm of the MLP, card against CPU
    wn = apply_weight_norm(dict(mlp.named_parameters()))
    wn = {n: t.detach() for n, t in wn.items()}
    w_card = compute_weights({n: t.to(dev) for n, t in wn.items()})
    w_cpu = compute_weights(wn)
    top = max(float(t.abs().max()) for t in w_cpu.values())
    wn_err = max(_err(w_card[n].cpu(), w_cpu[n]) for n in w_cpu) / top
    out["weight_norm_rel_err"] = wn_err
    check(wn_err <= 1e-6, f"compute_weights: card vs CPU {wn_err}")
    # BF16_Optimizer over fused_adam on the bf16 MLP
    opt = BF16_Optimizer(fused_adam(1e-3), dynamic_loss_scale=True)
    model = {n: t.detach().to(dev, torch.bfloat16)
             for n, t in mlp.named_parameters()}
    state = opt.init(model)
    net = MLP(MLP_SIZES, activation="sigmoid").to(dev, torch.bfloat16)
    xs = x.to(dev, torch.bfloat16)
    target = torch.randn(batch, 1, device=dev, generator=g)
    losses, scales, kept = [], [], None
    for i in range(5):
        ps = {n: t.requires_grad_() for n, t in model.items()}
        y = torch.func.functional_call(net, ps, (xs,))
        loss = F.mse_loss(y.float(), target)
        grads = dict(zip(ps, torch.autograd.grad(opt.scale_loss(loss, state),
                                                 list(ps.values()))))
        if i == 2:
            grads["kernel_0"] = grads["kernel_0"].clone()
            grads["kernel_0"][0, 0] = float("inf")
            before = {n: t.clone() for n, t in state.master.items()}
        model = {n: t.detach() for n, t in model.items()}
        model, state = opt.step(grads, state, model)
        if i == 2:
            kept = all(torch.equal(state.master[n], before[n])
                       for n in before)
        losses.append(float(loss.detach()))
        scales.append(float(state.scaler.loss_scale))
    out["bf16_optimizer"] = {"losses": losses, "scales": scales,
                             "skip_kept_masters": kept}
    emit({"phase": "library_modules", "mlp_sizes": MLP_SIZES, "batch": batch,
          "xentropy_shape": list(xent), "groupbn_shape": list(bn),
          "phase_s": time.perf_counter() - t_phase, **out,
          "tol": "MLP fp32 1e-5 relative L2, bf16 5e-2 of max; xentropy "
                 "losses 2e-6 of max, dlogits 1 bf16 ulp + 1e-9; groupbn bit "
                 "for bit; weight norm 1e-6 of max"})
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"BF16_Optimizer: {losses}")
    check(kept and scales == [2.0 ** 32] * 2 + [2.0 ** 31] * 3,
          f"BF16_Optimizer: skip kept {kept}, scales {scales}")
    return xe_counts


# -- phase 16: the rest of the library, part 2: ASP sparsity and the RNNs ----

C1_SHAPE = (50257, 768)  # GPT-2's word table


def phase_l2norm_card(dev, shape=C1_SHAPE):
    """``multi_tensor_l2norm`` on the card (one ``_foreach_norm`` launch)
    against the sum-of-squares form ``sqrt(sum(x * x))`` in fp32 on the
    card and against float64, on one N(0, 0.02^2) leaf of GPT-2's word
    table: within 1e-6 relative of the sum of squares (the CPU takes
    that form, as the JAX package does)."""
    gen = torch.Generator(device=dev).manual_seed(50)
    x = torch.empty(shape, device=dev).normal_(0.0, 0.02, generator=gen)
    launch = float(multi_tensor_l2norm([x]))
    sumsq = float(torch.sqrt(torch.sum(x * x)))
    exact = float(torch.sqrt(torch.sum(x.double() * x.double())))
    rec = {"phase": "l2norm_card", "shape": list(shape),
           "multi_tensor_l2norm": launch, "sum_of_squares_fp32": sumsq,
           "float64": exact,
           "rel_launch_vs_sum_of_squares": abs(launch - sumsq) / sumsq,
           "rel_launch_vs_float64": abs(launch - exact) / exact,
           "rel_sum_of_squares_vs_float64": abs(sumsq - exact) / exact}
    emit(rec)
    check(rec["rel_launch_vs_sum_of_squares"] <= 1e-6,
          f"l2norm_card: the launch is {rec['rel_launch_vs_sum_of_squares']}"
          " from the sum of squares")
    del x
    return rec


def _mask_mismatch(w, got, want, m: int = 4, n: int = 2):
    """m4n2_1d masks of one ``io`` leaf: (groups that differ, of them the
    groups whose two best scores are within 4 fp32 ulps)."""
    groups = [sparse_masklib._pad_cols(sparse_masklib._canonicalize(
        t.float().cpu(), "io")[0], m).reshape(-1, m) for t in (w, got, want)]
    bad = (groups[1] != groups[2]).any(dim=1)
    if not bool(bad.any()):
        return 0, 0
    table = torch.from_numpy(sparse_masklib.compute_valid_1d_patterns(m, n))
    top2 = (groups[0][bad].abs() @ table.T).topk(2, dim=1).values
    ulp = torch.finfo(torch.float32).eps * top2[:, 0]
    return int(bad.sum()), int((top2[:, 0] - top2[:, 1] <= 4 * ulp).sum())


def phase_asp(dev, params, dense_rec, b: int = 12, s: int = 512, k: int = 6,
              leaf_2d: str = "mlm_transform.kernel"):
    """BERT-large MLM pruned 2:4 by ASP on the card: ``bert_train``'s
    configuration (O2, 12 x 512 padded, dropout 0.1) with
    ``ASP().prune_trained_model(params, fused_lamb(1e-3,
    weight_decay=0.01))`` through ``AmpOptimizer``'s unfused route, one
    K = 6 window (:func:`phase_bert_train` with ``sparse``: exact
    launches, every pruned position exactly 0 in the masters and the
    bf16 model, a planted overflow skipped with the masks unchanged)
    and one profiled step.  Then: every sparse leaf exactly half dense;
    the card's m4n2_1d masks against the CPU's, leaf by leaf (a
    differing group counted apart when its two best scores are within 4
    fp32 ulps); a checkpoint round trip of the masks bit for bit, and a
    restore into masks of ``None`` raising; ``m4n2_2d_best`` on the card
    and the host's ``m4n2_2d_greedy`` timed on one (1024, 1024) leaf;
    sequences/s beside ``bert_train``'s dense window of the same run
    (reported, not gated)."""
    t_phase = time.perf_counter()
    phase_l2norm_card(dev)
    counted, step, carry, rec = phase_bert_train(
        dev, params, b=b, s=s, k=k, timed=1, phase="asp_train", sparse=True)
    phase_step_profile(step, carry, "asp_profile", "one O2 step, BERT-large "
                       "MLM pruned 2:4, batch 12 x 512 padded, dropout 0.1, "
                       "sparsify(fused_lamb) on the unfused route")
    del step
    masters, state = carry
    masks = state.opt_state.masks
    sparse = [n for n, m in masks.items() if m is not None]
    half = {n: int(masks[n].double().sum()) * 2 == masks[n].numel()
            for n in sparse}
    t0 = time.perf_counter()
    cpu_masks, _ = ASP().compute_sparse_masks(params)
    cpu_mask_s = time.perf_counter() - t0
    differ = {n: _mask_mismatch(params[n], masks[n], cpu_masks[n])
              for n in sparse}
    same_leaves = [n for n in sparse if cpu_masks[n] is not None
                   and torch.equal(masks[n].cpu(), cpu_masks[n])]
    # the masks through a checkpoint: bit for bit into a template that
    # holds masks, refused by one whose masks are all None
    tmp = tempfile.mkdtemp(prefix="asp_ckpt_")
    try:
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(tmp, {"masks": masks}, 1)
        save_s = time.perf_counter() - t0
        template = {"masks": {n: None if m is None else torch.empty_like(m)
                              for n, m in masks.items()}}
        t0 = time.perf_counter()
        got, _ = checkpoint.restore_checkpoint(tmp, template)
        restore_s = time.perf_counter() - t0
        restored = all(torch.equal(got["masks"][n], masks[n])
                       for n in sparse) and all(
            got["masks"][n] is None for n in masks if n not in sparse)
        del got
        try:
            checkpoint.restore_checkpoint(
                tmp, {"masks": {n: None for n in masks}})
            none_template = "restored (sparsity dropped)"
        except checkpoint.CheckpointIntegrityError as e:
            none_template = f"raised {type(e).__name__}"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # the 2d masks on one (1024, 1024) leaf: exhaustive on the card,
    # greedy on the host
    w = params[leaf_2d].to(dev)
    best = sparse_masklib.create_mask(w, "m4n2_2d_best", layout="io")
    best_cpu = sparse_masklib.create_mask(params[leaf_2d], "m4n2_2d_best",
                                          layout="io")
    best_ms = time_ms(lambda: sparse_masklib.create_mask(
        w, "m4n2_2d_best", layout="io"), iters=5, warmup=1)
    t0 = time.perf_counter()
    greedy = sparse_masklib.create_mask(w, "m4n2_2d_greedy", layout="io")
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    out = {"phase": "asp", "model": "BERT-large MLM, O2, 12 x 512 padded, "
           "ASP m4n2_1d over every Dense kernel, sparsify(fused_lamb)",
           "sparse_leaves": len(sparse),
           "sparse_leaf_names_sample": sparse[:3] + sparse[-2:],
           "sparse_elements": sum(masks[n].numel() for n in sparse),
           "all_half_dense": all(half.values()),
           "masks_equal_cpu_leaves": len(same_leaves),
           "mask_groups_differing": sum(d[0] for d in differ.values()),
           "mask_groups_differing_near_tie": sum(d[1]
                                                 for d in differ.values()),
           "cpu_masks_s": cpu_mask_s,
           "checkpoint": {"save_s": save_s, "restore_s": restore_s,
                          "masks_bit_for_bit": restored,
                          "restore_into_none_masks": none_template},
           "m4n2_2d_best_ms_1024x1024": best_ms,
           "m4n2_2d_best_equal_cpu": bool(torch.equal(best.cpu(), best_cpu)),
           "m4n2_2d_best_half_dense": int(best.double().sum()) * 2
           == best.numel(),
           "m4n2_2d_greedy_s_1024x1024_host": greedy_s,
           "sequences_per_s": rec["sequences_per_s"],
           "dense_sequences_per_s_bert_train":
               dense_rec["sequences_per_s"],
           "valid_tokens_per_s": rec["valid_tokens_per_s"],
           "loss_first_step": rec["loss_first_step"],
           "loss_last_window": rec["loss_last_window"],
           "launches_one_window": counted,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    check(out["all_half_dense"], f"asp: a leaf is not half dense: {half}")
    check(len(sparse) > 0 and all(d[0] == d[1] for d in differ.values())
          and len(same_leaves) + sum(1 for d in differ.values() if d[0])
          == len(sparse), f"asp: card masks differ from the CPU's {differ}")
    check(restored, "asp: the masks changed through a checkpoint")
    check(none_template.startswith("raised"),
          "asp: a restore into masks of None did not raise")
    check(out["m4n2_2d_best_half_dense"], "asp: 2d-best is not half dense")
    del carry, masters, state, masks, cpu_masks, w, best, greedy
    torch.cuda.empty_cache()
    return counted


# (mode, source, input width, hidden, layers, steps, batch)
RNN_CONFIGS = (
    ("lstm", "Zaremba et al. 2014, the large PTB LSTM: 2 layers of 1500, "
     "35 steps, batch 20", 1500, 1500, 2, 35, 20),
    ("gru", "the large PTB LSTM's sizes (Zaremba et al. 2014) through the "
     "GRU", 1500, 1500, 2, 35, 20),
    ("mlstm", "Radford et al. 2017, the byte-level mLSTM: 1 layer of 4096 "
     "over 64-wide byte embeddings, 256 steps, batch 128", 64, 4096, 1, 256,
     128),
)
RNN_PARITY = (16, 4)  # steps, batch of the card-vs-CPU check
RNN_TOL = ("outputs 1e-4 max abs; gradients of sum(outputs) 1e-4 "
           "relative L2 per weight and for the input")


def _rnn_flops(mode, inp, hidden, layers, t, b) -> float:
    """Multiply-adds x 2 of the gate products (and the mLSTM's m)."""
    gates = {"lstm": 4, "gru": 3, "mlstm": 4}[mode] * hidden
    per = 0
    for i in range(layers):
        fan_in = inp if i == 0 else hidden
        per += fan_in * gates + hidden * gates
        if mode == "mlstm":
            per += fan_in * hidden + hidden * hidden
    return 2.0 * per * t * b


def _rnn_grads(model, x):
    ys, _ = model(x)
    ps = list(model.parameters())
    gs = torch.autograd.grad(ys.float().sum(), ps + [x])
    return ys.detach(), gs


def phase_rnn(dev, configs=RNN_CONFIGS, parity=RNN_PARITY, repeats: int = 3):
    """The RNN stacks at published sizes, fp32 with TF32 off: each
    against the port on the CPU on its first 16 steps at batch 4 (the
    same seeded weights; :data:`RNN_TOL`), then forward and forward plus
    backward timed at full size (host wall around a synchronised run,
    the device-busy share of one profiled forward and backward; the
    steps run as a Python loop of eager launches), and the mLSTM once in
    bf16 against its fp32 run (the gap reported)."""
    from torch.profiler import ProfilerActivity, profile

    factories = {"lstm": LSTM, "gru": GRU, "mlstm": mLSTM}
    out = {}
    for i, (mode, source, inp, hidden, layers, t, b) in enumerate(configs):
        t_case = time.perf_counter()
        model = factories[mode](inp, hidden_size=hidden, num_layers=layers,
                                generator=torch.Generator()
                                .manual_seed(40 + i))
        card = factories[mode](inp, hidden_size=hidden, num_layers=layers)
        card.load_state_dict(model.state_dict())
        card.to(dev)
        pt, pb = parity
        gen = torch.Generator().manual_seed(45 + i)
        x = torch.randn(pt, pb, inp, generator=gen)
        got = _rnn_grads(card, x.to(dev).requires_grad_(True))
        want = _rnn_grads(model, x.clone().requires_grad_(True))
        names = [n for n, _ in model.named_parameters()] + ["input"]
        out_err = _err(got[0].cpu(), want[0])
        grad_rel = {n: _rel(g.cpu(), w) for n, g, w in zip(names, got[1],
                                                           want[1])}
        del model, got, want
        xs = torch.randn(t, b, inp, device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(47 + i))
        xg = xs.clone().requires_grad_(True)

        def fwd():
            with torch.no_grad():
                return card(xs)[0]

        def fwd_bwd():
            return _rnn_grads(card, xg)

        walls = {}
        for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
            fn()
            torch.cuda.synchronize()
            ms = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            walls[name] = sorted(ms)[len(ms) // 2]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fwd_bwd()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        busy = sum(e.time_range.elapsed_us() for e in _kernel_events(prof)
                   ) / 1e3
        flops = _rnn_flops(mode, inp, hidden, layers, t, b)
        rec = {"phase": "rnn", "mode": mode, "source": source,
               "input": inp, "hidden": hidden, "layers": layers,
               "steps": t, "batch": b, "dtype": "float32 (TF32 off)",
               "parity_steps_batch": list(parity), "tol": RNN_TOL,
               "parity_out_max_abs_err": out_err,
               "parity_grad_rel_l2": grad_rel,
               "fwd_ms": walls["fwd"], "fwd_bwd_ms": walls["fwd_bwd"],
               "fwd_flops": flops,
               # the products' operations alone at the fp32 peak (the
               # backward's two products a forward one: 3x)
               "fwd_ops_ms_at_fp32_peak": flops / FP32_FLOPS * 1e3,
               "fwd_bwd_ops_ms_at_fp32_peak": 3 * flops / FP32_FLOPS * 1e3,
               "profiled_fwd_bwd_wall_ms": prof_wall,
               "device_busy_ms": busy or None,
               "device_busy_share": busy / prof_wall if busy else None,
               "sequences_per_s_fwd_bwd": b / walls["fwd_bwd"] * 1e3}
        if mode == "mlstm":
            # the same weights in bf16 (compute and outputs; fp32 carries)
            half = factories[mode](inp, hidden_size=hidden,
                                   num_layers=layers, dtype=torch.bfloat16)
            half.load_state_dict(card.state_dict())
            half.to(dev)
            with torch.no_grad():
                ys32 = card(xs)[0]
                ys16 = half(xs)[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                half(xs)
            torch.cuda.synchronize()
            rec["bf16"] = {"fwd_ms": (time.perf_counter() - t0) * 1e3,
                           "max_abs_gap_vs_fp32": _err(ys16, ys32),
                           "rel_l2_gap_vs_fp32": _rel(ys16.float(), ys32),
                           "finite": bool(torch.isfinite(ys16).all())}
            del half, ys32, ys16
        rec["case_s"] = time.perf_counter() - t_case
        emit(rec)
        check(out_err <= 1e-4, f"rnn {mode}: outputs differ by {out_err}")
        check(all(r <= 1e-4 for r in grad_rel.values()),
              f"rnn {mode}: gradients differ {grad_rel}")
        check(rec.get("bf16", {"finite": True})["finite"],
              f"rnn {mode}: non-finite bf16 outputs")
        out[mode] = rec
        del card, xs, xg
        torch.cuda.empty_cache()
    return out


# -- phase 17: scale-out (meshes, sequence, tensor and pipeline parallelism) --

#: the long-context gang: GPT-2 small's width, 12 GPTLayers, a (data 2,
#: seq 2) mesh of gloo ranks on the one card, global S 4096 (2048 a
#: rank), batch 1 a data rank, O2, attention dropout, dots_saveable, M = 2
#: microbatches, 2 steps of DistributedFusedAdam
LC = dict(layers=12, hidden=768, heads=12, data=2, seq=2, s_local=2048,
          b_local=1, m=2, steps=2, rate=0.1, remat="dots_saveable")
#: the tensor/pipeline gang: transformer_parallel at GPT-2 small's width
#: (12 heads: 6 a rank; MLP 3072: 1536 a rank), 12 blocks as 2 stages of
#: 6 on a (pipe 2, model 2) mesh, S 1024, M = 4 microbatches of 2, 2 steps
TPP = dict(pipe=2, model=2, blocks=6, d_model=768, d_ff=3072, heads=12,
           head_dim=64, seq=1024, m=4, mb=2, steps=2)
SP_GANG = 4
SP_TIMEOUT_S = 300
#: layers of sp_world1's boundaries (depth cut: the update's arithmetic,
#: not the depth, is what that check holds)
SP_WORLD1_LAYERS = 2
#: the flash kernels' bf16 rule, for a sharded attention against the
#: unsharded kernel call
SP_TOL = ("outputs: within 1 bf16 ulp or 1e-2 of max|want|; lse: within "
          "1e-3 absolute (fp32); gradients: within 2 bf16 ulps + 1e-2 of "
          "max|want|")
#: a gang's training against the one-rank run of the same model on the
#: card: each step's loss within 1e-3 relative, and the masters' movement
#: from their start within max(0.05, 2 x floor) relative L2 (the floor:
#: the one-rank run on the kernels' plain versions against itself on the
#: kernels; Adam's first steps turn rounding-level gradient differences
#: on near-zero gradients into +-lr moves, so the movement, not the
#: masters, is compared)
SP_TRAIN_TOL = ("loss 1e-3 relative a step; masters' movement within "
                "max(0.05, 2 x floor) relative L2, floor = the one-rank "
                "run on the kernels' plain versions against itself")


def _sp_out_ok(got, want) -> bool:
    return bf16_ulp_ok(got, want, ulps=1, floor=1e-2 * want.float().abs()
                       .max().item())


def _sp_grad_ok(got, want) -> bool:
    return bf16_ulp_ok(got, want, ulps=2, floor=1e-2 * want.float().abs()
                       .max().item())


def _sp_counts():
    return {k: v for k, v in launch_counts().items() if v}


def _lc_cfg(cfg: dict, dtype=torch.bfloat16) -> GPTConfig:
    return GPTConfig(hidden_size=cfg["hidden"], num_heads=cfg["heads"],
                     num_layers=cfg["layers"], dropout_rate=0.0,
                     attn_dropout_rate=cfg["rate"], compute_dtype=dtype)


def _grads_of(fn, *inputs, cot):
    """``fn(*inputs)`` and the gradients of sum(out * cot) w.r.t. the
    inputs (fresh leaves)."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    (out.float() * cot.float()).sum().backward()
    return [out.detach()] + [t.grad for t in leaves]


def _sp_attention(dev, seq, cfg: dict) -> dict:
    """Ring and Ulysses attention over ``seq`` at the model's attention
    shape (batch 1, 12 heads of 64, this rank's 2048 of 4096 positions,
    bf16, causal, dropout 0.1) against the unsharded flash kernels on the
    whole sequence: outputs, lse and gradients within :data:`SP_TOL`; the
    dropout mask of every block this rank runs bit for bit the unsharded
    mask's slice; the launches (r + 1 forward and r + 1 backward blocks on
    seq rank r); the ring on the kernels against the ring on their plain
    versions; the two planted ring faults must miss."""
    from apex_tpu_torch.ops.attention import _drop_keep
    from apex_tpu_torch.parallel import (ring_attention, ring_attention_fwd,
                                         ulysses_attention)

    h, d, rate, seed = cfg["heads"], cfg["hidden"] // cfg["heads"], \
        cfg["rate"], 77
    n, r, sl = seq.size, seq.index, cfg["s_local"]
    s = n * sl
    gen = torch.Generator(device=dev).manual_seed(60)
    q, k, v, do = (torch.randn(1, h, s, d, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    rows = slice(r * sl, (r + 1) * sl)
    loc = [t[:, :, rows].contiguous() for t in (q, k, v, do)]
    pack = _pack_seed(seed, device=dev)
    scale = d ** -0.5
    o_full, lse_full = flash_attention_fwd(
        *(t.reshape(h, s, d).contiguous() for t in (q, k, v)), pack, scale,
        True, rate, (h, h))
    o_full = o_full.reshape(1, h, s, d)
    reset_launch_counts()
    reset_collective_counts()
    o_ring, lse_ring = ring_attention_fwd(*loc[:3], seq, causal=True,
                                          dropout_rate=rate,
                                          dropout_seed=seed)
    fwd_launches = _sp_counts()
    want_o = o_full[:, :, rows]
    want_lse = lse_full.reshape(1, h, s)[:, :, rows]

    def ring(a, b, c):
        return ring_attention(a, b, c, seq, causal=True, dropout_rate=rate,
                              dropout_seed=seed)

    def full(a, b, c):
        return flash_attention(a, b, c, causal=True, dropout_rate=rate,
                               dropout_seed=seed)

    reset_launch_counts()
    reset_collective_counts()
    got = _grads_of(ring, *loc[:3], cot=loc[3])
    ring_launches, ring_colls = _sp_counts(), collective_counts()
    ref = [t[:, :, rows] for t in _grads_of(full, q, k, v, cot=do)]
    with _plain_kernels():
        plain = _grads_of(ring, *loc[:3], cot=loc[3])
    # the dropout mask of each block this rank runs (row and column
    # offsets as the ring packs them) against the unsharded mask
    full_mask = _drop_keep(pack, h, (h, h), s, s, rate)
    masks = []
    for i in range(n):
        src = (r - i) % n
        if i > r:
            continue  # a causal ring skips the future blocks
        bp = _pack_seed(seed, r * sl, src * sl, device=dev)
        masks.append(bool(torch.equal(
            _drop_keep(bp, h, (h, h), sl, sl, rate),
            full_mask[:, rows, src * sl:(src + 1) * sl])))
    del full_mask
    faults = {}
    for name, fault in (("column_offset", {"col": 64}),
                        ("mask_off_diagonal", {"mask_all": True})):
        o_f, _ = ring_attention_fwd(*loc[:3], seq, causal=True,
                                    dropout_rate=rate, dropout_seed=seed,
                                    _fault=fault)
        faults[name] = {"passes_gate": _sp_out_ok(o_f, want_o),
                        "max_abs_err": _err(o_f, want_o)}
    reset_collective_counts()
    uly = _grads_of(lambda a, b, c: ulysses_attention(
        a, b, c, seq, causal=True, dropout_rate=rate, dropout_seed=seed),
        *loc[:3], cot=loc[3])
    uly_colls = collective_counts()
    rec = {
        "shape": f"batch 1, {h} heads x {d}, {sl} of {s} positions a rank, "
                 f"bf16, causal, dropout {rate}",
        "ring_out_ok": _sp_out_ok(o_ring, want_o),
        "ring_out_err": _err(o_ring, want_o),
        "ring_lse_err": _err(lse_ring, want_lse),
        "ring_grads_ok": [_sp_grad_ok(g, w) for g, w in zip(got[1:],
                                                            ref[1:])],
        "ring_grads_err": [_err(g, w) for g, w in zip(got[1:], ref[1:])],
        "ring_autograd_out_ok": _sp_out_ok(got[0], want_o),
        "ring_fwd_launches": fwd_launches,
        "ring_fwd_bwd_launches": ring_launches,
        "ring_collectives": ring_colls,
        "ring_vs_plain_out_err": _err(got[0], plain[0]),
        "ring_vs_plain_ok": _close(got[0], plain[0], 1e-3, ulps=2)
        and all(_rel(g, p) <= 1e-2 for g, p in zip(got[1:], plain[1:])),
        "ring_vs_plain_grad_rel": [_rel(g, p)
                                   for g, p in zip(got[1:], plain[1:])],
        "masks_bitwise": masks,
        "planted_faults": faults,
        "ulysses_out_ok": _sp_out_ok(uly[0], want_o),
        "ulysses_out_err": _err(uly[0], want_o),
        "ulysses_grads_ok": [_sp_grad_ok(g, w)
                             for g, w in zip(uly[1:], ref[1:])],
        "ulysses_grads_err": [_err(g, w) for g, w in zip(uly[1:], ref[1:])],
        "ulysses_collectives": uly_colls}
    # the off-diagonal mask can show only where an off-diagonal block runs
    faults["mask_off_diagonal"]["can_show"] = r > 0
    rec["ok"] = (rec["ring_out_ok"] and rec["ring_lse_err"] <= 1e-3
                 and all(rec["ring_grads_ok"])
                 and rec["ring_autograd_out_ok"] and rec["ring_vs_plain_ok"]
                 and all(masks) and len(masks) == r + 1
                 and not any(f["passes_gate"] for f in faults.values()
                             if f.get("can_show", True))
                 and rec["ulysses_out_ok"] and all(rec["ulysses_grads_ok"]))
    return rec


#: a GPTLayer on the kernels against itself on their plain versions: the
#: attention's few-ulp differences pass through two bf16 products and a
#: LayerNorm, so the output is held like the gradients, by relative L2
LAYER_TOL = "output and every gradient within 1e-2 relative L2"


def _layer_vs_plain(layer, x, gen_seed: int = 3) -> dict:
    """One GPTLayer forward and backward with the kernels against the same
    on their plain versions (LayerNorm, the ring's flash blocks), the same
    dropout: :data:`LAYER_TOL` (the ring's attention alone is held to the
    bf16 rule in :func:`_sp_attention`)."""
    dev = x.device
    cot = torch.randn(x.shape, generator=torch.Generator(device=dev)
                      .manual_seed(4), device=dev, dtype=x.dtype)
    res = []
    for plain in (False, True):
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        for p in layer.parameters():
            p.grad = None
        xi = x.detach().clone().requires_grad_()
        with _plain_kernels() if plain else contextlib.nullcontext():
            out = layer(xi, False, gen)
            (out.float() * cot.float()).sum().backward()
        res.append((out.detach(), xi.grad,
                    {n: p.grad.clone() for n, p in layer.named_parameters()}))
    for p in layer.parameters():
        p.grad = None
    (o, dx, g), (po, pdx, pg) = res
    rels = {n: _rel(g[n], pg[n]) for n in g}
    return {"out_err": _err(o, po), "out_rel": _rel(o, po),
            "dx_rel": _rel(dx, pdx), "grad_rel_max": max(rels.values()),
            "ok": max(_rel(o, po), _rel(dx, pdx), *rels.values()) <= 1e-2,
            "tol": LAYER_TOL}


def _masters_flat(masters: dict) -> torch.Tensor:
    return torch.cat([v.detach().float().reshape(-1) for v in
                      masters.values()]).cpu()


def _movement(got: torch.Tensor, want: torch.Tensor,
              start: torch.Tensor) -> float:
    d = (want.double() - start.double())
    return float((got.double() - want.double()).norm()
                 / d.norm().clamp_min(1e-30))


def _timed_step(run_step, profiled: bool) -> dict:
    """``run_step()``'s wall; under ``torch.profiler`` (``profiled``) also
    this process's device-busy ms and share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if not profiled:
        return {"wall_ms": wall_ms}
    busy = sum(e.time_range.elapsed_us() for e in _kernel_events(prof)) / 1e3
    return {"wall_ms": wall_ms, "profiled": True, "device_busy_ms": busy,
            "device_busy_share": busy / wall_ms}


def _lc_run(dev, cfg, seq, data, mesh=None, plain=False) -> dict:
    """``cfg["steps"]`` steps of examples/gpt_long_context over ``mesh``
    (None: one rank, the whole batch and sequence, its loss taken n_seq
    times for the gang's gradient): per-step losses and flat masters (on
    the CPU), the launches and collectives of the steps, each step's
    wall (the last profiled, on a mesh)."""
    from apex_tpu_torch.examples import gpt_long_context as lc
    from apex_tpu_torch.parallel import P

    mcfg = _lc_cfg(cfg)
    attend = None if mesh is None else lc.sequence_attention(
        "ring", seq, data.index * cfg["b_local"])
    layers = lc.make_layers(mcfg, cfg["layers"], attend, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    step, carry, cspec = lc.build(
        layers, seq, data, microbatches=cfg["m"], remat_policy=cfg["remat"],
        generator=gen, grad_factor=1.0 if mesh else float(cfg["seq"]))
    driver = FusedTrainDriver(
        step, steps_per_dispatch=1, mesh=mesh,
        batch_spec=P("data", "seq") if mesh else None,
        carry_spec=cspec if mesh else None, per_step=("loss",))
    x, y = lc.synthetic_data(mcfg, cfg["data"] * cfg["b_local"],
                             cfg["seq"] * cfg["s_local"])
    x, y = x.to(dev), y.to(dev)
    window = (x.expand(cfg["m"], *x.shape), y.expand(cfg["m"], *y.shape))
    state = {"carry": carry, "losses": []}

    def one():
        state["carry"], res = driver.run_window(state["carry"], window)
        state["losses"].append(res.per_step["loss"])

    start = _masters_flat(carry[0])
    masters, times = [], []
    reset_launch_counts()
    reset_collective_counts()
    with _plain_kernels() if plain else contextlib.nullcontext():
        for i in range(cfg["steps"]):
            times.append(_timed_step(one, mesh is not None
                                     and i == cfg["steps"] - 1))
            masters.append(_masters_flat(state["carry"][0]))
    return {"losses": [float(t) for t in state["losses"]],
            "masters": masters, "start": start, "launches": _sp_counts(),
            "collectives": collective_counts(), "times": times,
            "layers": layers}


def _lc_compare(gang: dict, ref: dict, floor: dict) -> dict:
    """The gang's steps against the one-rank run's (:data:`SP_TRAIN_TOL`),
    beside the floor's."""
    steps = []
    for i in range(len(ref["losses"])):
        fl = _movement(floor["masters"][i], ref["masters"][i], ref["start"])
        steps.append({
            "loss": gang["losses"][i], "one_rank_loss": ref["losses"][i],
            "loss_rel_err": abs(gang["losses"][i] - ref["losses"][i])
            / abs(ref["losses"][i]),
            "movement_rel_l2": _movement(gang["masters"][i],
                                         ref["masters"][i], ref["start"]),
            "floor_movement_rel_l2": fl,
            "floor_loss_rel_err": abs(floor["losses"][i] - ref["losses"][i])
            / abs(ref["losses"][i])})
    ok = all(st["loss_rel_err"] <= 1e-3 and st["movement_rel_l2"]
             <= max(0.05, 2 * st["floor_movement_rel_l2"]) for st in steps)
    return {"steps": steps, "ok": ok, "tol": SP_TRAIN_TOL}


def _lc_worker(dev, out_dir: str, rank: int, cfg: dict) -> dict:
    """One rank of ``long_context_gang``; rank 0 also runs the one-rank
    model and its floor after the gang."""
    from apex_tpu_torch.parallel import make_mesh

    mesh = make_mesh([("data", cfg["data"]), ("seq", cfg["seq"])])
    data, seq = mesh["data"], mesh["seq"]
    out = {"rank": rank, "coords": mesh.coords,
           "attention": _sp_attention(dev, seq, cfg)}
    gang = _lc_run(dev, cfg, seq, data, mesh)
    layers = gang.pop("layers")
    x = torch.randn(cfg["b_local"], cfg["s_local"], cfg["hidden"],
                    generator=torch.Generator(device=dev).manual_seed(8),
                    device=dev, dtype=torch.bfloat16)
    out["layer_vs_plain"] = _layer_vs_plain(layers[0], x)
    del layers
    digest = hashlib.sha256(gang["masters"][-1].numpy().tobytes())
    out.update({"losses": gang["losses"], "launches": gang["launches"],
                "collectives": gang["collectives"], "times": gang["times"],
                "masters_sha256": digest.hexdigest()})
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        torch.cuda.empty_cache()
        from apex_tpu_torch.parallel import Axis
        single = (Axis.single("seq"), Axis.single("data"))
        ref = _lc_run(dev, cfg, *single)
        ref.pop("layers")
        floor = _lc_run(dev, cfg, *single, plain=True)
        floor.pop("layers")
        out["one_rank"] = {"times": ref["times"],
                           "floor_times": floor["times"]}
        out["vs_one_rank"] = _lc_compare(gang, ref, floor)
    return out


def _tp_weights(stage_single, pipe_index: int):
    """Stage ``pipe_index``'s full weights, as the example seeds them."""
    from apex_tpu_torch.examples import transformer_parallel as ex
    return ex.full_weights(stage_single, 1, seed=100 + pipe_index)


def _tp_run(dev, cfg, pipe, model, data, plain=False) -> dict:
    """``cfg["steps"]`` O2 steps of examples/transformer_parallel: on the
    (pipe, model) mesh each rank's stage shard, or on one rank (axes of
    one member) all 2 x blocks blocks unsharded from the same weights."""
    from apex_tpu_torch.examples import transformer_parallel as ex
    from apex_tpu_torch.parallel import Axis
    from apex_tpu_torch.weights import tp_shard_params

    amp_ = amp.initialize("O2")
    dims = (cfg["d_model"], cfg["d_ff"], cfg["heads"], cfg["head_dim"])
    single = Axis.single("model")
    if pipe.group is None:  # one rank: the stages' full weights, in order
        stage = ex.make_stage(cfg["pipe"] * cfg["blocks"], *dims, single)
        full = {}
        for p in range(cfg["pipe"]):
            w = _tp_weights(ex.make_stage(cfg["blocks"], *dims, single), p)
            full.update({f"{int(k.split('.', 1)[0]) + p * cfg['blocks']}."
                         f"{k.split('.', 1)[1]}": v for k, v in w.items()})
        stage.load_state_dict(full)
    else:
        stage = ex.make_stage(cfg["blocks"], *dims, model)
        w = _tp_weights(ex.make_stage(cfg["blocks"], *dims, single),
                        pipe.index)
        stage.load_state_dict(tp_shard_params(w, model.index, cfg["model"]))
    stage.to(dev)
    opt = amp.AmpOptimizer(fused_adam(ex.LR), amp_)
    masters = opt.attach(stage)
    state = opt.init(masters)
    step = ex.make_step(stage, amp_, opt, pipe, model, data)
    g = torch.Generator().manual_seed(0)
    shape = (cfg["m"], cfg["mb"], cfg["seq"], cfg["d_model"])
    x = (torch.randn(shape, generator=g) * 0.5).to(dev)
    y = (torch.randn(shape, generator=g) * 0.5).to(dev)
    run = {"masters": masters, "state": state, "losses": []}
    start = {k: v.detach().cpu().clone() for k, v in masters.items()}

    def one():
        run["masters"], run["state"], loss = step(run["masters"],
                                                  run["state"], x, y)
        run["losses"].append(loss)

    reset_launch_counts()
    reset_collective_counts()
    times = []
    with _plain_kernels() if plain else contextlib.nullcontext():
        for i in range(cfg["steps"]):
            times.append(_timed_step(one, pipe.group is not None
                                     and i == cfg["steps"] - 1))
    return {"losses": [float(t) for t in run["losses"]], "start": start,
            "masters": {k: v.detach().cpu() for k, v in
                        run["masters"].items()},
            "launches": _sp_counts(), "collectives": collective_counts(),
            "times": times, "stage": stage}


def _tp_fault(stage, dev, cfg, model) -> dict:
    """The first block's MLP with its row-parallel backward passing the
    cotangent through unsummed (planted) against the same MLP summed:
    the input gradient must move by the factor the missing sum takes."""
    from apex_tpu_torch.parallel import replicated_loss

    mlp = stage[0].mlp
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(cfg["mb"], cfg["seq"], cfg["d_model"], generator=g,
                    device=dev)
    cot = torch.randn(x.shape, generator=g, device=dev)
    grads = []
    for fault in (False, True):
        mlp.wo._fault = fault
        xi = x.clone().requires_grad_()
        loss = replicated_loss((mlp(xi).float() * cot).sum(), model)
        grads.append(torch.autograd.grad(loss, mlp.wi.kernel)[0])
    mlp.wo._fault = False
    return {"wi_grad_rel_change": _rel(grads[1], grads[0])}


def _tp_worker(dev, out_dir: str, rank: int, cfg: dict) -> dict:
    """One rank of ``tp_pipeline_gang``: the steps, its masters saved for
    rank 0, which then runs the one-rank model and its floor and holds
    every rank's shards against it."""
    from apex_tpu_torch.parallel import Axis, make_mesh

    mesh = make_mesh([("data", 1), ("pipe", cfg["pipe"]),
                      ("model", cfg["model"])])
    data, pipe, model = mesh["data"], mesh["pipe"], mesh["model"]
    gang = _tp_run(dev, cfg, pipe, model, data)
    out = {"rank": rank, "coords": mesh.coords, "losses": gang["losses"],
           "launches": gang["launches"],
           "collectives": gang["collectives"], "times": gang["times"],
           "planted_row_no_sum": _tp_fault(gang["stage"], dev, cfg, model)}
    torch.save({"start": gang["start"], "masters": gang["masters"],
                "coords": mesh.coords},
               os.path.join(out_dir, f"masters{rank}.pt"))
    del gang
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        torch.cuda.empty_cache()
        single = (Axis.single("pipe"), Axis.single("model"),
                  Axis.single("data"))
        ref = _tp_run(dev, cfg, *single)
        floor = _tp_run(dev, cfg, *single, plain=True)
        out["one_rank"] = {"losses": ref["losses"], "times": ref["times"],
                           "floor_losses": floor["losses"]}
        out["vs_one_rank"] = _tp_compare(out_dir, cfg, ref, floor)
    return out


def _tp_shard_of(tree: dict, cfg: dict, p: int, m: int) -> dict:
    """Rank (p, m)'s flat shard of a one-rank tree (its stage's blocks,
    its model shard)."""
    from apex_tpu_torch.weights import tp_shard_params

    b = cfg["blocks"]
    stage = {f"{int(k.split('.', 1)[0]) - p * b}.{k.split('.', 1)[1]}": v
             for k, v in tree.items()
             if p * b <= int(k.split(".", 1)[0]) < (p + 1) * b}
    return tp_shard_params(stage, m, cfg["model"])


def _tp_compare(out_dir: str, cfg: dict, ref: dict, floor: dict) -> dict:
    """Every rank's final masters against its shard of the one-rank run's
    (and the floor's against the one-rank run's)."""
    got, want, start = [], [], []
    for r in range(cfg["pipe"] * cfg["model"]):
        rec = torch.load(os.path.join(out_dir, f"masters{r}.pt"))
        p, m = rec["coords"]["pipe"], rec["coords"]["model"]
        w = _tp_shard_of(ref["masters"], cfg, p, m)
        got.append(_masters_flat(rec["masters"]))
        want.append(_masters_flat({k: w[k] for k in rec["masters"]}))
        start.append(_masters_flat(rec["start"]))
    got, want, start = (torch.cat(t) for t in (got, want, start))
    fl = _movement(_masters_flat(floor["masters"]),
                   _masters_flat(ref["masters"]),
                   _masters_flat(ref["start"]))
    rec = {"movement_rel_l2": _movement(got, want, start),
           "floor_movement_rel_l2": fl,
           "floor_loss_rel_err": [abs(a - b) / abs(b) for a, b in
                                  zip(floor["losses"], ref["losses"])],
           "tol": SP_TRAIN_TOL}
    rec["ok"] = rec["movement_rel_l2"] <= max(0.05, 2 * fl)
    return rec


def sp_worker(out_dir: str) -> int:
    """One rank of ``long_context_gang``, ``tp_pipeline_gang`` or the
    scale-out part 2 gang (``chip_smoke.py --sp-worker DIR``): gloo on
    CUDA tensors, every rank
    on the one card (the device and the sizes in DIR/config.json); writes
    DIR/rank<r>.json."""
    fp32_precision()
    with open(os.path.join(out_dir, "config.json")) as fh:
        conf = json.load(fh)
    dev = torch.device(conf["device"])
    init_distributed("gloo", init_method=f"file://{out_dir}/rendezvous",
                     timeout_s=SP_TIMEOUT_S)
    rank = dist.get_rank()
    try:
        work = {"long_context": _lc_worker, "tp_pipeline": _tp_worker,
                "scale_out2": _so2_worker}[conf["kind"]]
        out = work(dev, out_dir, rank, conf["cfg"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def _sp_gang(dev, kind: str, cfg: dict, worker_argv=None):
    """``SP_GANG`` ranks of ``sp_worker`` on the card: the ranks' records
    and the gang's wall."""
    out_dir = tempfile.mkdtemp(prefix=f"apex_{kind}_")
    try:
        with open(os.path.join(out_dir, "config.json"), "w") as fh:
            json.dump({"device": str(dev), "kind": kind, "cfg": cfg}, fh)
        argv = (worker_argv or [os.path.abspath(__file__), "--sp-worker"])
        t0 = time.perf_counter()
        launch([*argv, out_dir], SP_GANG, timeout_s=SP_TIMEOUT_S,
               echo_stderr=False, check=True)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(SP_GANG):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return ranks, wall


def _dead_rank() -> dict:
    """A gang whose rank 2 raises after the mesh is made while its seq
    partner waits in a ring shift: the launcher must reap the gang and
    name rank 2."""
    code = ("import os, sys, torch\n"
            f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
            "from apex_tpu_torch.parallel import (init_distributed, "
            "make_mesh, ring_shift)\n"
            "init_distributed('gloo', timeout_s=60)\n"
            "seq = make_mesh([('data', 2), ('seq', 2)])['seq']\n"
            "if os.environ['RANK'] == '2':\n"
            "    raise RuntimeError('planted: rank 2 died')\n"
            "ring_shift(torch.ones(4), seq)\n")
    try:
        launch(["-c", code], SP_GANG, timeout_s=90, echo_stderr=False,
               check=True)
        return {"reaped": False}
    except MultiprocError as err:
        return {"reaped": True, "guilty_ranks": err.guilty_ranks(),
                "stderr_tail_names_it": "planted: rank 2 died" in str(err)}


def _rank_times(ranks) -> list:
    return [{"rank": rk["rank"], "coords": rk["coords"],
             "step_wall_ms": [t["wall_ms"] for t in rk["times"]],
             "profiled_step_device_busy_share":
                 rk["times"][-1].get("device_busy_share")}
            for rk in ranks]


def phase_long_context_gang(dev, cfg=None, worker_argv=None) -> dict:
    """Four gloo ranks on the one card, a (data 2, seq 2) mesh: ring and
    Ulysses attention at the model's attention shape against the
    unsharded kernels (:func:`_sp_attention`), then examples/
    gpt_long_context at GPT-2 small's width (:data:`LC`) for two steps,
    against the same model on one rank over the whole sequence and batch
    with the same weights and dropout seeds (:func:`_lc_compare`), every
    flash and LayerNorm launch and every collective counted exactly, the
    first layer with the kernels against its plain versions; planted: a
    ring block with a wrong column offset, one with the causal mask off
    the diagonal, a rank that dies."""
    cfg = dict(LC if cfg is None else cfg)
    ranks, wall = _sp_gang(dev, "long_context", cfg, worker_argv)
    dead = _dead_rank()
    layers, m, steps = cfg["layers"], cfg["m"], cfg["steps"]
    n = cfg["seq"]
    bad = []
    for rk in ranks:
        r = rk["coords"]["seq"]
        mbs = m * steps
        # dots_saveable runs each block's forward again in the backward
        want = {"flash_attention_fwd": 2 * (r + 1) * layers * mbs,
                "flash_attention_bwd": (r + 1) * layers * mbs,
                "layer_norm": 4 * layers * mbs,
                "layer_norm_bwd": 2 * layers * mbs}
        ring = {"fwd": 2 * (n - 1), "bwd": 2 * (n - 1) + 2 * n}
        # under gloo the ring shifts of CUDA tensors go through host memory
        host = "[host]" if dev.type == "cuda" else ""
        wc = {f"ring{host}": layers * mbs * (2 * ring["fwd"] + ring["bwd"]),
              "loss": 3 * mbs, "seq_presum": steps, "zero_flag": steps,
              "zero_grads": steps, "zero_params": steps}
        att = rk["attention"]
        att_want = {"flash_attention_fwd": r + 1}
        if rk["launches"] != want or rk["collectives"] != wc                 or att["ring_fwd_launches"] != att_want                 or att["ring_fwd_bwd_launches"] != {
                    "flash_attention_fwd": r + 1,
                    "flash_attention_bwd": r + 1}:
            bad.append({"rank": rk["rank"], "launches": rk["launches"],
                        "want": want, "collectives": rk["collectives"],
                        "want_collectives": wc})
    r0 = ranks[0]
    rec = {"phase": "long_context_gang", "card": nvidia_smi_line(),
           "world_size": SP_GANG,
           "backend": "gloo (CUDA tensors, every rank on one card)",
           "mesh": {"data": cfg["data"], "seq": cfg["seq"]},
           "model": f"{layers} GPTLayers, hidden {cfg['hidden']}, "
                    f"{cfg['heads']} heads, ring attention over seq, O2, "
                    f"attention dropout {cfg['rate']}, {cfg['remat']}, "
                    f"M = {m}, DistributedFusedAdam over data",
           "global_sequence": cfg["seq"] * cfg["s_local"],
           "batch": cfg["data"] * cfg["b_local"], "steps": steps,
           "gang_s": wall, "tol": SP_TOL,
           "attention": [rk["attention"] for rk in ranks],
           "layer_vs_plain": [rk["layer_vs_plain"] for rk in ranks],
           "launches_by_rank": [rk["launches"] for rk in ranks],
           "collectives_by_rank": [rk["collectives"] for rk in ranks],
           "count_mismatches": bad,
           "rank_times": _rank_times(ranks),
           "times_note": "gloo over the host between four processes "
                         "that share one card: not NVLink, not a "
                         "multi-card measure",
           "masters_identical_across_ranks":
               len({rk["masters_sha256"] for rk in ranks}) == 1,
           "one_rank": r0["one_rank"], "vs_one_rank": r0["vs_one_rank"],
           "planted_dead_rank": dead}
    emit(rec)
    check(all(rk["attention"]["ok"] for rk in ranks),
          f"long_context_gang: sharded attention: {rec['attention']}")
    check(all(rk["layer_vs_plain"]["ok"] for rk in ranks),
          f"long_context_gang: kernels vs plain: {rec['layer_vs_plain']}")
    check(not bad, f"long_context_gang: counts: {bad}")
    check(rec["masters_identical_across_ranks"],
          "long_context_gang: the ranks' gathered masters differ")
    check(r0["vs_one_rank"]["ok"],
          f"long_context_gang: not the one-rank run: {r0['vs_one_rank']}")
    check(dead == {"reaped": True, "guilty_ranks": [2],
                   "stderr_tail_names_it": True},
          f"long_context_gang: a dead rank was not surfaced: {dead}")
    return {"launches": r0["launches"],
            "launches_by_rank": rec["launches_by_rank"]}


def phase_tp_pipeline_gang(dev, cfg=None, worker_argv=None) -> dict:
    """Four gloo ranks on the one card, a (pipe 2, model 2) mesh:
    examples/transformer_parallel at GPT-2 small's width (:data:`TPP`),
    12 blocks as two stages of 6, two O2 steps, against the unsharded
    model on one rank with the merged weights: the losses within 1e-3
    relative a step, every rank's masters' movement within
    :data:`SP_TRAIN_TOL`; the launches (LayerNorm and flash forward and
    backward on the local heads, every tick of the schedule) and the
    collectives counted exactly; planted: a row-parallel backward without
    the cotangent's sum."""
    cfg = dict(TPP if cfg is None else cfg)
    ranks, wall = _sp_gang(dev, "tp_pipeline", cfg, worker_argv)
    ticks = cfg["m"] + cfg["pipe"] - 1
    blocks, steps = cfg["blocks"], cfg["steps"]
    want = {"layer_norm": 2 * blocks * ticks * steps,
            "layer_norm_bwd": 2 * blocks * ticks * steps,
            "flash_attention_fwd": blocks * ticks * steps,
            "flash_attention_bwd": blocks * ticks * steps}
    # a block: one psum each way after attention and after the MLP; the
    # pipeline: m + n - 2 shifts each way, one psum each way; the step's
    # model-replicated gradients in one flat all-reduce
    host = "[host]" if dev.type == "cuda" else ""
    wc = {"tp_psum": 4 * blocks * ticks * steps,
          f"pipe_shift{host}": 2 * (ticks - 1) * steps,
          "pipe_psum": 2 * steps, "tp_sync": steps}
    bad = [{"rank": rk["rank"], "launches": rk["launches"],
            "collectives": rk["collectives"]}
           for rk in ranks if rk["launches"] != want
           or rk["collectives"] != wc]
    r0 = ranks[0]
    losses = [rk["losses"] for rk in ranks]
    loss_err = [abs(a - b) / abs(b) for a, b in
                zip(r0["losses"], r0["one_rank"]["losses"])]
    fault = [rk["planted_row_no_sum"] for rk in ranks]
    rec = {"phase": "tp_pipeline_gang", "card": nvidia_smi_line(),
           "world_size": SP_GANG,
           "backend": "gloo (CUDA tensors, every rank on one card)",
           "mesh": {"pipe": cfg["pipe"], "model": cfg["model"]},
           "model": f"{cfg['pipe'] * blocks} transformer_parallel Stage "
                    f"blocks (d {cfg['d_model']}, {cfg['heads']} heads of "
                    f"{cfg['head_dim']}, MLP {cfg['d_ff']}) as "
                    f"{cfg['pipe']} stages, O2, fused_adam",
           "sequence": cfg["seq"], "microbatches": cfg["m"],
           "microbatch": cfg["mb"], "steps": steps, "gang_s": wall,
           "losses_by_rank": losses, "one_rank": r0["one_rank"],
           "loss_rel_err": loss_err, "vs_one_rank": r0["vs_one_rank"],
           "launches_by_rank": [rk["launches"] for rk in ranks],
           "want_launches": want, "collectives_by_rank":
               [rk["collectives"] for rk in ranks],
           "want_collectives": wc, "count_mismatches": bad,
           "rank_times": _rank_times(ranks),
           "times_note": "gloo over the host between four processes "
                         "that share one card: not NVLink, not a "
                         "multi-card measure",
           "planted_row_no_sum": fault}
    emit(rec)
    check(all(lo == losses[0] for lo in losses),
          f"tp_pipeline_gang: the ranks' losses differ: {losses}")
    check(all(e <= 1e-3 for e in loss_err),
          f"tp_pipeline_gang: losses: {loss_err}")
    check(r0["vs_one_rank"]["ok"],
          f"tp_pipeline_gang: not the one-rank run: {r0['vs_one_rank']}")
    check(not bad, f"tp_pipeline_gang: counts: {bad}")
    check(all(f["wi_grad_rel_change"] > 0.1 for f in fault),
          f"tp_pipeline_gang: the planted row backward passes: {fault}")
    return {"launches": r0["launches"],
            "launches_by_rank": rec["launches_by_rank"]}


def phase_sp_world1(dev, cfg=None) -> dict:
    """NCCL at world 1: ring and Ulysses attention on a mesh of one rank
    bit for bit ``flash_attention``, forward and gradients, at the long
    context's attention shape; one ZeRO and one FSDP boundary of the
    long-context recipe (GPT-2 small width, 1024 tokens) against
    ``amp_microbatch_step(fused_adam)`` within a measured fp32 bound (the
    flat update's order of operations differs); the collectives counted
    exactly."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.examples import gpt_long_context as lc
    from apex_tpu_torch.parallel import (make_mesh, ring_attention,
                                         sync_replicated_grads,
                                         ulysses_attention)
    from apex_tpu_torch.train import (fsdp_init, fsdp_microbatch_step,
                                      fsdp_unflatten_params)

    cfg = dict(LC if cfg is None else cfg)
    init_distributed("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                     rank=0, world_size=1)
    try:
        mesh = make_mesh([("data", 1), ("seq", 1)])
        data, seq = mesh["data"], mesh["seq"]
        h, d, rate = cfg["heads"], cfg["hidden"] // cfg["heads"], cfg["rate"]
        s = cfg["s_local"]
        gen = torch.Generator(device=dev).manual_seed(70)
        q, k, v, do = (torch.randn(1, h, s, d, generator=gen, device=dev,
                                   dtype=torch.bfloat16) for _ in range(4))
        seed = torch.tensor(123, dtype=torch.int32, device=dev)
        runs, counts = {}, {}
        for name, fn in (
                ("flash", lambda a, b, c: flash_attention(
                    a, b, c, causal=True, dropout_rate=rate,
                    dropout_seed=seed)),
                ("ring", lambda a, b, c: ring_attention(
                    a, b, c, seq, causal=True, dropout_rate=rate,
                    dropout_seed=seed)),
                ("ulysses", lambda a, b, c: ulysses_attention(
                    a, b, c, seq, causal=True, dropout_rate=rate,
                    dropout_seed=seed))):
            reset_collective_counts()
            runs[name] = _grads_of(fn, q, k, v, cot=do)
            counts[name] = collective_counts()
        bitwise = {n: all(_bitwise(a, b) for a, b in zip(runs[n],
                                                         runs["flash"]))
                   for n in ("ring", "ulysses")}
        # one boundary of each policy from the same weights and seeds
        mcfg = _lc_cfg(cfg)
        x, y = lc.synthetic_data(mcfg, 1, s)
        window = (x.expand(cfg["m"], *x.shape).to(dev),
                  y.expand(cfg["m"], *y.shape).to(dev))
        res, bcounts = {}, {}
        for policy in ("amp", "zero", "fsdp"):
            layers = lc.make_layers(mcfg, SP_WORLD1_LAYERS, device=dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            if policy == "fsdp":
                amp_ = amp.initialize("O2")
                grad_fn = lc.make_grad_fn(layers, amp_, seq, data,
                                          remat_policy=cfg["remat"],
                                          generator=gen)
                masters = {n: p.detach().clone()
                           for n, p in layers.named_parameters()}
                opt = DistributedFusedAdam(data, lr=lc.LR)
                spec = opt.make_spec(masters)
                step = fsdp_microbatch_step(
                    grad_fn, opt, amp_, spec, microbatches=cfg["m"],
                    grad_presum=lambda g: sync_replicated_grads(
                        g, seq, tag="seq_presum"), model=layers)
                carry = fsdp_init(opt, amp_, masters, spec)
            else:
                step, carry, _ = lc.build(
                    layers, seq, data, zero=policy == "zero",
                    microbatches=cfg["m"], remat_policy=cfg["remat"],
                    generator=gen)
            start = _masters_flat(carry[0] if policy != "fsdp" else masters)
            reset_collective_counts()
            carry, _ = build_opt_step(step)(carry, window)
            bcounts[policy] = collective_counts()
            after = (fsdp_unflatten_params(carry[0], spec, data)
                     if policy == "fsdp" else carry[0])
            res[policy] = (start, _masters_flat(after))
            del layers, carry
        amp_start, amp_after = res["amp"]
        boundary = {p: {"movement_rel_l2": _movement(res[p][1], amp_after,
                                                     amp_start),
                        "max_abs_diff": float((res[p][1] - amp_after)
                                              .abs().max()),
                        "bitwise": bool(torch.equal(res[p][1], amp_after))}
                    for p in ("zero", "fsdp")}
    finally:
        dist.destroy_process_group()
    mbs = cfg["m"]
    want = {"ring": {}, "ulysses": {"ulysses": 8}, "flash": {},
            "zero": {"loss": 3 * mbs, "seq_presum": 1, "zero_flag": 1,
                     "zero_grads": 1, "zero_params": 1},
            "fsdp": {"loss": 3 * mbs, "seq_presum": 1, "fsdp_params": 1,
                     "zero_flag": 2, "zero_grads": 1},
            "amp": {"loss": 3 * mbs, "seq_presum": 1}}
    got = {**counts, **bcounts}
    rec = {"phase": "sp_world1", "backend": "nccl, world 1",
           "attention": f"batch 1, {h} heads x {d}, {s} positions, bf16, "
                        f"causal, dropout {rate}",
           "bitwise_flash_attention": bitwise,
           "boundary_vs_amp_fused_adam": boundary,
           "boundary_tol": "movement within 1e-5 relative L2 of "
                           "amp_microbatch_step(fused_adam)'s (fp32: "
                           "sqrt(v / bc2) against sqrt(v) / sqrt(bc2), "
                           "p - lr u against p + (-lr u))",
           "collectives": got, "want_collectives": want}
    emit(rec)
    check(all(bitwise.values()),
          f"sp_world1: not bit for bit flash_attention: {bitwise}")
    check(all(b["movement_rel_l2"] <= 1e-5 for b in boundary.values()),
          f"sp_world1: a sharded boundary is off: {boundary}")
    check(got == want, f"sp_world1: collectives {got} != {want}")
    return rec


# -- phase 18: scale-out, part 2 (TP serving, MoE, compression, restore) -----

#: the four-request mix of the spec and int8 checks: prompts of 64-256
#: tokens, 16 new tokens each
SO2_MIX4 = dict(seed=8, n=4, lo=64, hi=256, new=16)
#: the fp32 check: four prompts of 24-40 tokens, 16 new tokens each
SO2_FP32 = dict(seed=9, n=4, lo=24, hi=40, new=16)
#: Switch-Base-8's FFN (Fedus et al. 2021): d_model 768, d_ff 3072, 8
#: experts, 2 a rank over expert 4; top-2, capacity factor 2.0, 4096
#: tokens a rank, bf16 compute
SO2_MOE = dict(d=768, d_ff=3072, experts=8, k=2, cf=2.0, tokens=4096)
#: the compression gang: GPT-2 small's width with the depth cut to 2
#: layers (the vocabulary kept), fp32, 1 x 1024 tokens a rank, 2 steps
SO2_COMPRESS = dict(layers=2, s=1024, steps=2)
#: (policy, compression) pairs the compression gang runs
SO2_POLICIES = (("ddp", "bf16"), ("ddp", "int8"), ("zero", "int8"),
                ("fsdp", "bf16"), ("adasum", None))
SO2_TP = 4
#: Adasum's combined gradient card vs CPU: fp32 dot products and norms
#: over the flat gradient, summed in another order on each side
SO2_ADASUM_TOL = 1e-5
#: the masters' movement card vs CPU after the two Adam steps (fp32 Adam
#: on each side; 0 to 1.3e-7 read in the chip run of the final tree)
SO2_MOVEMENT_TOL = 1e-6
SO2_TOL = ("card vs CPU from the same state and gradients: each boundary "
           "exchange (the compressed SUM or this rank's reduce-scatter "
           "block, and the int8 residual) bit for bit (gloo sums host "
           "copies of CUDA tensors in its CPU order), Adasum's combined "
           "gradient within 1e-5 relative L2 (fp32 dot products in "
           "another order); the masters' movement within 1e-6 relative "
           "L2 (fp32 Adam on each side); MoE "
           "against the same layer at n = 1: outputs and the input's "
           "gradient within 1e-2 of max, the weights' gradients within "
           "1e-2 relative L2 (bf16 products of another batch)")


def _so2_prompts(spec: dict) -> list:
    rng = torch.Generator().manual_seed(spec["seed"])
    lens = torch.randint(spec["lo"], spec["hi"] + 1, (spec["n"],),
                         generator=rng).tolist()
    return [torch.randint(0, 50257, (n,), generator=rng).tolist()
            for n in lens]


class _LogitsTap:
    """Digest of every fp32 logits row a decoder's model returns for real
    tokens (sha256 over the bytes, in call order): every row of a
    prefill chunk, and the rows of the engine's active slots of a decode
    step (a free slot decodes garbage from the trash page, whose
    duplicate writes land in no fixed order); and the first ``keep``
    decode steps' active rows.  One host copy a forward."""

    def __init__(self, model, keep: int = 8):
        self.digest, self.first, self.keep = hashlib.sha256(), [], keep
        self.engine = None  # set before the first decode window
        for name in ("paged_prefill_chunk", "paged_decode_step"):
            setattr(model, name, self._wrap(getattr(model, name),
                                            name == "paged_decode_step"))

    def _wrap(self, fn, decode: bool):
        def go(*a, **kw):
            out = fn(*a, **kw)
            host = out.float().cpu()
            if decode:
                host = host[sorted(self.engine._active)]
                if len(self.first) < self.keep:
                    self.first.append(host)
            self.digest.update(host.numpy().tobytes())
            return out
        return go


def _so2_engine(dec, paged: bool = True, slots: int = 8, chunk: int = 128,
                **kw):
    return ServeEngine(dec, slots=slots, max_len=1024, page_len=16,
                       prefill_chunk=chunk, seed=0, paged=paged, **kw)


def _so2_run(eng, prompts, new: int) -> list:
    uids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    out = eng.run()
    return [out[u] for u in uids]


def _so2_handoff(dev, params, mesh=None) -> dict:
    """The handoff legs of the TP gang (``mesh`` None: the one-rank
    references), bf16, the four-request mix: ``tp_to_one``, a prefill-only
    source over ``mesh`` whose containers carry every head (its head
    blocks all-gathered, tag ``tp_handoff``) adopted by a one-rank decode
    engine; ``one_to_tp``, a one-rank source's containers adopted by a
    decode engine over ``mesh``, each rank taking its head block.  Each
    leg's tokens, the sha256 of its blobs and its collectives."""
    cfg = GPTConfig.small()
    bf = dict(compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
              tokens_per_dispatch=8, device=dev)
    tp = GPTDecoder(cfg, params, mesh=mesh, **bf)
    one = GPTDecoder(cfg, params, **bf)
    mix, new = _so2_prompts(SO2_MIX4), SO2_MIX4["new"]
    out = {}
    for name, src_dec, dst_dec in (("tp_to_one", tp, one),
                                   ("one_to_tp", one, tp)):
        reset_collective_counts()
        src = _so2_engine(src_dec, slots=4, prefill_only=True)
        dst = _so2_engine(dst_dec, slots=4)
        uids = [src.submit(p, max_new_tokens=new) for p in mix]
        while src._queue or src._prefilling:
            src.step()
        digests, adopted = [], []
        for u in uids:
            blob = src.export_handoff(u).to_bytes()
            digests.append(hashlib.sha256(blob).hexdigest())
            adopted.append(dst.adopt(KVHandoff.from_bytes(blob),
                                     max_new_tokens=new))
            src.detach(u)
        check(None not in adopted, f"tp_serve_gang: {name}: an adoption "
              "was refused")
        res = dst.run()
        out[name] = {"tokens": [res[v] for v in adopted],
                     "blob_sha256": digests,
                     "collectives": collective_counts()}
    return out


def _so2_serve_runs(dev, params, mesh=None) -> dict:
    """The serving runs of the TP gang, on one rank (``mesh`` None) or on
    this rank's head shard: the engine mix with the logits tap, the fp32
    mix, two requests of the four-request mix (the planted fault's
    control), and the chain, tree and int8 four-request mixes."""
    cfg = GPTConfig.small()
    bf = dict(compute_dtype=torch.bfloat16, cache_dtype=torch.bfloat16,
              tokens_per_dispatch=8, device=dev, mesh=mesh)
    out = {}
    dec = GPTDecoder(cfg, params, **bf)
    tap = _LogitsTap(dec.model)
    eng = tap.engine = _so2_engine(dec)
    reset_collective_counts()
    lens, got, wall, launches = _run_engine_mix(eng, cfg.vocab_size)
    st = eng.stats()
    out["engine"] = {
        "tokens": got, "wall_s": wall, "launches": launches,
        "collectives": collective_counts(),
        "logits_sha256": tap.digest.hexdigest(), "first_window": tap.first,
        "prefill_dispatches": st["prefill_dispatches"],
        "decode_dispatches": st["decode_dispatches"],
        "tensor_parallel": st.get("tensor_parallel"),
        "bytes_per_page": eng.cache.bytes_per_page}
    del eng, tap
    dec32 = GPTDecoder(cfg, params, compute_dtype=torch.float32,
                       cache_dtype=torch.float32, tokens_per_dispatch=8,
                       device=dev, mesh=mesh)
    out["fp32"] = _so2_run(_so2_engine(dec32, slots=4, chunk=64),
                           _so2_prompts(SO2_FP32), SO2_FP32["new"])
    del dec32
    mix = _so2_prompts(SO2_MIX4)
    # the planted misplaced head block's control: two requests, 8 tokens
    out["short"] = _so2_run(_so2_engine(GPTDecoder(cfg, params, **bf),
                                        slots=4), mix[:2], 8)
    for name, kw in (("chain", {"spec_tokens": 3}),
                     ("tree", {"spec_tokens": 3, "spec_tree": 2}),
                     ("int8", {"kv_int8": True})):
        d = GPTDecoder(cfg, params, **bf, **kw)
        out[name] = _so2_run(_so2_engine(d, slots=4), mix, SO2_MIX4["new"])
    out["handoff"] = _so2_handoff(dev, params, mesh)
    return out


def _so2_moe(dev, rank: int) -> dict:
    """MoE over expert 4 at Switch-Base-8's widths against the same layer
    at n = 1 on this rank's tokens with every expert."""
    from apex_tpu_torch.parallel import MoEMLP, make_mesh, psum, top_k_routing

    c = SO2_MOE
    ax = make_mesh([("expert", SO2_TP)])["expert"]
    full = MoEMLP(c["experts"], c["d"], c["d_ff"], None,
                  generator=torch.Generator().manual_seed(90)).state_dict()
    e_loc = c["experts"] // ax.size
    blk = slice(ax.index * e_loc, (ax.index + 1) * e_loc)
    mods = {}
    for name, axis, sd in (
            ("ep", ax, {"router": full["router"], "wi": full["wi"][blk],
                        "wo": full["wo"][blk]}),
            ("one", None, full)):
        m = MoEMLP(c["experts"], c["d"], c["d_ff"], axis, k=c["k"],
                   capacity_factor=c["cf"], compute_dtype=torch.bfloat16,
                   device=dev)
        m.load_state_dict(sd)
        mods[name] = m
    gen = torch.Generator(device=dev).manual_seed(91 + rank)
    x = torch.randn(c["tokens"], c["d"], device=dev, generator=gen).to(
        torch.bfloat16)
    cot = torch.randn(c["tokens"], c["d"], device=dev, generator=gen)
    res = {}
    for name, m in mods.items():
        xi = x.clone().requires_grad_()
        reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = m(xi)
        fwd = collective_counts()
        ((y.float() * cot).sum() + aux).backward()
        torch.cuda.synchronize()
        res[name] = {"y": y.detach().float(), "aux": float(aux),
                     "dx": xi.grad.float(), "fwd": fwd,
                     "counts": collective_counts(),
                     "wall_ms": (time.perf_counter() - t0) * 1e3,
                     "grads": {k: p.grad.float()
                               for k, p in m.named_parameters()}}
    ep, one = res["ep"], res["one"]
    # the one-rank expert gradients summed over every rank's tokens: the
    # expert-parallel layer's local experts see all of them
    tot = {k: psum(one["grads"][k], ax, tag="check_sum")[blk]
           for k in ("wi", "wo")}
    cap = mods["ep"].capacity(c["tokens"])
    logits = x.float() @ mods["ep"].router.float()
    d_ep = top_k_routing(logits, c["k"], cap)
    d_one = top_k_routing(x.float() @ mods["one"].router.float(), c["k"],
                          cap)

    def rel_max(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def rel_l2(a, b):
        return (torch.linalg.vector_norm(a - b)
                / torch.linalg.vector_norm(b)).item()

    rec = {"capacity": cap,
           "dispatch_exact": torch.equal(d_ep[0], d_one[0]),
           "combine_exact": torch.equal(d_ep[1], d_one[1]),
           "kept_tokens_share": float(d_ep[0].sum() / (c["k"] * c["tokens"])),
           "y_rel_max": rel_max(ep["y"], one["y"]),
           "aux_diff": abs(ep["aux"] - one["aux"]),
           "dx_rel_max": rel_max(ep["dx"], one["dx"]),
           "router_grad_rel_l2": rel_l2(ep["grads"]["router"],
                                        one["grads"]["router"]),
           "wi_grad_rel_l2": rel_l2(ep["grads"]["wi"], tot["wi"]),
           "wo_grad_rel_l2": rel_l2(ep["grads"]["wo"], tot["wo"]),
           "fwd_collectives": ep["fwd"], "collectives": ep["counts"],
           "ep_wall_ms": ep["wall_ms"], "one_rank_wall_ms": one["wall_ms"]}
    rec["ok"] = (rec["dispatch_exact"] and rec["combine_exact"]
                 and rec["y_rel_max"] <= 1e-2 and rec["dx_rel_max"] <= 1e-2
                 and rec["aux_diff"] <= 1e-6
                 and max(rec["router_grad_rel_l2"], rec["wi_grad_rel_l2"],
                         rec["wo_grad_rel_l2"]) <= 1e-2)
    return rec


def _bits_equal(a, b) -> bool:
    """Two tensors equal bit for bit (NaN payloads and signed zeros too)."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


class _ExchangeTap:
    """The boundary exchanges of ``train.accum`` as they return, moved to
    the host: the compressed SUM (the all-reduce's, or this rank's
    reduce-scatter block) and the new int8 residual, or Adasum's
    combined gradient.  Given the card's record as ``want``, each CPU
    exchange is compared as it comes and not kept: the SUM and the
    residual bit for bit, Adasum's gradient by its relative L2."""

    NAMES = ("compress_allreduce", "compress_reduce_scatter",
             "adasum_combine")

    def __init__(self, want=None):
        self.want, self.got, self.diffs = want, [], []

    def __enter__(self):
        from apex_tpu_torch.train import accum

        self.saved = {n: getattr(accum, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            setattr(accum, n, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        from apex_tpu_torch.train import accum

        for n, fn in self.saved.items():
            setattr(accum, n, fn)

    def _wrap(self, fn):
        def tapped(*args, **kw):
            out = fn(*args, **kw)
            parts = out if isinstance(out, tuple) else (out,)
            host = [None if t is None else t.detach().cpu() for t in parts]
            if self.want is None:
                self.got.append(host)
            else:
                self.diffs.append(self._diff(self.want[len(self.diffs)],
                                             host))
            return out
        return tapped

    @staticmethod
    def _diff(card, cpu) -> dict:
        if len(card) == 1:  # Adasum's combined gradient
            a, b = card[0].double(), cpu[0].double()
            return {"combined_rel_l2": float(torch.linalg.vector_norm(a - b)
                                             / torch.linalg.vector_norm(b))}
        return {"sum_bit_for_bit": _bits_equal(card[0], cpu[0]),
                "residual_bit_for_bit": (None if card[1] is None
                                         and cpu[1] is None else
                                         card[1] is not None
                                         and cpu[1] is not None
                                         and _bits_equal(card[1], cpu[1]))}


def _so2_policy(name: str, comp, axis, model, params, data, *, dev,
                replay=None, plant=None, record=None):
    """Two steps (one window each) of a boundary policy on ``dev`` over
    ``axis``: the masters, the flags and scales, the residuals after each
    step, the collectives; the gradients either computed by ``model`` on
    this rank's ``data`` (and appended to ``record``) or replayed."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.train import (adasum_microbatch_step, ef_init,
                                      fsdp_init, fsdp_microbatch_step,
                                      fsdp_unflatten_params, zero_init,
                                      zero_microbatch_step)

    amp_ = amp.initialize("O2")
    p0 = {k: v.detach().to(dev, copy=True) for k, v in params.items()}
    step_no = [0]

    def grad_fn(carry, mb):
        i = step_no[0]
        if replay is not None:
            grads = {k: v.to(dev) for k, v in replay[i].items()}
        else:
            ps = {k: v.detach().requires_grad_() for k, v in carry[0].items()}
            _, loss = torch.func.functional_call(model, ps, data)
            grads = dict(zip(ps, torch.autograd.grad(
                amp_.scale_loss(loss, carry[1].scaler[0]), list(ps.values()))))
            if record is not None:
                record.append({k: g.detach().cpu() for k, g in grads.items()})
        if plant is not None and i == plant:
            grads["wpe.weight"] = grads["wpe.weight"].clone()
            grads["wpe.weight"].view(-1)[0] = float("inf")
        step_no[0] += 1
        return grads, {}

    length = sum(v.numel() for v in p0.values())
    if name in ("ddp", "adasum"):
        opt = amp.AmpOptimizer(fused_adam(1e-3), amp_)
        step = (adasum_microbatch_step(grad_fn, opt, axis=axis)
                if name == "adasum" else
                amp_microbatch_step(grad_fn, opt,
                                    ddp=DistributedDataParallel(),
                                    compress=comp))
        carry = (p0, opt.init(p0))
    else:
        zopt = DistributedFusedAdam(axis, lr=1e-3)
        spec = zopt.make_spec(p0)
        length = spec.padded
        if name == "zero":
            step = zero_microbatch_step(grad_fn, zopt, amp_, spec,
                                        compress=comp)
            carry = (p0, zero_init(zopt, amp_, p0, spec))
        else:
            step = fsdp_microbatch_step(grad_fn, zopt, amp_, spec,
                                        compress=comp)
            carry = fsdp_init(zopt, amp_, p0, spec)
    if comp == "int8":
        carry = carry + (ef_init(length, device=dev),)
    run = build_opt_step(step)
    out = {"skipped": [], "scale": [], "res": [], "collectives": []}
    for _ in range(SO2_COMPRESS["steps"]):
        reset_collective_counts()
        carry, m = run(carry, None)
        out["collectives"].append(collective_counts())
        out["skipped"].append(float(m["skipped"]))
        out["scale"].append(float(m["scale"]))
        if comp == "int8":
            out["res"].append(carry[2].ef_residual.detach().clone())
    if name == "fsdp":
        masters = fsdp_unflatten_params(carry[0], spec, axis)
    else:
        masters = carry[0]
    out["masters"] = torch.cat([masters[k].detach().float().reshape(-1)
                                for k in params]).cpu()
    out["carry"] = carry if name == "zero" else None
    return out


def _so2_wrong_scale(axis, params, want, rec, base, d_card, *, dev,
                     plant) -> dict:
    """Planted: the mean int8 policy again on the card from the recorded
    gradients with the shared scale decoded 1 % off.  The exchange gate
    must fail; the masters' movement against the good run's shows why
    it alone cannot see such a fault (Adam's update is about lr sign(g)
    at first, and a uniform scale cancels in m / sqrt(v))."""
    from apex_tpu_torch.train import compress as compress_module

    decode = compress_module._decode
    compress_module._decode = lambda q, scale, amax: decode(
        q, scale * 1.01, amax)
    try:
        with _ExchangeTap(want=want) as tap:
            bad = _so2_policy("ddp", "int8", axis, None, params, None,
                              dev=dev, replay=rec, plant=plant)
    finally:
        compress_module._decode = decode
    d_bad = bad["masters"] - base
    return {"caught": not all(e["sum_bit_for_bit"] for e in tap.diffs),
            "movement_rel_l2": float(torch.linalg.vector_norm(d_bad - d_card)
                                     / torch.linalg.vector_norm(d_card))}


def _so2_compress(dev, rank: int, out_dir: str) -> dict:
    """Compression, Adasum and the cross-mesh restore over data 4."""
    from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
    from apex_tpu_torch.parallel import make_mesh
    from apex_tpu_torch.train import (fsdp_unflatten_params,
                                      restore_train_state, save_train_state)

    c = SO2_COMPRESS
    mesh = make_mesh([("data", SO2_TP)])
    axis = mesh["data"]
    cfg = GPTConfig(num_layers=c["layers"], compute_dtype=torch.float32,
                    dropout_rate=0.0, attn_dropout_rate=0.0)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with torch.device(dev):
        model = GPTLM(cfg)
    model.requires_grad_(False)
    gen = torch.Generator().manual_seed(40 + rank)
    ids = torch.randint(0, 50257, (1, c["s"] + 1), generator=gen)
    data = (ids[:, :-1].to(dev), ids[:, 1:].to(dev))
    out = {}
    for name, comp in SO2_POLICIES:
        plant = 1 if comp == "int8" and rank == 1 else None
        rec = []
        t0 = time.perf_counter()
        with _ExchangeTap() as tap:
            card = _so2_policy(name, comp, axis, model, params, data,
                               dev=dev, plant=plant, record=rec)
        wall = time.perf_counter() - t0
        with _ExchangeTap(want=tap.got) as ctap:
            cpu = _so2_policy(name, comp, axis, None, params, None,
                              dev=torch.device("cpu"), replay=rec,
                              plant=plant)
        base = torch.cat([params[k].reshape(-1) for k in params])
        d_card, d_cpu = card["masters"] - base, cpu["masters"] - base
        r = {"movement_rel_l2": float(torch.linalg.vector_norm(d_card - d_cpu)
                                      / torch.linalg.vector_norm(d_cpu)),
             "skipped": card["skipped"], "cpu_skipped": cpu["skipped"],
             "scale": card["scale"], "cpu_scale": cpu["scale"],
             "collectives": card["collectives"],
             "cpu_collectives": cpu["collectives"], "wall_s": wall,
             "exchanges": ctap.diffs, "card_exchanges": len(tap.got)}
        if comp == "int8":
            r["residual_kept_at_skip"] = bool(torch.equal(card["res"][0],
                                                          card["res"][1]))
        if (name, comp) == ("ddp", "int8"):
            r["planted_wrong_scale"] = _so2_wrong_scale(
                axis, params, tap.got, rec, base, d_card, dev=dev,
                plant=plant)
        out[f"{name}_{comp or 'full'}"] = r
        if name == "zero":
            zero_carry = card["carry"][:2]
        del card, cpu, rec, tap
    # the restore: this ZeRO carry saved over data 4, restored as FSDP on a
    # (data 2, model 2) mesh
    path = os.path.join(out_dir, "train_state")
    save_train_state(path, zero_carry, 2, mode="zero", mesh=mesh)
    dist.barrier()
    mesh22 = make_mesh([("data", 2), ("model", 2)])
    fopt = DistributedFusedAdam(mesh22["data"], lr=1e-3)
    t0 = time.perf_counter()
    fcarry, at = restore_train_state(path, params, opt=fopt,
                                     amp_=amp.initialize("O2"), mode="fsdp",
                                     mesh=mesh22)
    got = fsdp_unflatten_params(fcarry[0], fopt.make_spec(params),
                                mesh22["data"])
    side = checkpoint.read_sharding_outcome(path, rank=0)
    out["restore"] = {
        "step": at, "restore_s": time.perf_counter() - t0,
        "params_bit_for_bit": all(torch.equal(got[k].cpu(),
                                              zero_carry[0][k].cpu())
                                  for k in params),
        "sidecar_mode": side.get("mode"), "sidecar_mesh": side.get("mesh")}
    dist.barrier()
    return out


def _so2_fault_offset(dev, params, mesh, rank: int) -> list:
    """Rank 0 writes its head block one group along (its zero-padded (B,
    T, h) block rolled by a group's width before the head sum): every
    rank's tokens of the first two requests of the four-request mix."""
    from apex_tpu_torch.models import gpt as gpt_module

    psum = gpt_module.psum
    group = GPTConfig.small().hidden_size // SO2_TP
    if rank == 0:
        gpt_module.psum = lambda x, axis, **kw: psum(
            torch.roll(x, group, dims=-1), axis, **kw)
    try:
        dec = GPTDecoder(GPTConfig.small(), params,
                         compute_dtype=torch.bfloat16,
                         cache_dtype=torch.bfloat16, tokens_per_dispatch=8,
                         device=dev, mesh=mesh)
        return _so2_run(_so2_engine(dec, slots=4), _so2_prompts(SO2_MIX4)[:2],
                        8)
    finally:
        gpt_module.psum = psum


def _so2_worker(dev, out_dir: str, rank: int, cfg: dict) -> dict:
    """One rank of the scale-out part 2 gang: TP serving over model 4,
    then MoE over expert 4, then compression, Adasum and the restore over
    data 4; the first window's logits to DIR for rank 0's bound."""
    from apex_tpu_torch.serve import serve_mesh

    torch.set_num_threads(2)
    params = init_params(GPTConfig.small(), torch.Generator().manual_seed(0))
    mesh = serve_mesh(SO2_TP)
    t0 = time.perf_counter()
    serve = _so2_serve_runs(dev, params, mesh)
    fault = _so2_fault_offset(dev, params, mesh, rank)
    prof = _profile_window(GPTDecoder(
        GPTConfig.small(), params, compute_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16, tokens_per_dispatch=8, device=dev,
        mesh=mesh), steps=8)
    torch.save(serve["engine"].pop("first_window"),
               os.path.join(out_dir, f"window{rank}.pt"))
    dist.barrier()
    serve_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    moe = _so2_moe(dev, rank)
    torch.cuda.empty_cache()
    comp = _so2_compress(dev, rank, out_dir)
    dist.barrier()
    return {"rank": rank, "serve": serve, "fault_offset_tokens": fault,
            "profile": {k: prof[k] for k in (
                "wall_ms", "unprofiled_wall_ms", "device_busy_ms",
                "device_busy_share", "launches")},
            "serve_s": serve_s, "moe": moe, "compress": comp,
            "moe_compress_s": time.perf_counter() - t1}


def _dead_tp_rank() -> dict:
    """A gang whose rank 2 raises after the serve mesh is made while the
    others wait in a head all-reduce: the launcher must reap the gang and
    name rank 2."""
    code = ("import os, sys, torch\n"
            f"sys.path.insert(0, {os.path.dirname(os.path.abspath(__file__))!r})\n"
            "from apex_tpu_torch.parallel import init_distributed, psum\n"
            "from apex_tpu_torch.serve import serve_mesh\n"
            "init_distributed('gloo', timeout_s=60)\n"
            "model = serve_mesh(4)['model']\n"
            "if os.environ['RANK'] == '2':\n"
            "    raise RuntimeError('planted: rank 2 died')\n"
            "psum(torch.ones(4), model, tag='tp_heads')\n")
    try:
        launch(["-c", code], SO2_TP, timeout_s=90, echo_stderr=False,
               check=True)
        return {"reaped": False}
    except MultiprocError as err:
        return {"reaped": True, "guilty_ranks": err.guilty_ranks(),
                "stderr_tail_names_it": "planted: rank 2 died" in str(err)}


def _paged_h3(dev) -> dict:
    """The paged kernel at a rank's 3 heads: the T = 1 decode and T = 128
    prefill-chunk bf16 problems of :func:`paged_problems` cut to heads
    3-5, against the plain version, and bit for bit heads 3-5 of the
    12-head call (the kernel's split choice does not depend on H)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = []
    for t in (1, 8, 128):
        p = _paged_problem(dev, gen, t, torch.bfloat16, False)
        sl = slice(3, 6)
        cut = {k: (v[:, :, sl] if k in ("pool_k", "pool_v") else
                   v[:, sl] if k in ("q", "k_new", "v_new") else v)
               for k, v in p.items()}
        kw = {k: v for k, v in p.items() if k not in ("q", "k_new", "v_new")}
        kw3 = {k: (v.contiguous() if torch.is_tensor(v) else v)
               for k, v in cut.items()
               if k not in ("q", "k_new", "v_new")}
        q3, k3, v3 = (cut[k].contiguous() for k in ("q", "k_new", "v_new"))
        full = paged_fused_attention(p["q"], p["k_new"], p["v_new"], **kw)
        got = paged_fused_attention(q3, k3, v3, **kw3)
        want = paged_cached_attention(q3, k3, v3, **kw3)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(_paged_close(got, want),
              f"paged attention H=3 T={t}: max abs err {err}")
        kern = timings(lambda: paged_fused_attention(q3, k3, v3, **kw3))
        plain = timings(lambda: paged_cached_attention(q3, k3, v3, **kw3),
                        iters=20)
        lib = timings(_sdpa_yardstick(dict(cut, **kw3, q=q3, k_new=k3,
                                           v_new=v3)), iters=20)
        bound, by = _paged_bound(dict(cut, **kw3, q=q3, k_new=k3, v_new=v3))
        case = {"case": f"T={t} pool=bfloat16 H=3 (a rank of 4)",
                "B": q3.shape[0], "H": 3, "T": t, "D": q3.shape[3],
                "max_abs_err": err, "tol": "2 bf16 ulps + 1e-5, and 2e-2",
                "equals_12_head_slice": torch.equal(got, full[:, sl]),
                **_merge(kern, plain, lib), "bound_ms": bound,
                "bound_by": by}
        emit({"phase": "kernel", "kernel": "paged_fused_attention", **case})
        cases.append(case)
        del p, cut, kw, kw3
    return cases


def phase_scale_out2_world1(dev) -> dict:
    """NCCL at world 1: a TP decoder at tp = 1 (tokens and logits bit for
    bit the plain decoder's); ``compress=None`` bit for bit the
    uncompressed step; the bf16 and int8 codecs on a GPT-2-small-sized
    flat gradient bit for bit the CPU's; Adasum at world 1 bit for bit
    ``amp_microbatch_step``; ``MoEMLP`` at n = 1 against ``moe_mlp_ref``
    with ample capacity; exact collective counts."""
    from apex_tpu_torch.parallel import (Axis, MoEMLP, make_mesh,
                                         moe_mlp_ref)
    from apex_tpu_torch.serve import serve_mesh
    from apex_tpu_torch.train import (adasum_microbatch_step,
                                      compress_allreduce,
                                      compression_default, ef_init)

    init_distributed("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                     rank=0, world_size=1)
    rec = {"phase": "scale_out2_world1", "card": nvidia_smi_line()}
    try:
        params = init_params(GPTConfig.small(),
                             torch.Generator().manual_seed(0))
        prompts = _so2_prompts(SO2_MIX4)
        toks, digests = {}, {}
        for name, mesh in (("plain", None), ("tp1", serve_mesh(1))):
            dec = GPTDecoder(GPTConfig.small(), params,
                             compute_dtype=torch.bfloat16,
                             cache_dtype=torch.bfloat16,
                             tokens_per_dispatch=8, device=dev, mesh=mesh)
            tap = _LogitsTap(dec.model, keep=0)
            eng = tap.engine = _so2_engine(dec, slots=4)
            reset_collective_counts()
            toks[name] = _so2_run(eng, prompts, 16)
            digests[name] = tap.digest.hexdigest()
            st = eng.stats()
            forwards = (st["prefill_dispatches"]
                        + 8 * st["decode_dispatches"])
            counts = collective_counts()
            del dec, eng, tap
        rec["tp1"] = {"tokens_equal": toks["plain"] == toks["tp1"],
                      "logits_bit_for_bit": digests["plain"] == digests["tp1"],
                      "collectives": counts,
                      "want_collectives": {"tp_heads": 12 * forwards}}
        # the codecs on a GPT-2-small-sized flat gradient: card vs CPU
        data = make_mesh([("data", 1)])["data"]
        n = sum(v.numel() for v in params.values())
        gen = torch.Generator().manual_seed(50)
        flat = torch.randn(n, generator=gen) * 1e-2
        res = torch.randn(n, generator=gen) * 1e-4
        codec = {}
        for mode in ("bf16", "int8"):
            spec = compression_default(mode)
            r_card = res.to(dev) if mode == "int8" else None
            r_cpu = res if mode == "int8" else None
            reset_collective_counts()
            s_card, nr_card = compress_allreduce(flat.to(dev), data, spec,
                                                 r_card, tag="ddp")
            counts = collective_counts()
            s_cpu, nr_cpu = compress_allreduce(flat, Axis.single("data"),
                                               spec, r_cpu, tag="ddp")
            codec[mode] = {
                "sum_bit_for_bit": torch.equal(s_card.cpu(), s_cpu),
                "residual_bit_for_bit": (nr_card is None or torch.equal(
                    nr_card.cpu(), nr_cpu)),
                "collectives": counts}
        rec["codecs"] = codec
        # compress=None and Adasum at world 1 against the plain step, on
        # GPT-2 small's parameters with seeded scaled gradients
        amp_ = amp.initialize("O2")
        grads = {k: torch.randn(v.shape, generator=gen).to(dev) * 64.0
                 for k, v in params.items()}

        def grad_fn(carry, mb):
            return grads, {}

        steps = {}
        for name in ("plain", "none", "adasum"):
            opt = amp.AmpOptimizer(fused_adam(1e-3), amp_)
            p0 = {k: v.to(dev) for k, v in params.items()}
            if name == "adasum":
                st = adasum_microbatch_step(grad_fn, opt, axis=data)
            elif name == "none":
                st = amp_microbatch_step(grad_fn, opt, compress=None)
            else:
                st = amp_microbatch_step(grad_fn, opt)
            reset_collective_counts()
            carry, _ = build_opt_step(st)((p0, opt.init(p0)), None)
            steps[name] = (carry[0], collective_counts())
            del carry, p0
        same = {name: all(torch.equal(steps[name][0][k],
                                      steps["plain"][0][k]) for k in params)
                for name in ("none", "adasum")}
        rec["compress_none_bit_for_bit"] = same["none"]
        rec["adasum_bit_for_bit"] = same["adasum"]
        rec["adasum_collectives"] = steps["adasum"][1]
        del steps, grads
        # MoE at n = 1 against the dense reference, capacity ample (cf =
        # E / k: every expert takes every token)
        c = SO2_MOE
        m = MoEMLP(c["experts"], c["d"], c["d_ff"], None, k=c["k"],
                   capacity_factor=c["experts"] / c["k"],
                   generator=torch.Generator().manual_seed(90), device=dev)
        x = torch.randn(c["tokens"], c["d"], generator=gen).to(dev)
        with torch.no_grad():
            y, _ = m(x)
            want = moe_mlp_ref(x, dict(m.named_parameters()), c["experts"],
                               c["k"])
        rec["moe_n1_vs_ref_rel_max"] = ((y - want).abs().max()
                                        / want.abs().max()).item()
    finally:
        dist.destroy_process_group()
    emit(rec)
    check(rec["tp1"]["tokens_equal"] and rec["tp1"]["logits_bit_for_bit"]
          and rec["tp1"]["collectives"] == rec["tp1"]["want_collectives"],
          f"scale_out2_world1: tp=1 is not the plain decoder: {rec['tp1']}")
    check(all(v["sum_bit_for_bit"] and v["residual_bit_for_bit"]
              for v in rec["codecs"].values()),
          f"scale_out2_world1: codecs card vs CPU: {rec['codecs']}")
    check(rec["codecs"]["bf16"]["collectives"] == {"ddp": 1}
          and rec["codecs"]["int8"]["collectives"] == {"ddp": 1, "pmax": 1},
          f"scale_out2_world1: codec collectives: {rec['codecs']}")
    check(rec["compress_none_bit_for_bit"] and rec["adasum_bit_for_bit"],
          "scale_out2_world1: compress=None or Adasum is not the plain step")
    check(rec["adasum_collectives"] == {"adasum": 1},
          f"scale_out2_world1: Adasum collectives "
          f"{rec['adasum_collectives']}")
    check(rec["moe_n1_vs_ref_rel_max"] <= 1e-5,
          f"scale_out2_world1: MoE n = 1 vs moe_mlp_ref: "
          f"{rec['moe_n1_vs_ref_rel_max']}")
    return rec


def phase_scale_out2_gangs(dev, worker_argv=None) -> dict:
    """The one-rank references, then one gang of four gloo ranks on the
    card (``--sp-worker``, kind ``scale_out2``): ``tp_serve_gang`` (GPT-2
    small over a (model 4) mesh, 3 heads a rank: the engine mix's tokens
    and every logits tensor bit for bit the one-rank engine's, the fp32
    mix equal to ``reference_generate``, the chain, tree and int8 mixes
    equal to the one-rank engines', a quarter of the pool bytes, the
    launches equal to the one-rank run's, 12 head all-reduces a forward;
    planted: a rank's block at the wrong offset, a dead rank; the paged
    kernel at H = 3) and ``moe_compress_gang`` (MoE over expert 4,
    compression and Adasum over data 4 against the CPU, the ZeRO carry
    of data 4 restored as FSDP on (data 2, model 2))."""
    params = init_params(GPTConfig.small(), torch.Generator().manual_seed(0))
    t_ref = time.perf_counter()
    ref = _so2_serve_runs(dev, params)
    cfg32 = dataclasses.replace(GPTConfig.small(),
                                compute_dtype=torch.float32)
    ref["reference_generate"] = [
        reference_generate(cfg32, params, p, SO2_FP32["new"], device=dev)
        for p in _so2_prompts(SO2_FP32)]
    one_window = ref["engine"].pop("first_window")
    ref_s = time.perf_counter() - t_ref
    torch.cuda.empty_cache()
    h3 = _paged_h3(dev)
    out_dir = tempfile.mkdtemp(prefix="apex_scale_out2_")
    try:
        with open(os.path.join(out_dir, "config.json"), "w") as fh:
            json.dump({"device": str(dev), "kind": "scale_out2", "cfg": {}},
                      fh)
        argv = (worker_argv or [os.path.abspath(__file__), "--sp-worker"])
        t0 = time.perf_counter()
        launch([*argv, out_dir], SO2_TP, timeout_s=SP_TIMEOUT_S,
               echo_stderr=False, check=True)
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(SO2_TP):
            with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        windows = [torch.load(os.path.join(out_dir, f"window{r}.pt"))
                   for r in range(SO2_TP)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    dead = _dead_tp_rank()
    e1 = ref["engine"]
    layers, k = 12, 8
    serve = []
    for rk, win in zip(ranks, windows):
        s, e = rk["serve"], rk["serve"]["engine"]
        forwards = e["prefill_dispatches"] + k * e["decode_dispatches"]
        win_err = max((a - b).abs().max().item()
                      for a, b in zip(win, one_window))
        serve.append({
            "rank": rk["rank"],
            "tokens_equal_one_rank": e["tokens"] == e1["tokens"],
            "logits_bit_for_bit": e["logits_sha256"] == e1["logits_sha256"],
            "first_window_max_abs_err": win_err,
            "fp32_equal_reference_generate":
                s["fp32"] == ref["reference_generate"],
            "chain_equal": s["chain"] == ref["chain"],
            "tree_equal": s["tree"] == ref["tree"],
            "int8_equal": s["int8"] == ref["int8"],
            "pool_bytes_quarter": e["bytes_per_page"] * SO2_TP
                == e1["bytes_per_page"],
            "launches_equal_one_rank": e["launches"] == e1["launches"],
            "head_all_reduces": e["collectives"],
            "head_all_reduces_want": {"tp_heads": layers * forwards},
            "window_all_reduces":
                e["tensor_parallel"]["all_reduces_last_window"],
            "short_equal": s["short"] == ref["short"],
            "handoff": {
                leg: {"tokens_equal_one_rank":
                      s["handoff"][leg]["tokens"] == ref["handoff"][leg]
                      ["tokens"],
                      "blobs_bit_for_bit_one_rank":
                      s["handoff"][leg]["blob_sha256"]
                      == ref["handoff"][leg]["blob_sha256"],
                      "collectives": s["handoff"][leg]["collectives"]}
                for leg in ("tp_to_one", "one_to_tp")},
            "fault_offset_caught": rk["fault_offset_tokens"]
                != ref["short"],
            "engine_wall_s": e["wall_s"], "profile": rk["profile"]})
    rec = {"phase": "tp_serve_gang", "card": nvidia_smi_line(),
           "world_size": SO2_TP,
           "backend": "gloo (CUDA tensors, every rank on one card)",
           "mesh": {"model": SO2_TP},
           "model": "GPT-2 small, random weights (seed 0), bf16 compute and "
                    "pages, 3 heads a rank",
           "traffic": "the engine phase's mix: 16 requests, 64-768-token "
                      "prompts, 64 new tokens, two sharing a 256-token "
                      "prefix, 8 slots, page_len 16, chunks of 128, K = 8",
           "one_rank_launches": e1["launches"],
           "one_rank_engine_wall_s": e1["wall_s"], "references_s": ref_s,
           "paged_h3": h3, "ranks": serve, "gang_s": wall,
           "planted_dead_rank": dead,
           "times_note": "gloo over the host between four processes that "
                         "share one card (the engine wall with one host copy "
                         "of the logits a forward): not NVLink, not a "
                         "multi-card measure"}
    moe = [rk["moe"] for rk in ranks]
    comp = [rk["compress"] for rk in ranks]
    want_counts = {
        "ddp_bf16": {"ddp": 1}, "ddp_int8": {"ddp": 1, "pmax": 1},
        "zero_int8": {"zero_flag": 1, "zero_grads": 1, "zero_params": 1,
                      "pmax": 1},
        "fsdp_bf16": {"fsdp_params": 1, "zero_flag": 2, "zero_grads": 1},
        "adasum_full": {"adasum": 1}}
    rec2 = {"phase": "moe_compress_gang", "card": nvidia_smi_line(),
            "world_size": SO2_TP,
            "backend": "gloo (CUDA tensors, every rank on one card)",
            "moe": {"mesh": {"expert": SO2_TP},
                    "config": "Switch-Base-8 FFN (Fedus et al. 2021): d_model "
                              "768, d_ff 3072, 8 experts (2 a rank), top-2, "
                              "capacity factor 2.0, 4096 tokens a rank, bf16",
                    "ranks": moe},
            "compress": {"mesh": {"data": SO2_TP},
                         "model": "GPT-2 small width, 2 layers, vocabulary "
                                  "50304, fp32, 1 x 1024 tokens a rank, 2 "
                                  "steps, an inf in step 2 on rank 1 (int8)",
                         "want_collectives_a_step": want_counts,
                         "ranks": comp},
            "tol": SO2_TOL,
            "moe_compress_s": [rk["moe_compress_s"] for rk in ranks],
            "serve_s": [rk["serve_s"] for rk in ranks]}
    emit(rec)
    emit(rec2)
    for s in serve:
        check(s["tokens_equal_one_rank"] and s["fp32_equal_reference_generate"]
              and s["chain_equal"] and s["tree_equal"] and s["int8_equal"]
              and s["short_equal"],
              f"tp_serve_gang: tokens differ from one rank's: {s}")
        check(s["logits_bit_for_bit"],
              f"tp_serve_gang: logits not bit for bit one rank's: {s}")
        check(s["pool_bytes_quarter"] and s["launches_equal_one_rank"],
              f"tp_serve_gang: pool bytes or launches: {s}")
        check(s["head_all_reduces"] == s["head_all_reduces_want"]
              and s["window_all_reduces"] == layers * k,
              f"tp_serve_gang: head all-reduces: {s}")
        check(s["fault_offset_caught"],
              "tp_serve_gang: a misplaced head block passed the token gate")
        ho = s["handoff"]
        check(all(h["tokens_equal_one_rank"]
                  and h["blobs_bit_for_bit_one_rank"] for h in ho.values()),
              f"tp_serve_gang: the handoff legs differ from one rank's: "
              f"{ho}")
        check(ho["tp_to_one"]["collectives"].get("tp_handoff")
              == 2 * SO2_MIX4["n"]
              and "tp_handoff" not in ho["one_to_tp"]["collectives"],
              f"tp_serve_gang: the handoff's all-gathers: {ho}")
    check(ref["handoff"]["tp_to_one"]["tokens"]
          == ref["handoff"]["one_to_tp"]["tokens"],
          "tp_serve_gang: the one-rank handoff references differ")
    check(all(c["equals_12_head_slice"] for c in h3),
          f"tp_serve_gang: the H=3 paged kernel is not the 12-head slice")
    check(dead == {"reaped": True, "guilty_ranks": [2],
                   "stderr_tail_names_it": True},
          f"tp_serve_gang: a dead rank was not surfaced: {dead}")
    for m in moe:
        check(m["ok"], f"moe_compress_gang: MoE: {m}")
        check(m["fwd_collectives"] == {"moe_dispatch": 1, "moe_combine": 1}
              and m["collectives"] == {"moe_dispatch": 2, "moe_combine": 2},
              f"moe_compress_gang: MoE all-to-alls: {m}")
    for cr in comp:
        for key, want in want_counts.items():
            r = cr[key]
            ex = r["exchanges"]
            check(len(ex) == r["card_exchanges"] == SO2_COMPRESS["steps"],
                  f"moe_compress_gang: {key} exchanges tapped: {r}")
            if key.startswith("adasum"):
                good = all(e["combined_rel_l2"] <= SO2_ADASUM_TOL
                           for e in ex)
            else:
                good = all(e["sum_bit_for_bit"]
                           and e["residual_bit_for_bit"]
                           is (True if key.endswith("int8") else None)
                           for e in ex)
            check(good, f"moe_compress_gang: {key} exchange card vs CPU: "
                  f"{ex}")
            check(r["movement_rel_l2"] <= SO2_MOVEMENT_TOL,
                  f"moe_compress_gang: {key} card vs CPU: {r}")
            check(r["skipped"] == r["cpu_skipped"]
                  and r["scale"] == r["cpu_scale"],
                  f"moe_compress_gang: {key} flags: {r}")
            check(all(c == want for c in r["collectives"]),
                  f"moe_compress_gang: {key} collectives: {r}")
            if key == "ddp_int8":
                check(r["planted_wrong_scale"]["caught"],
                      f"moe_compress_gang: a 1 % wrong int8 scale passed "
                      f"the exchange gate: {r['planted_wrong_scale']}")
            if key.endswith("int8"):
                check(r["skipped"] == [0.0, 1.0]
                      and r["residual_kept_at_skip"],
                      f"moe_compress_gang: {key} planted overflow: {r}")
        rs = cr["restore"]
        check(rs["params_bit_for_bit"] and rs["sidecar_mode"] == "zero"
              and rs["sidecar_mesh"] == {"data": SO2_TP} and rs["step"] == 2,
              f"moe_compress_gang: restore: {rs}")
    return {"launches": ranks[0]["serve"]["engine"]["launches"],
            "launches_by_rank": [rk["serve"]["engine"]["launches"]
                                 for rk in ranks]}


# -- phase 19: the obs plane -------------------------------------------------

#: the obs_serve phase's traffic: 32 requests, bursty arrivals (4x the base
#: rate while on), half the prompts fronted by one of four Zipf-weighted
#: 256-token prefixes, Pareto prompt lengths (unique 192-512 tokens,
#: shared 256 + 64-512), outputs 16-64 tokens, 20 % at priority 1
OBS_PLAN = dict(requests=32, rate_rps=8.0, arrival="bursty",
                burst_factor=4.0, burst_on_s=0.4, burst_off_s=1.6,
                vocab_size=50257, n_prefixes=4, prefix_len=256, zipf_s=1.2,
                shared_frac=0.5, prompt_min=64, prompt_scale=64.0,
                prompt_alpha=1.5, prompt_cap=512, output_min=16,
                output_scale=16.0, output_alpha=1.3, output_cap=64,
                priorities=(0, 1), priority_weights=(0.8, 0.2))
#: virtual milliseconds a dispatch boundary costs on the harness's clock
OBS_STEP_MS = 50.0
#: the SLO-aware leg's stock tracker: a boundary is 50 virtual ms and a
#: K = 8 window spreads it over 8 tokens (6.25 ms each), so both budgets
#: burn: TTFT (every prompt takes 2-6 chunks) and ITL
OBS_SLO = dict(ttft_p99_ms=150.0, itl_p99_ms=5.0, window_s=2.0)


def _obs_plan():
    return TrafficPlan.from_seed(0, **OBS_PLAN)


def _obs_leg(dec, on: bool, slo: bool = False) -> dict:
    """One run of the obs plan on a :class:`VirtualClock` through the
    engine phase's configuration, with obs on or off, FIFO or SLO-aware
    admission; the launch counts are set to 0 just before it.  Returns
    the report, the host wall, the launches, the tracer and recorder."""
    obs.set_enabled(on)
    try:
        gen = LoadGen(_obs_plan(), step_cost_ms=OBS_STEP_MS)
        tracer = obs.Tracer()
        fr = obs.FlightRecorder(capacity=1 << 16)
        tracker = (obs.SloTracker.default_serve(clock=gen.clock, **OBS_SLO)
                   if slo else None)
        eng = ServeEngine(dec, slots=8, max_len=1024, page_len=16,
                          prefill_chunk=128, seed=0, clock=gen.clock,
                          tracer=tracer, flightrec=fr, slo_tracker=tracker,
                          slo_admission=slo, registry=obs.MetricsRegistry())
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        rep = gen.run(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        tracer.close()
    finally:
        obs.set_enabled(True)
    return {"report": rep, "wall_s": wall, "launches": launches,
            "tracer": tracer, "fr": fr, "stats": eng.stats()}


def _window_syncs(dec, on: bool) -> dict:
    """The host syncs of one warm decode window (8 slots, 256-token
    prompts, no prefill left), as ``torch.cuda.set_sync_debug_mode``
    reports them: each synchronizing call by its source line, and how
    many of them read the device to the host (a ``.cpu()``,
    ``.item()``, ``.tolist()`` or ``.numpy()`` on that line)."""
    import linecache
    import warnings

    obs.set_enabled(on)
    try:
        eng = ServeEngine(dec, slots=8, max_len=1024, page_len=16,
                          prefill_chunk=256, seed=0,
                          registry=obs.MetricsRegistry())
        rng = torch.Generator().manual_seed(6)
        for _ in range(8):
            eng.submit(torch.randint(0, 50257, (256,),
                                     generator=rng).tolist(),
                       max_new_tokens=64)
        while eng._prefilling or eng._queue or not eng._active:
            eng.step()
        eng.step()  # one warm window
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        obs.set_enabled(True)
    sites: dict = {}
    d2h = 0
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        site = f"{os.path.relpath(w.filename)}:{w.lineno}"
        sites[site] = sites.get(site, 0) + 1
        line = linecache.getline(w.filename, w.lineno)
        d2h += any(f in line for f in (".cpu()", ".item()", ".tolist()",
                                       ".numpy()"))
    return {"syncs": sum(sites.values()), "device_to_host": d2h,
            "sites": dict(sorted(sites.items()))}


def _hist_q(reg, name: str) -> dict:
    h = reg.get(name)
    if h is None or not h.count:
        return {"count": 0}
    return {"count": h.count, "p50": h.quantile(0.5), "p99": h.quantile(0.99)}


def _chunking(fr) -> dict:
    """Each request's prefill chunks ``(base, n)`` and shared prefix
    tokens at admission, from a run's recorder."""
    out: dict = {}
    for e in fr.events():
        a = e.get("attrs") or {}
        if e["kind"] == "serve/admit":
            out.setdefault(a["uid"], {"shared": [], "chunks": []})[
                "shared"].append(a["shared"])
        elif e["kind"] == "serve/prefill_chunk":
            out[a["uid"]]["chunks"].append((a["base"], a["n"]))
    return out


def _token_diff(got: dict, want: dict, chunk_got: dict,
                chunk_want: dict) -> dict:
    """The requests whose tokens differ between two runs of the plan,
    each with its first differing position and whether its prefill
    chunking (or shared prefix) differed between the runs."""
    rows = []
    for uid in sorted(want):
        if got[uid] == want[uid]:
            continue
        first = next((i for i, (x, y) in enumerate(zip(got[uid], want[uid]))
                      if x != y), min(len(got[uid]), len(want[uid])))
        rows.append({"uid": uid, "first_differing_token": first,
                     "chunking_differs": chunk_got[uid] != chunk_want[uid]})
    same_chunks = sum(chunk_got[u] == chunk_want[u] for u in chunk_want)
    return {"requests_differing": len(rows), "rows": rows,
            "requests_with_the_same_chunking": same_chunks}


def phase_obs_serve(dev, params, smi: str) -> dict:
    """The obs plane through the engine phase's configuration (GPT-2
    small bf16, bf16 pages, 8 slots, page_len 16, chunks of 128, K = 8,
    seed 0), driven by the seeded :data:`OBS_PLAN` on the load harness's
    virtual clock.  The SLO-aware run first (it also warms the set-up
    up), then obs on, off, on, off: the two obs-on FIFO runs give
    byte-identical ``LoadReport``s; the obs-off runs the same tokens per
    uid and launch counts; a warm window the same host syncs with obs on
    and off (after one measurement to warm the sync check up), one of
    them a device-to-host read.  SLO-aware admission (the stock tracker
    at :data:`OBS_SLO`) must give FIFO's tokens per uid, with at least
    one overtake or prefill yield; the requests that differ, if any, are
    reported with their first differing token and whether their prefill
    chunking differed.  The Chrome trace and the recorder's dump are
    written and read back, and no span after the first window may build
    or load a library.  Then one run on the wall clock with the whole
    plan submitted at once: TTFT and ITL p50/p99 and tokens/s, printed
    beside the obs on/off walls and the card, not gated."""
    t_phase = time.perf_counter()
    cfg = GPTConfig.small()
    dec = GPTDecoder(cfg, params, compute_dtype=torch.bfloat16,
                     cache_dtype=torch.bfloat16, tokens_per_dispatch=8,
                     device=dev)
    slo = _obs_leg(dec, on=True, slo=True)
    a = _obs_leg(dec, on=True)
    off = _obs_leg(dec, on=False)
    b = _obs_leg(dec, on=True)
    off2 = _obs_leg(dec, on=False)
    syncs = {"first": _window_syncs(dec, True),
             "on": _window_syncs(dec, True), "off": _window_syncs(dec, False)}
    rep, rep_off, rep_slo = a["report"], off["report"], slo["report"]
    slo_diff = _token_diff(rep_slo.tokens, rep.tokens, _chunking(slo["fr"]),
                           _chunking(a["fr"]))
    plan = _obs_plan()
    want_len = {r.uid: r.max_new_tokens for r in plan.requests}
    # the trace artifacts, written and read back
    tmp = tempfile.mkdtemp(prefix="apex_tpu_torch_obs_")
    try:
        chrome = json.load(open(a["tracer"].export_chrome(
            os.path.join(tmp, "trace.chrome.json"))))
        jsonl_events, _ = obs.read_jsonl(obs.write_jsonl(
            a["tracer"], os.path.join(tmp, "trace.jsonl"),
            flightrec=a["fr"]))
        meta, fr_events = obs.read_flightrec(a["fr"].dump(
            os.path.join(tmp, "flightrec.jsonl"), reason="obs_serve"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    windows = [sp for sp in a["tracer"].spans
               if sp.name == "serve/decode_window"]
    # the spans that began after the first window ended
    warm = [sp for sp in a["tracer"].spans
            if sp.t0 > windows[0].t0 + windows[0].dur]
    # the wall clock: the whole plan at once, obs on
    eng = ServeEngine(dec, slots=8, max_len=1024, page_len=16,
                      prefill_chunk=128, seed=0,
                      registry=obs.MetricsRegistry())
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for r in plan.requests:
        eng.submit(r.prompt, max_new_tokens=r.max_new_tokens,
                   priority=r.priority)
    wall_out = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    wall_launches = launch_counts()
    n_tok = sum(len(t) for t in wall_out.values())
    reg = eng.obs_registry

    rec = {
        "phase": "obs_serve", "nvidia_smi": smi,
        "model": "GPT-2 small bf16, bf16 pages, 8 slots, page_len 16, "
                 "chunks of 128, K = 8",
        "plan": {**plan.stats(), "seed": 0, "step_cost_ms": OBS_STEP_MS},
        "virtual": {"rounds": rep.rounds,
                    "virtual_wall_ms": rep.virtual_wall_ms,
                    "ttft_ms": rep.ttft_ms, "itl_ms": rep.itl_ms,
                    "queue_delay_ms": rep.queue_delay_ms,
                    "ttft_ms_by_priority": rep.ttft_ms_by_priority,
                    "goodput_tokens_per_s": rep.goodput_tokens_per_s},
        "byte_identical_reports": rep.to_json() == b["report"].to_json(),
        "report_bytes": len(rep.to_json()),
        "obs_off_same_tokens": rep_off.tokens == rep.tokens,
        "obs_off_same_launches": off["launches"] == a["launches"],
        "launches": {n: c for n, c in a["launches"].items() if c},
        "host_syncs_one_window": syncs,
        "slo": {"tracker": OBS_SLO,
                "same_tokens_as_fifo": rep_slo.tokens == rep.tokens,
                "against_fifo": slo_diff,
                "overtakes": rep_slo.slo_overtakes,
                "prefill_yields": rep_slo.slo_yields,
                "rounds": rep_slo.rounds, "ttft_ms": rep_slo.ttft_ms,
                "ttft_ms_by_priority": rep_slo.ttft_ms_by_priority,
                "itl_ms": rep_slo.itl_ms,
                "objectives": [{k: o[k] for k in ("name", "current",
                                                  "trips", "clears")}
                               for o in rep_slo.slo["objectives"]]},
        "spans": a["tracer"].span_names(),
        "span_compiles": a["tracer"].compiles,
        "warm_spans": len(warm),
        "warm_spans_compiled": sum(sp.compiles > 0 for sp in warm),
        "chrome_events": len(chrome["traceEvents"]),
        "jsonl_lines": len(jsonl_events),
        "flightrec": {"recorded": meta["recorded"],
                      "dropped": meta["dropped"],
                      "kinds": a["fr"].kinds()},
        "obs_walls_s": {"slo_on_first": slo["wall_s"],
                        "on": [a["wall_s"], b["wall_s"]],
                        "off": [off["wall_s"], off2["wall_s"]]},
        "obs_on_over_off": (a["wall_s"] + b["wall_s"])
        / (off["wall_s"] + off2["wall_s"]),
        "wall_clock": {"requests": len(wall_out), "generated_tokens": n_tok,
                       "wall_s": wall_s, "tokens_per_s": n_tok / wall_s,
                       "ttft_ms": _hist_q(reg, "serve.ttft_ms"),
                       "itl_ms": _hist_q(reg, "serve.itl_ms"),
                       "queue_delay_ms": _hist_q(reg,
                                                 "serve.queue_delay_ms"),
                       "windows": eng.decode_dispatches,
                       "chunks": eng.prefill_dispatches,
                       "prefix_hits": eng.stats()["prefix_hits"]},
        "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(rep.completed == 32 and all(
        len(rep.tokens[u]) == n for u, n in want_len.items())
        and all(0 <= t < cfg.vocab_size for toks in rep.tokens.values()
                for t in toks), "obs_serve: a request fell short")
    check(rep.ttft_ms["count"] == 32 and rep.itl_ms["count"] > 0,
          "obs_serve: the lifecycle did not see every request")
    check(rec["byte_identical_reports"],
          "obs_serve: two virtual-clock runs gave different reports")
    check(rec["obs_off_same_tokens"] and rec["obs_off_same_launches"]
          and off2["report"].tokens == rep.tokens
          and off2["launches"] == a["launches"],
          "obs_serve: obs off changed the tokens or the launches "
          f"({off['launches']} vs {a['launches']})")
    check(syncs["on"] == syncs["off"] and syncs["on"]["device_to_host"] == 1,
          f"obs_serve: host syncs a window differ or are not one read: "
          f"{syncs}")
    check(rec["slo"]["same_tokens_as_fifo"],
          f"obs_serve: SLO-aware admission changed tokens: {slo_diff}")
    check(rep_slo.slo_overtakes + rep_slo.slo_yields >= 1,
          "obs_serve: the SLO-aware run neither overtook nor yielded")
    check(all(a["launches"][n] > 0 for n in SERVING),
          f"obs_serve: a serving kernel never launched: {a['launches']}")
    check(len(fr_events) == meta["recorded"] and meta["dropped"] == 0
          and meta["schema"] == obs.SCHEMA
          and chrome["otherData"]["schema"] == obs.SCHEMA
          and len(chrome["traceEvents"]) == len(a["tracer"].spans)
          + len(a["tracer"].events),
          "obs_serve: the trace or the dump did not read back")
    check(len(windows) == a["stats"]["decode_dispatches"] > 1
          and warm and rec["warm_spans_compiled"] == 0,
          "obs_serve: a span after the first window built or loaded a "
          "library")
    check(wall_launches["paged_fused_attention"] > 0
          and len(wall_out) == 32, "obs_serve: the wall-clock run failed")
    return a["launches"]


def phase_obs_train(dev, params, b: int = 8, s: int = 1024, k: int = 4
                    ) -> dict:
    """One GPT-2 small O2 window (``_train_setup``, batch 8 x 1024, K =
    4) with obs off and one from a fresh set-up with obs on: the losses
    and scales bit for bit, the same launches; the obs-on window is one
    ``train/dispatch`` span with K steps and a ``train.dispatch_ms``
    sample; then ``save`` and ``restore`` of its carry, whose spans and
    recorder events follow JAX's order, and the restored leaves bit for
    bit the saved ones."""
    t_phase = time.perf_counter()
    metrics = {"loss": "last", "loss_scale": "last", "skipped": "sum"}
    runs = {}
    for on in (False, True):
        obs.set_enabled(on)
        obs.reset_default()
        obs.reset_default_flightrec()
        _, step, carry, _ = _train_setup(dev, params, b, s)
        driver = FusedTrainDriver(step, steps_per_dispatch=k,
                                  metrics=metrics,
                                  per_step=("loss", "loss_scale"))
        torch.cuda.synchronize()
        reset_launch_counts()
        carry, res = driver.run_window(carry)
        host = read_metrics(res)
        runs[on] = {"per_step": host.per_step, "launches": launch_counts(),
                    "wall_ms": driver.last_dispatch_ms}
        if not on:
            del step, carry, driver
            torch.cuda.empty_cache()
    tracer, reg, fr = (obs.default_tracer(), obs.default_registry(),
                       obs.default_flightrec())
    dispatch = [sp for sp in tracer.spans if sp.name == "train/dispatch"]
    tmp = tempfile.mkdtemp(prefix="apex_tpu_torch_obs_ckpt_")
    try:
        driver.save(tmp, carry, k)
        restored, at = driver.restore(tmp, carry)
        torch.cuda.synchronize()
        saved, got = _leaves(carry), _leaves(restored)
        same = all(torch.equal(t, got[n]) for n, t in saved.items()
                   if torch.is_tensor(t))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    names = [sp.name for sp in tracer.spans]
    kinds = [e["kind"] for e in fr.events()]
    rec = {"phase": "obs_train", "model": "GPT-2 small O2, dropout 0.1, "
           "fused_adam", "batch": [b, s], "steps_per_window": k,
           "losses_off": runs[False]["per_step"]["loss"],
           "losses_on": runs[True]["per_step"]["loss"],
           "scales_on": runs[True]["per_step"]["loss_scale"],
           "same_losses_and_scales": runs[False]["per_step"]
           == runs[True]["per_step"],
           "same_launches": runs[False]["launches"]
           == runs[True]["launches"],
           "launches": {n: c for n, c in runs[True]["launches"].items()
                        if c},
           "dispatch_spans": [{"attrs": sp.attrs, "dur_ms": sp.dur * 1e-6,
                               "compiles": sp.compiles} for sp in dispatch],
           "dispatch_ms_off_on": [runs[False]["wall_ms"],
                                  runs[True]["wall_ms"]],
           "registry": {n: reg.get(n).snapshot() for n in reg.names()},
           "spans": names, "flightrec_kinds": kinds,
           "restored_step": at, "restored_bit_for_bit": same,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(rec["same_losses_and_scales"] and rec["same_launches"],
          "obs_train: obs on changed the losses, scales or launches")
    check(len(dispatch) == 1 and dispatch[0].attrs == {
        "k": k, "microbatches": 1}
        and reg.get("train.steps").value == k
        and reg.get("train.dispatches").value == 1
        and reg.get("train.dispatch_ms").count == 1,
        "obs_train: the window is not one train/dispatch span of K steps")
    check(names == ["train/dispatch", "train/checkpoint_save",
                    "train/checkpoint_restore"] and kinds == names
          and at == k and same,
          f"obs_train: checkpoint spans {names} or records {kinds} out of "
          "JAX's order, or the restore differs")
    return runs[True]["launches"]


# -- phase 20: the input pipeline (native loader, prefetcher, ImageNet) --------

# the record file of both phases: 4 windows of K = 10 at batch 128 of
# 224 x 224 x 3 uint8 images and int32 labels (771 MB)
DL_RECORDS, DL_HW, DL_BATCH, DL_K = 5120, 224, 128, 10


def _dl_write(path: str, n: int, hw: int, seed: int = 40):
    """``n`` records through the port's ``write_records``: seeded uint8
    noise whose first 4 bytes hold the record's index (int32), and
    seeded labels in [0, 1000); returns the labels."""
    import numpy as np

    from apex_tpu_torch.data import write_records

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 1000, n).astype(np.int32)

    def samples():
        for lo in range(0, n, 256):
            m = min(256, n - lo)
            imgs = rng.randint(0, 256, (m, hw, hw, 3), dtype=np.uint8)
            imgs.reshape(m, -1)[:, :4] = np.arange(
                lo, lo + m, dtype="<i4")[:, None].view(np.uint8)
            for j in range(m):
                yield {"image": imgs[j], "label": labels[lo + j]}

    write_records(path, samples(), imagenet_example.fields(hw))
    return torch.from_numpy(labels)


def _record_index(images: torch.Tensor) -> torch.Tensor:
    """The index each record's image carries in its first 4 bytes."""
    flat = images.reshape(images.shape[0], -1)[:, :4].contiguous()
    return flat.view(torch.int32).reshape(-1).cpu()


def _dl_order(path: str, workers: int, epoch: int):
    """(record indices, labels) of one shuffled epoch, in batch order."""
    from apex_tpu_torch.data import NativeDataLoader

    loader = NativeDataLoader(path, imagenet_example.fields(DL_HW),
                              DL_BATCH, shuffle=True, seed=0,
                              num_workers=workers)
    try:
        idx, lab = [], []
        for b in loader.epoch(epoch):
            idx.append(_record_index(b["image"]))
            lab.append(b["label"])
        return torch.cat(idx), torch.cat(lab)
    finally:
        loader.close()


#: 50 ms of ``torch.cuda._sleep`` on an H100 (at most 1.98 GHz)
HOLD_CYCLES = 100_000_000


def _prefetch_hazards(dev) -> dict:
    """``DevicePrefetcher``'s two stream hazards, planted on the card.
    Six batches of 8 x 224 x 224 x 3 seeded uint8 (1.2 MB each, their
    own bytes) are staged, and the consumer copies each on its stream;
    each copy is held bit for bit against its host batch.  (1) Each
    staged copy held back 50 ms on the side stream (``torch.cuda._sleep``
    before it), the consumer reading at once: the real prefetcher passes,
    one handing over without ``wait_event`` must fail.  (2) The consumer
    held back 50 ms before each read and dropping the batch before it
    asks for the next: the real prefetcher passes, one that does not
    ``record_stream`` must fail (the next copy gets the dropped batch's
    memory and overwrites it before the read).  Returns, per case, each
    batch's verdict."""
    import numpy as np

    from apex_tpu_torch.data import DevicePrefetcher

    class HeldSide(DevicePrefetcher):
        def _stage(self, batch):
            with torch.cuda.stream(self._stream):
                torch.cuda._sleep(HOLD_CYCLES)
            return super()._stage(batch)

    class HeldSideNoWait(HeldSide):
        def _hand_over(self, staged, in_flight):
            batch, done, host = staged
            stream = torch.cuda.current_stream(self._device)
            batch.record_stream(stream)
            in_flight.append((done, host))
            return batch

    class NoRecord(DevicePrefetcher):
        def _hand_over(self, staged, in_flight):
            batch, done, host = staged
            torch.cuda.current_stream(self._device).wait_event(done)
            in_flight.append((done, host))
            return batch

    rng = np.random.RandomState(41)
    host = [torch.from_numpy(rng.randint(0, 256, (8, DL_HW, DL_HW, 3),
                                         dtype=np.uint8)) for _ in range(6)]

    def run(cls, hold_consumer):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reads = []
        for batch in cls(host, device=dev):
            if hold_consumer:
                torch.cuda._sleep(HOLD_CYCLES)
            reads.append(batch.clone())
            del batch
        torch.cuda.synchronize()
        return [bool(torch.equal(r.cpu(), h)) for r, h in zip(reads, host)]

    return {"held_side_stream": run(HeldSide, False),
            "held_side_stream_no_wait_event": run(HeldSideNoWait, False),
            "held_consumer": run(DevicePrefetcher, True),
            "held_consumer_no_record_stream": run(NoRecord, True)}


def phase_data_loader(dev, tmp: str) -> str:
    """The port's native loader on the record file of
    :data:`DL_RECORDS` 224 x 224 images (771 MB), written with
    ``write_records``: one epoch read with JAX's default 2 workers
    (batches/s and GB/s, from the page cache: the file was just written,
    so this is batch assembly and the copy out, not the disk); every
    record once (5,120 = 40 batches, nothing dropped) with its label;
    the same order under 1 and 4 workers and another for epoch 1.  Then
    ``DevicePrefetcher`` on the card over ``window_batches(K = 10)``:
    each staged window bit for bit a plain synchronous copy of the same
    host window, and, from a ``torch.profiler`` trace of one staged
    window, every host-to-device copy ``Memcpy HtoD (Pinned -> Device)``
    on a stream that runs no kernel of the consumer.  Returns the
    file's path."""
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.data import (DevicePrefetcher, NativeDataLoader,
                                     window_batches)

    t_phase = time.perf_counter()
    path = os.path.join(tmp, "train.bin")
    t0 = time.perf_counter()
    labels = _dl_write(path, DL_RECORDS, DL_HW)
    write_s = time.perf_counter() - t0
    nbytes = os.path.getsize(path)
    loader = NativeDataLoader(path, imagenet_example.fields(DL_HW),
                              DL_BATCH, shuffle=True, seed=0)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader.epoch(0))
    read_s = time.perf_counter() - t0
    order, got_labels = _dl_order(path, 2, 0)
    once = torch.equal(torch.sort(order).values,
                       torch.arange(DL_RECORDS, dtype=torch.int32))
    labels_ok = torch.equal(got_labels, labels[order.long()])
    same_order = {w: torch.equal(_dl_order(path, w, 0)[0], order)
                  for w in (1, 4)}
    next_epoch = _dl_order(path, 2, 1)[0]
    reshuffled = not torch.equal(next_epoch, order)

    def to_pair(b):
        return b["image"], b["label"]

    host = []

    def keep(windows):
        for w in windows:
            host.append(to_pair(w))
            yield w

    staged_ok = []
    for i, (img, lab) in enumerate(DevicePrefetcher(
            keep(window_batches(loader.epoch(0), DL_K)), transform=to_pair,
            device=dev)):
        # compared on the consumer's stream at once: a batch read before
        # its copy ended would differ
        hi, hl = host[i]
        staged_ok.append(bool(torch.equal(img, hi.to(dev)))
                         and bool(torch.equal(lab, hl.to(dev))))
        host[i] = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pf = iter(DevicePrefetcher(window_batches(loader.epoch(1), DL_K),
                                   transform=to_pair, device=dev))
        img, _ = next(pf)  # windows 0 and 1 staged, window 0 handed over
        imagenet_example.normalize(img).sum().item()
        pf.close()
        torch.cuda.synchronize()
    loader.close()
    hazards = _prefetch_hazards(dev)
    # each device event's resource id is its stream
    events = _kernel_events(prof)
    copies = [e for e in events if "Memcpy HtoD" in e.name]
    kernels = [e for e in events if "Memcpy" not in e.name
               and "Memset" not in e.name]
    copy_streams = sorted({e.device_resource_id for e in copies})
    kernel_streams = sorted({e.device_resource_id for e in kernels})
    copy_us = sum(e.time_range.elapsed_us() for e in copies)
    window_bytes = DL_K * DL_BATCH * (DL_HW * DL_HW * 3 + 4)
    rec = {"phase": "data_loader", "records": DL_RECORDS,
           "record_bytes": DL_HW * DL_HW * 3 + 4, "file_bytes": nbytes,
           "write_s": write_s, "batch": DL_BATCH, "workers": 2,
           "batches": n, "read_s": read_s, "batches_per_s": n / read_s,
           "gb_per_s": n * DL_BATCH * (DL_HW * DL_HW * 3 + 4) / read_s / 1e9,
           "read_from": "the page cache (the file was just written): batch "
                        "assembly and the copy out, not the disk",
           "every_record_once": once, "labels_match": labels_ok,
           "same_order_workers_1_4": same_order,
           "epoch_1_reshuffled": reshuffled,
           "staged_windows": len(staged_ok),
           "staged_bitwise_plain_copy": staged_ok,
           "htod_copies": [{"name": e.name, "stream": e.device_resource_id,
                            "us": e.time_range.elapsed_us()}
                           for e in copies],
           "copy_streams": copy_streams, "kernel_streams": kernel_streams,
           "copy_gb_per_s": (2 * window_bytes / (copy_us * 1e3)
                             if copy_us else None),
           "window_bytes": window_bytes,
           "planted_stream_hazards": hazards,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    check(n == DL_RECORDS // DL_BATCH and once and labels_ok,
          f"data_loader: {n} batches, every record once {once}, labels "
          f"{labels_ok}")
    check(all(same_order.values()) and reshuffled,
          f"data_loader: order under 1/4 workers {same_order}, epoch 1 "
          f"reshuffled {reshuffled}")
    check(len(staged_ok) == DL_RECORDS // (DL_BATCH * DL_K)
          and all(staged_ok),
          f"data_loader: staged windows differ from plain copies "
          f"{staged_ok}")
    check(len(copies) == 4 and all("Pinned -> Device" in e.name
                                   for e in copies)
          and kernel_streams and not set(copy_streams) & set(kernel_streams),
          f"data_loader: the staged copies are not pinned copies on a side "
          f"stream: {rec['htod_copies']} kernels on {kernel_streams}")
    check(all(hazards["held_side_stream"] + hazards["held_consumer"]),
          f"data_loader: the prefetcher's batches differ under held "
          f"streams: {hazards}")
    check(not all(hazards["held_side_stream_no_wait_event"])
          and not all(hazards["held_consumer_no_record_stream"]),
          f"data_loader: the check misses a planted stream hazard: "
          f"{hazards}")
    return path


class _Stop(Exception):
    """Ends an example run from its window hook."""


def _imagenet_args(path: str, *extra) -> list:
    """``bench.py``'s RN50 configuration through the example, from the
    record file."""
    return ["--data", path, "--opt-level", "O2", "-b", str(DL_BATCH),
            "--image-size", str(DL_HW), "--steps-per-dispatch", str(DL_K),
            "--epochs", "1", *extra]


def _device_intervals(prof) -> tuple:
    """(union of the device events' intervals in ms, the first kernel's
    start in ms from the trace's start, the first copy's)."""
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in _kernel_events(prof))
    busy, end = 0.0, None
    for s, e, _ in evs:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    first_kernel = next((s for s, _, n in evs if "Memcpy" not in n
                         and "Memset" not in n), None)
    first_copy = next((s for s, _, n in evs if "Memcpy HtoD" in n), None)
    return (busy / 1e3, None if first_kernel is None else first_kernel / 1e3,
            None if first_copy is None else first_copy / 1e3)


def _span_ms(spans, name: str) -> list:
    return [sp.dur / 1e6 for sp in spans if sp.name == name]


def phase_imagenet_example(dev, path: str, rn_images_per_s: float,
                           smi: str) -> dict:
    """``examples/imagenet`` of the port on the card.

    (a) In process, ``--data <file> --opt-level O2 -b 128 --image-size
    224 --steps-per-dispatch 10 --epochs 1 --digest-file``: 4 windows of
    ``bench.py``'s RN50 configuration fed by the loader, the prefetcher
    and the normalisation on the card.  Images/s beside
    ``resnet_train``'s fixed batch; per window the host ms in the loader
    wait (``data/next_batch``), ``window_batches`` (``data/window``),
    ``train/prefetch`` and ``train/dispatch`` spans; over window 2 (from
    window 1's host read to its own, window 3 staged before it) the
    device's busy share and the gap before its first kernel, from a
    profiler trace of its device events (images/s also over windows 1
    and 3 alone); the host syncs of window 3; the peak memory; the
    cross-entropy launches (exactly K each a window, nothing else).
    Gates: finite losses that fall (the last window's mean below the
    first's), exact launches, the digests written.
    (b) Window 0 again from a fresh build from the same seed, fed by
    plain synchronous copies of JAX's host transform (numpy, then
    ``.to``): the per-step losses, scale, skipped count and every master
    after it bit for bit (a)'s (TF32 off, cuDNN's defaults, as
    ``ddp_resnet``), and the normalised staged window bit for bit the
    plain copy.
    (c) The example's defaults: O1, ``-b 64``, synthetic data, K = 10,
    30 steps (ResNet-50 under O1 autocast): finite losses, the last
    window's below the first's, K cross-entropy launches each in the
    first window.
    (d) ``--sync_bn`` (an NCCL group of one) for one O2 window from the
    file: its losses bit for bit (a)'s window 0.
    (e) ``--prof 0``: the Chrome trace it writes names the cross-entropy
    kernels, K each."""
    import warnings

    import numpy as np

    from apex_tpu_torch.data import DevicePrefetcher, NativeDataLoader
    from apex_tpu_torch.data import window_batches
    from apex_tpu_torch.parallel import make_mesh

    ex = imagenet_example
    t_phase = time.perf_counter()
    tracer = obs.default_tracer()
    n0 = len(tracer.spans)
    caught = warnings.catch_warnings(record=True)
    seen = {}

    def on_window(epoch, w, carry, m):
        # window 2 (staging window 3 before it) under the profiler, its
        # device events only; window 3 (nothing left to stage) under the
        # sync debug mode
        if w == 0:
            seen["masters"] = {n: t.clone() for n, t in carry[0].items()}
            seen["m0"] = m
        elif w == 1:
            from torch.profiler import ProfilerActivity, profile

            seen["prof"] = profile(activities=[ProfilerActivity.CUDA])
            seen["prof"].start()
            seen["t1"] = time.perf_counter()
        elif w == 2:
            seen["wall"] = time.perf_counter() - seen["t1"]
            seen["prof"].stop()
            seen["w"] = caught.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        elif w == 3:
            torch.cuda.set_sync_debug_mode("default")
            caught.__exit__(None, None, None)

    # torch reports a synchronisation of its own the first time the sync
    # debug mode is on in a process: spend it here
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.zeros(1, device=dev).add_(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    digest = os.path.join(os.path.dirname(path), "digests.json")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = ex.run(ex.parse_args(_imagenet_args(path, "--digest-file",
                                              digest)), on_window=on_window)
    a_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    spans = tracer.spans[n0:]
    with open(digest) as fh:
        digests = json.load(fh)
    syncs = [w for w in seen.get("w", [])
             if "synchroniz" in str(w.message)]
    sync_sites: dict = {}
    for w in syncs:
        site = f"{os.path.relpath(w.filename)}:{w.lineno}"
        sync_sites[site] = sync_sites.get(site, 0) + 1
    busy_ms, first_kernel_ms, first_copy_ms = _device_intervals(seen["prof"])
    wins = res["windows"]
    unprofiled = [w["wall_s"] for w in wins if w["window"] in (1, 3)]
    losses = [x for w in wins for x in
              digests["losses"][w["window"] * DL_K:(w["window"] + 1) * DL_K]]
    n_win = len(wins)
    per_window = {
        name: _span_ms(spans, name)
        for name in ("data/next_batch", "data/window", "train/prefetch",
                     "train/dispatch")}
    loader_wait = [sum(per_window["data/next_batch"][i * DL_K:(i + 1) * DL_K])
                   for i in range(n_win)]
    want_launches = {n: 0 for n in launches}
    want_launches.update({"softmax_xentropy_fwd": n_win * DL_K,
                          "softmax_xentropy_bwd": n_win * DL_K})
    first_mean = sum(losses[:DL_K]) / DL_K
    last_mean = sum(losses[-DL_K:]) / DL_K
    rec_a = {"phase": "imagenet_example", "part": "a",
             "args": _imagenet_args("<file>", "--digest-file", "<json>"),
             "nvidia_smi": smi, "world": res["world"], "windows": n_win,
             "seconds": a_s, "images_per_s": res["images_per_s"],
             "images_per_s_unprofiled": DL_BATCH * DL_K * len(unprofiled)
             / sum(unprofiled),
             "resnet_train_images_per_s": rn_images_per_s,
             "window_walls_s": [w["wall_s"] for w in wins],
             "losses_per_step": losses,
             "scale": [w["scale"] for w in wins],
             "skipped": [w["skipped"] for w in wins],
             "host_ms_per_window": {
                 "loader_wait": loader_wait,
                 "window_batches": per_window["data/window"],
                 "train_prefetch": per_window["train/prefetch"],
                 "train_dispatch": per_window["train/dispatch"]},
             "window_2_profiled": {
                 "wall_ms": seen["wall"] * 1e3, "device_busy_ms": busy_ms,
                 "device_busy_share": busy_ms / (seen["wall"] * 1e3),
                 "gap_before_first_kernel_ms": first_kernel_ms,
                 "first_htod_copy_ms": first_copy_ms},
             "window_3_host_syncs": len(syncs),
             "window_3_host_sync_sites": dict(sorted(sync_sites.items())),
             "max_memory_allocated_bytes": peak,
             "launches": launches,
             "launches_expected": want_launches}
    emit(rec_a)
    check(len(losses) == n_win * DL_K == len(digests["losses"])
          and n_win == DL_RECORDS // (DL_BATCH * DL_K)
          and all(math.isfinite(x) for x in losses),
          f"imagenet (a): {n_win} windows, losses {losses}")
    check(last_mean < first_mean, f"imagenet (a): the loss did not fall "
          f"({first_mean} -> {last_mean})")
    check(launches == want_launches,
          f"imagenet (a): launches {launches} != {want_launches}")

    # (b) window 0 again, fed by plain copies of JAX's host transform
    group_ok = init_distributed(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout_s=120)
    check(group_ok, "imagenet (b): no NCCL group")
    try:
        net, carry = ex.build("O2", device=dev, seed=0)
        driver = FusedTrainDriver(ex.make_step(net), steps_per_dispatch=DL_K,
                                  metrics=ex.METRICS, per_step=("loss",),
                                  mesh=make_mesh([("data", 1)]))
        loader = NativeDataLoader(path, ex.fields(DL_HW), DL_BATCH,
                                  shuffle=True, seed=0)
        w0 = next(window_batches(loader.epoch(0), DL_K))
        loader.close()
        x = torch.from_numpy((w0["image"].numpy().astype(np.float32)
                              - 127.5) / 127.5).to(dev)
        y = w0["label"].to(dev)
        staged = next(iter(DevicePrefetcher(
            [(w0["image"], w0["label"])], device=dev)))
        images_bitwise = bool(torch.equal(ex.normalize(staged[0]), x)) \
            and bool(torch.equal(staged[1], y))
        del staged
        carry, r = driver.run_window(carry, (x, y))
        m = read_metrics({**r.metrics, "losses": r.per_step["loss"]})
        masters = carry[0]
        window_bitwise = {
            "losses": m["losses"] == seen["m0"]["losses"],
            "scale": m["scale"] == seen["m0"]["scale"],
            "skipped": m["skipped"] == seen["m0"]["skipped"],
            "masters": _tensors_equal(masters, seen["masters"])}
        max_diff = max(float((masters[n] - seen["masters"][n]).abs().max())
                       for n in masters)
        del net, carry, driver, masters, x, y
    finally:
        dist.destroy_process_group()
    del seen["masters"]
    torch.cuda.empty_cache()
    emit({"phase": "imagenet_example", "part": "b",
          "what": "window 0 from the same seed, plain synchronous copies "
                  "of JAX's host transform",
          "window_bitwise": window_bitwise, "masters_max_abs_diff": max_diff,
          "staged_images_bitwise": images_bitwise})
    check(images_bitwise, "imagenet (b): the staged, normalised window is "
          "not the plain copy of JAX's transform bit for bit")
    check(all(window_bitwise.values()),
          f"imagenet (b): window 0 differs from (a)'s: {window_bitwise}, "
          f"masters {max_diff}")

    # (c) the example's defaults: O1, -b 64, synthetic data, K = 10 and
    # its 30 steps (the loss climbs over the first window from a fresh
    # start at lr 0.1, at O2 in (a) too, and comes back down after)
    def first_window_launches(epoch, w, carry, m):
        if w == 0:
            seen["c"] = launch_counts()

    reset_launch_counts()
    t0 = time.perf_counter()
    res_c = ex.run(ex.parse_args([]), on_window=first_window_launches)
    c_s = time.perf_counter() - t0
    launches_c = seen.pop("c")
    c_digests = res_c["digests"]
    c_windows = [c_digests[i:i + DL_K] for i in range(0, len(c_digests),
                                                      DL_K)]
    emit({"phase": "imagenet_example", "part": "c",
          "what": "the example's defaults: O1, -b 64, synthetic data, "
                  "K = 10, 30 steps", "seconds": c_s,
          "images_per_s": res_c["images_per_s"],
          "window_walls_s": [w["wall_s"] for w in res_c["windows"]],
          "losses_per_step": c_digests,
          "scale": [w["scale"] for w in res_c["windows"]],
          "skipped": [w["skipped"] for w in res_c["windows"]],
          "launches_first_window": launches_c})
    check(len(c_windows) == 3 and all(math.isfinite(x) for x in c_digests)
          and sum(c_windows[-1]) < sum(c_windows[0]),
          f"imagenet (c): O1 losses not finite and falling: {c_digests}")
    check(launches_c == {n: (DL_K if n.startswith("softmax_xentropy")
                             else 0) for n in launches_c},
          f"imagenet (c): launches {launches_c}")

    # (d) --sync_bn at world 1: window 0 bit for bit (a)'s
    got_d = {}

    def stop_after_first(epoch, w, carry, m):
        got_d.update(m)
        raise _Stop

    try:
        ex.run(ex.parse_args(_imagenet_args(path, "--sync_bn")),
               on_window=stop_after_first)
    except _Stop:
        pass
    check(not dist.is_initialized(), "imagenet (d): the example left its "
          "process group behind")
    d_bitwise = got_d.get("losses") == seen["m0"]["losses"]
    emit({"phase": "imagenet_example", "part": "d",
          "what": "--sync_bn, NCCL at world 1, window 0",
          "losses_per_step": got_d.get("losses"),
          "bitwise_a_window_0": d_bitwise})
    check(d_bitwise, "imagenet (d): --sync_bn's window 0 is not (a)'s")

    # (e) --prof 0: a trace that names the cross-entropy kernels
    res_e = ex.run(ex.parse_args(_imagenet_args(path, "--prof", "0")))
    trace = res_e["trace"]
    with open(trace) as fh:
        names = [e.get("name", "") for e in json.load(fh)["traceEvents"]
                 if e.get("cat") == "kernel"]
    trace_bytes = os.path.getsize(trace)
    os.remove(trace)
    xent = {k: sum(k in n for n in names)
            for k in ("xent_fwd_kernel", "xent_bwd_kernel")}
    emit({"phase": "imagenet_example", "part": "e",
          "what": "--prof 0: the Chrome trace of window 0",
          "trace_bytes": trace_bytes, "kernels": len(names),
          "xent_kernels": xent,
          "seconds": time.perf_counter() - t_phase})
    check(xent == {"xent_fwd_kernel": DL_K, "xent_bwd_kernel": DL_K},
          f"imagenet (e): the trace's cross-entropy kernels {xent}")
    return {"a": launches, "c": launches_c}


INPUT_TIMEOUT_S = 600


def input_worker(out_dir: str) -> int:
    """``data_loader`` and ``imagenet_example`` in a process of their
    own (``chip_smoke.py --input-worker DIR``, spawned by
    :func:`phase_input_pipeline`): DIR/config.json holds the card's
    ``nvidia-smi`` line and ``resnet_train``'s images/s; the phases'
    records go to stdout, the example's launches to DIR/launches.json,
    and the record file into DIR."""
    fp32_precision()
    with open(os.path.join(out_dir, "config.json")) as fh:
        conf = json.load(fh)
    dev = torch.device("cuda")
    path = phase_data_loader(dev, out_dir)
    launches = phase_imagenet_example(dev, path, conf["rn_images_per_s"],
                                      conf["nvidia_smi"])
    with open(os.path.join(out_dir, "launches.json"), "w") as fh:
        json.dump(launches, fh)
    return 0


def phase_input_pipeline(rn_images_per_s: float, smi: str) -> dict:
    """Runs :func:`input_worker` in a fresh process and relays its
    records.  In a process that has run profiled training windows (the
    earlier phases here, or these phases themselves) the profiler stops
    delivering some device events, kernels and copies alike, even to
    sessions padded with idle time, while a fresh process delivers every
    one (PERF.md, Findings, the ImageNet example's slice); these
    phases' checks read the copies from the profiler.  Returns the example's launches ``{"a", "c"}``."""
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_input_")
    try:
        with open(os.path.join(out_dir, "config.json"), "w") as fh:
            json.dump({"rn_images_per_s": rn_images_per_s,
                       "nvidia_smi": smi}, fh)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--input-worker",
             out_dir], capture_output=True, text=True,
            timeout=INPUT_TIMEOUT_S)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(line, flush=True)
        check(proc.returncode == 0, f"input pipeline worker failed (exit "
              f"{proc.returncode}):\n{proc.stdout[-3000:]}\n"
              f"{proc.stderr[-3000:]}")
        with open(os.path.join(out_dir, "launches.json")) as fh:
            return json.load(fh)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


# -- phase 21: KV handoff, streamed handoff, prefix migration, weight swaps --

#: new tokens a request in the fp32 legs (a) and (e)
HANDOFF_NEW = 32
#: the streamed leg's prompt: 768 tokens (48 pages), prefill chunks of 128
STREAM_PROMPT, STREAM_CHUNK = 768, 128


def _serve_engine(dec, slots: int, chunk: int = 128, **kw):
    """The engine phase's geometry: ``max_len`` 1024, page_len 16."""
    return ServeEngine(dec, slots=slots, max_len=1024, page_len=16,
                       prefill_chunk=chunk, seed=0, **kw)


def _sync_ms(fn):
    """``(fn(), its wall in ms)`` between two device syncs."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _slot_of(eng, uid: int) -> int:
    return next(s for s, r in eng._active.items() if r.uid == uid)


def _pages_bits_equal(eng, pages, container) -> bool:
    """``pages`` of ``eng``'s pool bit for bit the container's arrays."""
    got = eng.decoder.gather_pages(eng.cache, pages)
    want = (container.k, container.v, container.k_scale, container.v_scale)
    return all((g is None and w is None) or _bits_equal(g, w)
               for g, w in zip(got, want))


def _hop(src, dst, uid: int, max_new: int):
    """One monolithic handoff: ``uid`` exported from ``src`` (gather and
    host copy), through ``to_bytes``/``from_bytes``, adopted by ``dst``,
    its pages there checked bit for bit against the container, then
    detached from ``src``.  Returns ``(new uid, record)``; the uid is
    None, and the request stays on ``src``, when ``dst`` cannot take it
    now."""
    before = [int(src.pool.ref[p])
              for p in src.pool.slot_pages(_slot_of(src, uid))]
    ho, export_ms = _sync_ms(lambda: src.export_handoff(uid))
    after = [int(src.pool.ref[p])
             for p in src.pool.slot_pages(_slot_of(src, uid))]
    t0 = time.perf_counter()
    blob = ho.to_bytes()
    t1 = time.perf_counter()
    back = KVHandoff.from_bytes(blob)
    t2 = time.perf_counter()
    new, adopt_ms = _sync_ms(lambda: dst.adopt(back, max_new_tokens=max_new))
    rec = {"payload_bytes": ho.payload_bytes, "blob_bytes": len(blob),
           "pages": ho.n_pages, "export_ms": export_ms,
           "to_bytes_s": t1 - t0, "from_bytes_s": t2 - t1,
           "adopt_ms": adopt_ms, "source_refs_unchanged": before == after}
    if new is None:
        return None, rec
    pages = dst.pool.slot_pages(_slot_of(dst, new))
    rec["pages_bit_for_bit"] = _pages_bits_equal(dst, pages, ho)
    rec["destination_refs_one"] = all(int(dst.pool.ref[p]) == 1
                                      for p in pages)
    src.detach(uid)
    return new, rec


def _window_launches(eng, k: int = 8) -> dict:
    """The kernels a forward count, 25 LayerNorms and 12 paged calls of
    GPT-2 small, times the forwards ``eng`` ran: one a prefill chunk, K
    a window."""
    fwd = eng.prefill_dispatches + k * eng.decode_dispatches
    return {"layer_norm": 25 * fwd, "paged_fused_attention": 12 * fwd}


def _handoff_fp32(dev, params, dec32) -> dict:
    """(a): a prefill-only source and a decode engine, 4 slots each,
    page_len 16, fp32 compute and pool; an anchor prompt of 100 tokens (6
    full pages and a partial one), its duplicate (the full pages shared,
    the partial tail copy-on-written by the re-run last token) and two
    more; the duplicate handed off first, then the rest, each through
    bytes and detached at the source."""
    rng = torch.Generator().manual_seed(21)
    anchor = torch.randint(0, 50257, (100,), generator=rng).tolist()
    prompts = [anchor, list(anchor)] + [
        torch.randint(0, 50257, (n,), generator=rng).tolist()
        for n in (200, 57)]
    src = _serve_engine(dec32, 4, chunk=64, prefill_only=True)
    dst = _serve_engine(dec32, 4, chunk=64)
    torch.cuda.synchronize()
    reset_launch_counts()
    ua = src.submit(anchor, max_new_tokens=HANDOFF_NEW)
    while not src._active:
        src.step()
    uids = [ua] + [src.submit(p, max_new_tokens=HANDOFF_NEW)
                   for p in prompts[1:]]
    while src._queue or src._prefilling:
        src.step()
    torch.cuda.synchronize()
    src_launches = launch_counts()
    hits, cow = src.pool.prefix_hits, src.pool.cow_copies
    anchor_pages = src.pool.slot_pages(_slot_of(src, ua))
    dup_pages = src.pool.slot_pages(_slot_of(src, uids[1]))
    shared_refs = [int(src.pool.ref[p]) for p in anchor_pages]
    new, recs = {}, {}
    for i in (1, 0, 2, 3):  # the duplicate first, while the anchor holds
        new[i], recs[i] = _hop(src, dst, uids[i], HANDOFF_NEW)
        check(new[i] is not None, f"serve_handoff (a): request {i} refused")
        if i == 1:
            anchor_refs = [int(src.pool.ref[p]) for p in anchor_pages]
    torch.cuda.synchronize()
    reset_launch_counts()
    out = dst.run()
    torch.cuda.synchronize()
    dst_launches = launch_counts()
    tokens = [out[new[i]] for i in range(4)]
    cfg32 = dataclasses.replace(GPTConfig.small(),
                                compute_dtype=torch.float32)
    ref = [reference_generate(cfg32, params, p, HANDOFF_NEW, device=dev)
           for p in prompts[1:]]
    ref = [ref[0]] + ref
    want_src, want_dst = _window_launches(src), _window_launches(dst)
    return {
        "prompt_lens": [len(p) for p in prompts],
        "pages_a_request": [recs[i]["pages"] for i in range(4)],
        "prefix_hits": hits, "cow_copies": cow,
        "shared_pages": sum(p in anchor_pages for p in dup_pages),
        "shared_refs_before_export": shared_refs,
        "anchor_refs_after_detach": anchor_refs,
        "tokens_equal_reference_generate": tokens == ref,
        "source_refs_unchanged": all(r["source_refs_unchanged"]
                                     for r in recs.values()),
        "destination_refs_one": all(r["destination_refs_one"]
                                    for r in recs.values()),
        "pages_bit_for_bit": all(r["pages_bit_for_bit"]
                                 for r in recs.values()),
        "source_windows": src.decode_dispatches,
        "source_chunks": src.prefill_dispatches,
        "destination_chunks": dst.prefill_dispatches,
        "destination_windows": dst.decode_dispatches,
        "source_launches": {n: c for n, c in src_launches.items() if c},
        "destination_launches": {n: c for n, c in dst_launches.items() if c},
        "launches_exact": (
            src_launches == {n: want_src.get(n, 0) for n in src_launches}
            and dst_launches == {n: want_dst.get(n, 0)
                                 for n in dst_launches})}


def _handoff_mix(dec16, engine_run: dict) -> dict:
    """(b) and (f): the engine phase's 16-request mix disaggregated, 8
    slots on both sides: the first prompt lands on the prefill-only
    source before the rest are submitted (so the second shares its
    pages there), and at each boundary every parked request the decode
    engine can take hops over, each adopted page checked bit for bit.
    Timed, with the launches of the run; the tokens against the engine
    phase's are reported, not gated (the chunk batching differs)."""
    prompts = _engine_mix_prompts()
    src = _serve_engine(dec16, 8, prefill_only=True)
    dst = _serve_engine(dec16, 8)
    index, recs = {}, []
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    index[src.submit(prompts[0], max_new_tokens=64)] = 0
    while not src._active:
        src.step()
    for i, p in enumerate(prompts[1:], 1):
        index[src.submit(p, max_new_tokens=64)] = i
    adopted = {}
    while src._queue or src._prefilling or src._active or dst._active:
        src.step()
        for r in sorted(src._active.values(), key=lambda r: r.uid):
            new, rec = _hop(src, dst, r.uid, 64)
            if new is None:
                break  # the decode engine is full: the rest wait
            adopted[new] = index[r.uid]
            recs.append(rec)
        dst.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    tokens = [None] * len(prompts)
    for new, i in adopted.items():
        tokens[i] = dst.results[new].tokens
    n_bytes = sum(r["payload_bytes"] for r in recs)
    check(len(adopted) == len(prompts)
          and all(t is not None and len(t) == 64 for t in tokens),
          "serve_handoff (b): a request of the mix fell short")
    same = sum(a == b for a, b in zip(tokens, engine_run["tokens"]))
    return {
        "requests": len(recs), "hits_on_source": src.pool.prefix_hits,
        "pages_bit_for_bit": all(r["pages_bit_for_bit"] for r in recs),
        "source_refs_unchanged": all(r["source_refs_unchanged"]
                                     for r in recs),
        "source_windows": src.decode_dispatches,
        "destination_chunks": dst.prefill_dispatches,
        "launches": launches,
        "tokens_equal_engine_phase": same,
        "timing": {
            "payload_bytes_a_request": n_bytes / len(recs),
            "payload_bytes_min_max": [min(r["payload_bytes"] for r in recs),
                                      max(r["payload_bytes"] for r in recs)],
            "export_ms_median": statistics.median(r["export_ms"]
                                                  for r in recs),
            "export_ms_max": max(r["export_ms"] for r in recs),
            "to_bytes_mb_per_s": n_bytes / 1e6
            / sum(r["to_bytes_s"] for r in recs),
            "from_bytes_mb_per_s": n_bytes / 1e6
            / sum(r["from_bytes_s"] for r in recs),
            "adopt_ms_median": statistics.median(r["adopt_ms"]
                                                 for r in recs),
            "adopt_ms_max": max(r["adopt_ms"] for r in recs),
            "disaggregated_wall_s": wall,
            "engine_phase_wall_s": engine_run["wall_s"],
            "generated_tokens": sum(map(len, tokens)),
            "tokens_per_s": sum(map(len, tokens)) / wall}}


def _in_place_vs_adopted(dec16) -> dict:
    """(b): four requests of the mix prefilled on a prefill-only engine,
    exported before any window and adopted elsewhere; then the source
    goes on in place (``prefill_only`` off) while the destination decodes
    the adopted copies, 8 slots each: the same tokens, since a window's
    products have the same rows whatever slots are active and the paged
    kernel reads each slot alone."""
    prompts = _engine_mix_prompts()[2:6]
    src = _serve_engine(dec16, 8, prefill_only=True)
    dst = _serve_engine(dec16, 8)
    uids = [src.submit(p, max_new_tokens=64) for p in prompts]
    while src._queue or src._prefilling:
        src.step()
    check(src.decode_dispatches == 0, "serve_handoff (b): a window ran on "
          "the prefill-only source")
    adopted = [dst.adopt(KVHandoff.from_bytes(src.export_handoff(u)
                                              .to_bytes()),
                         max_new_tokens=64) for u in uids]
    check(None not in adopted, "serve_handoff (b): an adoption was refused")
    src.prefill_only = False  # the source goes on in place
    a, b = src.run(), dst.run()
    equal = [a[u] == b[v] for u, v in zip(uids, adopted)]
    return {"requests": len(uids), "prompt_lens": [len(p) for p in prompts],
            "tokens_equal": equal,
            "first_difference": [next((j for j, (x, y) in enumerate(
                zip(a[u], b[v])) if x != y), None)
                for u, v in zip(uids, adopted)]}


def _handoff_streamed(dec16) -> dict:
    """(c): one 768-token prompt chunk-prefilled 128 tokens a boundary on
    a prefill-only source, each full page streamed as it lands (the last
    page held back for the tail), staged on a destination with every
    chunk's pages checked bit for bit, committed and decoded; the same
    request handed off whole to another engine must give the same
    tokens.  Planted: a chunk with one flipped byte must raise, and the
    abort put the destination's pages back; a chunk out of order must be
    refused."""
    rng = torch.Generator().manual_seed(22)
    prompt = torch.randint(0, 50257, (STREAM_PROMPT,), generator=rng).tolist()
    src = _serve_engine(dec16, 2, chunk=STREAM_CHUNK, prefill_only=True)
    dst, mono = _serve_engine(dec16, 2), _serve_engine(dec16, 2)
    uid = src.submit(prompt, max_new_tokens=HANDOFF_NEW)
    chunks, nxt = [], 0
    while True:
        src.step()
        c = src.export_prefill_chunk(uid, nxt, len(chunks))
        if c is not None:
            chunks.append(c)
            nxt += c.n_pages
        if src.prefill_progress(uid) is None:
            break
    tail = src.export_handoff_tail(uid, nxt, len(chunks))
    stage = dst.adopt_stage_begin()
    staged, bits = [], []
    for c in chunks + [tail]:
        back = KVHandoffChunk.from_bytes(c.to_bytes())
        if c is tail:
            iu = dst.adopt_stage_commit(stage, back,
                                        max_new_tokens=HANDOFF_NEW)
            staged.append(iu is not None)
        else:
            staged.append(dst.adopt_stage_chunk(stage, back))
        row = dst.pool.tables[stage]
        bits.append(_pages_bits_equal(
            dst, [int(p) for p in row[c.page_offset:c.page_offset
                                      + c.n_pages]], c))
    streamed = dst.run()[iu]
    whole = mono.adopt(KVHandoff.from_bytes(src.export_handoff(uid)
                                            .to_bytes()),
                       max_new_tokens=HANDOFF_NEW)
    whole_tokens = mono.run()[whole]
    before = dst.pool.in_use
    stage = dst.adopt_stage_begin()
    first_ok = dst.adopt_stage_chunk(stage, chunks[0])
    mid = dst.pool.in_use
    blob = bytearray(chunks[1].to_bytes())
    blob[-100] ^= 0x10
    try:
        KVHandoffChunk.from_bytes(bytes(blob))
        flipped = "parsed"
    except HandoffError as e:
        flipped = str(e)
    dst.adopt_stage_abort(stage)
    after = dst.pool.in_use
    stage = dst.adopt_stage_begin()
    out_of_order = dst.adopt_stage_chunk(stage, chunks[1])
    dst.adopt_stage_abort(stage)
    return {"prompt": STREAM_PROMPT, "chunk": STREAM_CHUNK,
            "chunks": [(c.seq, c.page_offset, c.n_pages)
                       for c in chunks + [tail]],
            "staged": staged, "pages_bit_for_bit": bits,
            "tokens_equal_whole_handoff": streamed == whole_tokens,
            "planted_flipped_byte": flipped,
            "abort_in_use": [before, mid, after], "first_chunk_ok": first_ok,
            "planted_out_of_order_refused": out_of_order is False}


def _handoff_prefix(dec16) -> dict:
    """(d): the mix's 256-token shared prefix exported from an engine
    that serves its first prompt, imported ahead of demand by another;
    the second prompt (which extends it) must hit it there, 256 tokens,
    and stream the tokens of an engine that prefills it whole; the
    release returns the pool to its free count."""
    prompts = _engine_mix_prompts()
    shared = prompts[0][:256]
    src = _serve_engine(dec16, 2)
    src.submit(prompts[0], max_new_tokens=64)
    while not src._active:
        src.step()
    chunk = src.export_prefix(shared)
    dst = _serve_engine(dec16, 8)
    free0 = dst.pool.n_free
    pages = dst.import_prefix(chunk, shared)
    check(pages is not None, "serve_handoff (d): the prefix was refused")
    again = dst.import_prefix(chunk, shared)  # registered already: None
    bits = _pages_bits_equal(dst, pages, chunk)
    hits0 = (dst.pool.prefix_hits, dst.pool.prefix_hit_tokens)
    u = dst.submit(prompts[1], max_new_tokens=64)
    got = dst.run()[u]
    hits = (dst.pool.prefix_hits - hits0[0],
            dst.pool.prefix_hit_tokens - hits0[1])
    whole = _serve_engine(dec16, 8)
    v = whole.submit(prompts[1], max_new_tokens=64)
    want = whole.run()[v]
    held = dst.pool.n_free
    dst.release_prefix(pages)
    return {"prefix_tokens": len(shared), "pages": len(pages),
            "pages_bit_for_bit": bits, "hits": hits[0],
            "hit_tokens": hits[1], "tokens_equal_whole_prefill": got == want,
            "free_pages": [free0, held, dst.pool.n_free],
            "registered_again_refused": again is None}


def _handoff_swaps(dev, params, dec16, dec32) -> dict:
    """(e): an identical-digest swap mid-decode (bf16, four requests of
    the mix): nothing requeued, the tokens bit for bit an unswapped
    run's, no library built or loaded; a leaf of the wrong shape refused
    with the digest, queue and slots as they were; and a swap to a
    reseeded GPT-2 small mid-decode at fp32 (five requests on four
    slots): every prefilling and active request requeued, the prefix
    registry empty after it (the requeue frees most pages, and with them
    their keys; ``drop_prefixes`` takes the rest), and each request's later tokens ``reference_generate``'s
    under the new weights from its prompt and tokens so far."""
    mix = _engine_mix_prompts()[2:6]
    eng, base = _serve_engine(dec16, 4), _serve_engine(dec16, 4)
    uids = [eng.submit(p, max_new_tokens=HANDOFF_NEW) for p in mix]
    buids = [base.submit(p, max_new_tokens=HANDOFF_NEW) for p in mix]
    for _ in range(6):
        eng.step()
    heard = []

    def listen(kind, name):
        heard.append((kind, name))

    _build.add_build_listener(listen)
    try:
        same = eng.swap_weights(params)
    finally:
        _build.remove_build_listener(listen)
    a, b = eng.run(), base.run()
    identical = {"summary": {k: v for k, v in same.items() if k != "digest"},
                 "tokens_equal_unswapped": [a[u] for u in uids]
                 == [b[u] for u in buids],
                 "builds_or_loads": heard}

    new_params = init_params(GPTConfig.small(),
                             torch.Generator().manual_seed(1))
    rng = torch.Generator().manual_seed(23)
    prompts = [torch.randint(0, 50257, (n,), generator=rng).tolist()
               for n in (40, 150, 90, 64, 120)]
    eng = _serve_engine(dec32, 4, chunk=64)
    uids = [eng.submit(p, max_new_tokens=HANDOFF_NEW) for p in prompts]
    for _ in range(3):
        eng.step()
    state = (eng.weights_digest, len(eng._queue),
             {s: r.uid for s, r in eng._active.items()},
             {s: e[0].uid for s, e in eng._prefilling.items()})
    bad = dict(new_params)
    bad["wpe.weight"] = torch.zeros(tuple(bad["wpe.weight"].shape[:1])
                                    + (bad["wpe.weight"].shape[1] + 1,))
    try:
        eng.swap_weights(bad)
        refused = "accepted"
    except ValueError as e:
        refused = str(e)
    kept = state == (eng.weights_digest, len(eng._queue),
                     {s: r.uid for s, r in eng._active.items()},
                     {s: e[0].uid for s, e in eng._prefilling.items()})
    before = {u: list(t) for u, (t, _) in eng.progress().items()}
    inflight = len(eng._active) + len(eng._prefilling)
    registered = len(eng.pool._prefix)
    changed = eng.swap_weights(new_params)
    registry_after = len(eng.pool._prefix)
    out = eng.run()
    cfg32 = dataclasses.replace(GPTConfig.small(),
                                compute_dtype=torch.float32)
    later_ok = []
    for u, p in zip(uids, prompts):
        so_far = before[u]
        rest = reference_generate(cfg32, new_params, p + so_far,
                                  HANDOFF_NEW - len(so_far), device=dev)
        later_ok.append(out[u] == so_far + rest)
    return {"identical": identical,
            "planted_bad_leaf": {"refused": refused,
                                 "engine_unchanged": kept},
            "changed": {"summary": {k: v for k, v in changed.items()
                                    if k != "digest"},
                        "inflight": inflight,
                        "registry_before_after": [registered,
                                                  registry_after],
                        "tokens_so_far": [len(before[u]) for u in uids],
                        "later_tokens_equal_reference": later_ok,
                        "digests_differ": changed["digest"]
                        != same["digest"]}}


def phase_serve_handoff(dev, params, engine_run: dict, smi: str) -> dict:
    """Disaggregated serving of GPT-2 small on the card: (a) fp32 handoff
    between a prefill-only and a decode engine, (b) the bf16 engine mix
    disaggregated and in place against adopted, (c) the streamed handoff,
    (d) prefix migration, (e) weight swaps, (f) the timing line.  Returns
    the mix run's launches."""
    t_phase = time.perf_counter()
    cfg = GPTConfig.small()
    dec32 = GPTDecoder(cfg, params, compute_dtype=torch.float32,
                       cache_dtype=torch.float32, tokens_per_dispatch=8,
                       device=dev)
    dec16 = GPTDecoder(cfg, params, compute_dtype=torch.bfloat16,
                       cache_dtype=torch.bfloat16, tokens_per_dispatch=8,
                       device=dev)
    a = _handoff_fp32(dev, params, dec32)
    mix = _handoff_mix(dec16, engine_run)
    inplace = _in_place_vs_adopted(dec16)
    streamed = _handoff_streamed(dec16)
    prefix = _handoff_prefix(dec16)
    swaps = _handoff_swaps(dev, params, dec16, dec32)
    timing = {"card": smi, **mix.pop("timing")}
    rec = {"phase": "serve_handoff", "nvidia_smi": smi,
           "model": "GPT-2 small, random weights (seed 0), page_len 16, "
                    "chunks of 128 (64 at fp32), K = 8",
           "fp32": a, "mix_bf16": {k: v for k, v in mix.items()
                                   if k != "launches"},
           "mix_launches": {n: c for n, c in mix["launches"].items() if c},
           "in_place_vs_adopted": inplace, "streamed": streamed,
           "prefix": prefix, "swaps": swaps, "timing": timing,
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    emit({"phase": "serve_handoff_timing", **timing})
    check(a["tokens_equal_reference_generate"],
          f"serve_handoff (a): adopted tokens differ from "
          f"reference_generate: {a}")
    check(a["prefix_hits"] == 1 and a["cow_copies"] >= 1
          and a["shared_pages"] == 6
          and a["shared_refs_before_export"] == [2] * 6 + [1]
          and a["anchor_refs_after_detach"] == [1] * 7,
          f"serve_handoff (a): the source's pages: {a}")
    check(a["source_refs_unchanged"] and a["destination_refs_one"]
          and a["pages_bit_for_bit"],
          f"serve_handoff (a): refcounts or pages: {a}")
    check(a["source_windows"] == 0 and a["destination_chunks"] == 0
          and a["launches_exact"],
          f"serve_handoff (a): windows, chunks or launches: {a}")
    check(mix["pages_bit_for_bit"] and mix["source_refs_unchanged"]
          and mix["source_windows"] == 0 and mix["destination_chunks"] == 0
          and mix["hits_on_source"] >= 1,
          f"serve_handoff (b): the mix's handoffs: {rec['mix_bf16']}")
    check(all(mix["launches"][n] > 0 for n in SERVING)
          and all(c == 0 for n, c in mix["launches"].items()
                  if n not in SERVING),
          f"serve_handoff (b): launches {mix['launches']}")
    check(all(inplace["tokens_equal"]),
          f"serve_handoff (b): in place and adopted differ: {inplace}")
    check(all(streamed["staged"]) and all(streamed["pages_bit_for_bit"])
          and streamed["tokens_equal_whole_handoff"]
          and len(streamed["chunks"]) == STREAM_PROMPT // STREAM_CHUNK,
          f"serve_handoff (c): {streamed}")
    check("CRC" in streamed["planted_flipped_byte"]
          and streamed["first_chunk_ok"]
          and streamed["abort_in_use"][0] == streamed["abort_in_use"][2]
          < streamed["abort_in_use"][1]
          and streamed["planted_out_of_order_refused"],
          f"serve_handoff (c): a planted fault passed: {streamed}")
    check(prefix["pages_bit_for_bit"] and prefix["hits"] == 1
          and prefix["hit_tokens"] == 256
          and prefix["tokens_equal_whole_prefill"]
          and prefix["free_pages"][0] == prefix["free_pages"][2]
          == prefix["free_pages"][1] + prefix["pages"]
          and prefix["registered_again_refused"],
          f"serve_handoff (d): {prefix}")
    ident, bad, ch = swaps["identical"], swaps["planted_bad_leaf"], \
        swaps["changed"]
    check(ident["summary"]["identical"]
          and ident["summary"]["recomputed"] == 0
          and ident["tokens_equal_unswapped"]
          and ident["builds_or_loads"] == [],
          f"serve_handoff (e): the identical swap: {ident}")
    check("geometry change" in bad["refused"] and bad["engine_unchanged"],
          f"serve_handoff (e): a wrong-shape leaf: {bad}")
    check(not ch["summary"]["identical"]
          and ch["summary"]["recomputed"] == ch["inflight"] >= 1
          and ch["registry_before_after"][0] >= 1
          and ch["registry_before_after"][1] == 0
          and all(ch["later_tokens_equal_reference"])
          and ch["digests_differ"],
          f"serve_handoff (e): the changed swap: {ch}")
    return mix["launches"]


class _Tee:
    """stdout that also writes to a log file."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text: str) -> int:
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self) -> None:
        for st in self.streams:
            st.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", help="also write every output line to this "
                    "file (the output can be longer than a terminal keeps)")
    ap.add_argument("--gloo-worker", metavar="DIR",
                    help=argparse.SUPPRESS)  # a rank of ddp_gloo_card
    ap.add_argument("--sp-worker", metavar="DIR",
                    help=argparse.SUPPRESS)  # a rank of the scale-out gangs
    ap.add_argument("--input-worker", metavar="DIR",
                    help=argparse.SUPPRESS)  # the input-pipeline phases
    args = ap.parse_args(argv)
    if args.gloo_worker is not None:
        return gloo_worker(args.gloo_worker)
    if args.sp_worker is not None:
        return sp_worker(args.sp_worker)
    if args.input_worker is not None:
        return input_worker(args.input_worker)
    if args.log is None:
        return _run()
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    stdout = sys.stdout
    with open(args.log, "w") as fh:
        sys.stdout = _Tee(stdout, fh)
        try:
            return _run()
        finally:
            sys.stdout = stdout


def _run() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    fp32_precision()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    built = _build.build()
    ptxas = {name: ptxas_by_function(_build.build_log(name))
             for name in _build.KERNEL_SOURCES}
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": built, "build_wall_s": time.perf_counter() - t0,
          "ptxas": ptxas})

    ln_cases = phase_layer_norm(dev)
    pa_cases = phase_paged_attention(dev)

    params = init_params(GPTConfig.small(), torch.Generator().manual_seed(0))
    phase_parity(params)
    launches, dec, engine_run = phase_engine(dev, params)
    plain_profile = phase_profile(dec)
    del dec
    torch.cuda.empty_cache()
    prompts, plain, ref, chain_stats = phase_spec_parity(dev, params)
    phase_spec_tree_parity(dev, params, prompts, plain, ref, chain_stats)
    spec_launches = phase_spec_engine(dev, params)
    tree_launches = phase_spec_tree_engine(dev, params)
    phase_spec_profile(dev, params, plain_profile)

    lnb_cases = phase_layer_norm_bwd(dev)
    fl_cases = phase_flash(dev)
    phase_flash_shapes(dev)
    xe_cases = phase_xent(dev)
    phase_train_parity(params)
    train_launches, step, carry, o2_tokens_per_s = phase_train(dev, params)
    phase_step_profile(step, carry, "train_profile", "one O2 step, GPT-2 "
                       "small, batch 16 x 1024, dropout 0.1")
    del step, carry, params
    torch.cuda.empty_cache()

    fb_cases = phase_flash_bias(dev)
    lamb_case = phase_lamb(dev)
    bert_params = init_bert_params(BertConfig.large(),
                                   torch.Generator().manual_seed(20))
    phase_bert_parity(bert_params)
    bert_launches, step, carry, bert_rec = phase_bert_train(dev, bert_params)
    phase_step_profile(step, carry, "bert_profile", "one O2 step, BERT-large "
                       "MLM, batch 12 x 512 padded, dropout 0.1, fused_lamb")
    del step, carry
    torch.cuda.empty_cache()
    asp_launches = phase_asp(dev, bert_params, bert_rec)
    del bert_params
    torch.cuda.empty_cache()

    phase_conv_bn_tile_check(dev)
    cb_tc_info = phase_conv_bn_tc_info()
    conv_path, cb_cases = phase_conv_bn(dev)
    xe_rn = phase_xent_rn50(dev)
    with torch.device("meta"):
        rn_shapes = resnet50()
    rn_params, rn_stats = init_resnet_params(
        rn_shapes, torch.Generator().manual_seed(24))
    phase_resnet_parity(rn_params, rn_stats)
    rn_launches, step, carry, rn_first = phase_resnet_train(dev, rn_params,
                                                            rn_stats)
    rn_rate = rn_first["images_per_s"]
    phase_step_profile(step, carry, "rn50_profile", "one O2 step, ResNet-50, "
                       "batch 128 x 224^2, fused_sgd")
    del step, carry
    torch.cuda.empty_cache()
    ddp_launches = phase_ddp_resnet(dev, rn_params, rn_stats, rn_first)
    del rn_first, rn_params, rn_stats
    torch.cuda.empty_cache()
    phase_ddp_gloo_card(dev)
    t_in = time.perf_counter()
    in_launches = phase_input_pipeline(rn_rate, smi)
    emit({"phase": "input_pipeline_time",
          "seconds": time.perf_counter() - t_in,
          "phases": ["data_loader", "imagenet_example"]})

    acc_cases = phase_flash_acc(dev)
    pb_cases = phase_flash_probs_bf16(dev)
    phase_dropout_heads(dev)
    d128_cases = phase_flash_d128(dev)
    md_cases = phase_medium_kernels(dev)
    md_params = init_params(GPTConfig.medium(),
                            torch.Generator().manual_seed(30))
    phase_medium_parity(md_params, dev)
    md_launches, step, carry, md_model = phase_medium_train(dev, md_params)
    phase_remat_memory(dev, md_model)
    phase_step_profile(step, carry, "medium_profile", "one O2 step of GPT-2 "
                       "medium, 4 microbatches of 8 x 1024, full_block, "
                       "probs_bf16, dq_acc, fused_adam")
    del step, carry, md_model, md_params
    torch.cuda.empty_cache()

    params = init_params(GPTConfig.small(), torch.Generator().manual_seed(0))
    bert_params = init_bert_params(BertConfig.large(),
                                   torch.Generator().manual_seed(20))
    phase_o1_parity(params, bert_params)
    del bert_params
    o1_launches = phase_o1_train(dev, params, o2_tokens_per_s)
    torch.cuda.empty_cache()
    phase_checkpoint_resume(dev, params)
    stash = phase_stash(dev, params)
    na_launches = phase_novograd_adagrad(dev, params)
    del params
    torch.cuda.empty_cache()
    ed_launches, ed_cases = phase_encdec_attn(dev)
    untied_launches = phase_bert_untied(dev)
    phase_dcgan(dev)
    xm_launches = phase_library_modules(dev)
    phase_rnn(dev)
    torch.cuda.empty_cache()
    t_sp = time.perf_counter()
    phase_sp_world1(dev)
    lc_path = phase_long_context_gang(dev)
    tp_path = phase_tp_pipeline_gang(dev)
    emit({"phase": "scale_out_time", "seconds": time.perf_counter() - t_sp,
          "phases": ["sp_world1", "long_context_gang", "tp_pipeline_gang"]})
    torch.cuda.empty_cache()
    t_so2 = time.perf_counter()
    phase_scale_out2_world1(dev)
    tps_path = phase_scale_out2_gangs(dev)
    emit({"phase": "scale_out2_time",
          "seconds": time.perf_counter() - t_so2,
          "phases": ["scale_out2_world1", "tp_serve_gang",
                     "moe_compress_gang"]})
    torch.cuda.empty_cache()
    t_obs = time.perf_counter()
    params = init_params(GPTConfig.small(), torch.Generator().manual_seed(0))
    obs_serve_launches = phase_obs_serve(dev, params, smi)
    torch.cuda.empty_cache()
    obs_train_launches = phase_obs_train(dev, params)
    torch.cuda.empty_cache()
    emit({"phase": "obs_time", "seconds": time.perf_counter() - t_obs,
          "phases": ["obs_serve", "obs_train"]})
    t_ho = time.perf_counter()
    handoff_launches = phase_serve_handoff(dev, params, engine_run, smi)
    del params, engine_run
    torch.cuda.empty_cache()
    emit({"phase": "serve_handoff_time",
          "seconds": time.perf_counter() - t_ho})

    # the summary rows: the serving kernels at the engine's decode-step
    # shape with the engine run's launches, the GPT training kernels at
    # the O2 training shapes with one GPT training window's launches, the
    # BERT kernels at BERT-large's shapes with one BERT window's launches
    # (the flash wrappers count their launches with and without a bias
    # alike: each window's count is of its own path)
    ln = next(c for c in ln_cases if c["rows"] == 8 and c["dtype"] == "float32")
    pa = next(c for c in pa_cases if c["case"] == "T=1 pool=bfloat16 "
              "masked=False")
    lnb = next(c for c in lnb_cases if c["rows"] == 16384
               and c["x_dtype"] == "float32" and c["w_dtype"] == "bfloat16")
    fl_f, fl_b = next(c for c in fl_cases
                      if c[0]["case"] == "bfloat16 dropout=0.1")
    xe_f, xe_b = next(c for c in xe_cases
                      if c[0]["case"] == "rows=16384 V=50304 bfloat16 "
                      "smoothing=0.0")
    windows = {"serve": (launches, "ServeEngine run, GPT-2 small"),
               "gpt": (train_launches, "one O2 training window, GPT-2 "
                       "small"),
               "bert": (bert_launches, "one O2 training window, BERT-large "
                        "MLM"),
               "conv_bn": (conv_path, "the conv_bn entry points once at each "
                           "of RN50's eight 1x1 shapes, batch 128"),
               "medium": (md_launches, "one O2 training window of GPT-2 "
                          "medium, K = 2 steps of 4 microbatches")}
    rows = []
    for name, counter, src, tpu, c, window in (
            ("layer_norm", "layer_norm", "apex_tpu_torch/csrc/layer_norm.cu",
             "apex_tpu/ops/layer_norm.py:133", ln, "serve"),
            ("paged_fused_attention", "paged_fused_attention",
             "apex_tpu_torch/csrc/paged_attention.cu",
             "apex_tpu/ops/attention.py:415", pa, "serve"),
            ("layer_norm_bwd", "layer_norm_bwd",
             "apex_tpu_torch/csrc/layer_norm.cu",
             "apex_tpu/ops/layer_norm.py:169", lnb, "gpt"),
            ("flash_attention_fwd", "flash_attention_fwd",
             "apex_tpu_torch/csrc/flash_attention.cu",
             "apex_tpu/ops/attention.py:1027", fl_f, "gpt"),
            ("flash_attention_bwd", "flash_attention_bwd",
             "apex_tpu_torch/csrc/flash_attention.cu",
             "apex_tpu/ops/attention.py:868", fl_b, "gpt"),
            ("softmax_xentropy_fwd", "softmax_xentropy_fwd",
             "apex_tpu_torch/csrc/softmax_xentropy.cu",
             "apex_tpu/ops/softmax_xentropy.py:79", xe_f, "gpt"),
            ("softmax_xentropy_bwd", "softmax_xentropy_bwd",
             "apex_tpu_torch/csrc/softmax_xentropy.cu",
             "apex_tpu/ops/softmax_xentropy.py:139", xe_b, "gpt"),
            ("flash_attention_fwd_bias", "flash_attention_fwd",
             "apex_tpu_torch/csrc/flash_attention.cu",
             "apex_tpu/ops/attention.py:638", fb_cases["bert"][0], "bert"),
            ("flash_attention_bwd_bias", "flash_attention_bwd",
             "apex_tpu_torch/csrc/flash_attention.cu",
             "apex_tpu/ops/attention.py:859", fb_cases["bert"][1], "bert"),
            ("lamb_stage1", "lamb_stage1", "apex_tpu_torch/csrc/fused_lamb.cu",
             "apex_tpu/ops/fused_optim.py:50", lamb_case, "bert"),
            ("matmul_stats", "matmul_stats", "apex_tpu_torch/csrc/conv_bn.cu",
             "apex_tpu/ops/conv_bn.py:85", cb_cases[0]["matmul_stats"],
             "conv_bn"),
            ("bn_relu_matmul", "bn_relu_matmul",
             "apex_tpu_torch/csrc/conv_bn.cu", "apex_tpu/ops/conv_bn.py:122",
             cb_cases[0]["bn_relu_matmul"], "conv_bn"),
            ("matmul_bwd_dual", "matmul_bwd_dual",
             "apex_tpu_torch/csrc/conv_bn.cu", "apex_tpu/ops/conv_bn.py:402",
             cb_cases[0]["matmul_bwd_dual"], "conv_bn"),
            ("flash_attention_bwd_acc", "flash_attention_bwd_acc",
             "apex_tpu_torch/csrc/flash_attention.cu",
             "apex_tpu/ops/attention.py:885", acc_cases["GPT-2 medium"],
             "medium")):
        counts, what = windows[window]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": counts[counter],
                     "launches_of": f"{counter}, {what}",
                     "max_abs_err": c["max_abs_err"], "tol": c["tol"],
                     "ms": c["ms"], "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"],
                     "case": _case_name(c)})
    by_name = {r["name"]: r for r in rows}

    def other_path(name, counts, c):
        return {"launches": counts[name], "case": _case_name(c),
                **{k: c[k] for k in ("design", "max_abs_err", "tol", "ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms") if k in c}}

    # LayerNorm forward is on all three paths, its backward and the
    # cross-entropy on both training paths: their rows also carry the
    # other paths' cases at those paths' shapes, with their launches
    by_name["layer_norm"]["train_path"] = other_path(
        "layer_norm", train_launches,
        next(c for c in ln_cases if c["rows"] == 16384
             and c["w_dtype"] == "bfloat16"))
    bert_cases = {
        "layer_norm": next(c for c in ln_cases if c["n"] == 1024
                           and c["w_dtype"] == "bfloat16"),
        "layer_norm_bwd": next(c for c in lnb_cases if c["n"] == 1024
                               and c["w_dtype"] == "bfloat16"),
        "softmax_xentropy_fwd": xe_cases[-1][0],
        "softmax_xentropy_bwd": xe_cases[-1][1]}
    for name, c in bert_cases.items():
        by_name[name]["bert_path"] = other_path(name, bert_launches, c)
    # the cross-entropy is also on the RN50 path, at (128, 1000) fp32
    for name, c in zip(("softmax_xentropy_fwd", "softmax_xentropy_bwd"),
                       xe_rn[0]):
        by_name[name]["rn50_path"] = other_path(name, rn_launches, c)
        by_name[name]["ddp_path"] = {
            "launches_of": f"{name}, one O2 training window of ResNet-50 "
                           "with DDP + SyncBN, NCCL at world 1 (ddp_resnet)",
            **other_path(name, ddp_launches, c)}
    # and on the ImageNet example's paths: its O2 run from the record
    # file at (128, 1000) fp32, and its defaults (O1, -b 64: bf16 logits)
    for name, c, c_o1 in zip(("softmax_xentropy_fwd", "softmax_xentropy_bwd"),
                             *xe_rn):
        by_name[name]["imagenet_path"] = {
            "launches_of": f"{name}, the ImageNet example's O2 run of 4 "
                           "windows of K = 10 at 128 x 224^2 from the record "
                           "file (imagenet_example (a))",
            **other_path(name, in_launches["a"], c)}
        by_name[name]["imagenet_o1_path"] = {
            "launches_of": f"{name}, the first window of the ImageNet "
                           "example at its defaults: O1, -b 64, K = 10, "
                           "synthetic (imagenet_example (c))",
            **other_path(name, in_launches["c"], c_o1)}
    # the paged row holds the decode step's case; every case beside it
    by_name["paged_fused_attention"]["cases"] = [
        {k: c[k] for k in ("case", "design", "max_abs_err", "ms", "plain_ms",
                           "library_ms", "bound_ms", "bound_by")}
        for c in pa_cases]
    by_name["layer_norm_bwd"]["design"] = lnb["design"]
    by_name["layer_norm"]["design"] = ln["design"]
    # the conv_bn rows hold their first RN50 shape; every case beside it
    for name in CONV_BN_KERNELS:
        by_name[name]["design"] = cb_cases[0][name]["design"]
        by_name[name]["shapes"] = [
            {k: c[name][k] for k in ("case", "design", "tc_kernel",
                                     "max_abs_err", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by")}
            for c in cb_cases]
        by_name[name]["tc_info"] = {
            k: v for k, v in cb_tc_info.items()
            if k.startswith("dual") == (name == "matmul_bwd_dual")
            and k.endswith(", bn>") == (name == "bn_relu_matmul")}
    # the bias backward also stands for the two-pass backward of
    # bias_grad=True (its dbias checked in phase_flash_bias)
    by_name["flash_attention_bwd_bias"]["also_replaces"] = [
        "apex_tpu/ops/attention.py:850", "apex_tpu/ops/attention.py:893",
        "apex_tpu/ops/attention.py:1045"]
    by_name["flash_attention_bwd_bias"]["dbias_check"] = fb_cases["dbias"]
    # GPT-2 medium: the forward with probs_bf16 and the LayerNorm and
    # cross-entropy kernels at its shapes, with its window's launches; the
    # acc backward's other cases and its probs_bf16 record; the partials
    # backward with probs_bf16 (on no path: the medium path takes the acc
    # backward)
    by_name["flash_attention_fwd"]["medium_path"] = other_path(
        "flash_attention_fwd", md_launches, pb_cases["GPT-2 medium"][0])
    for name, c in md_cases.items():
        by_name[name]["medium_path"] = other_path(name, md_launches, c)
    by_name["flash_attention_bwd"]["probs_bf16_case"] = {
        "launches": 0, "case": pb_cases["GPT-2 medium"][1]["case"],
        **{k: pb_cases["GPT-2 medium"][1][k]
           for k in ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms")}}
    acc_row = by_name["flash_attention_bwd_acc"]
    acc_row["also_replaces"] = ["apex_tpu/ops/attention.py:876"]
    acc_row["other_cases"] = [
        {k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms",
                           "library_ms", "bound_ms", "bound_by",
                           "partials_ms", "peak_bytes_acc",
                           "peak_bytes_partials") if k in c}
        for n, c in acc_cases.items() if n != "GPT-2 medium"]
    acc_row["partials_ms"] = acc_cases["GPT-2 medium"]["partials_ms"]
    acc_row["peak_bytes_acc_partials"] = [
        acc_cases["GPT-2 medium"]["peak_bytes_acc"],
        acc_cases["GPT-2 medium"]["peak_bytes_partials"]]
    # the flash rows: which design ran (their cases are bf16: the tensor
    # cores), the shared memory and blocks per SM of the instantiation
    # each row's case launched (GPT-2 medium's takes probs_bf16), and the
    # head_dim-128 instantiation's timed cases, each with its own
    # instantiation's records (on no ported model's path: no configuration
    # has head_dim 128, so no main-path window counts their launches)
    tc_info = d128_cases["tc_info"]
    pb = "_probs_bf16"
    for name, kind, rec_key, probs in (
            ("flash_attention_fwd", "fwd", "fwd", False),
            ("flash_attention_fwd_bias", "fwd", "fwd", False),
            ("flash_attention_bwd", "bwd_partials", "bwd", False),
            ("flash_attention_bwd_bias", "bwd_partials", "bwd", False),
            ("flash_attention_bwd_acc", "bwd_acc", "bwd_acc", True)):
        row = by_name[name]
        row["design"] = FLASH_DESIGN[torch.bfloat16]
        row["tc_info_d64"] = tc_info["d64"][kind + (pb if probs else "")]
        row["head_dim_128"] = {
            "on_main_path": False,
            "cases": [{"case": c["case"],
                       "tc_info": tc_info["d128"][
                           kind + (pb if c["probs_bf16"] else "")],
                       **{k: c[rec_key][k]
                          for k in ("max_abs_err", "ms", "plain_ms",
                                    "library_ms", "bound_ms", "bound_by")}}
                      for n, c in d128_cases.items()
                      if n != "tc_info" and rec_key in c]}
    by_name["flash_attention_fwd"]["medium_path"]["tc_info_d64"] = \
        tc_info["d64"]["fwd" + pb]
    # the speculative serving path: the n-gram spec engine's runs of the
    # engine mix at D = 3 and 7, each with its own launches, beside the
    # verify block's cases (8 slots x (1 + D) positions, no mask)
    spec_cases = {
        "layer_norm": {3: next(c for c in ln_cases if c["rows"] == 32),
                       7: next(c for c in ln_cases if c["rows"] == 64)},
        "paged_fused_attention": {
            3: next(c for c in pa_cases
                    if c["case"] == "T=4 pool=bfloat16 masked=False"),
            7: next(c for c in pa_cases
                    if c["case"] == "T=8 pool=bfloat16 masked=False")}}
    for name, by_draft in spec_cases.items():
        for draft, c in by_draft.items():
            by_name[name][f"spec_path_d{draft}"] = {
                "launches_of": f"{name}, ServeEngine run, GPT-2 small, "
                f"n-gram speculation at D = {draft}",
                **other_path(name, spec_launches[draft], c)}
    # the tree path: the tree engines' runs of the engine mix at (W, D) =
    # (2, 3) and (3, 3), beside the tree block's cases (8 slots x (1 + W
    # D) nodes under the branch mask)
    tree_cases = {
        "layer_norm": {"w2d3": next(c for c in ln_cases if c["rows"] == 56),
                       "w3d3": next(c for c in ln_cases if c["rows"] == 80)},
        "paged_fused_attention": {
            "w2d3": next(c for c in pa_cases
                         if c["case"] == "T=7 pool=bfloat16 tree=W2xD3"),
            "w3d3": next(c for c in pa_cases
                         if c["case"] == "T=10 pool=bfloat16 tree=W3xD3")}}
    for name, by_tree in tree_cases.items():
        for tree, c in by_tree.items():
            by_name[name][f"spec_tree_path_{tree}"] = {
                "launches_of": f"{name}, ServeEngine run, GPT-2 small, "
                f"tree speculation {tree}",
                **other_path(name, tree_launches[f"tree_{tree}"], c)}
    # AMP O1 training: the GPT kernels at fp32 LayerNorm rows and logits
    # and bf16 q, k, v, with one O1 window's launches; the stash route's
    # LAMB stage 1 (g_scale 1/clip alone), with one stash step's launches
    for name in ("layer_norm", "layer_norm_bwd", "flash_attention_fwd",
                 "flash_attention_bwd", "softmax_xentropy_fwd",
                 "softmax_xentropy_bwd"):
        by_name[name]["o1_path"] = {
            "launches": o1_launches[name],
            "launches_of": f"{name}, one O1 training window of GPT-2 small, "
                           "K = 4 steps of 8 x 1024 (o1_train)"}
    lamb_stash = stash["fused_lamb"]
    by_name["lamb_stage1"]["stash_path"] = {
        "launches": lamb_stash["launches_one_step"]["lamb_stage1"],
        "launches_of": "lamb_stage1, one stash-route step of GPT-2 small "
                       "O2 (accumulate, then step), fused_lamb",
        "checks": lamb_stash["lamb_stage1_checks"],
        "tol": lamb_stash["lamb_tol"]}
    # the rest of the library: each path's launches, counted around that
    # path alone (the flash wrappers count with and without a bias alike)
    paths = {
        "encdec_path": ({n: sum(ed_launches[c].get(n, 0) for c in ed_launches)
                         for n in ed_launches["plain"]},
                        "EncdecMultiheadAttn at Transformer-big, one forward "
                        "and backward without and one with include_norm_add "
                        "(encdec_attn)"),
        "bert_untied_path": (untied_launches, "one O2 training window of "
                             "BERT-large MLM with the untied head, K = 2 "
                             "(bert_untied_train)"),
        "novograd_path": (na_launches["fused_novograd"], "one O2 training "
                          "window of GPT-2 small, fused_novograd, K = 4"),
        "adagrad_path": (na_launches["fused_adagrad"], "one O2 training "
                         "window of GPT-2 small, fused_adagrad, K = 4"),
        "xentropy_module_path": (xm_launches, "SoftmaxCrossEntropyLoss at "
                                 "(16384, 50304) bf16, one forward and "
                                 "backward (library_modules)"),
        "asp_path": (asp_launches, "one O2 training window of BERT-large "
                     "MLM pruned 2:4 by ASP, sparsify(fused_lamb), K = 6 "
                     "(asp_train)")}
    on_paths = {
        "layer_norm": ("encdec_path", "bert_untied_path", "novograd_path",
                       "adagrad_path", "asp_path"),
        "layer_norm_bwd": ("encdec_path", "bert_untied_path",
                           "novograd_path", "adagrad_path", "asp_path"),
        "flash_attention_fwd": ("novograd_path", "adagrad_path"),
        "flash_attention_bwd": ("novograd_path", "adagrad_path"),
        "flash_attention_fwd_bias": ("encdec_path", "bert_untied_path",
                                     "asp_path"),
        "flash_attention_bwd_bias": ("encdec_path", "bert_untied_path",
                                     "asp_path"),
        "softmax_xentropy_fwd": ("bert_untied_path", "novograd_path",
                                 "adagrad_path", "xentropy_module_path",
                                 "asp_path"),
        "softmax_xentropy_bwd": ("bert_untied_path", "novograd_path",
                                 "adagrad_path", "xentropy_module_path",
                                 "asp_path"),
        "lamb_stage1": ("bert_untied_path", "asp_path")}
    counter_of = {r["name"]: r["launches_of"].split(",")[0] for r in rows}
    for name, names in on_paths.items():
        for p in names:
            counts, what = paths[p]
            by_name[name][p] = {"launches": counts[counter_of[name]],
                                "launches_of": f"{counter_of[name]}, {what}"}
    # scale-out: rank 0's launches in the gangs' steps, beside every rank's
    for key, path, what in (
            ("long_context_path", lc_path, "two O2 steps of "
             "examples/gpt_long_context, 12 GPTLayers at GPT-2 small's "
             "width, ring attention over seq 2, S 4096, M = 2, "
             "dots_saveable, ZeRO over data 2 (long_context_gang)"),
            ("tp_path", tp_path, "two O2 steps of "
             "examples/transformer_parallel, 12 blocks at GPT-2 small's "
             "width as 2 pipeline stages x 2 tensor-parallel shards, "
             "S 1024, M = 4 (tp_pipeline_gang)")):
        for name in ("layer_norm", "layer_norm_bwd", "flash_attention_fwd",
                     "flash_attention_bwd"):
            by_name[name][key] = {
                "launches": path["launches"].get(name, 0),
                "launches_by_rank": [c.get(name, 0)
                                     for c in path["launches_by_rank"]],
                "launches_of": f"{name} on rank 0 of 4, {what}"}
    for name in ("layer_norm", "paged_fused_attention"):
        by_name[name]["tp_serve_path"] = {
            "launches": tps_path["launches"].get(name, 0),
            "launches_by_rank": [c.get(name, 0)
                                 for c in tps_path["launches_by_rank"]],
            "launches_of": f"{name} on rank 0 of 4, the engine mix on GPT-2 "
                           f"small over a (model 4) mesh, 3 heads a rank "
                           f"(tp_serve_gang)"}
    # the obs phases: the obs-on virtual-clock run of the plan, and the
    # obs-on training window
    for name in ("layer_norm", "paged_fused_attention"):
        by_name[name]["obs_serve_path"] = {
            "launches": obs_serve_launches[name],
            "launches_of": f"{name}, the obs plan (32 requests) through "
                           "the engine phase's configuration on the "
                           "virtual clock, obs on (obs_serve)"}
    # the disaggregated run of the engine mix: both engines' launches
    for name in ("layer_norm", "paged_fused_attention"):
        by_name[name]["serve_handoff_path"] = {
            "launches": handoff_launches[name],
            "launches_of": f"{name}, the engine mix disaggregated: a "
                           "prefill-only engine and a decode engine, 8 "
                           "slots each, every request handed off through "
                           "bytes (serve_handoff)"}
    for name in ("layer_norm", "layer_norm_bwd", "flash_attention_fwd",
                 "flash_attention_bwd", "softmax_xentropy_fwd",
                 "softmax_xentropy_bwd"):
        by_name[name]["obs_train_path"] = {
            "launches": obs_train_launches[name],
            "launches_of": f"{name}, one O2 training window of GPT-2 small, "
                           "K = 4 steps of 8 x 1024, obs on (obs_train)"}
    for kind in ("fwd", "bwd"):
        by_name[f"flash_attention_{kind}_bias"]["encdec_path"].update(
            {k: ed_cases[kind][k] for k in (
                "case", "max_abs_err", "tol", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by")})
    check(all(r["launches"] > 0 for r in rows)
          and all(r[p]["launches"] > 0 for r in rows
                  for p in ("train_path", "bert_path", "rn50_path",
                            "ddp_path", "medium_path", "spec_path_d3", "spec_path_d7",
                            "spec_tree_path_w2d3", "spec_tree_path_w3d3",
                            "o1_path", "stash_path", "long_context_path",
                            "tp_path", "tp_serve_path", "obs_serve_path",
                            "obs_train_path", "serve_handoff_path", *paths)
                  if p in r),
          f"a kernel never launched on its path: {rows}")
    check(all(by_name[n][p]["launches"] > 0
              for n in ("softmax_xentropy_fwd", "softmax_xentropy_bwd")
              for p in ("imagenet_path", "imagenet_o1_path")),
          "a kernel never launched on the ImageNet example's paths")
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
