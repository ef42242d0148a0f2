"""apex_tpu_torch — the PyTorch/CUDA port of apex_tpu, for NVIDIA Hopper.

The JAX package ``apex_tpu`` stays the reference; this package is held
against it slice by slice.  The first slice is paged serving of a
GPT-2-style LM: the model's serving forward, the page pool, the
decoder's paged programs and the continuous-batching engine.  The second
is O2 training of the same LM: the training forward and loss, the
``amp`` policies, loss scaler and ``AmpOptimizer``, ``fused_adam`` and
the K-step ``FusedTrainDriver``.  The third is BERT MLM pretraining
under O2 with ``fused_lamb`` on padded batches: ``BertForMLM``, the
contrib ``SelfMultiheadAttn`` and the LAMB stage-1 kernel.  The fourth
is O2 training of ResNet-50 with ``fused_sgd`` (``ResNet``, ``Conv``,
single-process ``SyncBatchNorm``), with the three conv+BN matmul kernels
of ``ops.conv_bn`` as library entry points.  The fifth is O2 training
of GPT-2 medium, larger than one microbatch on one card: gradient
accumulation over microbatches (``train.accum``: ``amp_microbatch_step``,
``MicrobatchedStep``, taken by ``FusedTrainDriver``), activation
rematerialization per block (``remat``: ``none``, ``dots_saveable``,
``full_block``), and the flash kernels' ``probs_bf16`` option and
dq-accumulating backward (``dq_acc``).  Serving also has the
contiguous slot cache (``KVCache``, ``ServeEngine(paged=False)``) and
chain and tree self-speculative decoding (``GPTDecoder(spec_tokens=,
spec_proposer=, spec_tree=)``: n-gram or shallow-exit drafts verified in
one block forward, or W n-gram branches in one masked tree forward) with
a draft-depth auto-tuner (``ServeEngine(spec_autotune=True)``), the
policy's KV-cache dtype (``GPTDecoder(policy=, kv_int8=)``) and an
untied head (``GPTConfig(tie_word_embeddings=False)``), with
``reference_generate`` as the full-recompute oracle.
Training also has AMP O1 (``amp.F`` over the JAX package's cast tables,
``amp.initialize()``'s default), the accumulate/stash path and the
unfused optimizer route (``AmpOptimizer.accumulate``), and checkpoints
(``checkpoint``, ``FusedTrainDriver.save``/``restore``).  Data
parallelism runs across processes over ``torch.distributed``
(``parallel``: ``init_distributed`` and the gang ``launch``,
``DistributedDataParallel`` with one flat all-reduce a dtype,
cross-process ``SyncBatchNorm`` and ``convert_syncbn_model``,
``ResNet(sync_batchnorm=True)``, ``amp_microbatch_step(ddp=)`` with one
all-reduce a boundary, and ``LARC``).  The rest of the library follows:
the encoder-decoder ``EncdecMultiheadAttn``, BERT's token types and
untied head, ``fused_novograd`` and ``fused_adagrad``, ``ConvTranspose``
and the DCGAN ``Generator``/``Discriminator`` with the three-scaler
example (``examples/dcgan.py``), the contrib ``SoftmaxCrossEntropyLoss``
and ``BatchNorm2d_NHWC``, ``mlp.MLP``, ``bf16_utils`` and
``reparameterization``; then the recurrent stacks of ``RNN`` (the LSTM,
GRU, ReLU, Tanh and mLSTM factories, stacked and bidirectional) and 2:4
structured sparsity (``contrib.sparsity``: the mask library, ``ASP`` and
``sparsify``), which complete the library.  The host planes start with
``obs`` (metrics, spans, the request lifecycle, SLO tracking, the flight
recorder and exporters) wired through ``ServeEngine`` (with SLO-aware
admission) and ``FusedTrainDriver``, and the seeded load generator
(``serve.loadgen``); then ``data`` (the native C++ record loader, built
with g++ at first use, ``window_batches`` and the pinned, side-stream
``DevicePrefetcher``) with the ImageNet ResNet-50 example
(``examples/imagenet.py``); then disaggregated serving
(``serve.handoff``: a prefill-only ``ServeEngine`` hands each request's
KV pages to a decode engine, whole or streamed, on JAX's wire), prefix
migration and live weight swaps (``ServeEngine.swap_weights``); then
fault injection and self-healing (``resilience``: seeded fault plans
injected at the engine's and the driver's host boundaries, and the
``ResilientServeEngine`` and ``ResilientTrainDriver`` that retry, roll
back, restart and replay); then the serving fleet (``fleet``: the
per-host preflight, ``FleetHost`` and ``FleetRouter`` with health
checks, host-loss recovery, prefix affinity, prefill/decode roles over
the KV handoff, autoscaling and host rolls).
Every kernel on those paths
(LayerNorm forward and backward, paged attention, flash attention
forward and backward with and without an additive bias and its gradient,
with half-precision probabilities and with dq accumulated in place,
fused cross-entropy forward and backward, LAMB stage 1, the matmul with
a BN-stats epilogue, the BN-prologue matmul and the dual matmul
backward) is
written by hand in CUDA C++ for sm_90a (``csrc/``, built with ``nvcc`` at
first use into ``build/apex_tpu_torch/``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version instead.  This package imports neither JAX nor ``apex_tpu``.
"""
from apex_tpu_torch import obs  # noqa: F401
from apex_tpu_torch.amp import Conv, ConvTranspose, Dense  # noqa: F401
from apex_tpu_torch.mlp import MLP  # noqa: F401
from apex_tpu_torch.models import (  # noqa: F401
    BertConfig,
    BertEncoder,
    BertForMLM,
    Discriminator,
    GPTConfig,
    GPTLM,
    GPTLayer,
    Generator,
    ResNet,
    init_bert_params,
    init_dcgan_params,
    init_params,
    init_resnet_params,
    resnet50,
)
from apex_tpu_torch.normalization import FusedLayerNorm  # noqa: F401
from apex_tpu_torch.ops import launch_counts, reset_launch_counts  # noqa: F401
from apex_tpu_torch.parallel import (  # noqa: F401
    DistributedDataParallel,
    Reducer,
    SyncBatchNorm,
    collective_counts,
    convert_syncbn_model,
    data_parallel_group,
    init_distributed,
    launch,
    replicate,
    reset_collective_counts,
    shard_batch,
)
from apex_tpu_torch.serve import (  # noqa: F401
    GPTDecoder,
    KVCache,
    PagePool,
    PagedKVCache,
    Request,
    SamplingParams,
    ServeEngine,
    init_cache,
    init_paged_cache,
    reference_generate,
    sample_tokens,
)
from apex_tpu_torch.train import (  # noqa: F401
    FusedTrainDriver,
    MicrobatchedStep,
    amp_microbatch_step,
    read_metrics,
)
from apex_tpu_torch.weights import (  # noqa: F401
    from_jax_bert_params,
    from_jax_dcgan_params,
    from_jax_opt_state,
    from_jax_params,
    from_jax_resnet_params,
    from_jax_rnn_params,
    to_jax_bert_params,
)

__version__ = "0.8.0"

__all__ = [
    "BertConfig",
    "BertEncoder",
    "BertForMLM",
    "Conv",
    "ConvTranspose",
    "Dense",
    "Discriminator",
    "DistributedDataParallel",
    "FusedLayerNorm",
    "FusedTrainDriver",
    "GPTConfig",
    "GPTDecoder",
    "GPTLM",
    "GPTLayer",
    "Generator",
    "KVCache",
    "MLP",
    "MicrobatchedStep",
    "PagePool",
    "PagedKVCache",
    "Reducer",
    "Request",
    "ResNet",
    "SamplingParams",
    "ServeEngine",
    "SyncBatchNorm",
    "amp_microbatch_step",
    "collective_counts",
    "convert_syncbn_model",
    "data_parallel_group",
    "from_jax_bert_params",
    "from_jax_dcgan_params",
    "from_jax_opt_state",
    "from_jax_params",
    "from_jax_resnet_params",
    "from_jax_rnn_params",
    "init_bert_params",
    "init_cache",
    "init_dcgan_params",
    "init_distributed",
    "init_paged_cache",
    "init_params",
    "init_resnet_params",
    "launch",
    "launch_counts",
    "obs",
    "read_metrics",
    "reference_generate",
    "replicate",
    "reset_collective_counts",
    "reset_launch_counts",
    "resnet50",
    "sample_tokens",
    "shard_batch",
    "to_jax_bert_params",
]
