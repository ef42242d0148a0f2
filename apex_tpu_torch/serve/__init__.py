"""Serving of the port: contiguous and paged KV caches, the decoder with
chain and tree self-speculative decoding, the continuous-batching engine
with its telemetry and SLO-aware admission, disaggregated prefill and
decode over the serialized KV handoff (whole or streamed), prefix
migration and live weight swaps, tensor-parallel serving over a
head-sharded cache, and the seeded open-loop load harness."""
from apex_tpu_torch.serve.decode import (  # noqa: F401
    DEFAULT_SPEC_HIST,
    DEFAULT_TOKENS_PER_DISPATCH,
    GPTDecoder,
    SamplingParams,
    propose_ngram,
    propose_ngram_tree,
    reference_generate,
    sample_tokens,
)
from apex_tpu_torch.serve.engine import Request, ServeEngine  # noqa: F401
from apex_tpu_torch.serve.handoff import (  # noqa: F401
    CHUNK_SCHEMA,
    HANDOFF_SCHEMA,
    HandoffError,
    KVHandoff,
    KVHandoffChunk,
)
from apex_tpu_torch.serve.loadgen import (  # noqa: F401
    LoadGen,
    LoadReport,
    LoadRequest,
    TrafficPlan,
    VirtualClock,
)
from apex_tpu_torch.serve.sharding import (  # noqa: F401
    cache_pspec,
    paged_cache_pspec,
    serve_mesh,
)
from apex_tpu_torch.serve.kv_cache import (  # noqa: F401
    TRASH_PAGE,
    KVCache,
    PagedKVCache,
    PagePool,
    SlotAllocator,
    auto_page_len,
    cache_bytes_per_slot,
    init_cache,
    init_paged_cache,
)

__all__ = [
    "CHUNK_SCHEMA",
    "DEFAULT_SPEC_HIST",
    "DEFAULT_TOKENS_PER_DISPATCH",
    "GPTDecoder",
    "HANDOFF_SCHEMA",
    "HandoffError",
    "KVCache",
    "KVHandoff",
    "KVHandoffChunk",
    "LoadGen",
    "LoadReport",
    "LoadRequest",
    "PagePool",
    "PagedKVCache",
    "Request",
    "SamplingParams",
    "ServeEngine",
    "SlotAllocator",
    "TRASH_PAGE",
    "TrafficPlan",
    "VirtualClock",
    "auto_page_len",
    "cache_bytes_per_slot",
    "cache_pspec",
    "init_cache",
    "init_paged_cache",
    "paged_cache_pspec",
    "propose_ngram",
    "propose_ngram_tree",
    "reference_generate",
    "sample_tokens",
    "serve_mesh",
]
