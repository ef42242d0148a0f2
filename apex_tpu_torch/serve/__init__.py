"""Paged serving of the port: page pool, decoder, engine."""
from apex_tpu_torch.serve.decode import (  # noqa: F401
    DEFAULT_TOKENS_PER_DISPATCH,
    GPTDecoder,
    SamplingParams,
    sample_tokens,
)
from apex_tpu_torch.serve.engine import Request, ServeEngine  # noqa: F401
from apex_tpu_torch.serve.kv_cache import (  # noqa: F401
    TRASH_PAGE,
    PagedKVCache,
    PagePool,
    SlotAllocator,
    auto_page_len,
    init_paged_cache,
)

__all__ = [
    "DEFAULT_TOKENS_PER_DISPATCH",
    "GPTDecoder",
    "PagePool",
    "PagedKVCache",
    "Request",
    "SamplingParams",
    "ServeEngine",
    "SlotAllocator",
    "TRASH_PAGE",
    "auto_page_len",
    "init_paged_cache",
    "sample_tokens",
]
