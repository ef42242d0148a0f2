"""Tensor-parallel serving: the mesh and the head-sharded cache specs.

Counterpart of ``apex_tpu/serve/sharding.py``.  Serving memory is set by
the KV cache, so sharding the cache's head axis over a ``model`` mesh
axis divides that ceiling, and the attention work with it, while the
scheduler stays as it is.  The qkv and MLP products stay replicated, so
a one-rank checkpoint serves a tensor-parallel mesh with no parameter
surgery, and each layer's only collective is the head reassembly (one
all-reduce a layer, ``models.gpt``; paging adds none, as the page table
indexes the unsharded page axis).

``shard_decode_fn`` has no counterpart: JAX wraps each decode program in
``shard_map``, and the port runs SPMD instead, every rank of the axis
running the same programs on its own head shard
(``GPTDecoder(mesh=serve_mesh(tp))``).  :func:`cache_pspec` and
:func:`paged_cache_pspec` say which cache leaves are sharded, as the
JAX package's do; they derive from
:func:`apex_tpu_torch.sharding.serve_cache_rules`.
"""
from __future__ import annotations

from apex_tpu_torch.serve.kv_cache import KVCache, PagedKVCache
from apex_tpu_torch.sharding.rules import _Leaf

__all__ = ["cache_pspec", "paged_cache_pspec", "serve_mesh"]


def serve_mesh(tp: int, axis_name: str = "model"):
    """A one-axis mesh of ``tp`` ranks over the initialised world (its
    size must be ``tp``)."""
    from apex_tpu_torch.parallel.mesh import make_mesh

    return make_mesh([(axis_name, int(tp))])


def cache_pspec(axis_name: str = "model") -> KVCache:
    """The spec tree of a :class:`KVCache`: K/V sharded on the head axis
    (dim 2 of ``(slots, layers, heads, max_len, head_dim)``), lengths and
    the token counter replicated."""
    from apex_tpu_torch.sharding import serve_cache_rules

    template = KVCache(k=_Leaf(), v=_Leaf(), lengths=_Leaf(),
                       decoded=_Leaf())
    return serve_cache_rules(axis_name).match(template)


def paged_cache_pspec(axis_name: str = "model",
                      quantized: bool = False) -> PagedKVCache:
    """The spec tree of a :class:`PagedKVCache`: the pools sharded on the
    head axis (dim 2 of ``(num_pages, layers, heads, page_len,
    head_dim)``), and with ``quantized`` the int8 pools' per-token scale
    arrays ``(num_pages, layers, heads, page_len)`` sharded alike, so each
    rank quantizes its own head group; lengths and the counter
    replicated."""
    from apex_tpu_torch.sharding import serve_cache_rules

    sc = _Leaf() if quantized else None
    template = PagedKVCache(k=_Leaf(), v=_Leaf(), lengths=_Leaf(),
                            decoded=_Leaf(), k_scale=sc, v_scale=sc)
    return serve_cache_rules(axis_name).match(template)
