"""Serving stack of the port: paged KV cache and prefix index, engine, stats."""
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.errors import InvalidRequest, PoolExhausted, SlotExhausted
from repro_torch.serving.kv_cache import (
    BlockAllocator, PrefixIndex, build_mixed_batch, init_paged_state, paged_cache_bytes,
)
from repro_torch.serving.ttft import RequestTiming, ServeStats

__all__ = ["Engine", "Request", "InvalidRequest", "PoolExhausted", "SlotExhausted",
           "BlockAllocator", "PrefixIndex", "build_mixed_batch", "init_paged_state",
           "paged_cache_bytes", "RequestTiming", "ServeStats"]
