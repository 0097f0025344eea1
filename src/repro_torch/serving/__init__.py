"""Serving stack of the port: paged KV cache and prefix index, engine, fault
injection and supervised recovery, stats."""
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.errors import (
    OUTCOME_CANCELLED, OUTCOME_OK, OUTCOME_REJECTED, OUTCOME_TIMED_OUT, TERMINAL_OUTCOMES,
    EngineDead, InvalidRequest, PoolExhausted, ServingError, SlotExhausted, StepStuck,
    WireCorruption,
)
from repro_torch.serving.faults import FAULT_KINDS, Fault, FaultPlan
from repro_torch.serving.kv_cache import (
    BlockAllocator, PrefixIndex, build_mixed_batch, init_paged_state, paged_cache_bytes,
)
from repro_torch.serving.supervisor import RECOVERABLE, EngineSupervisor, RecoveryEvent
from repro_torch.serving.ttft import RequestTiming, ServeStats

__all__ = ["Engine", "Request", "ServingError", "InvalidRequest", "PoolExhausted",
           "SlotExhausted", "EngineDead", "StepStuck", "WireCorruption",
           "OUTCOME_OK", "OUTCOME_REJECTED", "OUTCOME_TIMED_OUT", "OUTCOME_CANCELLED",
           "TERMINAL_OUTCOMES", "Fault", "FaultPlan", "FAULT_KINDS",
           "EngineSupervisor", "RecoveryEvent", "RECOVERABLE",
           "BlockAllocator", "PrefixIndex", "build_mixed_batch", "init_paged_state",
           "paged_cache_bytes", "RequestTiming", "ServeStats"]
