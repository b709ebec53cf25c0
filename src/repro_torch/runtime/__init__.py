"""Runtime of the port (reference: `repro/runtime/`).

  serve_session  ServeSession: prefill -> decode with the cache handoff

The trainer and its health checks wait for ROADMAP Queue 1 item 6c.
"""
from repro_torch.runtime.serve_session import ServeSession, \
    convert_prefill_caches

__all__ = ["ServeSession", "convert_prefill_caches"]
