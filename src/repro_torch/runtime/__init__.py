"""Runtime of the port (reference: `repro/runtime/`).

  trainer        Trainer: the fault-tolerant training loop
  health         straggler watchdog, failure injection, heartbeat
  serve_session  ServeSession: prefill -> decode with the cache handoff
"""
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.runtime.health import (
    FailureInjector, RankFailure, SimulatedDeviceFailure, StragglerWatchdog,
)
from repro_torch.runtime.serve_session import ServeSession, \
    convert_prefill_caches

__all__ = ["Trainer", "TrainerConfig", "StragglerWatchdog",
           "FailureInjector", "RankFailure", "SimulatedDeviceFailure",
           "ServeSession", "convert_prefill_caches"]
