"""repro_torch.core — the ACCL+ collective engine, ranks stacked on one
device.

Public API:
    CollectiveEngine     the CCLO: MPI-like + streaming collectives
    execute_program      the one data plane: runs a compiled micro-op Program
    Selector             runtime-tunable algorithm/protocol selection
    Communicator         rank group over a mesh axis
    Schedule/Step/Sel    microcode IR (compiles to a Program)
    Program              the micro-op IR (core/program.py)
    Sequencer/Request    the collective offload queue (engine.issue(...))
    PricingEnv           the one bundle of pricing parameters (env=)
    MeshMakespan         contention-aware composition of many queues
    FabricOccupancy      per-chip physical-link capacity map
    FaultPlan/ReliabilityTier  fabric fault model + protocol tiers
    register_collective  out-of-tree collectives, no engine changes needed
    Tracer/MetricsRegistry  unified telemetry (core/telemetry.py):
                         virtual-clock traces + the stats registry
    WallTracer/WALL      wall-clock spans and counters, recorded while a
                         torch profiler session is active
"""
from repro_torch.core.engine import CollectiveEngine, execute_program
from repro_torch.core.faults import (
    FaultPlan, FaultyTransport, PeerFailedError, ReliabilityTier, TIERS,
    TransportError, TransportTimeout,
)
from repro_torch.core.mesh_cost import MeshMakespan
from repro_torch.core.pricing import PricingEnv, resolve_env
from repro_torch.core.program import Program, compile_schedule
from repro_torch.core.plugins import register_collective, \
    unregister_collective
from repro_torch.core.selector import Selector, Choice
from repro_torch.core.sequencer import Request, RequestCancelled, Sequencer
from repro_torch.core.topology import Communicator, FabricOccupancy, axis_comm
from repro_torch.core.schedule import Schedule, Step, Sel
from repro_torch.core.hw_spec import HwSpec, TPU_V5E, ACCL_CLUSTER
from repro_torch.core.telemetry import NULL, WALL, MetricsRegistry, \
    NullTracer, StatsView, Tracer, WallTracer
from repro_torch.core import algorithms, faults, hierarchical, mesh_cost, \
    plugins, pricing, program, sequencer, simulator, telemetry, verify

__all__ = [
    "CollectiveEngine", "execute_program", "Program", "compile_schedule",
    "register_collective", "unregister_collective", "Selector", "Choice",
    "Request", "RequestCancelled", "Sequencer",
    "PricingEnv", "resolve_env", "MeshMakespan", "FabricOccupancy",
    "FaultPlan", "FaultyTransport", "ReliabilityTier", "TIERS",
    "TransportError", "TransportTimeout", "PeerFailedError",
    "Communicator", "axis_comm", "Schedule", "Step", "Sel",
    "HwSpec", "TPU_V5E", "ACCL_CLUSTER",
    "Tracer", "NullTracer", "WallTracer", "NULL", "WALL", "MetricsRegistry",
    "StatsView", "algorithms", "faults", "hierarchical", "mesh_cost", "plugins",
    "pricing", "program", "sequencer", "simulator", "telemetry", "verify",
]
