"""repro_torch — the ACCL+ collective engine ported to PyTorch and CUDA.

A second package beside the JAX reference `repro`, mirroring its layout
module for module. All ranks of a communicator are stacked on one device
(`core/engine.py`); the streaming plugins run hand-written Hopper kernels
(`kernels/`) on the card and their plain PyTorch versions on the CPU.
Imports torch, never jax, and nothing from `repro`.
"""
