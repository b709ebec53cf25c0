from repro_torch.parallel.ops import ParCtx, local_matmul

__all__ = ["ParCtx", "local_matmul"]
