"""The backward of every engine collective a training forward reaches.

JAX differentiates the reference's engine for free: inside `shard_map`
`jax.grad` transposes the ppermutes each program is made of. The port's
executor writes into buffers in place and its kernels are loaded through
ctypes (`kernels/_build.py`), so a collective leaves no autograd graph on
the card — and on the CPU autograd would trace straight through the
executor's plain ops. Each collective is therefore ONE
`torch.autograd.Function` here, entered at the `CollectiveEngine` method
(`engine.py`) whenever grad is enabled and an input requires it. Its
forward runs the executor with grad off; its backward issues the ADJOINT
collective through the same engine, so the backward runs K1 on the card
as the forward does, and the CPU and the card take one backward:

  allreduce(add)         <-> allreduce(add)
  allgather              <-> reduce_scatter(add), and the other way round
  alltoall               <-> alltoall (the inverse block permutation)
  allgather_matmul(x, w)     dx = reduce_scatter(dy @ w^T),
                             dw = allgather(x)^T @ dy per rank, the
                             gathered x being the shards the forward's
                             ring brought (no second gather)
  matmul_reduce_scatter(x, w)  G = allgather(dy): dx = G @ w^T, dw = x^T @ G

A two-axis (product) collective's adjoint is the same call over the same
axis tuple: the inner-major flat rank that places a rank's shard in the
forward reads it back in the backward. The adjoints keep the contract of
the reference's `parallel/ops.py`: the backward differentiates the SUM of
the per-rank losses (a TP-replicated loss is pre-scaled by 1/tp by its
caller) and an FSDP gather's adjoint yields the data-summed shard. A max
or min allreduce is only used on gradient-free values (the CE stabiliser,
the greedy head); its Function raises if a gradient reaches it. The
transposed products run in fp32 and are cast to the operand's dtype, as
the reference's `jnp.dot` transposes are. The adjoints' summation order
is the engine's forward program for the adjoint collective, not the
transpose of the forward's ring (ROADMAP Queue 3).
"""
from __future__ import annotations

import torch


def needed(*xs) -> bool:
    """True when a collective on `xs` must record its adjoint."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _mm_t(a, b, dtype, ta: bool = False, tb: bool = False):
    """fp32 product of stacked operands (transposing the last two dims of
    `a` / `b` as asked), cast to `dtype`."""
    a = a.float().transpose(-1, -2) if ta else a.float()
    b = b.float().transpose(-1, -2) if tb else b.float()
    return torch.matmul(a, b).to(dtype)


class AllReduce(torch.autograd.Function):
    """allreduce(x, axis, op); adjoint allreduce(add)."""

    @staticmethod
    def forward(ctx, engine, x, axis, op, kw):
        ctx.engine, ctx.axis, ctx.op, ctx.kw = engine, axis, op, kw
        return engine.allreduce(x, axis, op=op, **kw)

    @staticmethod
    def backward(ctx, g):
        if ctx.op != "add":
            raise RuntimeError(
                f"a gradient reached an allreduce(op={ctx.op!r}): it is "
                f"only defined on gradient-free values")
        dx = ctx.engine.allreduce(g.contiguous(), ctx.axis, **ctx.kw)
        return None, dx, None, None, None


class ReduceScatter(torch.autograd.Function):
    """reduce_scatter(x, axis); adjoint allgather."""

    @staticmethod
    def forward(ctx, engine, x, axis, op, kw):
        if op != "add":
            raise RuntimeError(f"reduce_scatter(op={op!r}) has no adjoint")
        ctx.engine, ctx.axis, ctx.shape = engine, axis, tuple(x.shape)
        return engine.reduce_scatter(x, axis, op=op, **kw)

    @staticmethod
    def backward(ctx, g):
        full = ctx.engine.allgather(g.contiguous(), ctx.axis)
        return None, full.reshape(ctx.shape), None, None, None


class AllGather(torch.autograd.Function):
    """allgather(x, axis); adjoint reduce_scatter(add)."""

    @staticmethod
    def forward(ctx, engine, x, axis, kw):
        ctx.engine, ctx.axis, ctx.shape = engine, axis, tuple(x.shape)
        return engine.allgather(x, axis, **kw)

    @staticmethod
    def backward(ctx, g):
        shard = ctx.engine.reduce_scatter(g.contiguous(), ctx.axis)
        return None, shard.reshape(ctx.shape), None, None


class AllToAll(torch.autograd.Function):
    """alltoall(x, axis) on the leading local dim; self-adjoint."""

    @staticmethod
    def forward(ctx, engine, x, axis, kw):
        ctx.engine, ctx.axis = engine, axis
        return engine.alltoall(x, axis, **kw)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.engine.alltoall(g.contiguous(), ctx.axis), None, None


class AllGatherMatmul(torch.autograd.Function):
    """allgather(x) @ w per rank: x (*mesh, m, k), w (*mesh, k, p)."""

    @staticmethod
    def forward(ctx, engine, x, w, axis, segments):
        ctx.engine, ctx.axis = engine, axis
        ctx.x_shape, ctx.x_dtype = tuple(x.shape), x.dtype
        if not ctx.needs_input_grad[2]:
            ctx.save_for_backward(w)
            return engine.allgather_matmul(x, w, axis, segments=segments)
        y, xg = engine.allgather_matmul(x, w, axis, segments=segments,
                                        keep_gathered=True)
        ctx.save_for_backward(w, xg)
        return y

    @staticmethod
    def backward(ctx, g):
        w = ctx.saved_tensors[0]
        dx = dw = None
        if ctx.needs_input_grad[1]:
            z = _mm_t(g, w, ctx.x_dtype, tb=True)      # (*mesh, n m, k)
            dx = ctx.engine.reduce_scatter(z, ctx.axis).reshape(ctx.x_shape)
        if ctx.needs_input_grad[2]:
            xg = ctx.saved_tensors[1]
            dw = _mm_t(xg.reshape(tuple(g.shape[:-1]) + (xg.shape[-1],)),
                       g, w.dtype, ta=True)
        return None, dx, dw, None, None


class MatmulReduceScatter(torch.autograd.Function):
    """reduce_scatter(x @ w) over rows: x (*mesh, m, k), w (*mesh, k, p)."""

    @staticmethod
    def forward(ctx, engine, x, w, axis, segments):
        ctx.engine, ctx.axis = engine, axis
        ctx.save_for_backward(x, w)
        return engine.matmul_reduce_scatter(x, w, axis, segments=segments)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        G = ctx.engine.allgather(g.contiguous(), ctx.axis).reshape(
            tuple(x.shape[:-1]) + (g.shape[-1],))
        dx = _mm_t(G, w, x.dtype, tb=True) if ctx.needs_input_grad[1] \
            else None
        dw = _mm_t(x, G, w.dtype, ta=True) if ctx.needs_input_grad[2] \
            else None
        return None, dx, dw, None, None
