"""Collectives over a process group: the port's counterparts of JAX's
`lax.ppermute` (`ring_shift`), `lax.psum` (`all_reduce_sum`) and
`multihost_utils.process_allgather` (`all_gather_vector`), the three
that FSDP and tensor parallelism need where GSPMD inserts its own
(`all_gather_dim`, `reduce_scatter_dim`, `broadcast`), and the one-way hop
of pipeline generation (`send_next` / `recv_prev`: one edge of JAX's
ppermute ring, where the receiver waits for its sender).

Over NCCL they move the tensors where they lie. Over gloo a CUDA tensor is
staged through a pinned host buffer on the way out and copied back to its
device on the way in; `staged_bytes` counts the bytes those copies move
between the card and host memory, both ways. The route follows from the group's backend and
the tensor's device alone: nothing is retried on another, and a failed op
raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

staged_bytes = 0  # bytes copied between the card and host memory for gloo, both ways

_BUCKET_BYTES = 256 << 20  # all_reduce_sum reduces in flat buckets of at most this size


def _stages(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _out(x: torch.Tensor, group) -> torch.Tensor:
    """x as the collective takes it: a pinned host copy over gloo, else x."""
    global staged_bytes
    if not _stages(x, group):
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    staged_bytes += x.numel() * x.element_size()
    return host


def _buffer(like: torch.Tensor, group) -> torch.Tensor:
    """An empty receive buffer for a tensor like `like`: pinned host memory
    over gloo, else on like's device."""
    if _stages(like, group):
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty_like(like, memory_format=torch.contiguous_format)


def _global(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def ring_shift(tensors: Sequence[torch.Tensor], group=None) -> list[torch.Tensor]:
    """Send each tensor to the group's next rank (r + 1 mod n) and return the
    ones received from the previous rank (r − 1 mod n), on the senders'
    device: one `batch_isend_irecv` for all of them."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt, prv = _global(group, (r + 1) % n), _global(group, (r - 1) % n)
    sends = [_out(t.contiguous(), group) for t in tensors]
    recvs = [_buffer(t, group) for t in tensors]
    ops = [dist.P2POp(dist.isend, s, nxt, group) for s in sends]
    ops += [dist.P2POp(dist.irecv, b, prv, group) for b in recvs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [_back(b, t) for b, t in zip(recvs, tensors)]


def _back(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received buffer on like's device: a staged one copied back, counted."""
    global staged_bytes
    if buf.device == like.device:
        return buf
    staged_bytes += buf.numel() * buf.element_size()
    return buf.to(like.device)


def send_next(x: torch.Tensor, group=None) -> None:
    """Send x to the group's next rank (r + 1 mod n); returns when it is sent.
    The receiver calls `recv_prev` with a tensor like x."""
    dist.send(_out(x.contiguous(), group), _global(group, (dist.get_rank(group) + 1) % dist.get_world_size(group)),
              group=group)


def recv_prev(like: torch.Tensor, group=None) -> torch.Tensor:
    """The tensor the group's previous rank (r − 1 mod n) sent with
    `send_next`, of like's shape and dtype on like's device. Waits for it."""
    buf = _buffer(like, group)
    dist.recv(buf, _global(group, (dist.get_rank(group) - 1) % dist.get_world_size(group)), group=group)
    return _back(buf, like)


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Sum each tensor over the group, in place. The tensors go in flat
    buckets of one dtype and device (at most `_BUCKET_BYTES` each), one
    all_reduce a bucket, reduced in their own dtype."""
    global staged_bytes
    order: dict = {}
    for t in tensors:
        order.setdefault((t.dtype, t.device), []).append(t)
    for ts in order.values():
        i = 0
        while i < len(ts):
            j, nbytes = i, 0
            while j < len(ts) and (j == i or nbytes + ts[j].numel() * ts[j].element_size() <= _BUCKET_BYTES):
                nbytes += ts[j].numel() * ts[j].element_size()
                j += 1
            chunk = ts[i:j]
            flat = torch.cat([t.reshape(-1) for t in chunk])
            wire = _out(flat, group)
            dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
            if wire is not flat:
                flat.copy_(wire)
                staged_bytes += flat.numel() * flat.element_size()
            off = 0
            for t in chunk:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
            i = j


def all_gather_vector(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, *x.shape): every rank's x stacked in group-rank order, on x's
    device. Every rank passes the same shape and dtype."""
    global staged_bytes
    wire = _out(x.contiguous(), group)
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    out = torch.stack(parts)
    if wire is not x and x.is_cuda:
        staged_bytes += out.numel() * out.element_size()
        return out.to(x.device)
    return out



def all_gather_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in group-rank order, on x's
    device (a rank's block of a sharded leaf → the leaf). Every rank passes
    the same shape and dtype."""
    global staged_bytes
    x = x.contiguous()
    wire = _out(x, group)
    parts = [_buffer(x, group) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, wire, group=group)
    if wire is not x:
        staged_bytes += sum(p.numel() * p.element_size() for p in parts)
        parts = [p.to(x.device, non_blocking=True) for p in parts]
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The sum of x over the group, cut into n equal blocks along `dim`; rank
    r gets block r (a gradient of a gathered leaf → this rank's block of its
    sum), in x's dtype and on x's device."""
    global staged_bytes
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter over {n} ranks of a dim of {x.shape[dim]}")
    blocks = [b.contiguous() for b in x.chunk(n, dim=dim)]
    out = _buffer(blocks[r], group)
    dist.reduce_scatter(out, [_out(b, group) for b in blocks], op=dist.ReduceOp.SUM, group=group)
    if out.device != x.device:
        staged_bytes += out.numel() * out.element_size()
        out = out.to(x.device)
    return out


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """x of the group's rank `src` on every rank, in place (x must have the
    same shape and dtype everywhere); returns x."""
    global staged_bytes
    if not x.is_contiguous():
        raise ValueError("broadcast works in place: x must be contiguous")
    wire = _out(x, group)
    dist.broadcast(wire, src=_global(group, src), group=group)
    if wire is not x:
        x.copy_(wire)
        staged_bytes += x.numel() * x.element_size()
    return x
