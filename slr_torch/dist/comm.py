"""Every collective the parallel tier issues (the counterpart of the
``ppermute``, ``psum`` and ``all_gather`` calls of ``slr/dist/``), over
``torch.distributed``: NCCL between cards, Gloo on the CPU or where the
caller names it.

- ``ring_exchange``: the halo ring, one ``batch_isend_irecv`` of four
  ``P2POp``s (a send to each neighbour on the axis and a receive from each);
- ``all_reduce_``: a sum in place (the Schur system, one buffer);
- ``all_gather_rows``: tensors concatenated along dim 0 in group-rank order,
  moved as bytes in one ``all_gather``, so every rank ends with the same
  bits;
- ``barrier``.

``calls`` counts the calls of each kind and ``sent_bytes`` the bytes a rank
handed to each; a group of None (a trivial mesh) is an identity and counts
nothing.

Gloo's send and receive hand the tensor's memory to its TCP transport as
is, so a CUDA tensor cannot travel by them: under Gloo the ring's tensors
on the card are copied to the host and back, explicitly, and the op's name
is added to ``staged``. Nothing stages under NCCL, and no op falls back
without being listed there.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("ring", "all_reduce", "all_gather", "barrier")
# the ops Gloo takes only for tensors in host memory
GLOO_HOST_ONLY = frozenset({"send", "recv"})

calls = dict.fromkeys(KINDS, 0)
sent_bytes = dict.fromkeys(KINDS, 0)
staged: set = set()


def reset() -> None:
    """Every count to 0 and ``staged`` emptied."""
    for k in KINDS:
        calls[k] = 0
        sent_bytes[k] = 0
    staged.clear()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _host_only(op: str, group, t) -> bool:
    return (t.device.type != "cpu" and op in GLOO_HOST_ONLY
            and dist.get_backend(group) == "gloo")


def ring_exchange(up, down, group, tag: int = 0):
    """Sends ``up`` to the previous rank of ``group`` and ``down`` to the
    next (both cyclic) and returns (the previous rank's ``down``, the next
    rank's ``up``): one ``batch_isend_irecv`` of four operations. ``up`` and
    ``down`` have one shape and dtype on every rank of the group. The
    receives are posted in the order the peers send (next, then previous),
    so with two ranks, where both neighbours are one peer, the pairs still
    match."""
    n = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    prev = dist.get_global_rank(group, (me - 1) % n)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    host = _host_only("send", group, up)
    bufs = [t.cpu() if host else t.contiguous() for t in (up, down)]
    from_prev = torch.empty_like(bufs[1])
    from_next = torch.empty_like(bufs[0])
    ops = [dist.P2POp(dist.isend, bufs[0], prev, group, tag),
           dist.P2POp(dist.isend, bufs[1], nxt, group, tag + 1),
           dist.P2POp(dist.irecv, from_next, nxt, group, tag),
           dist.P2POp(dist.irecv, from_prev, prev, group, tag + 1)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    calls["ring"] += 1
    sent_bytes["ring"] += _nbytes(up) + _nbytes(down)
    if host:
        staged.update(("send", "recv"))
        return from_prev.to(up.device), from_next.to(up.device)
    return from_prev, from_next


def all_reduce_(buf, group):
    """Sums ``buf`` over ``group`` in place; returns it."""
    if group is None:
        return buf
    dist.all_reduce(buf, group=group)
    calls["all_reduce"] += 1
    sent_bytes["all_reduce"] += _nbytes(buf)
    return buf


def all_gather_rows(tensors, group):
    """Each tensor of ``tensors`` concatenated along dim 0 over the ranks of
    ``group``, in group-rank order; every rank passes tensors of the same
    shapes and dtypes. The tensors travel as their bytes in one
    ``all_gather``, so the result is every rank's bits."""
    if group is None:
        return list(tensors)
    n = dist.get_world_size(group)
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    sizes = [f.numel() for f in flat]
    payload = torch.cat(flat)
    parts = [torch.empty_like(payload) for _ in range(n)]
    dist.all_gather(parts, payload, group=group)
    calls["all_gather"] += 1
    sent_bytes["all_gather"] += payload.numel()
    out = []
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)
    for i, t in enumerate(tensors):
        pieces = [p[offsets[i]:offsets[i + 1]].view(t.dtype).reshape(t.shape)
                  for p in parts]
        out.append(torch.cat(pieces) if t.dim() else torch.stack(pieces))
    return out


def world() -> tuple[int, int]:
    """(this process's rank, the world's size); (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Every rank of the world waits here; nothing without a process group."""
    if world()[1] > 1:
        dist.barrier()
        calls["barrier"] += 1


def rank0_writes(write) -> None:
    """Runs ``write()`` on rank 0 alone, between two barriers: no rank is
    still reading what the write changes when it starts (a rank that counts
    the files on disk counts them before it), and every rank waits until it
    is done (without a process group: just ``write()``)."""
    barrier()
    if world()[0] == 0:
        write()
    barrier()
