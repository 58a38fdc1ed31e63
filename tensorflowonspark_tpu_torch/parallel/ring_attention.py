"""Ring attention: sequence parallelism over an ``sp`` mesh axis — the port
of the JAX package's ``parallel/ring_attention.py``.

The sequence is split over the ranks of the ``sp`` group: each rank holds
one block of queries and one block of keys/values, and the K/V blocks (with
their segment ids) travel around the ring, one hop a step, so every query
block meets every K/V block. Memory a rank is O(L_local) for each block
pair: the JAX version folds each pair into an online softmax with plain f32
einsums (O(L_local²) scores); here each pair is one launch of the flash
kernels (``ops/flash_attention.py``), which give the pair's output and its
log-sum-exp, and the pairs are merged through their lse in f32:
``lse = logaddexp(lse, lse_s)``, ``o = o·exp(lse_old − lse) + o_s·exp(lse_s
− lse)``. A row that attends no key of a hop carries the kernels' sentinel
lse there and weighs exactly 0 in the merge; its own key, on the diagonal
hop, which is merged first, always gives it a real one.

Under the causal mask member ``my`` takes the hop from source ``(my − s) mod
n`` as: causal on the diagonal (``s = 0``), unmasked from a source before it,
and skipped (no launch) from a source after it, so a direction launches each
kernel n(n+1)/2 times over the ring. The backward (a
``torch.autograd.Function``) recomputes nothing of the forward: ``delta =
rowsum(dO·O)`` in f32, then every hop runs the dq and dk/dv kernels with the
*final* lse, dq accumulates on the rank, and the dk/dv accumulators travel
with their K/V block and arrive home after n rotations. The K/V blocks are
rotated again in the backward rather than kept from the forward, so a
rank's memory stays one block. Every value that crosses hops (the merged O,
dq, the dk/dv partials) is f32: the kernels write f32 outputs for the ring
(``out_dtype``); the result is cast once at the end.

Each hop's send and receive (``dist.batch_isend_irecv`` to the ring's
neighbours) is issued before the hop's kernel, so the transfer overlaps the
launch; in the backward the accumulators' hop overlaps the next block's
kernels. The per-member arithmetic (:class:`_Member`: the hop schedule, the
masks, the merge, the backward's accumulation) is apart from the exchange
(:class:`_Ring`), so one process can run all members of a ring in lockstep
(:func:`ring_attention_local`), handing each the blocks the exchange would
deliver, in the same order of sums. That is the test seam for one card
(NCCL takes no two ranks on one device), not a user feature.

:func:`plain_attention` is the dense reference the flash kernels and the
transformer's ``attention="plain"`` path are held against.
"""

import math

import torch

from tensorflowonspark_tpu_torch.ops import flash_attention as fa

#: finite stand-in for -inf, the same sentinel as the JAX package's: a fully
#: masked row gives finite garbage instead of NaN
NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)


def plain_attention(q, k, v, causal=False, scale=None, segment_ids=None):
    """Reference single-device attention over ``[B, H, L, D]`` tensors: f32
    scores, the causal mask and the packed-sequence fence (``segment_ids``
    ``int [B, L]``, 0 = padding) as the finite sentinel, softmax in f32,
    the result cast back to ``q``'s dtype."""
    head_dim = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if causal:
        l_q, l_k = q.shape[2], k.shape[2]
        mask = (torch.arange(l_q, device=q.device)[:, None]
                >= torch.arange(l_k, device=q.device)[None, :])
        scores = torch.where(mask[None, None], scores, NEG_BIG)
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32)
        scores = torch.where(seg[:, None, :, None] == seg[:, None, None, :], scores, NEG_BIG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def hop_mask(n, my, s, causal):
    """How member ``my`` of a ring of ``n`` attends the block it holds after
    ``s`` rotations (source ``(my − s) mod n``): True for the causal mask
    (the diagonal), False for none, None to skip it (causal, a later
    source: every score masked)."""
    if not causal:
        return False
    src = (my - s) % n
    if src == my:
        return True
    return False if src < my else None


def hop_schedule(n, causal):
    """``[(s, member, source, causal)]``: every hop of a ring of ``n`` that
    launches the kernels, in the order :func:`ring_attention_local` runs
    them."""
    return [(s, my, (my - s) % n, hop_mask(n, my, s, causal))
            for s in range(n) for my in range(n) if hop_mask(n, my, s, causal) is not None]


class _Member:
    """The arithmetic of one member of a ring over ``[BH, L, D]`` operands:
    its queries ``q`` and their ids ``seg`` (None: no fence), the hops'
    kernel launches, the forward's merge and the backward's accumulation."""

    def __init__(self, q, seg, my, n, causal, scale, heads):
        # the queries padded once to the kernels' head width (on the card),
        # the held blocks and dO once a hop / a backward
        self.d, self.q = q.shape[-1], fa.widen_heads(q)
        self.seg, self.my, self.n = seg, my, n
        self.causal, self.scale, self.heads = causal, scale, heads
        self.o = self.lse = self.dq = None

    def forward_hop(self, s, k, v, seg_k):
        """Fold the held block (``k``, ``v``, its ids ``seg_k``) into the
        running ``(o, lse)``."""
        mask = hop_mask(self.n, self.my, s, self.causal)
        if mask is None:
            return
        o, lse = fa.flash_fwd(self.q, fa.widen_heads(k), fa.widen_heads(v), self.seg, self.scale, mask,
                              self.heads, seg_k=seg_k, out_dtype=torch.float32)
        o = fa.narrow_heads(o, self.d)
        if self.o is None:
            self.o, self.lse = o, lse
            return
        merged = torch.logaddexp(self.lse, lse)
        self.o = self.o * torch.exp(self.lse - merged)[..., None] + o * torch.exp(lse - merged)[..., None]
        self.lse = merged

    def backward_begin(self, o, lse, do):
        """The backward's row statistics from the final output and lse."""
        self.do, self.lse = fa.widen_heads(do), lse
        self.delta = (do.float() * o.float()).sum(-1)
        self.dq = None

    def backward_hop(self, s, k, v, seg_k):
        """Add the held block's part of dq; returns its ``[dk, dv]`` part
        (f32), or None for a skipped hop."""
        mask = hop_mask(self.n, self.my, s, self.causal)
        if mask is None:
            return None
        args = (self.seg, self.do, self.lse, self.delta, self.scale, mask, self.heads)
        k, v = fa.widen_heads(k), fa.widen_heads(v)
        dq = fa.narrow_heads(fa.flash_bwd_dq(self.q, k, v, *args, seg_k=seg_k, out_dtype=torch.float32), self.d)
        dk, dv = (fa.narrow_heads(t, self.d)
                  for t in fa.flash_bwd_dkv(self.q, k, v, *args, seg_k=seg_k, out_dtype=torch.float32))
        if self.dq is None:
            self.dq = dq
        else:
            self.dq += dq
        return [dk, dv]


def _accumulate(acc, part):
    """The traveling ``[dk, dv]`` accumulator with this hop's part added in
    place (the received buffers are this rank's own)."""
    if part is not None:
        for a, p in zip(acc, part):
            a += p
    return acc


class _Pending:
    def __init__(self, reqs, outs):
        self.reqs, self.outs = reqs, outs

    def wait(self):
        for req in self.reqs:
            req.wait()
        return self.outs


class _Ring:
    """The exchange of a ring over a process group: each member sends to
    the next (``rank + 1``) and receives from the previous. A member's
    place is its rank in the group, which ``sharding.sequence_shard`` holds
    equal to its block of the sequence on the mesh."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        self.n, self.me = dist.get_world_size(group), dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.me + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.me - 1) % self.n)

    def shift(self, tensors):
        """Start one hop of ``tensors`` (None entries stay None): a handle
        whose ``wait()`` gives the previous member's."""
        import torch.distributed as dist

        outs = [None if t is None else torch.empty_like(t) for t in tensors]
        ops = []
        for tag, (t, o) in enumerate(zip(tensors, outs)):
            if t is not None:
                ops += [dist.P2POp(dist.isend, t, self.next, self.group, tag),
                        dist.P2POp(dist.irecv, o, self.prev, self.group, tag)]
        return _Pending(dist.batch_isend_irecv(ops), outs)


def _ring_forward(member, k, v, seg, ring):
    held = [k, v, seg]
    for s in range(ring.n):
        pending = ring.shift(held) if s < ring.n - 1 else None
        member.forward_hop(s, *held)
        if pending is not None:
            held = pending.wait()


def _ring_backward(member, k, v, seg, ring):
    """``(dk, dv)`` of this member's own block: every member's part, summed
    in ring order as the accumulators travel."""
    held, acc = [k, v, seg], None
    for s in range(ring.n):
        pending = ring.shift(held) if s < ring.n - 1 else None
        part = member.backward_hop(s, *held)
        acc = part if s == 0 else _accumulate(acc.wait(), part)
        acc = ring.shift(acc)  # after the last hop: home
        if pending is not None:
            held = pending.wait()
    return acc.wait()


class _RingAttention(torch.autograd.Function):
    """One member's ring attention over ``[BH, L_local, D]`` blocks and its
    ``[B, L_local]`` int32 ids (or None) over the ring of ``group``."""

    @staticmethod
    def forward(ctx, q, k, v, seg, group, causal, scale, heads):
        ring = _Ring(group)
        member = _Member(q, seg, ring.me, ring.n, causal, scale, heads)
        _ring_forward(member, k, v, seg, ring)
        o = member.o.to(q.dtype)
        ctx.save_for_backward(q, k, v, seg, o, member.lse)
        ctx.args = (group, causal, scale, heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        group, causal, scale, heads = ctx.args
        ring = _Ring(group)
        member = _Member(q, seg, ring.me, ring.n, causal, scale, heads)
        member.backward_begin(o, lse, do.contiguous())
        dk, dv = _ring_backward(member, k, v, seg, ring)
        return member.dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None


class _LocalRing(torch.autograd.Function):
    """All ``n`` members of a ring in this process, in lockstep: the
    ``[BH, L, D]`` operands and ``[B, L]`` ids are split into ``n`` blocks
    along L, and member ``my`` gets at hop ``s`` the block of source ``(my
    − s) mod n``, as the exchange would deliver it."""

    @staticmethod
    def forward(ctx, q, k, v, seg, n, causal, scale, heads):
        blocks = _split(n, k, v, seg)
        members = [_Member(qb, b[2], my, n, causal, scale, heads)
                   for my, (qb, b) in enumerate(zip(_chunks(q, n), blocks))]
        for s in range(n):
            for my, m in enumerate(members):
                m.forward_hop(s, *blocks[(my - s) % n])
        o = torch.cat([m.o for m in members], 1).to(q.dtype)
        lse = torch.cat([m.lse for m in members], 1)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.args = (n, causal, scale, heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        n, causal, scale, heads = ctx.args
        blocks = _split(n, k, v, seg)
        members = []
        for my, (qb, ob, lb, db) in enumerate(zip(_chunks(q, n), _chunks(o, n), _chunks(lse, n),
                                                  _chunks(do.contiguous(), n))):
            m = _Member(qb, blocks[my][2], my, n, causal, scale, heads)
            m.backward_begin(ob, lb, db)
            members.append(m)
        accs = [None] * n
        for s in range(n):
            for my, m in enumerate(members):
                src = (my - s) % n
                part = m.backward_hop(s, *blocks[src])
                accs[src] = part if s == 0 else _accumulate(accs[src], part)
        dq = torch.cat([m.dq for m in members], 1).to(q.dtype)
        dk = torch.cat([a[0] for a in accs], 1).to(k.dtype)
        dv = torch.cat([a[1] for a in accs], 1).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None


def _chunks(t, n):
    """``n`` contiguous blocks of ``t`` along its dim 1 (L)."""
    return [c.contiguous() for c in t.chunk(n, 1)]


def _split(n, k, v, seg):
    """Each member's ``(k, v, ids)`` block."""
    ids = [None] * n if seg is None else _chunks(seg, n)
    return list(zip(_chunks(k, n), _chunks(v, n), ids))


def _merged(q, k, v, segment_ids, scale):
    """``[BH, L, D]`` operands, int32 ids and the scale of a ``[B, H, L,
    D]`` call."""
    b, h, length, d = q.shape
    merge = lambda t: t.reshape(b * h, t.shape[2], d).contiguous()  # noqa: E731
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    return merge(q), merge(k), merge(v), seg, float(1.0 / math.sqrt(d) if scale is None else scale)


def ring_attention(q, k, v, group, causal=False, scale=None, segment_ids=None):
    """Ring attention of this rank's block over the ring of ``group`` (the
    ``sp`` axis's process group; the JAX version's ``axis_name`` inside
    ``shard_map``).

    ``q``/``k``/``v``: this member's block of the sequence, ``[batch, heads,
    seq_local, head_dim]``; member i holds positions ``[i·seq_local, (i +
    1)·seq_local)``, so the causal mask is the whole sequence's.
    ``segment_ids`` (``int [batch, seq_local]``, 0 = padding) is this
    member's block of the packed-sequence ids; the keys' ids travel with
    K/V, so packed sequences never cross-attend on any hop. A group of one
    member (or None) is the flash call."""
    import torch.distributed as dist

    if group is None or dist.get_world_size(group) == 1:
        return fa.flash_attention(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
    b, h, length, d = q.shape
    qm, km, vm, seg, scale = _merged(q, k, v, segment_ids, scale)
    o = _RingAttention.apply(qm, km, vm, seg, group, bool(causal), scale, h)
    return o.reshape(b, h, length, d)


def ring_attention_local(q, k, v, n, causal=False, scale=None, segment_ids=None):
    """All ``n`` members of a ring in this process (the test seam, see the
    module docstring): ``[B, H, L, D]`` inputs (``L`` a multiple of ``n``),
    member i on positions ``[i·L/n, (i + 1)·L/n)``, the same kernel launches
    and sums as a ring of ``n`` ranks, the whole ``[B, H, L, D]`` output."""
    b, h, length, d = q.shape
    if length % n:
        raise ValueError("a ring of {} members needs L divisible by it, got {}".format(n, length))
    qm, km, vm, seg, scale = _merged(q, k, v, segment_ids, scale)
    return _LocalRing.apply(qm, km, vm, seg, int(n), bool(causal), scale, h).reshape(b, h, length, d)


def ring_attention_sharded(q, k, v, mesh, causal=False, scale=None, axis="sp", segment_ids=None):
    """Ring attention over the ``axis`` of ``mesh`` on whole ``[B, H, L,
    D]`` tensors (this rank's rows; every member of the ring holds the
    same): each member takes its block of the sequence, the ring runs, and
    the output is gathered back whole. The gradient is whole on every
    member too (the split's backward gathers it).

    With no ``axis`` in the mesh, or one of size 1, it is the single-block
    path: the flash call, the same math. A length that does not divide the
    ring is padded up to a multiple and the pad rows sliced off after —
    exact, because appended keys carry segment id 0, which never equals a
    real (>= 1) segment (an input without ids that is not causal gets an
    all-ones id tensor for the same fence; under the causal mask alone the
    appended tail is already unreachable)."""
    from tensorflowonspark_tpu_torch.parallel import collectives, sharding
    from tensorflowonspark_tpu_torch.parallel.mesh import mesh_shape

    n = mesh_shape(mesh).get(axis, 1) if mesh is not None else 1
    if n == 1:
        return fa.flash_attention(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
    length = q.shape[2]
    pad = (-length) % n
    if pad:
        seg = segment_ids
        if seg is None and not causal:
            seg = torch.ones(q.shape[0], length, dtype=torch.int32, device=q.device)
        padded = [torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v)]
        if seg is not None:
            seg = torch.nn.functional.pad(seg.to(torch.int32), (0, pad))
        out = ring_attention_sharded(*padded, mesh, causal=causal, scale=scale, axis=axis, segment_ids=seg)
        return out[:, :, :length]
    index, _ = sharding.sequence_shard(mesh, axis=axis)  # checks that the group's order is the mesh's
    group = collectives.axes_group(mesh, axis)
    mine = [collectives.split_to_region(t, group, dim=2) for t in (q, k, v)]
    seg = None if segment_ids is None else segment_ids.chunk(n, 1)[index]
    out = ring_attention(*mine, group, causal=causal, scale=scale, segment_ids=seg)
    return collectives.gather_from_region(out, group, dim=2)
