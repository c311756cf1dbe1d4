"""Model layers: norms, rotary embedding, chunked (flash-style) attention,
dense/MoE FFNs, and the Mamba-2 SSD mixer.  Plain functional PyTorch;
parameters are plain dicts of tensors.  Compute in bf16, reductions/softmax
in fp32, as the reference (``repro.models.layers``) does.

The reference's ``preferred_element_type=float32`` products of two bf16
operands are computed here on operands upcast with ``.float()`` first: the
product of two bf16 values is exact in f32, so only the f32 summation order
differs.

Under a mesh (``distributed.ctx.activation_axes`` with ``DTensor``
parameters and inputs) the layers take the reference's sharding
constraints (``constrain``) at its sites.  Where the reference's body is a
scan that GSPMD partitions by those constraints, the port runs the same
plain body on each device's local shards with ``local_map``: flash
attention on batch shards (the reference pins its tiles and carries to the
batch axes), the SSD scan on batch and head shards, the MoE dispatch with
explicit collectives.  Outside a mesh every function runs as before, on
plain tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.ctx import constrain, current_axes, is_dtensor, replicate_like, spec_for
from .config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e30


# ------------------------------------------------------------ activations
def _silu(x):
    """``jax.nn.silu``, x * sigmoid(x), with the sigmoid written out as
    1 / (1 + exp(-x)): the reference's XLA lowering computes it so, rounding
    to the input's dtype after each op, and so does this (``F.silu`` rounds
    once)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation, op by op as the
    reference writes it, the constants in the input's dtype."""
    c = torch.tensor(0.7978845608028654, dtype=x.dtype, device=x.device)
    a = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * x ** 3))))


# ----------------------------------------------------------------- norms
def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


# ----------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta):
    """x: (..., L, H, hd); positions: (..., L).  Split halves, not
    interleaved pairs, computed in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs     # (..., L, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------- chunked attention
def _largest_divisor(n: int, at_most: int) -> int:
    for c in range(at_most, 0, -1):
        if n % c == 0:
            return c
    return n


def _local(fn, xs, dims, out_dims, partial_grads=None):
    """``fn`` on each device's local shards of the ``DTensor``s ``xs``, each
    constrained to its ``dims`` first; its outputs are the local shards of
    ``DTensor``s placed by ``out_dims``, given as (dims, global shape) pairs
    (``torch.distributed.tensor.experimental.local_map``).  The gradient of
    an input takes its placements, save that ``partial_grads`` maps an
    input's number to "model" or "batch": its gradient is a partial sum over
    those axes, where it is replicated (each of their shards uses it only in
    part)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import placements_for

    xs = [constrain(x, d) for x, d in zip(xs, dims)]
    mesh = xs[0].device_mesh
    # one output's placements are a list: a tuple names several outputs
    outs = tuple(list(placements_for(mesh, spec_for(shape, d))) for d, shape in out_dims)
    ins = tuple(list(x.placements) for x in xs)
    axes = current_axes() or {"model": None, "batch": ()}
    names = list(mesh.mesh_dim_names)
    kinds = {"model": {names.index(axes["model"])} if axes["model"] else set(),
             "batch": {names.index(a) for a in axes["batch"]}}
    partial_grads = partial_grads or {}
    grads = tuple(
        [Partial() if i in partial_grads and j in kinds[partial_grads[i]] and pl.is_replicate()
         else pl for j, pl in enumerate(p)] for i, p in enumerate(ins))
    return local_map(fn, outs if len(outs) > 1 else outs[0], in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)(*xs)


def _batch_dims(x):
    return ("batch",) + (None,) * (x.dim() - 1)


def flash_attention(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int,
                    q_offset: int = 0, causal_skip: bool = False):
    if is_dtensor(q):
        # the reference pins q, k, v, its tiles and its carries to the batch
        # axes: the whole attention runs on batch shards, every head local
        fn = functools.partial(flash_attention, causal=causal, q_chunk=q_chunk,
                               kv_chunk=kv_chunk, q_offset=q_offset, causal_skip=causal_skip)
        return _local(fn, (q, k, v), [_batch_dims(t) for t in (q, k, v)],
                      [(_batch_dims(q), q.shape)])
    if causal and causal_skip and q.shape[1] == k.shape[1] and q_offset == 0:
        return flash_attention_causal_pairs(q, k, v, chunk=min(q_chunk, kv_chunk))
    return _flash_attention_dense(
        q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
        q_offset=q_offset,
    )


def _flash_attention_dense(q, k, v, *, causal: bool, q_chunk: int,
                           kv_chunk: int, q_offset: int = 0):
    """Memory-bounded attention: a loop over KV chunks with online softmax
    inside a loop over Q chunks; never more than a (q_chunk, kv_chunk) tile
    of scores.

    q: (B, Lq, H, hd); k/v: (B, Lkv, KVH, hd).  GQA via head grouping.
    q_offset: absolute position of q[0] (a host int).  Returns (B, Lq, H, hd).

    Under a causal mask with ``q_offset >= 0`` a tile that lies wholly above
    the diagonal is skipped.  That is exact: every query row has met key 0
    in the first KV chunk, so its running max is finite, the tile's
    probabilities are ``exp(NEG_INF - m) == 0`` and its correction is
    ``exp(0) == 1``: the reference's scan leaves ``m``, ``l`` and ``acc``
    as they are on such a tile.
    """
    B, Lq, H, hd = q.shape
    _, Lkv, KVH, _ = k.shape
    group = H // KVH
    scale = hd ** -0.5

    q_chunk = _largest_divisor(Lq, min(q_chunk, Lq))
    kv_chunk = _largest_divisor(Lkv, min(kv_chunk, Lkv))
    nq, nkv = Lq // q_chunk, Lkv // kv_chunk

    qr = q.reshape(B, Lq, KVH, group, hd).float()
    kf, vf = k.float(), v.float()
    dev = q.device
    out = torch.empty((B, Lq, KVH, group, hd), dtype=q.dtype, device=dev)
    for i in range(nq):
        q0 = q_offset + i * q_chunk
        qb = qr[:, i * q_chunk:(i + 1) * q_chunk]        # (B, qc, KVH, g, hd)
        q_pos = q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KVH, group, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KVH, group, q_chunk, hd), dtype=torch.float32, device=dev)
        for j in range(nkv):
            if causal and q_offset >= 0 and q0 + q_chunk - 1 < j * kv_chunk:
                continue
            kb = kf[:, j * kv_chunk:(j + 1) * kv_chunk]
            vb = vf[:, j * kv_chunk:(j + 1) * kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale   # (B, KVH, g, qc, kc)
            if causal:
                k_pos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vb)
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp_min(l[..., None], 1e-30)
        out[:, i * q_chunk:(i + 1) * q_chunk] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out.reshape(B, Lq, H, hd)


def flash_attention_causal_pairs(q, k, v, *, chunk: int):
    """Causal flash attention over the lower-triangle tile list only.

    The reference scans the n(n+1)/2 pairs (i, j <= i) in order, restarting
    the online softmax at j == 0, and the final (i, i) pair's write wins:
    that is the dense loop at q_chunk == kv_chunk with its masked tiles
    skipped, which ``_flash_attention_dense`` does.  Requires Lq == Lkv.
    """
    L = q.shape[1]
    chunk = _largest_divisor(L, chunk)
    return _flash_attention_dense(q, k, v, causal=True, q_chunk=chunk, kv_chunk=chunk)


def decode_attention(q, k_cache, v_cache, kv_len):
    """Single-token attention against a (possibly longer, padded) cache.

    q: (B, 1, H, hd); caches: (B, Lmax, KVH, hd); kv_len: valid prefix length.
    """
    if is_dtensor(k_cache):
        return _decode_attention_mesh(q, k_cache, v_cache, kv_len)
    B, _, H, hd = q.shape
    _, Lmax, KVH, _ = k_cache.shape
    group = H // KVH
    qr = q.reshape(B, KVH, group, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache.float()) * (hd ** -0.5)
    mask = torch.arange(Lmax, device=q.device) < kv_len
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _decode_attention_mesh(q, k_cache, v_cache, kv_len):
    """``decode_attention`` on the caches' own shards: batch and kv heads
    where the caches shard them (q's heads follow their kv group), and a
    sequence sharded over mesh axes is reduced in place (flash decoding):
    each device scores its rows, and the row max, the exp-sums and the
    weighted values are all-reduced over those axes."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = k_cache.device_mesh
    cpl = list(k_cache.placements)
    # q (B, 1, H, hd): batch and heads as the cache's (B, Lmax, KVH, hd)
    qpl = [pl if pl.is_shard(0) or pl.is_shard(2) else Replicate() for pl in cpl]
    seq = [i for i, pl in enumerate(cpl) if pl.is_shard(1)]
    if not seq:
        fn = functools.partial(decode_attention, kv_len=kv_len)
        return local_map(fn, qpl, in_placements=(qpl, cpl, cpl), device_mesh=mesh)(
            q.redistribute(mesh, qpl), k_cache, v_cache.redistribute(mesh, cpl))
    n_loc = k_cache.to_local().shape[1]
    first = 0
    for i in seq:
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    first *= n_loc

    def reduce(x, op):
        for i in seq:
            x = funcol.wait_tensor(funcol.all_reduce(x, op, (mesh, i)))
        return x

    def local(ql, kl, vl):
        B, _, H, hd = ql.shape
        KVH = kl.shape[2]
        qr = ql.reshape(B, KVH, H // KVH, hd).float()
        s = torch.einsum("bhgd,bkhd->bhgk", qr, kl.float()) * (hd ** -0.5)
        mask = first + torch.arange(kl.shape[1], device=ql.device) < kv_len
        s = torch.where(mask, s, NEG_INF)
        m = reduce(s.amax(-1, keepdim=True), "max")
        p = torch.exp(s - m)
        den = reduce(p.sum(-1, keepdim=True), "sum")
        num = reduce(torch.einsum("bhgk,bkhd->bhgd", p.to(vl.dtype).float(), vl.float()), "sum")
        return (num / den).reshape(B, 1, H, hd).to(ql.dtype)

    return local_map(local, qpl, in_placements=(qpl, cpl, cpl), device_mesh=mesh)(
        q.redistribute(mesh, qpl), k_cache, v_cache.redistribute(mesh, cpl))


# ----------------------------------------------------------------- FFNs
def dense_ffn(x, p, cfg: ModelConfig):
    # on a mesh the hidden layer takes the TP layout (ffn-hidden over
    # `model`) whatever the weights' sharding; the identity outside one.
    # The reference leaves this layout to GSPMD: under the TP rules it is
    # what the weights give anyway, and under flat FSDP it is a choice of
    # the port's (DTensor cannot redistribute the nested strided shard)
    def up(w):
        return constrain(x @ w, ("batch", None, "model"))

    if cfg.act == "swiglu":
        h = _silu(up(p["w_gate"])) * up(p["w_up"])
    elif cfg.act == "squared_relu":
        h = torch.square(F.relu(up(p["w_up"])))
    elif cfg.act == "gelu":
        h = _gelu(up(p["w_up"]))
    else:
        raise ValueError(cfg.act)
    return h @ p["w_down"]


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor
    dropped_frac: torch.Tensor


def _capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T tokens."""
    cap = max(8, int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts))
    return min(cap, T)


def _route(xf, router, cfg: ModelConfig, cap: int):
    """Top-k routing of the (T, d) tokens: (probs (T, E), gate (T, k)
    renormalised, flat_e (T*k,) the expert of each routed copy in (token,
    choice) order, pos its slot in that expert's buffer, keep = pos < cap)."""
    logits = xf.float() @ router.float()                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = ranked.values[:, :cfg.top_k], ranked.indices[:, :cfg.top_k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, cfg.n_experts)                  # (T*k, E)
    pos = (onehot.cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
    return probs, gate, flat_e, pos, pos < cap


def moe_ffn(x, p, cfg: ModelConfig):
    """Top-k token-choice MoE with capacity-bounded sort-free dispatch.

    x: (B, L, d).  Per-expert buffers of capacity C; a routed copy's slot is
    its rank among the copies routed to its expert, in (token, choice)
    order, and a copy past C is dropped.  Ties in the top-k keep the lower
    expert index first (``jax.lax.top_k``'s order), by a stable sort.

    Kept copies own distinct slots, so the dispatch is a copy into each
    expert's buffer plus one spare row that takes the dropped copies (the
    reference adds their zeros into slot C - 1, which leaves it as it is);
    the combine adds each token's k weighted copies in choice order, as the
    reference's ``segment_sum`` over ``repeat(arange(T), k)`` does, without
    atomics.
    """
    if is_dtensor(x):
        return _moe_ffn_mesh(x, p, cfg)
    B, L, d = x.shape
    T = B * L
    y, aux, dropped = _moe_gather(x.reshape(T, d), p, cfg)
    return y.reshape(B, L, d), MoEStats(aux, dropped)


def _counts(flat_e, E: int):
    """Routed copies per expert, in f32 (exact: ``bincount`` has an output
    size that depends on the data, which a fake tensor cannot give)."""
    ones = torch.ones(flat_e.shape, dtype=torch.float32, device=flat_e.device)
    return torch.zeros(E, dtype=torch.float32, device=flat_e.device).index_add_(0, flat_e, ones)


def _experts(buf, wg, wu, wd, cfg: ModelConfig):
    """The expert FFNs on their (E, cap, d) buffers."""
    if cfg.act == "swiglu":
        h = _silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    else:
        h = torch.square(F.relu(torch.bmm(buf, wu)))
    return torch.bmm(h, wd)


def _combine(routed, keep, gate, T: int, k: int):
    """Each token's k kept, gate-weighted copies added in choice order (the
    reference's ``segment_sum`` over ``repeat(arange(T), k)``)."""
    routed = torch.where(keep[:, None], routed, 0.0)
    w = (gate.reshape(-1) * keep).to(routed.dtype)
    routed = (routed * w[:, None]).reshape(T, k, routed.shape[-1])
    y = routed[:, 0]
    for i in range(1, k):
        y = y + routed[:, i]
    return y


def _moe_gather(xf, p, cfg: ModelConfig, experts=None):
    """``moe_ffn`` on (T, d) tokens: (y, aux, dropped).  ``experts`` is
    ``(wg, wu, wd, split, gather)`` on a mesh: ``split`` takes this device's
    experts' buffers, which go through the local expert weights, and
    ``gather`` makes the (E, cap, d) outputs of every expert from the local
    ones."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, T)
    probs, gate, flat_e, pos, keep = _route(xf, p["router"], cfg, cap)
    tok = torch.arange(T, device=xf.device).repeat_interleave(k)

    slot = flat_e * (cap + 1) + torch.where(keep, pos, cap)
    buf = xf.new_zeros((E * (cap + 1), d)).index_copy_(0, slot, xf[tok])
    buf = buf.view(E, cap + 1, d)[:, :cap]

    # expert computation
    if experts is None:
        out_buf = _experts(buf, p.get("w_gate"), p["w_up"], p["w_down"], cfg)  # (E, cap, d)
    else:
        wg, wu, wd, split, gather = experts
        out_buf = gather(_experts(split(buf), wg, wu, wd, cfg))

    routed = out_buf[flat_e, torch.where(keep, pos, cap - 1)]   # (T*k, d)
    y = _combine(routed, keep, gate, T, k)

    if cfg.n_shared_experts:
        sh = _silu(xf @ p["shared_gate"]) * (xf @ p["shared_up"])
        y = y + sh @ p["shared_down"]

    # Switch-style load-balance auxiliary loss.
    me = probs.mean(dim=0)
    ce = _counts(flat_e, E) / (T * k)
    aux = E * torch.sum(me * ce)
    dropped = 1.0 - keep.float().mean()
    return y, aux, dropped


def _model_axis(mesh):
    """(name, size, index) of the context's model axis on ``mesh``, or Nones."""
    axes = current_axes()
    name = axes.get("model") if axes else None
    if name is None:
        return None, 1, None
    idx = list(mesh.mesh_dim_names).index(name)
    return name, mesh.size(idx), idx


def _all_gather(x, mesh, mi):
    import torch.distributed._functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    return funcol.wait_tensor(gather(x.contiguous(), 0, (mesh, mi)))


class _GatherReplicated(torch.autograd.Function):
    """All-gather along dim 0 over one mesh axis, for a computation every
    device of that axis repeats: the gradient is this device's slice of the
    (identical) incoming one, not a sum over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, mi):
        ctx.n, ctx.i = mesh.size(mi), mesh.get_local_rank(mi)
        return _all_gather(x, mesh, mi)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n)[ctx.i], None, None


class SumReplicated(torch.autograd.Function):
    """All-reduce (sum) over one mesh axis of partial results whose sum every
    device of the axis then uses whole: the gradient passes through as it is
    (each device's part takes the whole, identical incoming gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, mi):
        import torch.distributed._functional_collectives as funcol

        return funcol.wait_tensor(funcol.all_reduce(x, "sum", (mesh, mi)))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SliceReplicated(torch.autograd.Function):
    """This device's slice along dim 0 of a tensor every device of one mesh
    axis holds whole: its gradient is all-gathered over the axis, since the
    other devices took the gradients of the other slices."""

    @staticmethod
    def forward(ctx, x, mesh, mi):
        ctx.mesh, ctx.mi = mesh, mi
        return x.chunk(mesh.size(mi))[mesh.get_local_rank(mi)]

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.mi), None, None


def _moe_ffn_mesh(x, p, cfg: ModelConfig):
    """The gather MoE on ``DTensor``s: every device routes all T tokens (the
    reference's capacity is global), fills the buffers of its experts (the
    ``model`` shard of E; the reference pins the buffers there), runs them,
    and all-gathers the (E, cap, d) outputs over ``model`` to combine (the
    buffer all-gather the reference's GSPMD lowering makes)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    B, L, d = x.shape
    T = B * L
    E = cfg.n_experts
    mesh = x.device_mesh
    name, M, mi = _model_axis(mesh)
    if name is None or E % M:
        M, mi = 1, None
    rep = [Replicate()] * mesh.ndim
    ew = [Shard(0) if i == mi else Replicate() for i in range(mesh.ndim)]
    keys = [k_ for k_ in ("w_gate", "w_up", "w_down") if k_ in p]
    shared = [k_ for k_ in ("router", "shared_gate", "shared_up", "shared_down") if k_ in p]
    xr = constrain(x, (None, None, None)).reshape(T, d)       # every token on every device
    ws = [p[k_].redistribute(mesh, ew) for k_ in keys]
    ss = [p[k_].redistribute(mesh, rep) for k_ in shared]
    def split(buf):
        return buf if mi is None else _SliceReplicated.apply(buf, mesh, mi)

    def gather(out_local):
        return out_local if mi is None else _GatherReplicated.apply(out_local, mesh, mi)

    def local(xf, *tensors):
        w = dict(zip(keys, tensors[:len(keys)]))
        q = dict(zip(shared, tensors[len(keys):]))
        experts = (w.get("w_gate"), w["w_up"], w["w_down"], split, gather)
        return _moe_gather(xf, q, cfg, experts)

    y, aux, dropped = local_map(
        local, (rep, rep, rep), in_placements=(rep,) + (ew,) * len(ws) + (rep,) * len(ss),
        device_mesh=mesh)(xr, *ws, *ss)
    y = constrain(y.reshape(B, L, d), ("batch", None, None))
    return y, MoEStats(aux, dropped)


def moe_ffn_a2a(x, p, cfg: ModelConfig):
    """Expert-parallel MoE with explicit all-to-all dispatch (GShard layout).

    Tokens are split over (dp..., model); each token shard routes its own
    tokens with a per-shard capacity ``max(4, cf * T_loc * k / E)``, fills a
    send buffer (M, E_loc, cap, d) — destination rank, local expert, slot, so
    no indices travel — and exchanges it over ``model`` with an all-to-all
    (``all_to_all_single``); the expert outputs return by a second one.  The
    load-balance loss is taken over all tokens; ``dropped_frac`` is 0, as in
    the reference.

    Falls back to ``moe_ffn`` exactly where the reference does: no mesh
    context, no model axis, a non-swiglu activation, E not dividing the
    model axis or T not dividing the token shards.  Under a mesh context the
    input must be a ``DTensor`` (a plain tensor has no mesh to split over).
    """
    axes = current_axes()
    E, k = cfg.n_experts, cfg.top_k
    if axes is None or axes.get("model") is None or cfg.act != "swiglu":
        return moe_ffn(x, p, cfg)
    if not is_dtensor(x):
        raise ValueError("moe_ffn_a2a under a mesh context takes DTensor inputs")
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..distributed.sharding import placements_for

    mesh = x.device_mesh
    dp = axes["batch"]
    model_ax = axes["model"]
    names = list(mesh.mesh_dim_names)
    mi = names.index(model_ax)
    M = mesh.size(mi)
    B, L, d = x.shape
    T = B * L
    n_tok_shards = M
    for a in dp:
        n_tok_shards *= mesh.size(names.index(a))
    if E % M != 0 or T % n_tok_shards != 0:
        return moe_ffn(x, p, cfg)
    E_loc = E // M
    T_loc = T // n_tok_shards
    cap = max(4, int(cfg.capacity_factor * T_loc * k / E))

    tok = list(placements_for(mesh, ((*dp, model_ax), None)))
    ew = [Shard(0) if i == mi else Replicate() for i in range(mesh.ndim)]
    rep = [Replicate()] * mesh.ndim
    part = [Partial()] * mesh.ndim
    xb = constrain(x, ("batch", None, None)).reshape(T, d)
    xf = xb.redistribute(mesh, tok)
    ws = [p[n].redistribute(mesh, ew) for n in ("w_gate", "w_up", "w_down")]
    router = p["router"].redistribute(mesh, rep)
    group = (mesh, mi)

    def a2a(t):
        shape = t.shape
        out = funcol.all_to_all_single_autograd(t.reshape(M, -1), None, None, group)
        return out.reshape(shape)

    def local_moe(xf_l, router_l, wg, wu, wd):
        t_l = xf_l.shape[0]
        logits = xf_l.float() @ router_l.float()
        probs = torch.softmax(logits, dim=-1)
        ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, idx = ranked.values[:, :k], ranked.indices[:, :k]
        gate = (gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)).to(xf_l.dtype)
        flat_e = idx.reshape(-1)                       # (t_l*k,)
        dst = flat_e // E_loc
        e_loc = flat_e % E_loc
        pos = (F.one_hot(flat_e, E).cumsum(0) - 1).gather(1, flat_e[:, None])[:, 0]
        keep = pos < cap
        tok_i = torch.arange(t_l, device=xf_l.device).repeat_interleave(k)
        # kept copies own distinct slots; the dropped ones go to a spare slot
        slot = (dst * E_loc + e_loc) * (cap + 1) + torch.where(keep, pos, cap)
        send = xf_l.new_zeros((M * E_loc * (cap + 1), d)).index_copy(0, slot, xf_l[tok_i])
        send = send.view(M, E_loc, cap + 1, d)[:, :, :cap]
        recv = a2a(send.contiguous())                  # (M_src, E_loc, cap, d)
        xbuf = recv.transpose(0, 1).reshape(E_loc, M * cap, d)
        obuf = _experts(xbuf, wg, wu, wd, cfg)
        oback = obuf.reshape(E_loc, M, cap, d).transpose(0, 1).contiguous()
        ret = a2a(oback)                               # (M_dst, E_loc, cap, d)
        routed = ret[dst, e_loc, torch.where(keep, pos, cap - 1)]
        y = _combine(routed, keep, gate, t_l, k)
        return y, probs.sum(dim=0), _counts(flat_e, E)

    # each device routes its own tokens, and its experts see the tokens of
    # its model group only: the router's gradient is a partial sum over the
    # whole mesh, the experts' over the dp axes
    ew_grad = [pl if i == mi else Partial() for i, pl in enumerate(ew)]
    y, psum, counts = local_map(
        local_moe, (tok, part, part), in_placements=(tok, rep, ew, ew, ew),
        in_grad_placements=(tok, part, ew_grad, ew_grad, ew_grad),
        device_mesh=mesh)(xf, router, *ws)

    y = constrain(y, ("batch", None)).reshape(B, L, d)
    if cfg.n_shared_experts:
        sh = _silu(xb @ p["shared_gate"]) * (xb @ p["shared_up"])
        y = y + (sh @ p["shared_down"]).reshape(B, L, d)

    me = psum.redistribute(mesh, rep) / T
    ce = counts.redistribute(mesh, rep) / (T * k)
    aux = E * torch.sum(me * ce)
    y = constrain(y, ("batch", None, None))
    return y, MoEStats(aux, replicate_like(torch.zeros((), device=y.device), y))


# ------------------------------------------------------------- Mamba-2 SSD
def ssd_chunked(xh, dt, A, Bm, Cm, *, chunk: int, initial_state=None):
    """Mamba-2 state-space-duality scan (arXiv:2405.21060, simplified SSD).

    xh: (B, L, H, P) inputs per head; dt: (B, L, H) positive step sizes;
    A: (H,) negative decay rates;  Bm/Cm: (B, L, G, S) input/output maps
    (G groups broadcast over heads).  Returns (y, final_state) with
    y: (B, L, H, P), state: (B, H, P, S) in f32.

    Within a chunk the quadratic (attention-dual) form is used; across
    chunks a linear state is carried.  The reference's three- and
    four-operand einsums are taken as an elementwise product of the small
    operands first, then one contraction (f32 throughout).
    """
    if is_dtensor(xh):
        # heads on `model` (the reference pins xh so), batch on the dp axes
        heads = [("batch", None, "model", None), ("batch", None, "model"), ("model",),
                 _batch_dims(Bm), _batch_dims(Cm)]
        st = ("batch", "model", None, None)
        B, L, H, P = xh.shape
        out = [(heads[0], xh.shape), (st, (B, H, P, Bm.shape[3]))]
        xs = [xh, dt, replicate_like(A, xh), Bm, Cm]
        # A is whole on every batch shard, Bm and Cm on every model shard,
        # which uses them in part: their gradients are partial sums there
        partial = {2: "batch", 3: "model", 4: "model"}
        if initial_state is None:
            return _local(lambda *t: ssd_chunked(*t, chunk=chunk), xs, heads, out, partial)
        return _local(lambda *t: ssd_chunked(*t[:5], chunk=chunk, initial_state=t[5]),
                      xs + [initial_state], heads + [st], out, partial)
    B, L, H, P = xh.shape
    G, S = Bm.shape[2], Bm.shape[3]
    if L % chunk:
        raise ValueError(f"sequence length {L} is not a multiple of the chunk {chunk}")
    nc = L // chunk
    rep = H // G

    xc = xh.reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H)
    Bc = Bm.reshape(B, nc, chunk, G, S).repeat_interleave(rep, dim=3)   # (B,nc,c,H,S)
    Cc = Cm.reshape(B, nc, chunk, G, S).repeat_interleave(rep, dim=3)

    dA = dtc * A                                         # (B,nc,c,H) negative
    cum = torch.cumsum(dA, dim=2)                        # within-chunk cumsum
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))

    state = (torch.zeros((B, H, P, S), dtype=torch.float32, device=xh.device)
             if initial_state is None else initial_state)
    ys = []
    for c in range(nc):
        xb, dtb, cumb = xc[:, c].float(), dtc[:, c], cum[:, c]
        Bb, Cb = Bc[:, c].float(), Cc[:, c].float()
        # --- intra-chunk (quadratic dual): causal kernel L[s,t]
        seg = cumb[:, :, None, :] - cumb[:, None, :, :]  # (B, s, t, H)
        # mask BEFORE exp: valid (t<=s) entries are <=0, masked -> 0.
        kern = torch.exp(torch.where(tri[None, :, :, None], seg, NEG_INF))
        qk = torch.einsum("bshn,bthn->bsth", Cb, Bb)
        att = qk * kern
        xdt = xb * dtb[..., None]                        # (B, c, H, P)
        y_intra = torch.einsum("bsth,bthp->bshp", att, xdt)
        # --- inter-chunk: contribution of carried state
        decay_in = torch.exp(cumb)                       # (B, c, H)
        y_inter = torch.einsum("bshn,bhpn->bshp", Cb * decay_in[..., None], state)
        # --- state update
        total = cumb[:, -1, :]                           # (B, H)
        decay_out = torch.exp(total[:, None, :] - cumb)  # (B, c, H)
        state_in = torch.einsum("bthn,bthp->bhpn", Bb,
                                xb * (dtb * decay_out)[..., None])
        state = state * torch.exp(total)[:, :, None, None] + state_in
        ys.append((y_intra + y_inter).to(xh.dtype))
    y = torch.stack(ys, dim=1).reshape(B, L, H, P)
    return y, state


def mamba_mixer(x, p, cfg: ModelConfig, *, state=None, return_state=False):
    """Mamba-2 block (in_proj -> conv1d -> SSD -> gated out_proj).

    x: (B, L, d_model).  When ``state`` is provided (decode), L may be 1 and
    (conv_state, ssm_state) are updated incrementally.
    """
    B, L, _ = x.shape
    H, P, S, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, 1
    d_in = cfg.d_inner
    conv_dim = d_in + 2 * G * S

    zxbcdt = constrain(x @ p["in_proj"], ("batch", None, "model"))
    # the split cuts across the model shards: whole rows first (identity
    # outside a mesh)
    zxbcdt = constrain(zxbcdt, ("batch", None, None))
    z, xbc, dt = torch.split(zxbcdt, [d_in, conv_dim, zxbcdt.shape[-1] - d_in - conv_dim],
                             dim=-1)
    t = dt.float() + p["dt_bias"]
    dt = torch.logaddexp(t, torch.zeros_like(t))         # jax.nn.softplus, (B, L, H)

    # causal depthwise conv over the sequence
    w = p["conv_w"]                                      # (K, conv_dim)
    K = w.shape[0]
    if state is None:
        pad = replicate_like(torch.zeros((B, K - 1, conv_dim), dtype=xbc.dtype,
                                         device=x.device), xbc)
        xb_pad = torch.cat([pad, xbc], dim=1)
        new_conv_state = xb_pad[:, -(K - 1):, :] if return_state else None
    else:
        xb_pad = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
        new_conv_state = xb_pad[:, -(K - 1):, :]
    conv = sum(xb_pad[:, i:i + L, :] * w[i][None, None, :] for i in range(K)) + p["conv_b"]
    conv = _silu(conv)

    xh = constrain(conv[..., :d_in].reshape(B, L, H, P), ("batch", None, "model", None))
    Bm = conv[..., d_in:d_in + G * S].reshape(B, L, G, S)
    Cm = conv[..., d_in + G * S:].reshape(B, L, G, S)
    A = -torch.exp(p["A_log"].float())                   # (H,) negative

    init_state = state["ssm"] if state is not None else None
    chunk = _largest_divisor(L, min(cfg.ssm_chunk, L))
    y, fin = ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk, initial_state=init_state)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, L, d_in) * _silu(z)
    out = y @ p["out_proj"]
    if return_state or state is not None:
        return out, {"conv": new_conv_state, "ssm": fin}
    return out, None
