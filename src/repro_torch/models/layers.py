"""Model layers: norms, rotary embedding, chunked (flash-style) attention,
dense/MoE FFNs, and the Mamba-2 SSD mixer.  Plain functional PyTorch;
parameters are plain dicts of tensors.  Compute in bf16, reductions/softmax
in fp32, as the reference (``repro.models.layers``) does.

The reference's ``preferred_element_type=float32`` products of two bf16
operands are computed here on operands upcast with ``.float()`` first: the
product of two bf16 values is exact in f32, so only the f32 summation order
differs.  ``moe_ffn_a2a`` (an all-to-all over a device mesh) comes with the
distribution slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

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


def flash_attention(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int,
                    q_offset: int = 0, causal_skip: bool = False):
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


# ----------------------------------------------------------------- FFNs
def dense_ffn(x, p, cfg: ModelConfig):
    if cfg.act == "swiglu":
        h = _silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.act == "squared_relu":
        h = torch.square(F.relu(x @ p["w_up"]))
    elif cfg.act == "gelu":
        h = _gelu(x @ p["w_up"])
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
    B, L, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * L
    cap = _capacity(cfg, T)
    xf = x.reshape(T, d)
    probs, gate, flat_e, pos, keep = _route(xf, p["router"], cfg, cap)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)

    slot = flat_e * (cap + 1) + torch.where(keep, pos, cap)
    buf = x.new_zeros((E * (cap + 1), d)).index_copy_(0, slot, xf[tok])
    buf = buf.view(E, cap + 1, d)[:, :cap]

    # expert computation
    if cfg.act == "swiglu":
        h = _silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    else:
        h = torch.square(F.relu(torch.bmm(buf, p["w_up"])))
    out_buf = torch.bmm(h, p["w_down"])                        # (E, cap, d)

    routed = out_buf[flat_e, torch.where(keep, pos, cap - 1)]   # (T*k, d)
    routed = torch.where(keep[:, None], routed, 0.0)
    w = (gate.reshape(-1) * keep).to(routed.dtype)
    routed = (routed * w[:, None]).reshape(T, k, d)
    y = routed[:, 0]
    for i in range(1, k):       # the reference's segment_sum adds in this order
        y = y + routed[:, i]

    if cfg.n_shared_experts:
        sh = _silu(xf @ p["shared_gate"]) * (xf @ p["shared_up"])
        y = y + sh @ p["shared_down"]

    # Switch-style load-balance auxiliary loss.
    me = probs.mean(dim=0)
    ce = torch.bincount(flat_e, minlength=E).float() / (T * k)
    aux = E * torch.sum(me * ce)
    dropped = 1.0 - keep.float().mean()
    return y.reshape(B, L, d), MoEStats(aux, dropped)


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

    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [d_in, conv_dim, zxbcdt.shape[-1] - d_in - conv_dim],
                             dim=-1)
    t = dt.float() + p["dt_bias"]
    dt = torch.logaddexp(t, torch.zeros_like(t))         # jax.nn.softplus, (B, L, H)

    # causal depthwise conv over the sequence
    w = p["conv_w"]                                      # (K, conv_dim)
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((B, K - 1, conv_dim), dtype=xbc.dtype, device=x.device)
        xb_pad = torch.cat([pad, xbc], dim=1)
        new_conv_state = xb_pad[:, -(K - 1):, :] if return_state else None
    else:
        xb_pad = torch.cat([state["conv"].to(xbc.dtype), xbc], dim=1)
        new_conv_state = xb_pad[:, -(K - 1):, :]
    conv = sum(xb_pad[:, i:i + L, :] * w[i][None, None, :] for i in range(K)) + p["conv_b"]
    conv = _silu(conv)

    xh = conv[..., :d_in].reshape(B, L, H, P)
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
