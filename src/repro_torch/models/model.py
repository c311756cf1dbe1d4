"""Unified LM: parameter init, the training forward (a loop over super-blocks
with configurable remat), chunked cross-entropy, and the serving path
(prefill + single-token decode with KV / SSM caches).  The reference's
``repro.models.model``.

``cfg.remat`` and ``cfg.scan_levels`` change only what autograd saves for
the backward pass (``torch.utils.checkpoint``), never a forward value:
``"full"`` keeps each super-block's input and recomputes the block in
backward, ``"dots"`` also keeps the outputs of its 2-D weight products
(``aten.mm``), ``"none"`` keeps everything; ``scan_levels=2`` also
recomputes groups of ``_sqrt_factor(n_super)`` super-blocks, keeping only
the groups' inputs.  The cross-entropy recomputes each chunk's logits.

Parameters are a dict tree of tensors with the reference's keys, shapes and
dtypes: ``embed``, ``final_norm``, ``lm_head`` and ``blocks``, a list with
one dict per position of ``cfg.pattern`` whose leaves are stacked over the
``n_super`` super-blocks.  Every function runs on its parameters' device.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import torch
from torch.utils import checkpoint as _ckpt

from ..core.sampling import resolve_device
from . import layers
from .config import BlockSpec, ModelConfig

Params = Dict[str, Any]
COMPUTE = torch.bfloat16


# --------------------------------------------------------------------- init
def _block_shapes(cfg: ModelConfig, spec: BlockSpec) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.head_dim
    shapes: Dict[str, Tuple[int, ...]] = {"norm1": (d,)}
    if spec.mixer == "attn":
        shapes.update(
            wq=(d, cfg.n_heads * hd),
            wk=(d, cfg.n_kv_heads * hd),
            wv=(d, cfg.n_kv_heads * hd),
            wo=(cfg.n_heads * hd, d),
        )
        if cfg.qk_norm:
            shapes.update(q_norm=(hd,), k_norm=(hd,))
    else:  # mamba
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        shapes.update(
            in_proj=(d, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads),
            conv_w=(cfg.ssm_conv, conv_dim),
            conv_b=(conv_dim,),
            dt_bias=(cfg.ssm_heads,),
            A_log=(cfg.ssm_heads,),
            D=(cfg.ssm_heads,),
            out_proj=(cfg.d_inner, d),
        )
    if spec.ffn == "dense":
        shapes["norm2"] = (d,)
        if cfg.act == "swiglu":
            shapes.update(w_gate=(d, cfg.d_ff), w_up=(d, cfg.d_ff), w_down=(cfg.d_ff, d))
        else:
            shapes.update(w_up=(d, cfg.d_ff), w_down=(cfg.d_ff, d))
    elif spec.ffn == "moe":
        shapes["norm2"] = (d,)
        E, f = cfg.n_experts, cfg.d_ff
        shapes.update(router=(d, E))
        if cfg.act == "swiglu":
            shapes.update(w_gate=(E, d, f), w_up=(E, d, f), w_down=(E, f, d))
        else:
            shapes.update(w_up=(E, d, f), w_down=(E, f, d))
        if cfg.n_shared_experts:
            sf = f * cfg.n_shared_experts
            shapes.update(
                shared_gate=(d, sf), shared_up=(d, sf), shared_down=(sf, d)
            )
    return shapes


def param_shapes(cfg: ModelConfig) -> Params:
    """Abstract parameter tree: leaves are ``device="meta"`` tensors of the
    reference's shapes and dtypes (no storage)."""
    dt = getattr(torch, cfg.param_dtype)

    def leaf(shape):
        return torch.empty(shape, dtype=dt, device="meta")

    return {
        "embed": leaf((cfg.vocab, cfg.d_model)),
        "final_norm": leaf((cfg.d_model,)),
        "lm_head": leaf((cfg.d_model, cfg.vocab)),
        "blocks": [
            {k: leaf((cfg.n_super,) + shp) for k, shp in _block_shapes(cfg, spec).items()}
            for spec in cfg.pattern
        ],
    }


def _leaves(tree: Params):
    """(name, leaf) pairs in a fixed order: the top-level leaves, then each
    pattern position's in ``_block_shapes`` order."""
    for name in ("embed", "final_norm", "lm_head"):
        yield name, tree[name]
    for blk in tree["blocks"]:
        yield from blk.items()


def init_params(seed_or_generator, cfg: ModelConfig, *, device=None) -> Params:
    """Random parameters by the reference's leaf rules: norms are ones,
    ``A_log = log U[1, 16)``, ``conv_b`` and ``dt_bias`` zeros, ``D`` ones,
    and the rest ``normal * fan_in ** -0.5`` cast to ``cfg.param_dtype``.

    Draws from ``seed_or_generator`` (an int seed, or a ``torch.Generator``
    on the target device), leaf after leaf; it does not reproduce
    ``jax.random`` (carry the reference's parameters across with
    ``convert.lm_params_from_numpy``).  The device is CUDA unless the caller
    names one, and the default raises without CUDA.
    """
    dev = resolve_device(device)
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
    else:
        gen = torch.Generator(device=dev).manual_seed(int(seed_or_generator))

    def init_leaf(name, meta):
        shape, dt = tuple(meta.shape), meta.dtype
        if "norm" in name or name == "D":
            return torch.ones(shape, dtype=dt, device=dev)
        if name == "A_log":
            # A in [1, 16) as in Mamba-2 reference init
            u = torch.empty(shape, dtype=torch.float32, device=dev).uniform_(
                1.0, 16.0, generator=gen)
            return torch.log(u).to(dt)
        if name in ("conv_b", "dt_bias"):
            return torch.zeros(shape, dtype=dt, device=dev)
        fan_in = shape[-2] if len(shape) > 1 else shape[0]
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return w.mul_(fan_in ** -0.5).to(dt)

    shapes = param_shapes(cfg)
    out = {name: init_leaf(name, shapes[name]) for name in ("embed", "final_norm", "lm_head")}
    out["blocks"] = [{k: init_leaf(k, m) for k, m in blk.items()} for blk in shapes["blocks"]]
    return out


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count; active_only counts top-k of MoE experts."""
    total = 0
    for name, meta in _leaves(param_shapes(cfg)):
        n = meta.numel()
        if active_only and name in ("w_gate", "w_up", "w_down") and meta.dim() == 4:
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


# ------------------------------------------------------------------ blocks
def _mixer(h, p, spec: BlockSpec, cfg: ModelConfig, positions):
    if spec.mixer == "attn":
        B, L, d = h.shape
        q = (h @ p["wq"]).reshape(B, L, cfg.n_heads, cfg.head_dim)
        k = (h @ p["wk"]).reshape(B, L, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ p["wv"]).reshape(B, L, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = layers.rms_norm(q, p["q_norm"])
            k = layers.rms_norm(k, p["k_norm"])
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        o = layers.flash_attention(
            q, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            causal_skip=cfg.causal_skip,
        )
        return o.reshape(B, L, cfg.n_heads * cfg.head_dim) @ p["wo"], None
    out, _ = layers.mamba_mixer(h, p, cfg)
    return out, None


def _ffn(h, p, spec: BlockSpec, cfg: ModelConfig):
    if spec.ffn == "dense":
        return layers.dense_ffn(h, p, cfg), torch.zeros((), dtype=torch.float32,
                                                        device=h.device)
    if cfg.moe_impl == "a2a":
        raise NotImplementedError(
            f"{cfg.name}: moe_impl='a2a' (moe_ffn_a2a, an all-to-all dispatch over a "
            "device mesh) comes with the port's distribution slice; use "
            "moe_impl='gather'")
    y, stats = layers.moe_ffn(h, p, cfg)
    return y, stats.aux_loss


def _cast_tree(p, dtype=COMPUTE):
    """Cast float params to the compute dtype at point-of-use (master copies
    stay in cfg.param_dtype)."""
    if isinstance(p, dict):
        return {k: _cast_tree(v, dtype) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return type(p)(_cast_tree(v, dtype) for v in p)
    return p.to(dtype) if p.is_floating_point() else p


def _n_super(blocks) -> int:
    """The super-blocks the parameters stack (the reference's scan length)."""
    return next(iter(blocks[0].values())).shape[0]


def _super_params(blocks, s: int):
    """Super-block ``s``'s parameters, cast to the compute dtype."""
    return _cast_tree([{k: v[s] for k, v in blk.items()} for blk in blocks])


def _super_block(h, blk_params, cfg: ModelConfig, positions):
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    # the cast inside the block, as the reference's: under a checkpoint the
    # bf16 copies are recomputed in backward, not kept
    blk_params = _cast_tree(blk_params)
    for j, spec in enumerate(cfg.pattern):
        p = blk_params[j]
        mix, _ = _mixer(layers.rms_norm(h, p["norm1"]), p, spec, cfg, positions)
        h = h + mix
        if spec.ffn != "none":
            f, a = _ffn(layers.rms_norm(h, p["norm2"]), p, spec, cfg)
            h = h + f
            aux = aux + a
    return h, aux


#: ``cfg.remat`` -> the reference's ``jax.checkpoint_policies`` name (None:
#: save nothing).  ``"dots"`` saves the outputs of products without batch
#: dimensions, which are ``aten.mm`` here (an (B, L, d) @ (d, f) product
#: runs as one mm); the batched attention and SSD einsums and the MoE
#: ``bmm``s are recomputed.
_REMAT_POLICIES = {
    "full": None,  # save nothing
    "dots": "dots_with_no_batch_dims_saveable",
    "none": "everything_saveable",
}


def _save_mm(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``"dots"``."""
    if op is torch.ops.aten.mm.default:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _checkpoint(fn, *args, **kwargs):
    """``fn(*args)`` recomputed in backward (non-reentrant checkpoint);
    called as it is when autograd is off."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kwargs)


def _maybe_remat(fn, cfg: ModelConfig):
    if cfg.remat == "none":
        return fn
    policy = _REMAT_POLICIES[cfg.remat]
    if policy is None:
        return functools.partial(_checkpoint, fn)
    ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts, _save_mm)
    return functools.partial(_checkpoint, fn, context_fn=ctx)


# ----------------------------------------------------------------- forward
def _sqrt_factor(n: int) -> int:
    """Divisor of n closest to sqrt(n) (outer scan length)."""
    best = 1
    for d in range(1, n + 1):
        if n % d == 0 and abs(d - n ** 0.5) < abs(best - n ** 0.5):
            best = d
    return best


def backbone(params: Params, cfg: ModelConfig, h, positions):
    """Run the block stack on embeddings h (B, L, d) -> (hidden, aux_loss).

    Each stacked leaf is unbound into its super-blocks once, so backward
    stacks each leaf's gradient in one op (indexing it per super-block
    would zero-fill a whole leaf for every super-block).
    """
    n = _n_super(params["blocks"])
    slices = [{k: v.unbind(0) for k, v in blk.items()} for blk in params["blocks"]]

    def block_params(s):
        return [{k: t[s] for k, t in blk.items()} for blk in slices]

    body = _maybe_remat(lambda carry, xs: _super_block(carry, xs, cfg, positions), cfg)

    def run(h, first, count):
        aux = []
        for s in range(first, first + count):
            h, a = body(h, block_params(s))
            aux.append(a)
        return h, torch.stack(aux)

    if cfg.scan_levels == 2 and n > 3:
        # sqrt-remat: only group-boundary carries are kept; the checkpointed
        # group recomputes its inner carries in backward.  The per-block
        # aux losses are summed once, in block order, at every remat setting.
        outer = _sqrt_factor(n)
        inner = n // outer
        aux = []
        for g in range(outer):
            h, a = _checkpoint(run, h, g * inner, inner)
            aux.append(a)
        aux = torch.cat(aux)
    else:
        h, aux = run(h, 0, n)
    return layers.rms_norm(h, params["final_norm"]), torch.sum(aux)


def embed_inputs(params: Params, cfg: ModelConfig, tokens, extra_embeds=None):
    h = params["embed"][tokens].to(COMPUTE)
    if cfg.frontend_len:
        if extra_embeds is None:
            raise ValueError(f"{cfg.name} needs frontend embeddings")
        h = torch.cat([extra_embeds.to(COMPUTE), h], dim=1)
    return h


def _ce_chunk(hh, lm_head, yy, mm):
    logits = (hh @ lm_head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, yy[..., None].long())[..., 0]
    return ((lse - gold) * mm).sum()


def chunked_ce_loss(h, lm_head, labels, mask, chunk: int = 1024):
    """Cross-entropy without materializing (T, vocab) logits: a loop over
    sequence chunks, fp32 log-softmax, each chunk checkpointed so backward
    recomputes its logits."""
    B, L, d = h.shape
    chunk = layers._largest_divisor(L, min(chunk, L))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, L, chunk):
        hh, yy, mm = h[:, c:c + chunk], labels[:, c:c + chunk], mask[:, c:c + chunk]
        tot, cnt = tot + _checkpoint(_ce_chunk, hh, lm_head, yy, mm), cnt + mm.sum()
    return tot / torch.clamp_min(cnt, 1.0)


def _positions(B: int, L: int, device):
    return torch.arange(L, dtype=torch.int32, device=device)[None, :].expand(B, L)


def loss_fn(params: Params, cfg: ModelConfig, batch, aux_weight: float = 0.01):
    """batch: dict(tokens (B,L) int, labels (B,L) int, extra_embeds?).

    Frontend positions (if any) carry no loss.
    """
    tokens = batch["tokens"]
    h = embed_inputs(params, cfg, tokens, batch.get("extra_embeds"))
    B, L, _ = h.shape
    hidden, aux = backbone(params, cfg, h, _positions(B, L, h.device))
    labels = batch["labels"]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    if cfg.frontend_len:  # prepend ignore for frontend positions
        pad_lab = torch.zeros((B, cfg.frontend_len), dtype=labels.dtype, device=h.device)
        labels = torch.cat([pad_lab, labels], dim=1)
        mask = torch.cat([torch.zeros((B, cfg.frontend_len), device=h.device), mask], dim=1)
    ce = chunked_ce_loss(hidden, params["lm_head"].to(COMPUTE), labels, mask)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# ------------------------------------------------------------------- serve
class DecodeState(NamedTuple):
    """Per-pattern-position caches, each stacked over n_super blocks.

    ``pos``, the current length, is a host int (the reference carries a
    0-d int32 array): ``decode_step`` writes the cache row and masks the
    attention by it without reading anything back from the device.
    """

    caches: Tuple[Any, ...]   # attn: dict(k, v); mamba: dict(conv, ssm)
    pos: int


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=None) -> DecodeState:
    """Zero caches; CUDA unless the caller names a device."""
    dev = resolve_device(device)
    caches = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            shp = (cfg.n_super, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            caches.append({"k": torch.zeros(shp, dtype=COMPUTE, device=dev),
                           "v": torch.zeros(shp, dtype=COMPUTE, device=dev)})
        else:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            caches.append({
                "conv": torch.zeros((cfg.n_super, batch, cfg.ssm_conv - 1, conv_dim),
                                    dtype=COMPUTE, device=dev),
                "ssm": torch.zeros((cfg.n_super, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state), dtype=torch.float32, device=dev),
            })
    return DecodeState(caches=tuple(caches), pos=0)


def _mixer_decode(h, p, spec, cfg, cache, pos: int):
    """One-token mixer.  h: (B, 1, d).  An attention layer writes its key and
    value into row ``pos`` of ``cache`` in place (``decode_step`` hands it
    a copy of the state's caches); a Mamba layer returns its new state."""
    B = h.shape[0]
    if spec.mixer == "attn":
        q = (h @ p["wq"]).reshape(B, 1, cfg.n_heads, cfg.head_dim)
        k = (h @ p["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
        v = (h @ p["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = layers.rms_norm(q, p["q_norm"])
            k = layers.rms_norm(k, p["k_norm"])
        posb = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
        q = layers.apply_rope(q, posb, cfg.rope_theta)
        k = layers.apply_rope(k, posb, cfg.rope_theta)
        cache["k"][:, pos] = k[:, 0]
        cache["v"][:, pos] = v[:, 0]
        o = layers.decode_attention(q, cache["k"], cache["v"], pos + 1)
        out = o.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
        return out, cache
    return layers.mamba_mixer(h, p, cfg, state=cache)


def decode_step(params: Params, cfg: ModelConfig, state: DecodeState, tokens):
    """tokens: (B, 1) -> (logits (B, vocab), new state).

    ``state`` is left as it is: the new state's KV caches are a copy with
    row ``state.pos`` written.
    """
    h = params["embed"][tokens].to(COMPUTE)
    pos = state.pos
    caches = [{k: t.clone() for k, t in c.items()} if spec.mixer == "attn" else c
              for spec, c in zip(cfg.pattern, state.caches)]
    for spec, c in zip(cfg.pattern, caches):
        if spec.mixer == "attn" and pos >= c["k"].shape[2]:
            raise ValueError(f"decode position {pos} is past the cache's "
                             f"{c['k'].shape[2]} rows")
    mamba = {j: [] for j, spec in enumerate(cfg.pattern) if spec.mixer != "attn"}
    for s in range(_n_super(params["blocks"])):
        blk = _super_params(params["blocks"], s)
        for j, spec in enumerate(cfg.pattern):
            p = blk[j]
            mix, nc = _mixer_decode(layers.rms_norm(h, p["norm1"]), p, spec, cfg,
                                    {k: t[s] for k, t in caches[j].items()}, pos)
            h = h + mix
            if spec.mixer != "attn":
                mamba[j].append(nc)
            if spec.ffn != "none":
                f, _ = _ffn(layers.rms_norm(h, p["norm2"]), p, spec, cfg)
                h = h + f
    for j, states in mamba.items():
        caches[j] = {k: torch.stack([st[k] for st in states]) for k in ("conv", "ssm")}
    h = layers.rms_norm(h, params["final_norm"])
    logits = (h[:, 0, :] @ params["lm_head"].to(COMPUTE)).float()
    return logits, DecodeState(caches=tuple(caches), pos=pos + 1)


def prefill(params: Params, cfg: ModelConfig, tokens, max_len: int,
            extra_embeds=None):
    """Batched prompt ingestion: returns (last-token logits, DecodeState)."""
    h = embed_inputs(params, cfg, tokens, extra_embeds)
    B, L, _ = h.shape
    if max_len < L:
        raise ValueError(f"max_len {max_len} is shorter than the prompt's {L} positions")
    positions = _positions(B, L, h.device)
    n = _n_super(params["blocks"])
    caches = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            shp = (n, B, max_len, cfg.n_kv_heads, cfg.head_dim)
            caches.append({"k": torch.zeros(shp, dtype=COMPUTE, device=h.device),
                           "v": torch.zeros(shp, dtype=COMPUTE, device=h.device)})
        else:
            caches.append({"conv": [], "ssm": []})
    for s in range(n):
        blk = _super_params(params["blocks"], s)
        for j, spec in enumerate(cfg.pattern):
            p = blk[j]
            hn = layers.rms_norm(h, p["norm1"])
            if spec.mixer == "attn":
                q = (hn @ p["wq"]).reshape(B, L, cfg.n_heads, cfg.head_dim)
                k = (hn @ p["wk"]).reshape(B, L, cfg.n_kv_heads, cfg.head_dim)
                v = (hn @ p["wv"]).reshape(B, L, cfg.n_kv_heads, cfg.head_dim)
                if cfg.qk_norm:
                    q = layers.rms_norm(q, p["q_norm"])
                    k = layers.rms_norm(k, p["k_norm"])
                q = layers.apply_rope(q, positions, cfg.rope_theta)
                k = layers.apply_rope(k, positions, cfg.rope_theta)
                o = layers.flash_attention(
                    q, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk
                )
                h = h + o.reshape(B, L, cfg.n_heads * cfg.head_dim) @ p["wo"]
                caches[j]["k"][s, :, :L] = k
                caches[j]["v"][s, :, :L] = v
            else:
                mix, st = layers.mamba_mixer(hn, p, cfg, return_state=True)
                h = h + mix
                caches[j]["conv"].append(st["conv"].to(COMPUTE))
                caches[j]["ssm"].append(st["ssm"])
            if spec.ffn != "none":
                f, _ = _ffn(layers.rms_norm(h, p["norm2"]), p, spec, cfg)
                h = h + f
    caches = tuple(c if spec.mixer == "attn" else {k: torch.stack(v) for k, v in c.items()}
                   for spec, c in zip(cfg.pattern, caches))
    h = layers.rms_norm(h, params["final_norm"])
    logits = (h[:, -1, :] @ params["lm_head"].to(COMPUTE)).float()
    return logits, DecodeState(caches=caches, pos=L)
