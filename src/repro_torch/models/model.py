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

Under a mesh (``distributed.ctx.activation_axes``, with ``DTensor``
parameters placed by ``distributed.sharding``) the activations take the
reference's sharding constraints at its sites; outside one, ``constrain``
is the identity and every function runs on plain tensors as before.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as _ckpt

from ..core import prng
from ..core.sampling import resolve_device
from ..distributed.ctx import constrain, is_dtensor, pin_grad, replicate_like, spec_for
from ..kernels import threefry
from ..tree import tree_leaves, tree_map
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


def init_leaf(name: str, shape, dtype, key, *, start=None, length=None, device=None):
    """One leaf by the reference's rules (``init_params``), or the block of
    it at ``start`` of ``length`` (the whole leaf by default), drawn from
    the leaf's ``key`` on ``device`` (CUDA unless the caller names one):
    norms and ``D`` ones, ``conv_b`` and ``dt_bias`` zeros,
    ``A_log = log U[1, 16)``, the rest ``normal * float32(fan_in ** -0.5)``,
    cast to ``dtype``."""
    dev = resolve_device(device)
    shape = tuple(shape)
    length = shape if length is None else tuple(length)
    if "norm" in name or name == "D":
        return torch.ones(length, dtype=dtype, device=dev)
    if name in ("conv_b", "dt_bias"):
        return torch.zeros(length, dtype=dtype, device=dev)
    out = torch.empty(length, dtype=torch.float32, device=dev)
    if name == "A_log":
        # A in [1, 16) as in Mamba-2 reference init
        threefry.threefry_draw(out, key, shape, start, mode=threefry.UNIFORM, lo=1.0, hi=16.0)
        return out.log_().to(dtype)
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    threefry.threefry_draw(out, key, shape, start, mode=threefry.NORMAL, lo=threefry.NORMAL_LO,
                           hi=threefry.NORMAL_HI, scale=float(np.float32(fan_in ** -0.5)))
    return out.to(dtype)


def leaf_keys(seed_or_key, cfg: ModelConfig) -> Params:
    """Each leaf's raw key, in the parameters' tree: the reference's key
    (``jax.random.key(seed)`` for an int seed, else the raw (2,) uint32 key
    given) split over its leaves in its flatten order (sorted keys:
    ``blocks`` with each block's keys sorted, then ``embed``,
    ``final_norm``, ``lm_head``); every leaf uses up a key, the ones and
    zeros too."""
    if isinstance(seed_or_key, torch.Generator):
        raise TypeError("init_params: a torch.Generator cannot draw the reference's "
                        "parameters; pass the int seed or a raw (2,) uint32 key")
    key = prng.key_from_seed(seed_or_key) if isinstance(seed_or_key, (int, np.integer)) \
        else np.asarray(seed_or_key, dtype=np.uint32)
    if key.shape != (2,):
        raise ValueError("init_params: a seed (int) or a raw (2,) uint32 key, got "
                         f"{type(seed_or_key).__name__} of shape {key.shape}")
    shapes = param_shapes(cfg)
    # tree_map meets the leaves in the reference's flatten order
    keys = iter(prng.split(key, len(tree_leaves(shapes)), partitionable=True))
    return tree_map(lambda _: next(keys), shapes)


def init_params(seed_or_key, cfg: ModelConfig, *, device=None, shardings=None) -> Params:
    """The reference's ``init_params(jax.random.key(seed), cfg)``: each leaf
    drawn from its key (``leaf_keys``) by its rules (``init_leaf``) with
    ``jax.random``'s threefry counters (``kernels.threefry``: the CUDA
    kernel on the card, the plain version on the CPU).  Raw bits and
    uniforms are the reference's bit for bit and normals its eager draws'
    (XLA:CPU's ``erf_inv`` step by step), within 2 ulp of its jitted ones
    (XLA folds ``sqrt(2) * scale`` there); ``A_log``'s ``log`` is torch's,
    within an ulp.  ``seed_or_key`` is an int seed or a raw (2,) uint32 key;
    a ``torch.Generator`` cannot give these draws and is refused.  The
    device is CUDA unless the caller names one, and the default raises
    without CUDA.

    ``shardings`` (a ``distributed.sharding.param_shardings`` tree) draws
    each leaf as a ``DTensor``: each rank computes only the counters of its
    own block (``sharding.local_block``: torch's chunks, uneven ones too)
    and makes no tensor larger than that block, so a leaf larger than a
    device starts fresh; the values are those drawn without it.
    """
    keys = leaf_keys(seed_or_key, cfg)
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    names = {k: k for k in ("embed", "final_norm", "lm_head")}
    names["blocks"] = [{k: k for k in blk} for blk in shapes["blocks"]]

    def leaf(meta, name, key, sh=None):
        if sh is None:
            return init_leaf(name, meta.shape, meta.dtype, key, device=dev)
        from torch.distributed.tensor import DTensor

        from ..distributed.sharding import local_block

        placements, start, length = local_block(sh, meta.shape)
        local = init_leaf(name, meta.shape, meta.dtype, key, start=start, length=length,
                          device=dev)
        return DTensor.from_local(local, sh.mesh, placements, run_check=False,
                                  shape=meta.shape, stride=meta.stride())

    return tree_map(leaf, shapes, names, keys, *(() if shardings is None else (shardings,)))


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
_HDIMS = ("batch", None, "model", None)


def _heads(x, B: int, L: int, n: int, hd: int):
    """(B, L, n*hd) -> (B, L, n, hd) heads, constrained as the reference
    constrains them in training (prefill and decode take the same layout:
    the reference leaves those to GSPMD); on a ``DTensor`` the flat product
    is placed first so that the split keeps each sharded head whole."""
    if is_dtensor(x):
        heads_on_model = spec_for((B, L, n, hd), _HDIMS)[2] is not None
        x = constrain(x, ("batch", None, "model" if heads_on_model else None))
    return constrain(x.reshape(B, L, n, hd), _HDIMS)


def _merge_heads(o):
    """(B, L, H, hd) -> (B, L, H*hd), placed as ``_heads`` places it, so
    that the gradient of a product with a head-sharded weight comes back
    in a layout the split can take."""
    B, L, n, hd = o.shape
    x = o.reshape(B, L, n * hd)
    if is_dtensor(x):
        heads_on_model = spec_for((B, L, n, hd), _HDIMS)[2] is not None
        x = pin_grad(constrain(x, ("batch", None, "model" if heads_on_model else None)))
    return x


def _mixer(h, p, spec: BlockSpec, cfg: ModelConfig, positions):
    if spec.mixer == "attn":
        B, L, d = h.shape
        q = _heads(h @ p["wq"], B, L, cfg.n_heads, cfg.head_dim)
        k = _heads(h @ p["wk"], B, L, cfg.n_kv_heads, cfg.head_dim)
        v = _heads(h @ p["wv"], B, L, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = layers.rms_norm(q, p["q_norm"])
            k = layers.rms_norm(k, p["k_norm"])
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
        o = layers.flash_attention(
            q, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
            causal_skip=cfg.causal_skip,
        )
        return _merge_heads(o) @ p["wo"], None
    out, _ = layers.mamba_mixer(h, p, cfg)
    return out, None


def _ffn(h, p, spec: BlockSpec, cfg: ModelConfig):
    if spec.ffn == "dense":
        return layers.dense_ffn(h, p, cfg), torch.zeros((), dtype=torch.float32,
                                                        device=h.device)
    impl = layers.moe_ffn_a2a if cfg.moe_impl == "a2a" else layers.moe_ffn
    y, stats = impl(h, p, cfg)
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


def _residual(h, out, dims=("batch", None, None)):
    """``h + out``, both placed by ``dims`` on a mesh (the reference's
    constraint of the sum; ``out`` placed first, so that its gradient comes
    back in its own layout).  Plain ``h + out`` outside a mesh."""
    return constrain(h + constrain(out, dims), dims)


def _super_block(h, blk_params, cfg: ModelConfig, positions):
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    # the cast inside the block, as the reference's: under a checkpoint the
    # bf16 copies are recomputed in backward, not kept
    blk_params = _cast_tree(blk_params)
    hdims = ("batch", "model" if cfg.seq_shard_carry else None, None)
    # a sequence-sharded carry is gathered whole into each layer (sequence
    # parallelism); without it, and outside a mesh, ``whole`` is the identity
    whole = functools.partial(constrain, dims=("batch", None, None))
    h = constrain(h, hdims)
    for j, spec in enumerate(cfg.pattern):
        p = blk_params[j]
        mix, _ = _mixer(whole(layers.rms_norm(h, p["norm1"])), p, spec, cfg, positions)
        h = _residual(h, mix, hdims)
        if spec.ffn != "none":
            f, a = _ffn(whole(layers.rms_norm(h, p["norm2"])), p, spec, cfg)
            h = _residual(h, f, hdims)
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


def _embed(table, tokens):
    """Rows of ``table``.  On a ``DTensor`` table its model dim is gathered
    whole (an FSDP gather) and each device looks up its batch shard of the
    tokens; a vocabulary sharded over an axis is looked up in place
    (vocab-parallel): each device takes the rows in its range, zeros the
    others, and the rows are summed over that axis."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    rows = [Replicate() if pl.is_shard(1) else pl for pl in table.placements]
    table = table.redistribute(mesh, rows)
    tokens = replicate_like(tokens, table)
    vocab = [i for i, pl in enumerate(rows) if pl.is_shard(0)]
    tok = [Replicate() if i in vocab else pl for i, pl in enumerate(tokens.placements)]
    tokens = tokens.redistribute(mesh, tok)
    # the table's gradient: a partial sum over the axes that split the batch
    grad = [Partial() if t.is_shard() else r for t, r in zip(tok, rows)]
    if not vocab:
        # a whole vocabulary: the plain lookup on each batch shard
        return local_map(lambda t, i: t[i], tok, in_placements=(rows, tok),
                         in_grad_placements=(grad, tok), device_mesh=mesh)(table, tokens)
    (mi,) = vocab
    v_loc = table.to_local().shape[0]
    first = mesh.get_local_rank(mi) * v_loc

    def lookup(t, i):
        local = i - first
        here = (local >= 0) & (local < v_loc)
        part = torch.where(here[..., None], t[local.clamp(0, v_loc - 1)], 0.0)
        return layers.SumReplicated.apply(part, mesh, mi)

    grad[mi] = Shard(0)
    return local_map(lookup, tok, in_placements=(rows, tok), in_grad_placements=(grad, tok),
                     device_mesh=mesh)(table, tokens)


def embed_inputs(params: Params, cfg: ModelConfig, tokens, extra_embeds=None):
    h = _embed(params["embed"], tokens).to(COMPUTE)
    if cfg.frontend_len:
        if extra_embeds is None:
            raise ValueError(f"{cfg.name} needs frontend embeddings")
        h = torch.cat([extra_embeds.to(COMPUTE), h], dim=1)
    return constrain(h, ("batch", None, None))


def _ce_chunk(hh, lm_head, yy, mm):
    logits = constrain((hh @ lm_head).float(), ("batch", None, "model"))
    if is_dtensor(logits):
        return _ce_mesh(logits, yy, mm)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, yy[..., None].long())[..., 0]
    return ((lse - gold) * mm).sum()


def _ce_mesh(logits, yy, mm):
    """``_ce_chunk``'s sum on ``DTensor`` logits.  Logits whose vocabulary
    is whole on each device take the plain ops on their batch shards; a
    vocabulary sharded over ``model`` is reduced in place (vocab-parallel
    cross-entropy): the row max and the exp-sums are all-reduced, and each
    device picks the gold logits that fall in its vocabulary range."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    bat = [Replicate() if pl.is_shard(2) else pl for pl in logits.placements]
    yy, mm = (constrain(replicate_like(t, logits), ("batch", None)) for t in (yy, mm))
    vocab = [i for i, pl in enumerate(logits.placements) if pl.is_shard(2)]
    in_pl = (list(logits.placements), bat, bat)
    if not vocab:
        def plain(lg, y, m):
            lse = torch.logsumexp(lg, dim=-1)
            gold = lg.gather(-1, y[..., None].long())[..., 0]
            return (lse - gold) * m

        return local_map(plain, bat, in_placements=in_pl, device_mesh=mesh)(
            logits, yy, mm).sum()
    (mi,) = vocab
    v_loc = logits.to_local().shape[-1]
    first = mesh.get_local_rank(mi) * v_loc
    mx_pl = [Partial("max") if i == mi else pl for i, pl in enumerate(bat)]
    mx = local_map(lambda lg: lg.amax(-1).detach(), mx_pl, in_placements=(in_pl[0],),
                   device_mesh=mesh)(logits).redistribute(mesh, bat)
    sum_pl = [Partial() if i == mi else pl for i, pl in enumerate(bat)]

    def partial_sums(lg, m, y):
        local = y.long() - first
        here = (local >= 0) & (local < v_loc)
        gold = lg.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
        return torch.exp(lg - m[..., None]).sum(-1), torch.where(here, gold, 0.0)

    se, gold = local_map(partial_sums, (sum_pl, sum_pl), in_placements=(in_pl[0], bat, bat),
                         device_mesh=mesh)(logits, mx, yy)
    lse = mx + torch.log(se.redistribute(mesh, bat))
    return ((lse - gold.redistribute(mesh, bat)) * mm).sum()


def chunked_ce_loss(h, lm_head, labels, mask, chunk: int = 1024):
    """Cross-entropy without materializing (T, vocab) logits: a loop over
    sequence chunks, fp32 log-softmax, each chunk checkpointed so backward
    recomputes its logits."""
    B, L, d = h.shape
    chunk = layers._largest_divisor(L, min(chunk, L))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, L, chunk):
        # a sequence-sharded hidden state is gathered whole per chunk
        hh = constrain(h[:, c:c + chunk], ("batch", None, None))
        yy, mm = labels[:, c:c + chunk], mask[:, c:c + chunk]
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
    # replicated on the activations' mesh when they are DTensors
    hidden, aux = backbone(params, cfg, h, replicate_like(_positions(B, L, h.device), h))
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
        q = _heads(h @ p["wq"], B, 1, cfg.n_heads, cfg.head_dim)
        k = _heads(h @ p["wk"], B, 1, cfg.n_kv_heads, cfg.head_dim)
        v = _heads(h @ p["wv"], B, 1, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = layers.rms_norm(q, p["q_norm"])
            k = layers.rms_norm(k, p["k_norm"])
        posb = replicate_like(torch.full((B, 1), pos, dtype=torch.int32, device=h.device), h)
        q = layers.apply_rope(q, posb, cfg.rope_theta)
        k = layers.apply_rope(k, posb, cfg.rope_theta)
        _write_row(cache["k"], k[:, 0], pos)
        _write_row(cache["v"], v[:, 0], pos)
        o = layers.decode_attention(q, cache["k"], cache["v"], pos + 1)
        out = _merge_heads(o) @ p["wo"]
        return out, cache
    return layers.mamba_mixer(h, p, cfg, state=cache)


def _write_row(cache, row, pos: int):
    """``cache[:, pos] = row`` in place: (B, Lmax, KVH, hd) <- (B, KVH, hd).
    A ``DTensor`` cache is written on its local shards (the device whose
    sequence shard holds ``pos``), the row placed as the cache first."""
    if not is_dtensor(cache):
        cache[:, pos] = row
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = cache.device_mesh
    # cache dims (B, L, H, hd) -> row dims (B, H, hd); the sequence has none
    to_row = {0: 0, 2: 1, 3: 2}
    row_pl = [Shard(to_row[pl.dim]) if pl.is_shard() and pl.dim in to_row else Replicate()
              for pl in cache.placements]
    seq = [i for i, pl in enumerate(cache.placements) if pl.is_shard(1)]
    n_loc = cache.to_local().shape[1]
    first = 0
    for i in seq:           # nested sequence shards, in mesh order
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    first *= n_loc

    def write(c, r):
        if first <= pos < first + c.shape[1]:
            c[:, pos - first] = r
        return c

    local_map(write, list(cache.placements), in_placements=(list(cache.placements), row_pl),
              device_mesh=mesh)(cache, row.redistribute(mesh, row_pl))


def decode_step(params: Params, cfg: ModelConfig, state: DecodeState, tokens):
    """tokens: (B, 1) -> (logits (B, vocab), new state).

    ``state`` is left as it is: the new state's KV caches are a copy with
    row ``state.pos`` written.
    """
    h = _embed(params["embed"], tokens).to(COMPUTE)
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
            h = _residual(h, mix)
            if spec.mixer != "attn":
                mamba[j].append(nc)
            if spec.ffn != "none":
                f, _ = _ffn(layers.rms_norm(h, p["norm2"]), p, spec, cfg)
                h = _residual(h, f)
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
    positions = replicate_like(_positions(B, L, h.device), h)
    n = _n_super(params["blocks"])
    # on a mesh the KV rows are padded and stacked (a DTensor takes no
    # writes into a slice of a sharded buffer)
    on_mesh = is_dtensor(h)
    caches = []
    for spec in cfg.pattern:
        if spec.mixer == "attn" and not on_mesh:
            shp = (n, B, max_len, cfg.n_kv_heads, cfg.head_dim)
            caches.append({"k": torch.zeros(shp, dtype=COMPUTE, device=h.device),
                           "v": torch.zeros(shp, dtype=COMPUTE, device=h.device)})
        elif spec.mixer == "attn":
            caches.append({"k": [], "v": []})
        else:
            caches.append({"conv": [], "ssm": []})
    for s in range(n):
        blk = _super_params(params["blocks"], s)
        for j, spec in enumerate(cfg.pattern):
            p = blk[j]
            hn = layers.rms_norm(h, p["norm1"])
            if spec.mixer == "attn":
                q = _heads(hn @ p["wq"], B, L, cfg.n_heads, cfg.head_dim)
                k = _heads(hn @ p["wk"], B, L, cfg.n_kv_heads, cfg.head_dim)
                v = _heads(hn @ p["wv"], B, L, cfg.n_kv_heads, cfg.head_dim)
                if cfg.qk_norm:
                    q = layers.rms_norm(q, p["q_norm"])
                    k = layers.rms_norm(k, p["k_norm"])
                q = layers.apply_rope(q, positions, cfg.rope_theta)
                k = layers.apply_rope(k, positions, cfg.rope_theta)
                o = layers.flash_attention(
                    q, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk
                )
                h = _residual(h, _merge_heads(o) @ p["wo"])
                if on_mesh:
                    pad = (0, 0, 0, 0, 0, max_len - L)
                    caches[j]["k"].append(F.pad(k, pad).to(COMPUTE))
                    caches[j]["v"].append(F.pad(v, pad).to(COMPUTE))
                else:
                    caches[j]["k"][s, :, :L] = k
                    caches[j]["v"][s, :, :L] = v
            else:
                mix, st = layers.mamba_mixer(hn, p, cfg, return_state=True)
                h = _residual(h, mix)
                caches[j]["conv"].append(st["conv"].to(COMPUTE))
                caches[j]["ssm"].append(st["ssm"])
            if spec.ffn != "none":
                f, _ = _ffn(layers.rms_norm(h, p["norm2"]), p, spec, cfg)
                h = _residual(h, f)
    caches = tuple(c if spec.mixer == "attn" and not on_mesh
                   else {k: torch.stack(v) for k, v in c.items()}
                   for spec, c in zip(cfg.pattern, caches))
    h = layers.rms_norm(h, params["final_norm"])
    logits = (h[:, -1, :] @ params["lm_head"].to(COMPUTE)).float()
    return logits, DecodeState(caches=caches, pos=L)
