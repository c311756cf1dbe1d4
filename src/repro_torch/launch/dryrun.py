"""Multi-pod dry run: trace one step of every (arch x input-shape x mesh)
cell on a ``"fake"`` process group of 256 or 512 ranks, prove the
distribution config is coherent (sharding, memory, collectives) and extract
the roofline terms (the reference's ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 placeholder host
devices.  The port runs eagerly: it initialises a ``"fake"`` world (one
process standing in for rank 0 of 256 or 512; collectives are no-ops),
builds the production mesh, places abstract parameters, moments and inputs
with the sharding rules under ``FakeTensorMode`` (shapes and dtypes, no
storage), and runs one train, prefill or decode step under the walker
(``distributed.hlo_walk``).  Nothing is compiled: a record has ``trace_s``
where the reference has ``compile_s``.

Loops are traced once and multiplied, as the reference multiplies a loop
body by its trip count: a train step traces one microbatch (its gradient
and its accumulation) times the microbatch count, then the update once; every step is traced at
one and at two super-blocks, and the per-super-block difference is taken
``n_super - 1`` times (flops, bytes, collectives and the live-bytes peak
alike).  Argument bytes are exact: the sum of one device's shard bytes of
the full-depth parameters, moments and inputs.

The fake world is of device type ``cuda`` unless ``--device-type cpu`` is
given (without a card ``cuda`` is refused).  DTensor plans some
redistributions differently for the two, so each record names its
``device_type``; only a ``cuda`` record stands for the card.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k --mesh both \
      --device-type cpu        # on a host without a card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs import ARCH_IDS, SHAPES, SHAPES_BY_NAME, applicable, get_config, microbatches_for
from ..distributed import analysis, hlo_walk, sharding, steps
from ..distributed.ctx import activation_axes
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw
from ..tree import tree_leaves, tree_map
from .mesh import _device_type, data_axes, make_production_mesh


def fake_world(n: int, device_type: str = "cuda") -> None:
    """A ``"fake"`` default process group of ``n`` ranks (this process is
    rank 0) for meshes of ``device_type`` (``"cuda"`` raises without a card;
    name ``"cpu"`` for a CPU world).  The dry run's entry points create it;
    an existing fake world of another size is replaced, and any other
    process group is refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    device_type = _device_type(device_type)

    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a 'fake' process group; one of backend "
                               f"{dist.get_backend()!r} is already initialised")
        dist.destroy_process_group()
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _fake(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def input_specs(cfg: ModelConfig, cell, mesh, dp=None, *, device=None):
    """Fake stand-ins for every model input of this cell, placed by the
    batch rules (call under ``FakeTensorMode``)."""
    B, L = cell.global_batch, cell.seq_len
    sh = sharding.batch_shardings(cfg, mesh, with_frontend=bool(cfg.frontend_len),
                                  batch=B, dp=dp)
    i64 = torch.int64
    text_len = L - (cfg.frontend_len if cfg.frontend_len else 0)
    if cell.kind == "train":
        batch = {"tokens": _fake((B, text_len), i64, device),
                 "labels": _fake((B, text_len), i64, device)}
    elif cell.kind == "prefill":
        batch = {"tokens": _fake((B, text_len), i64, device)}
    else:  # decode: one new token against a seq_len cache
        return sharding.shard_tree({"tokens": _fake((B, 1), i64, device)},
                                   {"tokens": sh["tokens"]})
    if cfg.frontend_len:
        batch["extra_embeds"] = _fake((B, cfg.frontend_len, cfg.d_model), torch.bfloat16, device)
    return sharding.shard_tree(batch, {k: sh[k] for k in batch})


def _abstract(tree, shardings, device):
    """Fake tensors of ``tree``'s shapes and dtypes placed by ``shardings``."""
    fake = tree_map(lambda t: _fake(tuple(t.shape), t.dtype, device)
                    if isinstance(t, torch.Tensor) else t, tree)
    return sharding.shard_tree(fake, shardings)


def _depth(cfg: ModelConfig, n_super: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern) * n_super)


def _trace_step(cfg, cell, mesh, dp, n_micro, flat_fsdp, device):
    """The cost of one step of ``cfg``, traced under a walker."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        params_sh = sharding.param_shardings(cfg, mesh, flat_fsdp=flat_fsdp)
        params = _abstract(M.param_shapes(cfg), params_sh, device)
        if cell.kind == "train":   # one microbatch's inputs
            cell = dataclasses.replace(cell, global_batch=cell.global_batch // n_micro)
        batch = input_specs(cfg, cell, mesh, dp=dp, device=device)
        walker = hlo_walk.Walker()
        with activation_axes(mesh, dp=dp):
            if cell.kind == "train":
                opt_cfg = adamw.AdamWConfig(moment_dtype=cfg.moment_dtype)
                opt = adamw.init(opt_cfg, params)
                with walker:
                    # make_train_step's flow, its microbatch loop traced once
                    adt = getattr(torch, cfg.accum_dtype)
                    acc = steps.accumulators(params, adt) if n_micro > 1 else None
                    with walker.repeat(n_micro):
                        _, _, grads = steps.micro_grads(cfg, params, batch)
                        if acc is not None:
                            steps.accumulate(acc, grads, adt)
                    if acc is not None:
                        del grads
                        grads = [a.div_(float(n_micro)) for a in acc]
                    adamw.apply(opt_cfg, params, _unflat(params, grads), opt)
            elif cell.kind == "prefill":
                with walker:
                    steps.make_prefill_step(cfg, max_len=cell.seq_len)(params, batch)
            else:
                state = M.init_decode_state(cfg, cell.global_batch, cell.seq_len, device="meta")
                state = _abstract(state, sharding.decode_state_shardings(
                    cfg, mesh, cell.global_batch), device)
                state = state._replace(pos=cell.seq_len - 1)
                with walker:
                    steps.make_decode_step(cfg)(params, state, batch["tokens"])
        return walker.cost


def _unflat(params, grads):
    from ..tree import tree_unflatten

    return tree_unflatten(params, list(grads))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_overrides: dict | None = None,
               n_micro_override: int | None = None,
               flat_fsdp: bool = False,
               variant: str = "baseline",
               device_type: str = "cuda"):
    """Trace one cell on the production mesh; returns (record, cost).  It
    creates the fake world of 256 (single) or 512 (multi) ranks the mesh
    needs (``fake_world``) for ``device_type`` (``"cuda"`` raises without a
    card; DTensor plans other redistributions for ``"cpu"``, so the record
    names the type it was traced with).

    cfg_overrides / n_micro_override / flat_fsdp parameterize the variant
    ladders (``launch.perf``); the defaults are the baseline."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cell = SHAPES_BY_NAME[shape_name]
    tag = {"arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod else "single",
           "device_type": _device_type(device_type)}
    runs, reason = applicable(cfg, cell)
    if not runs:
        return {**tag, "status": "skip", "reason": reason}, None

    fake_world(512 if multi_pod else 256, device_type)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    record, cost = trace_cell(cfg, cell, mesh, n_micro_override=n_micro_override,
                              flat_fsdp=flat_fsdp)
    return {**tag, "variant": variant, **record}, cost


def trace_cell(cfg: ModelConfig, cell, mesh, *, n_micro_override: int | None = None,
               flat_fsdp: bool = False):
    """One step of ``cfg`` on ``cell``'s inputs, traced on ``mesh`` (a
    ``DeviceMesh`` of the world the caller set up); returns (record, cost)."""
    dev_type = mesh.device_type
    device = torch.device(dev_type, 0) if dev_type == "cuda" else torch.device(dev_type)
    dp = data_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    n_dev = math.prod(sizes.values())
    n_data = math.prod(sizes[a] for a in dp)
    n_micro = n_micro_override or microbatches_for(cfg, cell, n_data)

    t0 = time.perf_counter()
    c1 = _trace_step(_depth(cfg, 1), cell, mesh, dp, n_micro, flat_fsdp, device)
    c2 = _trace_step(_depth(cfg, 2), cell, mesh, dp, n_micro, flat_fsdp, device)
    cost = c1.extrapolate(c2, cfg.n_super - 1)
    trace_s = time.perf_counter() - t0
    arg_bytes = _argument_bytes(cfg, cell, mesh, dp, flat_fsdp)

    coll = cost.collective_stats()
    model_flops = analysis.model_flops_estimate(cfg, cell)
    roof = analysis.roofline(cost.flops, cost.bytes, cost.collective_wire_bytes, n_dev,
                             model_flops, collective_s=cost.collective_s)
    record = {
        "status": "ok",
        "device_type": dev_type,
        "n_devices": n_dev,
        "trace_s": round(trace_s, 1),
        "params_total": M.count_params(cfg),
        "params_active": M.count_params(cfg, active_only=True),
        "memory": {
            "argument_size_in_bytes": sum(arg_bytes.values()),
            "temp_size_in_bytes": int(cost.peak_bytes),
            **arg_bytes,
        },
        "hlo_walk": {
            "flops": cost.flops,
            "bytes": cost.bytes,
            "n_ops_traced": c1.n_ops + c2.n_ops,
            "super_block_trips": cfg.n_super,
        },
        "collectives": {
            "ops": coll.per_type_ops,
            "wire_bytes": {k: float(v) for k, v in coll.per_type_bytes.items()},
            "total_wire_bytes": coll.total_wire_bytes,
        },
        "roofline": roof.as_dict(),
        "hardware": analysis.DEVICE,
    }
    if cell.kind == "train":
        record["n_microbatch"] = n_micro
    return record, cost


def _argument_bytes(cfg, cell, mesh, dp, flat_fsdp) -> dict:
    """One device's bytes of the step's arguments at full depth, by kind:
    parameters, optimizer state (moments and step, train), KV / SSM caches
    (decode) and inputs, each the sum of its shard shapes under the
    sharding rules."""
    def tree_bytes(tree, shardings):
        total = 0
        for t, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
            if isinstance(t, torch.Tensor):
                spec = tuple(sh.spec) + (None,) * (t.dim() - len(sh.spec))
                n = math.prod(sharding.NamedSharding(sh.mesh, spec).shard_shape(t.shape))
                total += n * t.element_size()
        return total

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    shapes = M.param_shapes(cfg)
    psh = sharding.param_shardings(cfg, mesh, flat_fsdp=flat_fsdp)
    out = {"parameter_bytes": tree_bytes(shapes, psh), "optimizer_bytes": 0,
           "cache_bytes": 0, "input_bytes": 0}
    B, L = cell.global_batch, cell.seq_len
    bsh = sharding.batch_shardings(cfg, mesh, with_frontend=bool(cfg.frontend_len), batch=B,
                                   dp=dp)
    text = L - cfg.frontend_len
    if cell.kind == "train":
        opt = adamw.init(adamw.AdamWConfig(moment_dtype=cfg.moment_dtype), shapes)
        out["optimizer_bytes"] = 2 * tree_bytes(opt.mu, psh) + opt.step.element_size()
        ins = {"tokens": (B, text), "labels": (B, text)}
    elif cell.kind == "prefill":
        ins = {"tokens": (B, text)}
    else:
        state = M.init_decode_state(cfg, B, L, device="meta")
        out["cache_bytes"] = tree_bytes(
            state.caches, sharding.decode_state_shardings(cfg, mesh, B).caches)
        ins = {"tokens": (B, 1)}
    if cfg.frontend_len and cell.kind != "decode":
        out["input_bytes"] += tree_bytes(
            [meta((B, cfg.frontend_len, cfg.d_model), torch.bfloat16)], [bsh["extra_embeds"]])
    for k, shape in ins.items():
        out["input_bytes"] += tree_bytes([meta(shape, torch.int64)], [bsh[k]])
    return out


def bytes_per_device(record) -> float:
    m = record.get("memory", {})
    return m.get("argument_size_in_bytes", 0) + m.get("temp_size_in_bytes", 0)


def run_cells(cells, meshes, outdir: Path, device_type: str = "cuda", log=print):
    """Trace each (arch, shape) on each mesh (False single, True multi);
    write ``<arch>__<shape>__<mesh>.json`` under ``outdir``; returns the
    records.  A cell that raises is recorded as ``fail``."""
    outdir.mkdir(parents=True, exist_ok=True)
    records = []
    for arch, shape_name in cells:
        for multi in meshes:
            tag = f"{arch}__{shape_name}__{'multi' if multi else 'single'}"
            fp = outdir / f"{tag}.json"
            try:
                record, _ = lower_cell(arch, shape_name, multi, device_type=device_type)
            except Exception as e:  # a dry-run failure is a bug in the port
                record = {
                    "arch": arch, "shape": shape_name,
                    "mesh": "multi" if multi else "single", "device_type": device_type,
                    "status": "fail", "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:],
                }
            fp.write_text(json.dumps(record, indent=1))
            records.append(record)
            if record["status"] == "ok":
                r = record["roofline"]
                log(f"[dryrun] {tag}: OK trace={record['trace_s']}s "
                    f"mem/dev={bytes_per_device(record) / 2**30:.2f}GiB "
                    f"terms(s): C={r['compute_s']:.4f} M={r['memory_s']:.4f} "
                    f"X={r['collective_s']:.4f} dom={r['dominant']}")
            elif record["status"] == "skip":
                log(f"[dryrun] {tag}: SKIP ({record['reason'][:60]}...)")
            else:
                log(f"[dryrun] {tag}: FAIL {record['error']}")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda",
                    help="device type of the fake world and tensors; cuda needs a card")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    if args.device_type == "cuda" and not torch.cuda.is_available():
        ap.error("--device-type cuda needs a CUDA card; pass --device-type cpu to trace as cpu")

    cells = ([(a, s.name) for a in ARCH_IDS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    t0 = time.perf_counter()
    records = run_cells(cells, meshes, Path(args.out), device_type=args.device_type,
                        log=lambda m: print(m, flush=True))
    counts = {s: sum(r["status"] == s for r in records) for s in ("ok", "skip", "fail")}
    print(f"[dryrun] {len(records)} cells in {time.perf_counter() - t0:.1f}s: {counts}")
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    if counts["fail"]:
        raise SystemExit(f"{counts['fail']} dry-run cells failed")


if __name__ == "__main__":
    main()
