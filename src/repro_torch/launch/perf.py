"""Variant ladders: named variants of the three chosen (arch x shape) pairs,
each recording hypothesis -> change -> before -> after (the reference's
``repro.launch.perf``).  Each variant re-traces its cell with the port's dry
run (``launch.dryrun.lower_cell``) and re-derives the roofline terms; the
records land in experiments/perf_torch/.  The hypotheses are the
reference's, written for its target; the port's records say what they come
to on the card's model (``distributed.analysis``).

  PYTHONPATH=src python -m repro_torch.launch.perf --pair moe
  PYTHONPATH=src python -m repro_torch.launch.perf --pair all [--device-type cpu]

The cells are traced on a fake world of ``--device-type`` (``cuda``, the
default, needs a card); a recorded baseline of another device type is
traced again.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from .dryrun import bytes_per_device, lower_cell

OUT = Path("experiments/perf_torch")
BASELINES = Path("experiments/dryrun_torch")

# Each entry: (variant_name, hypothesis, kwargs for lower_cell)
LADDERS = {
    # Worst roofline fraction + most collective-bound: expert-buffer
    # gather/scatter all-gathers the full (E,cap,d) buffers per layer/ub.
    "moe": {
        "arch": "qwen3-moe-235b-a22b",
        "shape": "train_4k",
        "multi_pod": False,
        "variants": [
            (
                "i1_micro4",
                "collective wire scales with microbatch count (per-ub FSDP "
                "gathers + MoE buffer all-gathers); 16->4 ubs should cut the "
                "collective term ~3-4x at ~2-3x activation memory",
                dict(n_micro_override=4),
            ),
            (
                "i2_micro4_a2a",
                "MoE dispatch/return via shard_map all-to-all moves only "
                "routed tokens (T*k*d bytes) instead of all-gathering "
                "(E,cap,d) buffers: predict ~10x lower MoE collective bytes",
                dict(n_micro_override=4, cfg_overrides=dict(moe_impl="a2a")),
            ),
            (
                "i3_micro2_a2a",
                "with a2a the per-ub collective floor is FSDP param gathers; "
                "fewer ubs amortize them further; memory should still fit",
                dict(n_micro_override=2, cfg_overrides=dict(moe_impl="a2a")),
            ),
            (
                "i4_micro8_a2a_cskip",
                "memory term is now co-dominant and attention-score traffic "
                "is half wasted on fully-masked causal tiles; the static "
                "lower-triangle pair scan halves attention flops+bytes, and "
                "8 ubs rebalance the carry memory that micro4 inflated",
                dict(n_micro_override=8,
                     cfg_overrides=dict(moe_impl="a2a", causal_skip=True)),
            ),
        ],
    },
    # Biggest dense model; collective-bound via FSDP gathers x 16 ubs + SP.
    "dense340b": {
        "arch": "nemotron-4-340b",
        "shape": "train_4k",
        "multi_pod": False,
        "variants": [
            (
                "i1_micro4",
                "FSDP all-gathers repeat per microbatch: 16->4 ubs cuts "
                "param-gather wire ~4x; carry memory rises ~4x (seq-sharded "
                "carries keep it within HBM)",
                dict(n_micro_override=4),
            ),
            (
                "i2_micro4_nosp",
                "ablate sequence-parallel carries: SP halves carry memory "
                "but adds h-sized all-gathers around every block; without "
                "SP collective should drop at higher memory",
                dict(n_micro_override=4, cfg_overrides=dict(seq_shard_carry=False)),
            ),
            (
                "i3_micro8_nosp",
                "pick the fit point: no-SP at 8 ubs balances carry memory "
                "vs per-ub gather traffic",
                dict(n_micro_override=8, cfg_overrides=dict(seq_shard_carry=False)),
            ),
            (
                "i4_micro8_nosp_cskip",
                "squared-ReLU 96-layer stack at 4k: attention tiles are "
                "~20% of memory traffic; causal tile skipping halves them",
                dict(n_micro_override=8,
                     cfg_overrides=dict(seq_shard_carry=False, causal_skip=True)),
            ),
            (
                "i5_sp_cskip",
                "no-SP variants beat the bound but blow HBM (carry stash); "
                "keep SP for fitment and take the free causal-skip win — "
                "the shipped configuration (i2-i4 recorded as perf upper "
                "bounds pending sqrt-remat of the layer scan)",
                dict(cfg_overrides=dict(causal_skip=True)),
            ),
            (
                "i6_micro8_nosp_cskip_sqrt",
                "the 96-layer carry stash is what forced SP: a two-level "
                "(12x8) sqrt-remat scan keeps only ~20 boundary carries, "
                "so the fast no-SP sharding should now FIT — predict i4's "
                "bound (~205s, 2.5x fraction) at roughly half the memory",
                dict(n_micro_override=8,
                     cfg_overrides=dict(seq_shard_carry=False,
                                        causal_skip=True, scan_levels=2)),
            ),
        ],
    },
    # Paper-representative: cross-pod DP traffic on arbitrated DWDM links;
    # small model where 16-way TP is pure overhead.
    "crosspod": {
        "arch": "internlm2-1.8b",
        "shape": "train_4k",
        "multi_pod": True,
        "variants": [
            (
                "i1_flat_fsdp",
                "[REFUTED v1: sharding batch over all 512 incl. model axis "
                "replicated activations (256 % 512 != 0) and exploded both "
                "terms] v2: 1.8B params need no TP -> flat FSDP params over "
                "(data x model), batch over (pod x data), carry seq-sharded "
                "over model: removes the 2-all-reduce-per-layer TP tax",
                dict(flat_fsdp=True,
                     cfg_overrides=dict(seq_shard_carry=True)),
            ),
            (
                "i2_flat_fsdp_micro1",
                "per-device batch is 8 sequences at micro=4; grad "
                "accumulation is pure overhead at this scale -> 1 ub "
                "amortizes the FSDP param gathers 4x",
                dict(flat_fsdp=True, n_micro_override=1,
                     cfg_overrides=dict(seq_shard_carry=True)),
            ),
            (
                "i3_flat_fsdp_micro1_dots",
                "small model: full remat recompute is ~25% of compute; "
                "'dots' policy saves matmul outputs (memory is ample) "
                "cutting recompute flops",
                dict(flat_fsdp=True, n_micro_override=1,
                     cfg_overrides=dict(seq_shard_carry=True, remat="dots")),
            ),
            (
                "i4_flat_fsdp_micro1_cskip",
                "with collectives fixed the cell turns memory-bound; "
                "causal tile skipping halves the dominant attention-score "
                "traffic",
                dict(flat_fsdp=True, n_micro_override=1,
                     cfg_overrides=dict(seq_shard_carry=True, remat="dots",
                                        causal_skip=True)),
            ),
        ],
    },
}


def run_ladder(name: str, out: Path = OUT, baselines: Path = BASELINES,
               device_type: str = "cuda"):
    spec = LADDERS[name]
    out.mkdir(parents=True, exist_ok=True)
    arch, shape, multi = spec["arch"], spec["shape"], spec["multi_pod"]
    mesh_tag = "multi" if multi else "single"

    def recorded(fp):
        rec = json.loads(fp.read_text()) if fp.exists() else None
        return rec if rec and rec.get("device_type") == device_type else None

    # baseline from the dry-run records (traced here when there is none of
    # this device type)
    baseline = recorded(baselines / f"{arch}__{shape}__{mesh_tag}.json")
    if baseline is None:
        baseline, _ = lower_cell(arch, shape, multi, device_type=device_type)
    rows = [("baseline", "recorded dry-run baseline", baseline)]

    for vname, hypothesis, kw in spec["variants"]:
        fp = out / f"{name}__{vname}.json"
        rec = recorded(fp)
        if rec is None:
            print(f"[perf:{name}] {vname}: tracing...", flush=True)
            try:
                rec, _ = lower_cell(arch, shape, multi, variant=vname,
                                    device_type=device_type, **kw)
            except Exception as e:
                rec = {"status": "fail", "device_type": device_type,
                       "error": f"{type(e).__name__}: {e}"}
            rec["hypothesis"] = hypothesis
            fp.write_text(json.dumps(rec, indent=1))
        rows.append((vname, hypothesis, rec))

    print(f"\n=== ladder {name}: {arch} x {shape} ({mesh_tag}, device type "
          f"{device_type}) ===")
    print(f"{'variant':26s} {'C[s]':>9s} {'M[s]':>9s} {'X[s]':>9s} "
          f"{'bound[s]':>9s} {'frac':>8s} {'mem GiB':>8s}")
    prev_bound = None
    for vname, hyp, rec in rows:
        if rec.get("status") != "ok":
            print(f"{vname:26s} FAILED: {str(rec.get('error', rec.get('status')))[:60]}")
            continue
        r = rec["roofline"]
        mem = bytes_per_device(rec) / 2**30
        bound = r["step_time_lower_bound_s"]
        delta = "" if prev_bound is None else f"  ({bound / prev_bound:.2f}x)"
        print(
            f"{vname:26s} {r['compute_s']:9.3f} {r['memory_s']:9.3f} "
            f"{r['collective_s']:9.3f} {bound:9.3f} "
            f"{r['roofline_fraction']:8.4f} {mem:8.1f}{delta}"
        )
        prev_bound = bound
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", choices=list(LADDERS) + ["all"], default="all")
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda",
                    help="device type of the fake world; cuda needs a card")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    if args.device_type == "cuda" and not torch.cuda.is_available():
        ap.error("--device-type cuda needs a CUDA card; pass --device-type cpu to trace as cpu")
    names = list(LADDERS) if args.pair == "all" else [args.pair]
    for n in names:
        run_ladder(n, Path(args.out), device_type=args.device_type)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
