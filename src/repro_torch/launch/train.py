"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Without ``--production`` it trains the reduced same-family smoke config
(``get_smoke``), as the reference's launcher does on a host container, so
the full stack (pipeline -> step -> checkpointing -> optical fabric) runs
end to end.  ``--production`` trains the full config: on the 16 x 16
production mesh with the reference's parameter and optimizer shardings when
the caller's process group (``torchrun`` or ``init_process_group``) holds
256 ranks, else whole on one device; it prints the mesh it used.  The device
is CUDA unless ``--device`` names another (``cpu`` runs the kernels' plain
versions).
"""
from __future__ import annotations

import argparse
import tempfile

import torch.distributed as dist

from ..configs import ARCH_IDS, get_config, get_smoke
from ..core.sampling import resolve_device
from ..data.pipeline import DataConfig, TokenPipeline
from ..distributed import sharding, steps
from ..models import model as M
from ..optim import adamw
from ..runtime.trainer import Trainer, TrainerConfig
from .mesh import make_production_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--production", action="store_true",
                    help="full config: the 16x16 mesh in a 256-rank world, else one device")
    ap.add_argument("--device", default=None,
                    help="device to train on (default: CUDA, which must be present)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.production else get_smoke(args.arch)
    print(f"arch={cfg.name} params={M.count_params(cfg)/1e6:.1f}M device={device}")
    mesh, psh, osh = device, None, None
    if args.production and dist.is_initialized() and dist.get_world_size() >= 256:
        mesh = make_production_mesh(device_type=device.type)
        psh = sharding.param_shardings(cfg, mesh)
        osh = sharding.opt_shardings(psh, sharding.replicated(mesh))
    print(f"mesh: {mesh}")

    opt_cfg = adamw.AdamWConfig(
        warmup_steps=max(args.steps // 10, 1),
        decay_steps=args.steps,
        moment_dtype=cfg.moment_dtype,
    )
    step_fn = steps.make_train_step(cfg, opt_cfg, args.microbatch)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=max(args.steps // 2, 10),
        ckpt_dir=args.ckpt or tempfile.mkdtemp(prefix=f"repro_{args.arch}_"),
        log_every=max(args.steps // 10, 1),
    )
    trainer = Trainer(cfg, tcfg, opt_cfg, mesh, step_fn, psh, osh)
    fabric = trainer.bringup_fabric()
    print(f"optical fabric: {len(fabric.links)} links, "
          f"bw fraction {fabric.bandwidth_fraction:.3f}")

    data = TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch,
        frontend_len=cfg.frontend_len, d_model=cfg.d_model,
    ))
    try:
        state = trainer.init_state()
        state = trainer.fit(state, iter(data))
    finally:
        data.close()
    for m in trainer.metrics_log:
        print(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"{m['sec_per_step']:.2f}s/step")
    print(f"done at step {state.step}; ckpt={tcfg.ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
