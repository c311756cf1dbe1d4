"""Fault-tolerant training runtime (the reference's
``repro.runtime.trainer``).

Composes the substrates: data pipeline -> train step (microbatched, remat'd
model) -> optimizer, with production behaviours:

  * periodic + emergency (SIGTERM) checkpointing (atomic, in the
    reference's files: either package restores the other's)
  * straggler detection: per-step wall-time EWMA; a step slower than
    ``straggler_factor`` x EWMA is counted
  * optical-fabric awareness: bring-up arbitration before the first step
    (``optics.interconnect`` on the trainer's device: on CUDA it launches
    the port's kernels); injected link-degradation events trigger warm
    re-arbitration.

The port has no 2-D mesh until its distribution slice: ``mesh`` is the
device the trainer runs on (``None`` means CUDA, which raises without it),
and ``param_shardings`` / ``opt_shardings`` must be ``None``.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..checkpoint import store
from ..configs.wdm import WDM8_G200
from ..core.sampling import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..optics import interconnect
from ..optim import adamw
from ..tree import tree_map


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    log_every: int = 10
    straggler_factor: float = 2.0
    n_microbatch: int = 1
    seed: int = 0
    # optical fabric
    pods: int = 2
    links_per_pod_pair: int = 8
    link_failure_prob_per_step: float = 0.0  # injected fault rate


@dataclasses.dataclass
class TrainerState:
    params: Any
    opt_state: adamw.OptState
    step: int = 0


class Trainer:
    def __init__(
        self,
        cfg: ModelConfig,
        tcfg: TrainerConfig,
        opt_cfg: adamw.AdamWConfig,
        mesh,
        train_step: Callable,
        param_shardings=None,
        opt_shardings=None,
    ):
        if param_shardings is not None or opt_shardings is not None:
            raise NotImplementedError(
                "Trainer: parameter and optimizer shardings over a device mesh come "
                "with the port's distribution slice; pass None (one device)")
        self.cfg, self.tcfg, self.opt_cfg = cfg, tcfg, opt_cfg
        self.mesh = mesh
        self.device  # noqa: B018 -- resolves now: no CUDA and no device named raises
        self.train_step = train_step
        self.fabric: Optional[interconnect.FabricState] = None
        self.metrics_log: list = []
        self.straggler_events = 0
        self.rearb_rounds = 0
        self._ewma: Optional[float] = None
        self._emergency = False
        self._rng = np.random.default_rng(tcfg.seed)

    @property
    def device(self) -> torch.device:
        """The device named by ``mesh``; CUDA (checked at each use) if None."""
        return resolve_device(self.mesh)

    # ------------------------------------------------------------ bring-up
    def bringup_fabric(self):
        """Wavelength-arbitrate every inter-pod optical link (paper §V)."""
        self.fabric = interconnect.bringup(
            pods=self.tcfg.pods,
            links_per_pod_pair=self.tcfg.links_per_pod_pair,
            cfg=WDM8_G200,
            scheme="vtrs_ssm",
            seed=self.tcfg.seed,
            device=self.device,
        )
        deg = self.fabric.degraded_links()
        if deg:
            self.fabric, rounds = interconnect.rearbitrate(
                self.fabric, WDM8_G200, seed=self.tcfg.seed + 1
            )
            self.rearb_rounds += rounds
        return self.fabric

    # ---------------------------------------------------------- init/restore
    def init_state(self) -> TrainerState:
        """The latest checkpoint's params and ``opt/`` state restored onto
        the trainer's device, or fresh ones (``init_params`` seeded with
        ``tcfg.seed``, zero moments)."""
        latest = store.latest_step(self.tcfg.ckpt_dir)
        abstract_p = M.param_shapes(self.cfg)
        if latest is not None:
            on_device = lambda tree: tree_map(lambda _: self.device, tree)  # noqa: E731
            params = store.restore(self.tcfg.ckpt_dir, latest, abstract_p,
                                   on_device(abstract_p))
            opt_abs = adamw.init(self.opt_cfg, abstract_p)
            opt = store.restore(Path(self.tcfg.ckpt_dir) / "opt", latest, opt_abs,
                                on_device(opt_abs))
            return TrainerState(params=params, opt_state=opt, step=latest)
        params = M.init_params(self.tcfg.seed, self.cfg, device=self.device)
        return TrainerState(params=params, opt_state=adamw.init(self.opt_cfg, params), step=0)

    def save(self, state: TrainerState):
        store.save(self.tcfg.ckpt_dir, state.step, state.params)
        store.save(Path(self.tcfg.ckpt_dir) / "opt", state.step, state.opt_state)

    # ------------------------------------------------------------- main loop
    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {k: torch.from_numpy(np.asarray(v)).to(self.device) for k, v in batch.items()}
        for k in ("tokens", "labels"):
            out[k] = out[k].long()
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, state: TrainerState, batches: Iterator[Dict[str, np.ndarray]]):
        """Train until ``tcfg.total_steps``; step time is the host clock from
        the batch's copy to the device to a synchronisation after the step."""
        tcfg = self.tcfg
        old = signal.signal(signal.SIGTERM, self._on_term)
        try:
            while state.step < tcfg.total_steps:
                batch = next(batches)
                t0 = time.perf_counter()
                params, opt, metrics = self.train_step(
                    state.params, state.opt_state, self._to_device(batch)
                )
                self._sync()
                dt = time.perf_counter() - t0
                state = TrainerState(params=params, opt_state=opt, step=state.step + 1)
                self._track_step_time(dt, state.step)
                self._maybe_link_event(state.step)
                if state.step % tcfg.log_every == 0:
                    self.metrics_log.append(
                        {"step": state.step,
                         "loss": float(metrics["loss"]),
                         "grad_norm": float(metrics["grad_norm"]),
                         "sec_per_step": dt}
                    )
                if state.step % tcfg.ckpt_every == 0 or self._emergency:
                    self.save(state)
                    if self._emergency:
                        break
        finally:
            signal.signal(signal.SIGTERM, old)
        return state

    # ------------------------------------------------------------- internals
    def _on_term(self, *_):
        self._emergency = True  # emergency checkpoint at next step boundary

    def _track_step_time(self, dt: float, step: int):
        if self._ewma is None:
            self._ewma = dt
        if dt > self.tcfg.straggler_factor * self._ewma and step > 3:
            self.straggler_events += 1
        self._ewma = 0.9 * self._ewma + 0.1 * dt

    def _maybe_link_event(self, step: int):
        if (
            self.fabric is not None
            and self.tcfg.link_failure_prob_per_step > 0
            and self._rng.random() < self.tcfg.link_failure_prob_per_step
        ):
            # knock lanes off a random link, then re-arbitrate in place
            i = int(self._rng.integers(len(self.fabric.links)))
            link = self.fabric.links[i]
            self.fabric.links[i] = dataclasses.replace(
                link, lanes_up=max(0, link.lanes_up - 2), failure="zero_lock"
            )
            self.fabric, rounds = interconnect.rearbitrate(
                self.fabric, WDM8_G200, seed=self.tcfg.seed + 997 + step
            )
            self.rearb_rounds += rounds
