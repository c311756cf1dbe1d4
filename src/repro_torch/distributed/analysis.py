"""Roofline terms of one step (the reference's ``repro.distributed.analysis``).

The reference reads FLOPs, bytes and collectives off compiled XLA artifacts;
the port has no HLO, so ``hlo_walk.analyze`` fills the same numbers from the
ops one step runs on a device's local shards (``CollectiveStats`` included),
and this module turns them into roofline terms.  ``_wire_bytes`` is the
reference's ring model, formula for formula.

Hardware model: NVIDIA H100 80GB HBM3 (SXM) at its 700 W limit — 989 TFLOP/s
dense bf16, 3.35 TB/s HBM, and a collective group's link bandwidth: NVLink,
450 GB/s a direction, within one 8-GPU node; one 400 Gb/s NIC (50 GB/s) per
GPU when the group spans nodes.  These are the card's datasheet peaks, not
measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

DEVICE = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989e12        # dense bf16 per card
HBM_BW = 3.35e12           # bytes/s per card
NVLINK_BW = 450e9          # bytes/s a direction per GPU, within an 8-GPU node
NIC_BW = 50e9              # bytes/s per GPU (one 400 Gb/s NIC) across nodes
ICI_BW = NVLINK_BW         # the chip-to-chip fabric: NVLink within a node
NODE_SIZE = 8              # GPUs per NVLink node


def _wire_bytes(op: str, out_bytes: int, g: int) -> float:
    """Per-device bytes on the wire, ring algorithms."""
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (g - 1) / g * out_bytes
    if op == "all-gather":
        return (g - 1) / g * out_bytes
    if op == "reduce-scatter":
        return (g - 1) * out_bytes          # input = g * output
    if op == "all-to-all":
        return (g - 1) / g * out_bytes
    if op == "collective-permute":
        return float(out_bytes)
    return 0.0


def link_bw(ranks: Iterable[int], node_size: int = NODE_SIZE) -> float:
    """Link bandwidth of a ring over ``ranks``: NVLink when every rank sits
    in one node (ranks ``node_size * n ..``), else the NIC, its slowest hop."""
    nodes = {r // node_size for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NIC_BW


@dataclasses.dataclass
class CollectiveStats:
    per_type_ops: Dict[str, int]
    per_type_bytes: Dict[str, float]    # per-device wire bytes
    total_wire_bytes: float


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_flops_ratio: float   # MODEL_FLOPS / (walked flops * devices)
    step_time_lower_bound_s: float
    roofline_fraction: float    # useful-compute time / max(term) — the score

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline(flops: float, byts: float, wire_bytes: float, n_devices: int,
             model_flops: float, *, peak_flops: float = PEAK_FLOPS,
             hbm_bw: float = HBM_BW, link_bw: float = ICI_BW,
             collective_s: float | None = None) -> Roofline:
    """All inputs per-device except model_flops (global).  ``collective_s``,
    when given, is the collective term already summed over groups at their
    own link bandwidths (``hlo_walk.HloCost.collective_s``); else it is
    ``wire_bytes / link_bw``."""
    compute_s = flops / peak_flops
    memory_s = byts / hbm_bw
    if collective_s is None:
        collective_s = wire_bytes / link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total = flops * n_devices
    bound = max(terms.values())
    useful_s = (model_flops / n_devices) / peak_flops
    return Roofline(
        flops_per_device=flops,
        bytes_per_device=byts,
        wire_bytes_per_device=wire_bytes,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / total) if total else 0.0,
        step_time_lower_bound_s=bound,
        roofline_fraction=(useful_s / bound) if bound else 0.0,
    )


def model_flops_estimate(cfg, cell, n_tokens: int | None = None) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for training;
    2*N*D for inference (fwd only)."""
    from ..models.model import count_params

    n_active = count_params(cfg, active_only=True)
    if cell.kind == "train":
        toks = cell.global_batch * cell.seq_len
        return 6.0 * n_active * toks
    if cell.kind == "prefill":
        toks = cell.global_batch * cell.seq_len
        return 2.0 * n_active * toks
    toks = cell.global_batch  # one token per sequence
    return 2.0 * n_active * toks
