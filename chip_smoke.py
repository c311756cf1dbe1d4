#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py [--seed S] [--profile | --lm-controls N]

Needs one CUDA card and the CUDA toolkit.  Phases, each fatal on failure:

1. build    compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. kernels  hold each kernel against its plain PyTorch version on the same
            inputs at the main paths' shapes and at edge cases, exactly
            (float32 bit for bit): ``feasibility`` and ``table_build``
            against plain versions run on the CPU, ``match``, ``bottleneck``
            and ``probe`` against plain versions run on the card (WDM8 to
            WDM64, random bitmasks with bits 31 and 63 set, tie-heavy integer
            weights, a ragged 10,007-trial edge; for ``match`` also staircase
            graphs (BFS of up to N - 1 levels, walk-backs of N steps) and
            graphs where two rings of a level reach one line, at N = 8, 16,
            32 and 64, random bitmasks at N = 5, 12, 33 and 40 (at 5 and 12
            also with bits above N set), the temporal path's WDM16 hot-swap
            adjacency at TR 4.48 with a dead lane and a dead ring, and WDM64
            ragged at 10,007 trials; for ``feasibility`` also
            random systems at N = 13 and 40 with a permuted s, ragged edges at
            N = 8 and 16, and NaN and +-inf inputs, held against the plain
            version on the card bit for bit and on the CPU up to the NaN's
            bits; for ``bottleneck`` tie-heavy integers at N = 5, 8, 16, 33,
            64, ragged edges at N = 8 and 16, and rows of +inf weights; for
            ``table_build`` TR 2, 8.96 and 20 with 2-D and 3-D masks at
            WDM8/16/32, WDM64 (E = 192), the ragged edge, the temporal path's
            WDM16 (T, N, N) mask of a hot-swap step, and grid-quantized
            tie-heavy systems at max_alias 1, 3 and 8 and at N = 13 (E = 39)
            where most rows hold more window candidates than E; for ``probe``
            C = 1 and 4 rows, E = 39 rows on and off 16-byte alignment,
            floors -1, 0, E and E + 3, line ids >= L, all-taken and
            all-invalid rows, and every re-search of the first two rounds of
            a WDM16 protocol run); and ``table_build`` and ``match`` at the
            sweep engine's flattened sizes (fig4's 8 x 12 grid at WDM8 as one
            batch of 960,000 trials, 30 points of the WDM32 TR axis as
            300,000 trials with 7.4 GB of tables), held on the first and the
            last 10,007 trials; and at the fabric paths' shapes
            (``phase_fabric_kernels``): ``table_build`` at fig21's 2,016
            WDM16 trials with the (T, N, N) mask of a chaos step whose dead
            links (and a dead comb) give all-False masks, ``probe`` on those
            empty tables, ``match`` with the all-zero rows of dead rings and
            links, and ``feasibility`` at the same trials; and the
            interconnect's warm-repair tables: ``table_build`` on the
            runtime's 2,016 WDM16 trials with the 2-D (T, N) mask of links
            100 and 1,007 dead (all-False rows), and ``probe`` on them; and
            the draw kernel ``threefry`` (``phase_draw_kernel``) against its
            plain version on the CPU in its three modes (raw words and
            uniforms bit for bit, normals within ``DRAW_F32_ULP``) on ragged
            blocks, one of them past counter 2**32;
3. main     drive each ported path with the launch counts set to 0 just
            before and read just after (each kernel's ``launches`` in the
            kernels line is its sum over the paths; the paths run in the
            three process groups of ``PHASE_GROUPS``, side by side on the
            card and beside phase 2, so their own times are taken under
            that load, the timing phase's alone after them), at 100 x 100 = 10,000
            trials: the paper's LtC path (``evaluate_scheme`` for seq,
            rs_ssm and vtrs_ssm, ``evaluate_policy`` and ``policy_min_tr`` for
            ltc and ltd) at WDM8_G200 natural and permuted and WDM32_G200 natural;
            the LtA path (``evaluate_policy`` and ``policy_min_tr`` for lta
            at WDM8 natural and permuted, WDM16 and WDM32; the five
            ``seq_retry*`` schemes at WDM8 natural and permuted and
            ``seq_retry`` at WDM16 and WDM32), at TR 8.96; the protocol path
            (the five ``protocol_*`` schemes at WDM8 natural and permuted at
            TR 8.96 and at fig19's TR 3.436, ``protocol_lta`` at WDM16 and
            WDM32, ``run_protocol`` with stats for the depth ladder 1, 2, 4,
            None at WDM8); and the temporal path (``run_timeline`` warm and
            cold on the wdm16-thermal and wdm16-hotswap drift scenarios at
            TR = 4 x grid spacing); and the sweep path (``phase_sweep``: the
            fig4, fig14, fig5 and fig19 grids, a WDM32 TR axis and a timeline
            sweep, each a chunk of grid points run as one batch of trials,
            held against the same grid one point a chunk, against the port's
            per-point ``sweep_reference`` on a sub-grid, and timed); the
            fabric path (``phase_fabric``: ``bringup`` of the 1,008-link and
            10,080-link fabrics, fig21's grid for seq_retry, vtrs_ssm and
            protocol_lta against the same grid one point a chunk, fig21's
            constraints-off parity on all 1,008 links); and the chaos path
            (``phase_chaos``: fig22's four scenarios warm and cold,
            ``tiny-flap`` and a 1,008-link flap timeline, the no-fault
            parity); the interconnect runtime (``phase_interconnect``:
            ``optics.interconnect`` on 1,008 links with a comb per link,
            vtrs_ssm, WDM8 at TR 4.6 and WDM16 at TR 0.40 FSR: bringup,
            rearbitrate, inject_link_failure of links 100 and 1,007,
            rearbitrate, expected_failure_rates, each step held against the
            CPU plain path on all 1,008 links); and campaign checkpoints
            (``phase_campaign``: the temporal path's two scenarios split at
            step 4, saved, restored onto the card and resumed, equal to the
            uninterrupted runs); and the observability path (``phase_obs``:
            the flight recorder in ``run_protocol`` at WDM16 and WDM32 and in
            a hot-swap timeline, each equal to its untraced run, fig19's WDM16
            ``seq_retry`` failure taxonomy with no ``unknown`` residual,
            fig22's health matrices, fig14's grid and fig21's bring-up under
            a phase recorder with their device watermarks, and a manifest of
            it all rendered by the report); and the multi-device paths
            (``phase_mesh``: fig14's seq, fig5's WDM32 min_tr("lta") and
            fig19's protocol_lta grids through ``sweep(mesh=)``, FABRIC_1K
            ``bringup(mesh=)`` and a FABRIC_MID ``run_fabric_timeline(mesh=,
            health=True)`` on ``make_sweep_mesh()`` and on 2- and 3-way
            placeholder meshes over cuda:0, each bit for bit against the
            unsharded run; ``restore(shardings=)`` of a CPU-saved campaign
            checkpoint onto the card; the reference's public surface imported
            from the port, and a deprecated ``sigma_rlv=`` call); and the LM
            serving path (``phase_lm``: every smoke config's ``loss_fn``,
            ``prefill`` and 3 ``decode_step``s card against CPU, and decode
            against a longer prefill; internlm2-1.8b and mamba2-130m whole and
            one full-width super-block of qwen3-moe-235b-a22b serving waves
            of prompts, timed, each super-block and a shallow prefill + decode
            held against the CPU; its parameters are drawn on the card by the
            ``threefry`` kernel, the reference's draws from the seed, and it
            launches none of the five arbitration kernels); and
            the training path (``phase_train``: every smoke config's
            gradients and a 2-microbatch ``make_train_step`` card against
            CPU, internlm2-1.8b whole for 4 ``Trainer`` steps with the
            fabric's bring-up and repairs on the kernels and its fresh start
            drawn by ``threefry`` (timed, with its peak), a depth-2
            full-width step against the CPU, whose every leaf's last 65,536
            counters the card drew are held against the CPU plain version's
            (``_draw_hold``: float32 within 4 ulp, bf16 within 1 bf16 ulp;
            also the bf16 qwen3-moe super-block's), a mamba2-130m run split by a
            checkpoint and resumed, a qwen3-moe-235b-a22b super-block with
            bf16 moments); and the distribution path (``phase_dist``:
            internlm2-1.8b whole through the sharded ``Trainer`` on a one-rank
            1 x 1 mesh, bit for bit with the unsharded one; the a2a MoE of a
            full-width qwen3-moe-235b-a22b super-block against the CPU; the
            dry run of the Trainer's cell on a fake 1-rank world and of four
            production cells on fake worlds of 256 and 512 ranks).  Per-trial results on a 20 x 20 subset (per-link
            results on a subset of links) are held against the CPU plain
            path, and every call is timed.  Then ``BENCH_sweep.json``'s
            fig4, fig5, fig14, fig17 and fig19 records are recomputed on the
            card from units drawn as the benchmarks drew them
            (``phase_records``), exactly as counts of 576 trials, and its
            fig21 and fig22 records after their rounding;
4. timing   each kernel and its plain version alone at WDM8, WDM16 and WDM32
            (``match`` also at WDM16, TR 4.48, the temporal path's input;
            ``threefry`` at one super-block of internlm2-1.8b's ``wq`` and at
            its whole embedding, ``draw_timing``),
            beside its bound: the kernel's device time per launch from a
            ``torch.profiler`` trace, the wrapper's time per call from CUDA
            events over back-to-back calls (which holds the host's cost of
            issuing each call), and the plain version's time per call.

``--profile`` runs the build and then, in place of phases 2 to 4, traces
protocol calls, the LM serving path's prefill and decode and one train step
with ``torch.profiler`` to show where their time goes (see
``phase_profile``); it prints no kernels or result line.

The last three lines of standard output are the card's name and power limit
(``nvidia-smi``), one JSON object of the kernels, and the result line
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TR = 8.96                      # paper Table I mean tuning range [nm]
MAIN_CELLS = (("wdm8-g200", "natural"), ("wdm8-g200", "permuted"),
              ("wdm32-g200", "natural"))
SCHEMES = ("seq", "rs_ssm", "vtrs_ssm")
POLICIES = ("ltc", "ltd")
LTA_POLICY_CELLS = (("wdm8-g200", "natural"), ("wdm8-g200", "permuted"),
                    ("wdm16-g200", "natural"), ("wdm32-g200", "natural"))
RETRY_SCHEMES = ("seq_retry", "seq_retry_r1", "seq_retry_r2", "seq_retry_r4",
                 "seq_retry_phys")
LTA_SCHEME_CELLS = {("wdm8-g200", "natural"): RETRY_SCHEMES,
                    ("wdm8-g200", "permuted"): RETRY_SCHEMES,
                    ("wdm16-g200", "natural"): ("seq_retry",),
                    ("wdm32-g200", "natural"): ("seq_retry",)}
PROTOCOL_SCHEMES = ("protocol_lta", "protocol_lta_h1", "protocol_lta_h2",
                    "protocol_lta_h4", "protocol_ltd")
PROTOCOL_ORDERS = ("natural", "permuted")
DEPTHS = (1, 2, 4, None)       # fig19's chain-depth ladder (None = N hops)
DRIFT_CELLS = ("wdm16-thermal", "wdm16-hotswap")
TEMPORAL_TR_X = 4.0            # fig20's operating point, in grid spacings
N_SIDE = 100                   # 100 lasers x 100 rings = 10,000 trials
SUB_SIDE = 20                  # CPU-checked subset: 20 x 20 trials
RECORD_SIDE = 24               # BENCH_sweep.json's trials: 24 x 24 = 576
#: The seed of each benchmark whose records the sweep phase holds.
RECORD_SEEDS = {"fig4": 4, "fig5": 5, "fig14": 9, "fig17": 17, "fig19": 21}
FIG5_RLV_X = (0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0)   # in grid spacings
FIG4_CASES = (("LtA-N/A", "lta", "natural"), ("LtA-P/A", "lta", "permuted"),
              ("LtC-N/N", "ltc", "natural"), ("LtC-P/P", "ltc", "permuted"),
              ("LtD-N/N", "ltd", "natural"))
FIG17_SCHEMES = ("seq_retry_r1", "seq_retry_r2", "seq_retry_r4", "seq_retry",
                 "seq_retry_phys")
FIG19_SCHEMES = ("seq_retry", "protocol_lta_h1", "protocol_lta_h2", "protocol_lta_h4",
                 "protocol_lta")
FIG21_TRS_X = (0.40, 0.46)           # fig21's TR axis, in FSRs
FIG21_SCHEMES = ("seq_retry", "vtrs_ssm", "protocol_lta")
FIG22_SCENARIOS = ("mid-linkflap", "mid-combout", "mid-podheat", "mid-ringdeath")
#: fig22's schemes per scenario (``benchmarks/fig22_fabric_chaos.py``, default mode).
FIG22_SCHEMES = {"mid-linkflap": FIG21_SCHEMES}
FABRIC_SEED = 33                     # the fabric benchmarks' seed
#: Links of a fabric held against the CPU plain path: the first bundle's
#: first links, links 100 and 101 (100 is the one fig22's 1,008-link
#: timeline flaps) and the last 12 (the last bundle's, on FABRIC_1K).
FABRIC_SUBSET = tuple(range(0, 12)) + (100, 101) + tuple(range(-12, 0))
#: The interconnect runtime's operating points: the trainer's WDM8 fabric at
#: the reference tests' TR 4.6 nm, and WDM16 at fig21's TR 0.40 FSR (None:
#: in FSRs), and the links ``phase_interconnect`` kills.
RUNTIME_POINTS = (("wdm8-g200", 4.6, None), ("wdm16-g200", None, 0.40))
RUNTIME_DEAD = (100, 1007)
CAMPAIGN_SPLIT = 4                   # after hot-swap's lane kill (3), before its swap (6)
OBS_CAP = 128                        # fig19's flight-recorder capacity (trace_cap)
OBS_TIMELINE_CAP = 64
#: fig19's WDM16 TR points (of 12, 3.487-11.505 nm) whose seq_retry residuals
#: phase_obs classifies: the band where most of them lie (points 0 and 1 hold
#: 0 and 4 residuals at 10,000 trials, 8-11 a tail of 2,060-280); the other
#: six are left out to keep the phase near 90 s.
OBS_TAX_POINTS = (2, 3, 4, 5, 6, 7)
#: The reference's public surface that ``phase_mesh`` imports from the port:
#: the 62 re-exports of ``repro.core`` and ``repro.fabric.__all__``
#: (``tests/test_torch_surface.py`` holds these lists to the reference's).
SURFACE_CORE = (
    "POLICIES", "ArbitrationConfig", "DWDMGrid", "VariationModel", "natural_order",
    "permuted_order", "wdm_config", "AxisSpec", "Variations", "axis_names", "axis_spec",
    "register_axis", "SystemBatch", "UnitSamples", "draw_unit_samples", "instantiate",
    "sample_systems", "reach_matrix", "scaled_residual", "tuning_residual", "SCHEME_POLICY",
    "SCHEMES", "EvalResult", "SchemeSpec", "evaluate_policy", "evaluate_scheme",
    "make_protocol", "make_seq_retry", "make_units", "oblivious_arbitrate", "policy_min_tr",
    "register_scheme", "register_scheme_family", "registered_schemes", "scheme_spec", "shmoo",
    "ProtocolState", "ProtocolStats", "cold_state", "masked_first_entry", "revalidate_state",
    "run_protocol", "run_protocol_trace", "TemporalStats", "Timeline", "make_timeline",
    "restore_campaign", "run_timeline", "save_campaign", "slice_timeline", "SweepRequest",
    "SweepResult", "sweep", "sweep_grid", "sweep_grid_reference", "sweep_min_tr",
    "sweep_policy", "sweep_reference", "sweep_scheme", "Outcome", "classify", "Assignment",
)
SURFACE_FABRIC = (
    "FabricChaosStats", "FabricResult", "FabricSpec", "FabricStats", "FabricTimeline",
    "FabricUnits", "LinkEval", "aggregate_stats", "auto_link_chunk", "bringup",
    "fabric_stats_impl", "instantiate_link", "link_record", "make_fabric_timeline",
    "make_fabric_units", "run_fabric_timeline", "run_fabric_timeline_impl",
    "state_from_assignment", "summarize_chaos",
)
MESH_SIZES = (2, 3)                  # placeholder meshes: k x cuda:0
MESH_LINK_CHUNK = 256                # FABRIC_1K's 1,008 links in 4 chunks
MESH_CHAOS = ("mid-linkflap", "vtrs_ssm", 24)   # 48 links in 2 chunks of 24
#: The LM serving cells (``phase_lm``): each arch's request waves as (prompts,
#: prompt tokens), each prefilled as one batch and decoded greedily, and the
#: depth its end-to-end card-against-CPU check keeps (None = all; every
#: super-block is also held on the CPU's input).  qwen3-moe-235b-a22b runs
#: one super-block at full width (its 94 would take 470 GB of bf16).
LM_CELLS = (("internlm2-1.8b", None, ((4, 2048), (2, 256)), 32, 2),
            ("mamba2-130m", None, ((4, 2048), (2, 256)), 32, None),
            ("qwen3-moe-235b-a22b", 1, ((4, 512),), 8, None))
#: The path phases of step 3 in groups, each group one process of its own
#: (``--group``) beside the others on the card: the host-bound paths take
#: most of the script's time, and the host's speed moves it up to 2x.  A
#: phase needs only phases before it in its group; ``chaos`` runs in two
#: (``phase_mesh`` and ``phase_obs`` both hold its runs) and counts once.
PHASE_GROUPS = {
    "timelines": ("temporal", "chaos", "campaign", "obs"),
    "grids": ("main", "sweep", "fabric", "chaos", "interconnect", "mesh"),
    "models": ("lta", "protocol", "lm", "train", "dist"),
}
GROUP_RESULT = "[group result] "
LM_TOL = 2e-2                        # card against CPU, rtol and atol
LM_SPREAD_X = 2.0                    # full width: within 2 x a perturbation's spread
#: Super-blocks: each token's difference within 1.5 x the spread of the
#: CPU's block under a bf16 rounding of its input (``_lm_layers``).  On an
#: H100, sound runs read 0.45-0.86 at seeds 0-7 and a 2^-6 change of one
#: ``w_gate`` or ``in_proj`` leaf 1.73-18.9 (``--lm-controls 8``, PERF.md
#: section 6).
LM_BLOCK_X = 1.5
# H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
#: The draw kernel (``kernels/threefry.py``): the most elements of a leaf
#: drawn again on the CPU for the card-against-CPU hold; the float32
#: operations of one normal draw (uniform 4, ``x * -x`` 2, ``log1p`` 31,
#: ``erf_inv`` 19 and the two products; an FMA counts 2); the largest gaps
#: allowed between the card's draws and the CPU's, in float32 and bf16 ulps.
DRAW_HOLD = 65536
NORMAL_FLOPS = 57
DRAW_F32_ULP = 4
DRAW_BF16_ULP = 1


def host_launch_us(n: int = 20000) -> float:
    """The host's microseconds for one tiny CUDA op, launched and
    synchronised once at the end: the unit the host-bound phases are paid
    in, which differs between hosts and moves the script's wall time."""
    import torch

    x = torch.zeros(8, device="cuda")
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def bits(x):
    """float32 tensor -> its int32 bit pattern on the CPU."""
    import torch

    return x.detach().cpu().contiguous().view(torch.int32)


def compare(name: str, got, want, errs: list) -> None:
    """Exact comparison; float32 outputs bit for bit.  Records max |diff|."""
    import torch

    got, want = got.detach().cpu(), want.detach().cpu()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
    if got.dtype == torch.float32:
        both = torch.isfinite(got) & torch.isfinite(want)
        err = (got[both].double() - want[both].double()).abs().max().item() \
            if both.any() else 0.0
        errs.append(err)
        n_bad = int((bits(got) != bits(want)).sum())
    else:
        errs.append(float((got.long() - want.long()).abs().max()) if got.numel() else 0.0)
        n_bad = int((got != want).sum())
    if n_bad:
        fail(f"{name}: {n_bad} of {got.numel()} elements differ from the plain version")


def cuda_ms(fn, reps: int) -> float:
    """Steady-state milliseconds per call by CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str) -> float:
    """Device milliseconds per launch of the kernel named ``kernel`` over
    ``reps`` calls of ``fn`` after one warm-up, from a ``torch.profiler``
    trace: the kernel's own time, without the host's cost of issuing it.
    The mean is over the launches the trace holds (it can miss some); a
    trace that holds fewer than half is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and kernel in e.key]
        count = sum(e.count for e in hits)
        if count >= reps // 2:
            return sum(e.self_device_time_total for e in hits) / count / 1e3
        print(f"[time] the profiler traced {count} launches of {kernel} in {reps} calls")
    fail(f"three profiler traces held fewer than {reps // 2} launches of {kernel}")


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulp_gap(got, want) -> int:
    """The largest distance between two float32 (or bf16) CPU tensors in
    ulps of their type, by their order-preserving integer images."""
    import torch

    width = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[got.dtype]
    sign = 1 << (8 * got.element_size() - 1)

    def ordered(t):
        i = t.contiguous().view(width).long()
        return torch.where(i < 0, -(i & (sign - 1)), i)

    return int((ordered(got) - ordered(want)).abs().max()) if got.numel() else 0


def feasibility_cost(t: int, n: int) -> tuple[float, float]:
    """Bytes: 4 (T, N) float32 inputs and s read, 2 (T,) outputs written.
    Operations: sub, remainder, divide and max per residual; min per shift."""
    return 4 * t * n * 4 + n * 4 + 2 * t * 4, 4 * t * n * n + t * n


def table_cost(t: int, n: int, e: int, n_j: int, vis_bytes: int = 0) -> tuple[float, float]:
    """Bytes: 4 (T, N) float32 inputs (+ mask) read; delta, wl (T, N, E) and
    n_valid (T, N) written.  Operations: laser - ring per (ring, line), then
    j * fsr, a subtraction and two window compares per candidate."""
    return (4 * t * n * 4 + vis_bytes + t * n * e * 8 + t * n * 4,
            t * n * n + 4 * t * n * n * n_j)


def match_search(adj) -> tuple[list, int, list, list]:
    """The matching's search on these inputs, transcribed serially on the
    host, to count what it needs: (match_wl rows, operations, BFS levels
    beyond level 0 per ring, walk-back steps per ring).  Operations: per ring
    one test of its word against the matched lines; per deeper level one
    masked word per ring whose line is in the frontier; one update per
    walk-back step."""
    t, n = adj.shape
    mask = (1 << n) - 1
    lowest = lambda w: (w & -w).bit_length() - 1  # noqa: E731
    out, ops, levels, steps = [], 0, [], []
    for row in adj.cpu().tolist():
        words = [w & mask for w in row]
        match_wl, parent, matched = [-1] * n, [-1] * n, 0
        for i in range(n):
            free = words[i] & ~matched
            if free:                         # level 0: a path of one edge
                parent[lowest(free)] = i
            frontier = visited = 0 if free else words[i]
            for k in range(n):
                if frontier >> k & 1:
                    parent[k] = i
            depth = 0
            while frontier:                  # deeper levels, rings in order
                depth += 1
                reached = 0
                for r in range(n):
                    if match_wl[r] >= 0 and frontier >> match_wl[r] & 1:
                        ops += 1
                        fresh = words[r] & ~(visited | reached)
                        for k in range(n):
                            if fresh >> k & 1:
                                parent[k] = r
                        reached |= fresh
                visited |= reached
                free = reached & ~matched
                frontier = 0 if free else reached
            k, n_steps = lowest(free), 0
            if free:
                matched |= 1 << k
            while k >= 0:
                n_steps += 1
                r = parent[k]
                prev, match_wl[r] = match_wl[r], k
                k = -1 if r == i or prev < 0 else prev
            ops += 1 + n_steps
            levels.append(depth)
            steps.append(n_steps)
        out.append(match_wl)
    return out, ops, levels, steps


def match_cost(t: int, n: int, n_ops: int) -> tuple[float, float]:
    """Bytes: the adjacency at the function's own size, N bits per ring
    (ceil(N / 8) bytes; the port's int64 words read more), read; match_wl
    (T, N) int32 and ok (T,) written.  Operations: ``match_search``'s count
    on these inputs."""
    return t * n * -(-n // 8) + t * n * 4 + t, n_ops


def bottleneck_cost(t: int, n: int) -> tuple[float, float]:
    """Bytes: (T, N, N) float32 weights read, (T,) written.  Operations: the
    first selection of each ring, N compares, N rings; the further steps
    and relaxations depend on the data (the search stops early) and are not
    counted."""
    return t * n * n * 4 + t * 4, t * n * n


def probe_cost(wl, taken, floor, first, found) -> tuple[float, float, float]:
    """Bytes and operations of a first-visible search on this run's data.
    Bytes: of each row, the 32-byte sectors from its floor to its first
    visible entry (to its end if none is; none if the floor is past it), the
    trial's taken mask (L bytes) and floors (C * 4) read; first (C * 4) and
    found (C) written.  Operations: three integer compares per scanned entry.
    Third: the bytes with whole rows (T * C * E * 4) read in place of the
    sectors, for comparison."""
    import torch

    t, c, e = wl.shape
    start = floor.long().clamp(min=0)
    end = torch.where(found, first.long(), torch.full_like(start, e - 1))
    idx = torch.arange(e, device=wl.device)
    read = ((idx >= start[..., None]) & (idx <= end[..., None])).reshape(-1)
    read = torch.nn.functional.pad(read, (0, -read.numel() % 8))
    sectors = int(read.reshape(-1, 8).any(dim=1).sum())   # 8 int32 per sector
    fixed = t * (taken.shape[1] + c * 4) + t * c * 5
    return 32 * sectors + fixed, 3 * int(read.sum()), t * c * e * 4 + fixed


def tr_sweep(n_ch: int = 8, spacing: float = 1.12):
    """The benchmarks' TR axis (``benchmarks/common.py``, copied: the card's
    machine has no JAX): 12 points from 0.25 grid spacings to the FSR."""
    import numpy as np

    return np.linspace(0.25 * spacing, n_ch * spacing, 12).astype(np.float32)


def low_tr() -> float:
    """fig19's TR point 4: 3.436 nm, where seq_retry leaves residual CAFP."""
    return float(tr_sweep()[4])


def rlv_sweep(spacing: float = 1.12):
    """The benchmarks' sigma_rLV axis (``benchmarks/common.py``, copied)."""
    import numpy as np

    return np.array([0.25, 0.5, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0], np.float32) * spacing


def flat_grid(cfg, units, axes):
    """A grid's points flattened into one batch, as the sweep engine runs
    them: (system batch of P * T trials, per-trial TR (P * T,))."""
    import torch

    from repro_torch.core.sampling import instantiate, per_trial
    from repro_torch.core.sweep import _grid_points
    from repro_torch.core.variations import Variations

    names, points, _ = _grid_points(axes)
    var = Variations(**{n: torch.from_numpy(points[:, i].copy()) for i, n in enumerate(names)})
    sys_ = instantiate(cfg, units, var)
    return sys_, per_trial(var.get("tr_mean"), points.shape[0], sys_.n_trials,
                           sys_.laser.device)


def ends(t: int, side: int = 10007):
    """The first and the last ``side`` trials of T."""
    return (slice(0, side), slice(t - side, t))


def timed_call(fn):
    """(result, wall ms, ``probe`` launches) of one call, synchronised on
    both ends."""
    import torch

    from repro_torch.kernels.probe import masked_research

    torch.cuda.synchronize()
    n0, t0 = masked_research.launches, time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, masked_research.launches - n0


#: The five kernels of the arbitration paths (the TPU kernels' ports); the
#: sixth, ``threefry``, draws the LM's parameters and runs on no other path.
ARBITRATION_KERNELS = ("feasibility", "table_build", "match", "bottleneck", "probe")


def reset_launches() -> dict:
    """Every kernel wrapper, its launch count set to 0."""
    from repro_torch.kernels.bitmask_match import bottleneck_threshold, perfect_matching
    from repro_torch.kernels.feasibility import feasibility
    from repro_torch.kernels.probe import masked_research
    from repro_torch.kernels.table_build import build_tables
    from repro_torch.kernels.threefry import threefry_draw

    wrappers = {"feasibility": feasibility, "table_build": build_tables,
                "match": perfect_matching, "bottleneck": bottleneck_threshold,
                "probe": masked_research, "threefry": threefry_draw}
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def window_count(laser, ring, fsr, tr, vis, max_alias: int):
    """Per (trial, ring), the candidates in the window (visible lines only):
    how many a table of unbounded width would hold."""
    import torch

    j = torch.arange(-max_alias, max_alias + 1, dtype=torch.float32)
    d = (laser[:, None, :, None] - ring[:, :, None, None]) - j * fsr[:, :, None, None]
    ok = (d >= 0.0) & (d <= tr[:, :, None, None])
    if vis is not None:
        ok &= vis[:, None, :, None] if vis.dim() == 2 else vis[..., None]
    return ok.sum(dim=(2, 3))


def table_cases(seed: int):
    """Phase-2 inputs of ``table_build``: (name, (laser, ring, fsr, tr) on the
    card, visible mask on the CPU or None, max_alias, max_entries)."""
    import numpy as np
    import torch

    from repro_torch.configs.wdm import WDM_CONFIGS, drift_timeline
    from repro_torch.core.api import make_units
    from repro_torch.core.reach import as_f32
    from repro_torch.core.sampling import instantiate
    from repro_torch.core.variations import Variations, apply_axis_transforms

    def real(key, n_l, n_r, trs, masks, label=None):
        cfg = WDM_CONFIGS[key]
        n = cfg.grid.n_ch
        sys_ = instantiate(cfg, make_units(cfg, seed, n_l, n_r))
        t = sys_.n_trials
        gen = torch.Generator().manual_seed(seed + n)
        vis_of = {"2-D mask": lambda: torch.rand(t, n, generator=gen) < 0.7,
                  "3-D mask": lambda: torch.rand(t, n, n, generator=gen) < 0.7}
        cases = [(f"TR={tr}", tr, None) for tr in trs]
        cases += [(f"TR=8.96 {m}", 8.96, vis_of[m]()) for m in masks]
        for name, tr_mean, vis in cases:
            tr = as_f32(tr_mean, sys_.tr_unit.device) * sys_.tr_unit
            yield (f"{label or key} {name}", (sys_.laser, sys_.ring, sys_.fsr, tr), vis,
                   cfg.max_fsr_alias, 3 * n)

    both = ("2-D mask", "3-D mask")
    for key in ("wdm8-g200", "wdm16-g200", "wdm32-g200"):
        yield from real(key, N_SIDE, N_SIDE, (2.0, 8.96, 20.0), both)
    yield from real("wdm64-g200", 40, N_SIDE, (8.96, 20.0), ("3-D mask",))
    yield from real("wdm32-g200", 1, 10007, (8.96,), ("3-D mask",), "wdm32 ragged")

    # The temporal path's input: wdm16-hotswap at step 3 (lane 5 killed),
    # drifted, with its (T, N, N) mask of live lanes and rings.
    cfg, tl = drift_timeline("wdm16-hotswap")
    sys_ = instantiate(cfg, make_units(cfg, seed, N_SIDE, N_SIDE))
    ring_drift, laser_drift, lane_alive, ring_alive = (a[3] for a in tl)
    sys_ = apply_axis_transforms(
        sys_, Variations(thermal_drift=ring_drift, comb_wander=laser_drift), cfg)
    t, n = sys_.laser.shape
    vis = (lane_alive[None, :] & ring_alive[:, None]).expand(t, n, n).contiguous()
    tr = as_f32(TEMPORAL_TR_X * cfg.grid.grid_spacing, sys_.tr_unit.device) * sys_.tr_unit
    yield ("wdm16-hotswap step 3 temporal 3-D mask", (sys_.laser, sys_.ring, sys_.fsr, tr),
           vis.cpu(), cfg.max_fsr_alias, 3 * n)

    # Grid-quantized systems (every delta a multiple of 0.25): many (k, j)
    # share a delta, and most rows hold more window candidates than E.
    # N = 13 takes two lines a lane in groups of 8, and E = 39 scalar stores.
    rng = np.random.default_rng(seed)
    for n, aliases in ((8, (1, 3, 8)), (32, (8,)), (13, (8,))):
        t = N_SIDE * N_SIDE
        laser = rng.integers(0, 8, (t, n)).astype(np.float32) * 0.25
        ring = rng.integers(-4, 4, (t, n)).astype(np.float32) * 0.25
        fsr = rng.integers(1, 4, (t, n)).astype(np.float32) * 0.25
        args = tuple(torch.from_numpy(a).cuda() for a in
                     (laser, ring, fsr, np.full((t, n), 3.0, np.float32)))
        for max_alias in aliases:
            yield (f"quantized N={n} max_alias={max_alias} TR=3.0", args, None,
                   max_alias, 3 * n)


def deep_match_graphs(n: int, t: int, gen):
    """Phase-2 inputs of ``match`` that force deep and contested searches:
    (name, (T, N, N) bool reach on the CPU).

    A staircase of m = 2 + t % (N - 1) rings in trial t: ring r < m - 1
    reaches lines r and r + 1 and takes line r at level 0; ring m - 1
    reaches line 0 only, and finds line m - 1 free after a BFS of m - 1
    levels through every earlier ring, then walks back m steps; later rings
    are random.  Blocks of three rings on three lines, with random extra
    edges: the block's third ring finds both its lines taken, both rings of
    the next level reach the block's third line, and the lower ring, which
    holds the higher line, must win it."""
    import torch

    r, k = torch.arange(n)[:, None], torch.arange(n)[None, :]
    m = (2 + torch.arange(t) % (n - 1))[:, None, None]
    stair = ((k == r) | (k == r + 1)) & (r < m - 1) | (k == 0) & (r == m - 1)
    yield f"staircase N={n}", stair | (r >= m) & (torch.rand(t, n, n, generator=gen) < 0.3)
    block = torch.zeros(n, n, dtype=torch.bool)
    for b in range(0, n - 2, 3):
        for ring, lines in ((b, [b + 1, b + 2]), (b + 1, [b, b + 2]), (b + 2, [b, b + 1])):
            block[ring, lines] = True
    block[n - n % 3:] = True
    yield f"lowest ring wins N={n}", block | (torch.rand(t, n, n, generator=gen) < 0.04)


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"[build] kernel library ready in {secs:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[build]", line.strip())


def phase_kernels(seed: int) -> dict:
    import torch

    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core.api import make_units
    from repro_torch.core.sampling import SystemBatch, instantiate
    from repro_torch.kernels.feasibility import feasibility, feasibility_plain
    from repro_torch.kernels.table_build import build_tables, build_tables_plain

    errs = {"feasibility": [], "table_build": []}
    cpu = lambda xs: [x.cpu() for x in xs]  # noqa: E731

    def check_feasibility(name, sys_, s, nonfinite=False):
        """sys_ on the card.  With NaN inputs the plain version on the card
        is held bit for bit, the CPU one up to the NaN's bits: the card's
        arithmetic makes NaN with other bits than the CPU's."""
        got = feasibility(*sys_, s)
        want = feasibility_plain(*cpu(sys_), s)
        if nonfinite:
            for tag, g, w, w_card in zip(("ltd", "ltc"), got, want,
                                         feasibility_plain(*sys_, s)):
                compare(f"feasibility {name} {tag}", g, w_card, errs["feasibility"])
                nan = torch.isnan(w)
                if not (torch.equal(torch.isnan(g.cpu()), nan)
                        and torch.equal(bits(g)[~nan], bits(w)[~nan])):
                    fail(f"feasibility {name} {tag}: differs from the CPU plain version")
            print(f"[kernels] feasibility {name}: T={sys_.laser.shape[0]} "
                  f"N={sys_.laser.shape[1]} bit-exact to the plain version on the card, "
                  f"equal to the CPU one ({int(torch.isnan(want[1]).sum())} NaN ltc, "
                  f"{int(torch.isinf(want[0]).sum())} inf ltd)")
            return
        for tag, g, w in zip(("ltd", "ltc"), got, want):
            compare(f"feasibility {name} {tag}", g, w, errs["feasibility"])
        print(f"[kernels] feasibility {name}: T={sys_.laser.shape[0]} "
              f"N={sys_.laser.shape[1]} bit-exact")

    def plant_nonfinite(sys_):
        """A copy with NaN and +-inf planted in every trial but each 7th: a
        ring with fsr = 0, a NaN laser, a ring with fsr = +inf, tr_unit 0 and
        +inf, a laser at -inf."""
        laser, ring, fsr, tr_unit = (x.clone() for x in sys_)
        n = laser.shape[1]
        fsr[0::7, 2 % n] = 0.0
        laser[1::7, 3 % n] = float("nan")
        fsr[2::7, 1 % n] = float("inf")
        tr_unit[3::7, 0] = 0.0
        tr_unit[4::7, n - 1] = float("inf")
        laser[5::7, 0] = -float("inf")
        return SystemBatch(laser, ring, fsr, tr_unit)

    feas_cases = [
        ("wdm8 natural", WDM_CONFIGS["wdm8-g200"], N_SIDE, N_SIDE),
        ("wdm8 permuted", WDM_CONFIGS["wdm8-g200"].with_orders("permuted"), N_SIDE, N_SIDE),
        ("wdm16", WDM_CONFIGS["wdm16-g200"], N_SIDE, N_SIDE),
        ("wdm32", WDM_CONFIGS["wdm32-g200"], N_SIDE, N_SIDE),
        ("wdm64", WDM_CONFIGS["wdm64-g200"], 40, N_SIDE),
        ("wdm32 ragged T=10007", WDM_CONFIGS["wdm32-g200"], 1, 10007),
        ("wdm8 ragged T=10007", WDM_CONFIGS["wdm8-g200"], 1, 10007),
        ("wdm16 ragged T=10007", WDM_CONFIGS["wdm16-g200"], 1, 10007),
    ]
    for name, cfg, n_l, n_r in feas_cases:
        sys_ = instantiate(cfg, make_units(cfg, seed, n_l, n_r))
        check_feasibility(name, sys_, cfg.s)
        if name == "wdm8 natural":
            check_feasibility("wdm8 natural NaN and +-inf", plant_nonfinite(sys_), cfg.s,
                              nonfinite=True)

    # d / fsr within an ulp of an integer: laser = ring + m * fsr, nudged.
    gen = torch.Generator().manual_seed(seed)
    t, n = 10007, 8
    fsr = 8.0 + 2.0 * torch.rand(t, n, generator=gen)
    ring = 10.0 * torch.rand(t, n, generator=gen) - 5.0
    m = torch.randint(-3, 4, (t, n), generator=gen).to(torch.float32)
    laser = ring + m * fsr
    nudge = torch.randint(0, 3, (t, n), generator=gen)
    laser = torch.where(nudge == 1, torch.nextafter(laser, torch.tensor(torch.inf)), laser)
    laser = torch.where(nudge == 2, torch.nextafter(laser, torch.tensor(-torch.inf)), laser)
    tr_unit = 0.9 + 0.2 * torch.rand(t, n, generator=gen)
    crafted = SystemBatch(laser, ring, fsr, tr_unit)
    s = torch.randperm(n, generator=gen).numpy()
    got = feasibility(*(x.cuda() for x in crafted), s)
    want = feasibility_plain(*crafted, s)
    for tag, g, w in zip(("ltd", "ltc"), got, want):
        compare(f"feasibility near-integer {tag}", g, w, errs["feasibility"])
    print(f"[kernels] feasibility near-integer d/fsr: T={t} bit-exact")

    # Random systems at odd widths (idle lanes; two shifts a lane at N = 40)
    # with a permuted ordering.
    t = N_SIDE * N_SIDE
    for n in (13, 40):
        sys_ = SystemBatch(*((lo + (hi - lo) * torch.rand(t, n, generator=gen)).cuda()
                             for lo, hi in ((-5.0, 5.0), (-5.0, 5.0), (4.0, 8.0), (0.9, 1.1))))
        s = torch.randperm(n, generator=gen).numpy()
        check_feasibility(f"random N={n} permuted s", sys_, s)
        if n == 40:
            check_feasibility(f"random N={n} NaN and +-inf", plant_nonfinite(sys_), s,
                              nonfinite=True)

    for name, args, vis, max_alias, e in table_cases(seed):
        kw = dict(max_alias=max_alias, max_entries=e)
        got = build_tables(*args, visible=None if vis is None else vis.cuda(), **kw)
        want = build_tables_plain(*cpu(args), visible=vis, **kw)
        for tag, g, w in zip(("delta", "wl", "n_valid"), got, want):
            compare(f"table_build {name} {tag}", g, w, errs["table_build"])
        over = int((window_count(*cpu(args), vis, max_alias) > e).sum())
        print(f"[kernels] table_build {name}: T={args[0].shape[0]} E={got[0].shape[-1]} "
              f"exact (n_valid max {int(got[2].max())}; {over} of {got[2].numel()} "
              f"rows with more window candidates than E)")

    return {k: max(v) for k, v in errs.items()}


def phase_matching(seed: int) -> dict:
    """Phase 2 for ``match`` and ``bottleneck``.  Their plain versions run on
    the card on the same CUDA inputs: each is a batched search of fixed trip
    counts (N^2 steps of a few ops for one Kuhn run, ceil(log2 N^2) + 1 runs
    for the bottleneck), bound by op launch and too slow for the CPU here."""
    import torch

    from repro_torch.configs.wdm import WDM_CONFIGS, drift_timeline
    from repro_torch.core.api import make_units
    from repro_torch.core.matching import adjacency_bitmask
    from repro_torch.core.reach import reach_matrix, scaled_residual
    from repro_torch.core.sampling import instantiate
    from repro_torch.core.variations import Variations, apply_axis_transforms
    from repro_torch.kernels.bitmask_match import (
        bottleneck_threshold,
        bottleneck_threshold_plain,
        perfect_matching,
        perfect_matching_plain,
    )

    errs = {"match": [], "bottleneck": []}

    def check_match(name, adj):
        got, want = perfect_matching(adj), perfect_matching_plain(adj)
        compare(f"match {name} match_wl", got[0], want[0], errs["match"])
        compare(f"match {name} ok", got[1], want[1], errs["match"])
        print(f"[kernels] match {name}: T={adj.shape[0]} N={adj.shape[1]} exact "
              f"({int(got[1].sum())} perfect, {int((adj < 0).any(dim=1).sum())} "
              f"trials with bit 63 set)")

    def check_bottleneck(name, w):
        got, want = bottleneck_threshold(w), bottleneck_threshold_plain(w)
        compare(f"bottleneck {name}", got, want, errs["bottleneck"])
        print(f"[kernels] bottleneck {name}: T={w.shape[0]} N={w.shape[1]} "
              f"bit-exact (max {float(got.max())!r})")

    cells = [
        ("wdm8 natural", WDM_CONFIGS["wdm8-g200"], N_SIDE, N_SIDE),
        ("wdm8 permuted", WDM_CONFIGS["wdm8-g200"].with_orders("permuted"),
         N_SIDE, N_SIDE),
        ("wdm16", WDM_CONFIGS["wdm16-g200"], N_SIDE, N_SIDE),
        ("wdm32", WDM_CONFIGS["wdm32-g200"], N_SIDE, N_SIDE),
        ("wdm64", WDM_CONFIGS["wdm64-g200"], 40, N_SIDE),
        ("wdm32 ragged", WDM_CONFIGS["wdm32-g200"], 1, 10007),
        ("wdm8 ragged", WDM_CONFIGS["wdm8-g200"], 1, 10007),
        ("wdm16 ragged", WDM_CONFIGS["wdm16-g200"], 1, 10007),
    ]
    for name, cfg, n_l, n_r in cells:
        sys_ = instantiate(cfg, make_units(cfg, seed, n_l, n_r))
        for tr in (2.0, 4.5, TR):
            check_match(f"{name} TR={tr}", adjacency_bitmask(reach_matrix(sys_, tr)))
        check_bottleneck(f"{name} residual", scaled_residual(sys_))

    gen = torch.Generator().manual_seed(seed)
    for n in (32, 64):
        for density in (0.1, 0.3, 0.6):
            reach = torch.rand(N_SIDE * N_SIDE, n, n, generator=gen) < density
            reach[:, :, n - 1] |= torch.rand(N_SIDE * N_SIDE, n, generator=gen) < 0.5
            check_match(f"random density {density}", adjacency_bitmask(reach.cuda()))
    # Tie-heavy weights, at every lane shape (groups of 8, 16, 32 lanes with
    # idle lanes at N = 5, two lines a lane at N = 33 and 64); the plain
    # version is slow on the card, so beyond the first two at 2,000 trials.
    for n, t in ((12, N_SIDE * N_SIDE), (32, N_SIDE * N_SIDE), (5, 2000), (8, 2000),
                 (16, 2000), (33, 2000), (64, 2000)):
        w = torch.randint(0, 4, (t, n, n), generator=gen)
        check_bottleneck("tie-heavy integers 0-3", w.to(torch.float32).cuda())

    # Rows and columns of +inf weights: rings no finite weight reaches, whose
    # free lines all sit at +inf (the search then takes line 0), and trials
    # with no finite perfect matching.
    cfg = WDM_CONFIGS["wdm16-g200"]
    w = scaled_residual(instantiate(cfg, make_units(cfg, seed, 20, N_SIDE)))
    w[0::3, 1, :] = float("inf")
    w[1::3, :, 2] = float("inf")
    w[2::6, 0:2, :] = float("inf")
    check_bottleneck("wdm16 rows and columns of +inf", w)

    # Deep and contested searches at every lane shape (see deep_match_graphs),
    # from a generator of their own, so the cases above keep their inputs.
    gen = torch.Generator().manual_seed(seed + 1)
    t = N_SIDE * N_SIDE
    for n in (8, 16, 32, 64):
        for name, reach in deep_match_graphs(n, t, gen):
            check_match(name, adjacency_bitmask(reach.cuda()))
    # Random bitmasks at odd widths: idle lanes in groups of 8 and 16, two
    # rings and lines a lane at 33 and 40.  At 5 and 12 also with random bits
    # above N in every word, which the kernel and the plain version ignore.
    for n in (5, 12, 33, 40):
        for density in (0.1, 0.3, 0.6):
            reach = torch.rand(t, n, n, generator=gen) < density
            check_match(f"random N={n} density {density}", adjacency_bitmask(reach.cuda()))
        if n < 32:
            hi, lo = torch.randint(0, 2 ** 32, (2, t, n), generator=gen)
            words = adjacency_bitmask(torch.rand(t, n, n, generator=gen) < 0.3)
            words |= ((hi << 32) | lo) & ~((1 << n) - 1)
            check_match(f"random N={n} bits above N set", words.cuda())
    # The temporal path's feasibility input: wdm16-hotswap at step 3, drifted,
    # at TR = 4 grid spacings, lane 5 dead (a zero column), and ring 11 dead
    # too (a zero row, as a ring_kill event leaves it).
    cfg, tl = drift_timeline("wdm16-hotswap")
    sys_ = instantiate(cfg, make_units(cfg, seed, N_SIDE, N_SIDE))
    ring_drift, laser_drift, lane_alive, ring_alive = (a[3] for a in tl)
    sys_ = apply_axis_transforms(
        sys_, Variations(thermal_drift=ring_drift, comb_wander=laser_drift), cfg)
    ring_alive = ring_alive.clone()
    ring_alive[11] = False
    alive = lane_alive[None, :] & ring_alive[:, None]
    tr = TEMPORAL_TR_X * cfg.grid.grid_spacing
    check_match(f"wdm16-hotswap step 3 TR={tr!r} dead lane 5 and ring 11",
                adjacency_bitmask(reach_matrix(sys_, tr) & alive[None]))
    cfg = WDM_CONFIGS["wdm64-g200"]
    sys_ = instantiate(cfg, make_units(cfg, seed, 1, 10007))
    for tr in (4.5, TR):
        check_match(f"wdm64 ragged TR={tr}", adjacency_bitmask(reach_matrix(sys_, tr)))
    return {k: max(v) for k, v in errs.items()}


def phase_flat_grids(seed: int) -> dict:
    """Phase 2 at the sweep engine's flattened sizes: a grid's points are
    one batch of P * 10,000 trials, so the kernels see far more trials than
    a single point gives them."""
    import torch

    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core.api import make_units
    from repro_torch.core.matching import adjacency_bitmask
    from repro_torch.core.reach import reach_matrix
    from repro_torch.kernels.bitmask_match import perfect_matching, perfect_matching_plain
    from repro_torch.kernels.table_build import build_tables, build_tables_plain

    errs = {"table_build": [], "match": []}
    # Grid points flattened into the trial axis, as the sweep engine gives
    # them: fig4's 8 x 12 grid at WDM8 (960,000 trials) and 3 x 10 points of
    # the WDM32 TR axis (300,000 trials, 7.4 GB of tables); the first and the
    # last 10,007 trials against the plain version on the CPU.
    for key, axes in (("wdm8-g200", {"sigma_rlv": rlv_sweep(), "tr_mean": tr_sweep()}),
                      ("wdm32-g200", {"sigma_rlv": rlv_sweep()[[2, 3, 5]],
                                      "tr_mean": tr_sweep(32)[:10]})):
        cfg = WDM_CONFIGS[key]
        n = cfg.grid.n_ch
        sys_, tr = flat_grid(cfg, make_units(cfg, seed, N_SIDE, N_SIDE), axes)
        args = (sys_.laser, sys_.ring, sys_.fsr, tr[:, None] * sys_.tr_unit)
        kw = dict(max_alias=cfg.max_fsr_alias, max_entries=3 * n)
        got = build_tables(*args, **kw)
        t = args[0].shape[0]
        for part in ends(t):
            want = build_tables_plain(*(a[part].cpu() for a in args), **kw)
            for tag, g, w in zip(("delta", "wl", "n_valid"), got, want):
                compare(f"table_build {key} flattened grid trials {part} {tag}", g[part], w,
                        errs["table_build"])
        print(f"[kernels] table_build {key} flattened grid: T={t} ({t // N_SIDE ** 2} points) "
              f"E={3 * n}, {got[0].numel() * 8 / 1e9:.2f} GB of tables; the first and the "
              f"last 10007 trials exact")
        del sys_, tr, args, got
        torch.cuda.empty_cache()
    # fig4's 8 x 12 grid at WDM8 flattened into 960,000 trials, as the sweep
    # engine's direct LtA path gives it; the first and the last 10,007 trials
    # against the plain version.
    cfg = WDM_CONFIGS["wdm8-g200"]
    sys_, tr = flat_grid(cfg, make_units(cfg, seed, N_SIDE, N_SIDE),
                         {"sigma_rlv": rlv_sweep(), "tr_mean": tr_sweep()})
    adj = adjacency_bitmask(reach_matrix(sys_, tr))
    got = perfect_matching(adj)
    for part in ends(adj.shape[0]):
        want = perfect_matching_plain(adj[part])
        compare(f"match flattened grid trials {part} match_wl", got[0][part], want[0],
                errs["match"])
        compare(f"match flattened grid trials {part} ok", got[1][part], want[1], errs["match"])
    print(f"[kernels] match wdm8 flattened fig4 grid: T={adj.shape[0]} (96 points); the first "
          f"and the last 10007 trials exact ({int(got[1].sum())} perfect)")
    return {k: max(v) for k, v in errs.items()}


def phase_probe(seed: int) -> dict:
    """Phase 2 for ``probe``: the kernel against its plain version on the same
    CUDA inputs, exactly, at every shape the protocol engine gives it, at
    edge cases, and on every re-search of a real protocol run."""
    import torch

    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core import protocol as proto
    from repro_torch.core.api import make_units
    from repro_torch.core.relation import chain_spec
    from repro_torch.core.sampling import instantiate
    from repro_torch.core.search_table import build_search_tables
    from repro_torch.kernels.probe import masked_research, masked_research_plain

    errs = []

    def check(name, wl, taken, floor, quiet=False):
        got = masked_research(wl, taken, floor)
        want = masked_research_plain(wl, taken, floor)
        compare(f"probe {name} first", got[0], want[0], errs)
        compare(f"probe {name} found", got[1], want[1], errs)
        if not quiet:
            print(f"[kernels] probe {name}: T={wl.shape[0]} C={wl.shape[1]} "
                  f"E={wl.shape[2]} L={taken.shape[1]} exact "
                  f"({int(got[1].sum())} of {got[1].numel()} rows found)")
        return got

    gen = torch.Generator().manual_seed(seed)
    for n in (8, 16, 32, 64):
        e = 3 * n
        for c in (1, 4):
            for t in (N_SIDE * N_SIDE,) + ((10007,) if n == 32 else ()):
                wl = torch.randint(-1, n, (t, c, e), generator=gen, dtype=torch.int32)
                taken = torch.rand(t, n, generator=gen) < 0.5
                floor = torch.randint(0, e + 1, (t, c), generator=gen, dtype=torch.int32)
                check(f"random N={n}", wl.cuda(), taken.cuda(), floor.cuda())

    # E = 39, and a row start off 16-byte alignment: the scalar loads.
    t, n, e = N_SIDE * N_SIDE, 13, 39
    flat = torch.randint(-1, n, (t * 4 * e + 1,), generator=gen, dtype=torch.int32).cuda()
    floor = torch.randint(-1, e + 1, (t, 4), generator=gen, dtype=torch.int32).cuda()
    taken = (torch.rand(t, n, generator=gen) < 0.5).cuda()
    for tag, wl in (("E=39", flat[:-1]), ("E=39 off 16-byte alignment", flat[1:])):
        check(tag, wl.view(t, 4, e), taken, floor)

    # Edge cases: floors -1, 0, E, E + 3 in rows 0..3; line ids up to L + 3
    # (never taken); row 1 all invalid; every 7th trial has every line taken.
    t, n, e = 10007, 16, 48
    wl = torch.randint(-1, n + 4, (t, 4, e), generator=gen, dtype=torch.int32)
    wl[:, 1] = -1
    taken = torch.rand(t, n, generator=gen) < 0.5
    taken[::7] = True
    floor = torch.tensor([-1, 0, e, e + 3], dtype=torch.int32).repeat(t, 1)
    first, found = check("edge cases", wl.cuda(), taken.cuda(), floor.cuda())
    if bool(found[:, 1:].any()) or not bool(found[:, 0].any()):
        fail("probe edge cases: wrong found pattern")

    # Every re-search of the first two rounds of a WDM16 protocol run.
    cfg = WDM_CONFIGS["wdm16-g200"]
    sys_ = instantiate(cfg, make_units(cfg, seed, N_SIDE, N_SIDE))
    tables = build_search_tables(sys_, TEMPORAL_TR_X * cfg.grid.grid_spacing,
                                 max_alias=cfg.max_fsr_alias)
    calls = []
    real = proto.masked_research

    def checked(wl, taken, floor):
        calls.append(wl.shape[1])
        return check(f"protocol call {len(calls)}", wl, taken, floor, quiet=True)

    proto.masked_research = checked
    try:
        proto.run_protocol(tables, chain_spec(cfg.s), n_rounds=2)
    finally:
        proto.masked_research = real
    print(f"[kernels] probe: {len(calls)} re-searches of 2 rounds of a WDM16 protocol "
          f"run (T={sys_.n_trials}; {calls.count(1)} with C=1, {calls.count(4)} with "
          f"C=4) exact")
    if not calls:
        fail("probe: the protocol run made no re-search")
    return {"probe": max(errs)}


def _subset(units, side):
    """The first side x side samples on the CPU, and their trial indices."""
    import numpy as np

    from repro_torch.core.sampling import UnitSamples

    n_r = units.u_rlv.shape[0]
    sub = UnitSamples(units.u_go[:side], units.u_llv[:side], units.u_rlv[:side],
                      units.u_fsr[:side], units.u_tr[:side])
    idx = (np.arange(side)[:, None] * n_r + np.arange(side)[None, :]).reshape(-1)
    return UnitSamples(*(u.cpu().contiguous() for u in sub)), idx


def phase_main(seed: int) -> dict:
    import torch

    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core import api

    cells = []
    for key, order in MAIN_CELLS:
        cfg = WDM_CONFIGS[key].with_orders(order)
        cells.append((f"{key}/{order}", cfg, api.make_units(cfg, seed, N_SIDE, N_SIDE)))

    wrappers = reset_launches()
    out = {}
    for name, cfg, units in cells:
        for scheme in SCHEMES:
            out[name, scheme] = api.evaluate_scheme(cfg, units, scheme, TR)
        for policy in POLICIES:
            out[name, "afp", policy] = api.evaluate_policy(cfg, units, policy, TR)
            out[name, "min_tr", policy] = api.policy_min_tr(cfg, units, policy)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[main] launches on the main path: {launches}")
    for k in ("feasibility", "table_build"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the main path")

    t = N_SIDE * N_SIDE
    for name, cfg, units in cells:
        sub_units, idx = _subset(units, SUB_SIDE)
        for scheme in SCHEMES:
            r = out[name, scheme]
            for f in ("alg_success", "ideal_ok"):
                v = getattr(r, f)
                if v.shape != (t,) or v.dtype != torch.bool:
                    fail(f"{name} {scheme} {f}: {v.dtype}{tuple(v.shape)}")
            for f in ("afp", "cafp", "lock_err", "order_err"):
                x = float(getattr(r, f))
                if not 0.0 <= x <= 1.0:
                    fail(f"{name} {scheme} {f} = {x} outside [0, 1]")
            ref = api.evaluate_scheme(cfg, sub_units, scheme, TR)
            for f in ("alg_success", "ideal_ok"):
                if not torch.equal(getattr(r, f).cpu()[idx], getattr(ref, f)):
                    fail(f"{name} {scheme} {f} differs from the CPU plain path "
                         f"on the {SUB_SIDE}x{SUB_SIDE} subset")
            print(f"[main] {name} {scheme}: AFP={float(r.afp)!r} CAFP={float(r.cafp)!r} "
                  f"lock_err={float(r.lock_err)!r} order_err={float(r.order_err)!r} "
                  f"(subset of {len(idx)} trials equal to the CPU plain path)")
        for policy in POLICIES:
            afp = float(out[name, "afp", policy])
            mtr = float(out[name, "min_tr", policy])
            if not (0.0 <= afp <= 1.0 and mtr == mtr and mtr >= 0.0):
                fail(f"{name} {policy}: AFP={afp} min_tr={mtr}")
            per_trial = api.policy_trial_min_tr(cfg, units, policy).cpu()[idx]
            ref = api.policy_trial_min_tr(cfg, sub_units, policy)
            if not torch.equal(bits(per_trial), bits(ref)):
                fail(f"{name} {policy} per-trial min TR differs from the CPU plain path")
            print(f"[main] {name} policy {policy}: AFP={afp!r} min_tr={mtr!r}")

    for name, cfg, units in cells:
        for scheme in SCHEMES:
            ms = cuda_ms(lambda: api.evaluate_scheme(cfg, units, scheme, TR), 5)
            print(f"[time] evaluate_scheme {name} {scheme}: {ms!r} ms/call "
                  f"({t} trials)")
        for policy in POLICIES:
            ms = cuda_ms(lambda: api.evaluate_policy(cfg, units, policy, TR), 10)
            print(f"[time] evaluate_policy {name} {policy}: {ms!r} ms/call")
    return launches


def phase_lta(seed: int) -> dict:
    """The LtA path at 10,000 trials, then its checks and times."""
    import torch

    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core import api
    from repro_torch.core.reach import as_f32

    cells = []
    for key, order in LTA_POLICY_CELLS:
        cfg = WDM_CONFIGS[key].with_orders(order)
        cells.append((f"{key}/{order}", (key, order), cfg,
                      api.make_units(cfg, seed, N_SIDE, N_SIDE)))

    wrappers = reset_launches()
    out = {}
    for name, key, cfg, units in cells:
        out[name, "afp"] = api.evaluate_policy(cfg, units, "lta", TR)
        out[name, "min_tr"] = api.policy_min_tr(cfg, units, "lta")
        for scheme in LTA_SCHEME_CELLS[key]:
            out[name, scheme] = api.evaluate_scheme(cfg, units, scheme, TR)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[lta] launches on the LtA path: {launches}")
    for k in ("match", "bottleneck", "table_build"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the LtA path")

    t = N_SIDE * N_SIDE
    for name, key, cfg, units in cells:
        sub_units, idx = _subset(units, SUB_SIDE)
        afp, mtr = float(out[name, "afp"]), float(out[name, "min_tr"])
        if not (0.0 <= afp <= 1.0 and mtr == mtr and mtr >= 0.0):
            fail(f"{name} lta: AFP={afp} min_tr={mtr}")
        per_trial = api.policy_trial_min_tr(cfg, units, "lta")
        if per_trial.shape != (t,) or not bool(torch.isfinite(per_trial).all()):
            fail(f"{name} lta per-trial min TR: {tuple(per_trial.shape)}, not all finite")
        ref = api.policy_trial_min_tr(cfg, sub_units, "lta")
        if not torch.equal(bits(per_trial.cpu()[idx]), bits(ref)):
            fail(f"{name} lta per-trial min TR differs from the CPU plain path")
        print(f"[lta] {name} policy lta: AFP={afp!r} min_tr={mtr!r} (per-trial "
              f"min TR on the {SUB_SIDE}x{SUB_SIDE} subset equal to the CPU plain path)")
        for scheme in LTA_SCHEME_CELLS[key]:
            r = out[name, scheme]
            for f in ("alg_success", "ideal_ok"):
                v = getattr(r, f)
                if v.shape != (t,) or v.dtype != torch.bool:
                    fail(f"{name} {scheme} {f}: {v.dtype}{tuple(v.shape)}")
            for f in ("afp", "cafp", "lock_err", "order_err"):
                x = float(getattr(r, f))
                if not 0.0 <= x <= 1.0:
                    fail(f"{name} {scheme} {f} = {x} outside [0, 1]")
            if not torch.equal(r.ideal_ok, per_trial <= as_f32(TR, per_trial.device)):
                fail(f"{name} {scheme} ideal_ok (match) disagrees with the "
                     f"bottleneck min TR at TR {TR}")
            ref = api.evaluate_scheme(cfg, sub_units, scheme, TR)
            for f in ("alg_success", "ideal_ok"):
                if not torch.equal(getattr(r, f).cpu()[idx], getattr(ref, f)):
                    fail(f"{name} {scheme} {f} differs from the CPU plain path "
                         f"on the {SUB_SIDE}x{SUB_SIDE} subset")
            print(f"[lta] {name} {scheme}: AFP={float(r.afp)!r} CAFP={float(r.cafp)!r} "
                  f"lock_err={float(r.lock_err)!r} (subset of {len(idx)} trials "
                  f"equal to the CPU plain path)")

    for name, key, cfg, units in cells:
        ms = cuda_ms(lambda: api.evaluate_policy(cfg, units, "lta", TR), 10)
        print(f"[time] evaluate_policy {name} lta: {ms!r} ms/call")
        ms = cuda_ms(lambda: api.policy_min_tr(cfg, units, "lta"), 10)
        print(f"[time] policy_min_tr {name} lta: {ms!r} ms/call")
        for scheme in LTA_SCHEME_CELLS[key]:
            reps = 2 if cfg.grid.n_ch >= 32 else 5
            ms = cuda_ms(lambda: api.evaluate_scheme(cfg, units, scheme, TR), reps)
            print(f"[time] evaluate_scheme {name} {scheme}: {ms!r} ms/call ({t} trials)")
    return launches


def _check_eval(name, r, t):
    import torch

    for f in ("alg_success", "ideal_ok"):
        v = getattr(r, f)
        if v.shape != (t,) or v.dtype != torch.bool:
            fail(f"{name} {f}: {v.dtype}{tuple(v.shape)}")
    for f in ("afp", "cafp", "lock_err", "order_err"):
        x = float(getattr(r, f))
        if not 0.0 <= x <= 1.0:
            fail(f"{name} {f} = {x} outside [0, 1]")
    if bool((r.alg_success & ~r.ideal_ok).any()):
        fail(f"{name}: protocol success on a trial the ideal arbiter fails")


def phase_protocol(seed: int) -> dict:
    """The protocol path at 10,000 trials, then its checks."""
    import torch

    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core import api, ideal, metrics
    from repro_torch.core.outcomes import classify
    from repro_torch.core.protocol import run_protocol
    from repro_torch.core.relation import chain_spec
    from repro_torch.core.sampling import instantiate
    from repro_torch.core.search_table import build_search_tables

    low = low_tr()
    cells = []
    for order in PROTOCOL_ORDERS:
        cfg = WDM_CONFIGS["wdm8-g200"].with_orders(order)
        for tr in (TR, low):
            cells.append((f"wdm8-g200/{order} TR={tr!r}", cfg, tr, PROTOCOL_SCHEMES))
    for key in ("wdm16-g200", "wdm32-g200"):
        cells.append((f"{key}/natural TR={TR!r}", WDM_CONFIGS[key], TR, ("protocol_lta",)))
    units = {}
    for _, cfg, _, _ in cells:
        if cfg not in units:
            units[cfg] = api.make_units(cfg, seed, N_SIDE, N_SIDE)
    ladder_cfg = WDM_CONFIGS["wdm8-g200"]
    ladder_trs = (TR, low)

    wrappers = reset_launches()
    out, ms, n_probe = {}, {}, {}
    for name, cfg, tr, schemes in cells:
        for scheme in schemes:
            out[name, scheme], ms[name, scheme], n_probe[name, scheme] = timed_call(
                lambda: api.evaluate_scheme(cfg, units[cfg], scheme, tr))
    ladder_sys = instantiate(ladder_cfg, units[ladder_cfg])
    spec = chain_spec(ladder_cfg.s)
    for tr in ladder_trs:
        tables = build_search_tables(ladder_sys, tr, max_alias=ladder_cfg.max_fsr_alias)
        for depth in DEPTHS:
            key = "ladder", tr, depth
            out[key], ms[key], n_probe[key] = timed_call(
                lambda: run_protocol(tables, spec, depth=depth, with_stats=True))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[protocol] launches on the protocol path: {launches}")
    for k in ("probe", "table_build", "match", "feasibility"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the protocol path")

    t = N_SIDE * N_SIDE
    for name, cfg, tr, schemes in cells:
        sub_units, idx = _subset(units[cfg], SUB_SIDE)
        for scheme in schemes:
            r = out[name, scheme]
            _check_eval(f"{name} {scheme}", r, t)
            ref = api.evaluate_scheme(cfg, sub_units, scheme, tr)
            for f in ("alg_success", "ideal_ok"):
                if not torch.equal(getattr(r, f).cpu()[idx], getattr(ref, f)):
                    fail(f"{name} {scheme} {f} differs from the CPU plain path "
                         f"on the {SUB_SIDE}x{SUB_SIDE} subset")
            print(f"[protocol] {name} {scheme}: AFP={float(r.afp)!r} "
                  f"CAFP={float(r.cafp)!r} lock_err={float(r.lock_err)!r} "
                  f"order_err={float(r.order_err)!r} {ms[name, scheme]!r} ms/call, "
                  f"{n_probe[name, scheme]} probe launches "
                  f"(subset of {len(idx)} trials equal to the CPU plain path)")

    sub_units, idx = _subset(units[ladder_cfg], SUB_SIDE)
    sub_sys = instantiate(ladder_cfg, sub_units)
    for tr in ladder_trs:
        ideal_ok = ideal.success(ladder_sys, "lta", ladder_cfg.s, tr)
        sub_tables = build_search_tables(sub_sys, tr, max_alias=ladder_cfg.max_fsr_alias)
        for depth in DEPTHS:
            asg, stats = out["ladder", tr, depth]
            res = classify(asg, ladder_cfg.s, policy="lta")
            if bool(res.dup_lock.any()):
                fail(f"ladder TR={tr} depth={depth}: duplicate lock")
            if bool((res.success & ~ideal_ok).any()):
                fail(f"ladder TR={tr} depth={depth}: success where the ideal fails")
            _, ref = run_protocol(sub_tables, spec, depth=depth, with_stats=True)
            for f in stats._fields:
                if not torch.equal(getattr(stats, f).cpu()[idx], getattr(ref, f)):
                    fail(f"ladder TR={tr} depth={depth} stats.{f} differs from the "
                         f"CPU plain path on the {SUB_SIDE}x{SUB_SIDE} subset")
            print(f"[protocol] wdm8-g200/natural run_protocol TR={tr!r} depth={depth}: "
                  f"CAFP={float(metrics.cafp(res.success, ideal_ok))!r} "
                  f"mean probes={float(stats.probes.double().mean())!r} "
                  f"mean rounds={float(stats.rounds.double().mean())!r} "
                  f"mean worked={float(stats.worked.double().mean())!r} "
                  f"max worked={int(stats.worked.max())} "
                  f"{ms['ladder', tr, depth]!r} ms/call, {n_probe['ladder', tr, depth]} "
                  f"probe launches (no duplicate lock; stats on "
                  f"the subset equal to the CPU plain path)")
    return launches


def phase_temporal(seed: int, side: int, runs: dict | None = None) -> dict:
    """The temporal path: run_timeline warm and cold on two drift scenarios
    at side x side trials, then its checks.  ``runs`` receives each
    scenario's warm (final state, stats), under ``("ms", name)`` its ms and
    under ``("cpu", "wdm16-hotswap")`` the CPU subset's warm run traced at
    ``OBS_TIMELINE_CAP`` (final state, stats, buffers), for
    ``phase_campaign`` and ``phase_obs``."""
    import torch

    from repro_torch.configs.wdm import drift_timeline
    from repro_torch.core import api
    from repro_torch.core.temporal import run_timeline

    cells = []
    for name in DRIFT_CELLS:
        cfg, tl = drift_timeline(name)
        cells.append((name, cfg, tl, api.make_units(cfg, seed, side, side),
                      {"tr_mean": TEMPORAL_TR_X * cfg.grid.grid_spacing}))

    wrappers = reset_launches()
    out, ms, n_probe = {}, {}, {}
    for name, cfg, tl, units, var in cells:
        for warm in (True, False):
            out[name, warm], ms[name, warm], n_probe[name, warm] = timed_call(
                lambda: run_timeline(cfg, units, tl, var, warm=warm))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[temporal] launches on the temporal path: {launches}")
    for k in ("probe", "table_build", "match"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the temporal path")

    for name, cfg, tl, units, var in cells:
        sub_units, idx = _subset(units, SUB_SIDE)
        _, tl_cpu = drift_timeline(name, device="cpu")
        n = cfg.grid.n_ch
        for warm in (True, False):
            final, stats = out[name, warm]
            if stats.locked.shape != (tl.n_steps, side * side) or int(stats.locked.max()) > n:
                fail(f"{name} warm={warm}: stats shape {tuple(stats.locked.shape)}")
            # hot-swap's warm run is traced on the CPU: phase_obs holds the
            # card's traced timeline against its buffers
            traced = name == "wdm16-hotswap" and warm
            ref = run_timeline(cfg, sub_units, tl_cpu, var, warm=warm,
                               trace=OBS_TIMELINE_CAP if traced else None)
            ref_final, ref_stats = ref[:2]
            if traced and runs is not None:
                runs["cpu", name] = ref
            for f in stats._fields:
                if not torch.equal(getattr(stats, f).cpu()[:, idx], getattr(ref_stats, f)):
                    fail(f"{name} warm={warm} TemporalStats.{f} differs from the CPU "
                         f"plain path on the {SUB_SIDE}x{SUB_SIDE} subset")
            for f in final._fields:
                if not torch.equal(getattr(final, f).cpu()[idx], getattr(ref_final, f)):
                    fail(f"{name} warm={warm} final state {f} differs from the CPU "
                         f"plain path on the {SUB_SIDE}x{SUB_SIDE} subset")
            mean = lambda x: [round(v, 4) for v in x.double().mean(dim=1).tolist()]  # noqa: E731
            print(f"[temporal] {name} {'warm' if warm else 'cold'} T={side * side}: "
                  f"{ms[name, warm]!r} ms/call, {n_probe[name, warm]} probe launches; "
                  f"per-step mean probes {mean(stats.probes)}, "
                  f"rounds {mean(stats.rounds)}, locked {mean(stats.locked)}, broken "
                  f"{mean(stats.broken)}, churn {mean(stats.churn)}, feasible "
                  f"{mean(stats.feasible)} (per-step stats and final state on the "
                  f"subset equal to the CPU plain path)")
    if runs is not None:
        runs.update({name: out[name, True] for name in DRIFT_CELLS})
        runs.update({("ms", name): ms[name, True] for name in DRIFT_CELLS})
    return launches


def _hold_grid(name, got, want, t, exact_floats=True):
    """Two sweep results of one grid: tensors equal (float32 bit for bit)
    with ``exact_floats``, else integer and boolean fields exactly and float
    shares as integer counts (share x t)."""
    import torch

    for i, (g, w) in enumerate(zip(got, want) if isinstance(got, tuple) else ((got, want),)):
        field = got._fields[i] if hasattr(got, "_fields") else "data"
        g, w = g.detach().cpu(), w.detach().cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name} {field}: {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        if g.dtype == torch.float32 and not exact_floats:
            g, w = torch.round(g.double() * t), torch.round(w.double() * t)
        if not torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w):
            fail(f"{name} {field}: {int((g != w).sum())} of {g.numel()} elements differ")


def sweep_grids() -> list:
    """The sweep phase's grids at 10,000 trials a point: (name, SweepRequest
    keyword arguments, warm timing calls, sub-grid indices per axis for the
    per-point reference or None)."""
    import numpy as np

    from repro_torch.configs.wdm import WDM_CONFIGS, drift_timeline

    wdm8, wdm32 = WDM_CONFIGS["wdm8-g200"], WDM_CONFIGS["wdm32-g200"]
    fig4 = {"sigma_rlv": rlv_sweep(), "tr_mean": tr_sweep()}
    fig14 = {"sigma_rlv": rlv_sweep()[:6], "tr_mean": tr_sweep()}
    sub4 = {"sigma_rlv": [0, 3, 7], "tr_mean": [2, 5]}
    sub14 = {"sigma_rlv": [0, 3, 5], "tr_mean": [2, 5]}
    cfg16, tl = drift_timeline("wdm16-thermal")
    rlv5 = np.array(FIG5_RLV_X) * wdm32.grid.grid_spacing
    return [
        ("fig4 wdm8 LtC-N/N", dict(cfg=wdm8, policy="ltc", axes=fig4), 3, sub4),
        ("fig4 wdm8 LtA-N/A", dict(cfg=wdm8, policy="lta", axes=fig4), 3, sub4),
        ("fig4 wdm8 LtA-N/A tr_fast=False", dict(cfg=wdm8, policy="lta", axes=fig4,
                                                tr_fast=False), 3, sub4),
        ("fig14 wdm8 natural seq", dict(cfg=wdm8, scheme="seq", axes=fig14), 1, sub14),
        ("fig14 wdm8 natural vtrs_ssm", dict(cfg=wdm8, scheme="vtrs_ssm", axes=fig14), 1,
         sub14),
        ("wdm32 natural vtrs_ssm", dict(cfg=wdm32, scheme="vtrs_ssm",
                                        axes={"tr_mean": tr_sweep(32)}), 1,
         {"tr_mean": [0, 5, 11]}),
        ("fig5 wdm32 lta min_tr", dict(cfg=wdm32, policy="lta", metric="min_tr",
                                       axes={"sigma_rlv": rlv5}), 3, {"sigma_rlv": [0, 4, 8]}),
        ("fig19 wdm8 protocol_lta", dict(cfg=wdm8, scheme="protocol_lta",
                                         axes={"tr_mean": tr_sweep()}), 0,
         {"tr_mean": [1, 4, 9]}),
        ("wdm16-thermal protocol_lta timeline",
         dict(cfg=cfg16, scheme="protocol_lta", axes={"sigma_rlv": [2.24, 4.48]},
              fixed={"tr_mean": TEMPORAL_TR_X * cfg16.grid.grid_spacing}, timeline=tl), 0,
         None),
    ]


def phase_sweep(seed: int, store: dict | None = None) -> dict:
    """The sweep path: each grid of ``sweep_grids`` through ``sweep`` at its
    automatic chunk size, with the launch counts set to 0 just before and
    read just after; then per grid its time (CUDA events) beside the
    per-point loop's (the same grid at ``chunk_size=1``, which it must equal
    bit for bit), its peak memory beside chunk x per-point bytes, the
    port's per-point oracle ``sweep_reference`` on a sub-grid, and the CPU
    plain path on a 20 x 20 subset of the units.  ``store`` receives each
    grid's (request, result, first-call ms) for ``phase_mesh``."""
    import numpy as np
    import torch

    from repro_torch.configs.wdm import drift_timeline
    from repro_torch.core import api
    from repro_torch.core.sampling import UnitSamples
    from repro_torch.core.sweep import (
        SweepRequest,
        _auto_chunk,
        policy_point_bytes,
        scheme_point_bytes,
        sweep,
        sweep_reference,
    )
    units = {}
    grids = []
    for name, kw, reps, sub in sweep_grids():
        n = kw["cfg"].grid.n_ch
        if n not in units:
            units[n] = api.make_units(kw["cfg"], seed, N_SIDE, N_SIDE)
        grids.append((name, SweepRequest(units=units[n], **kw), reps, sub))

    wrappers = reset_launches()
    out, ms, peak = {}, {}, {}
    for name, req, _, _ in grids:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out[name] = sweep(req).data
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end)
        peak[name] = torch.cuda.max_memory_allocated() - base
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[sweep] launches on the sweep path: {launches}")
    for k in ARBITRATION_KERNELS:
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the sweep path")

    t = N_SIDE * N_SIDE
    for name, req, reps, sub in grids:
        wall0 = time.perf_counter()
        res = out[name]
        names = tuple(req.axes)
        n_points = int(np.prod([len(v) for v in req.axes.values()]))
        run_points = n_points // (len(req.axes["tr_mean"]) if req.policy is not None
                                  and req.metric == "eval" and req.tr_fast
                                  and "tr_mean" in req.axes else 1)
        chunk = _auto_chunk(req.cfg, req.units, run_points, req.scheme)
        per_point = (scheme_point_bytes(req.cfg, t) if req.scheme is not None
                     else policy_point_bytes(req.cfg, t))
        # Shapes and ranges.
        leaves = res if isinstance(res, tuple) else (res,)
        lead = tuple(len(v) for v in req.axes.values())
        for leaf in leaves:
            if tuple(leaf.shape[:len(lead)]) != lead or leaf.device.type != "cuda":
                fail(f"{name}: result {tuple(leaf.shape)} on {leaf.device}, axes {lead}")
            if leaf.dtype == torch.float32 and not bool(torch.isfinite(leaf).all()):
                fail(f"{name}: non-finite values")
        warm_ms = cuda_ms(lambda: sweep(req), reps) if reps else ms[name]
        # The per-point loop: one point a chunk.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = sweep(req.replace(chunk_size=1)).data
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - t0) * 1e3
        _hold_grid(f"{name} chunk_size=1 against auto", one, res, t)
        # The per-point oracle on a sub-grid.
        checked = "per-point loop"
        got, sub_req = res, req
        if sub is not None:
            sub_req = req.replace(axes={k: np.asarray(req.axes[k])[sub[k]] for k in names})
            pick = np.ix_(*(sub[k] for k in names))
            got = (type(res)(*(a[pick] for a in res)) if isinstance(res, tuple)
                   else res[pick])
            _hold_grid(f"{name} sweep_reference sub-grid", got, sweep_reference(sub_req).data,
                       t, exact_floats=req.metric == "min_tr")
            checked += f", sweep_reference on {int(np.prod([len(i) for i in sub.values()]))} points"
        # The CPU plain path on a 20 x 20 subset of the units (and on the
        # sub-grid's points): the same grid on those units on the CPU and on
        # the card; scheme grids also against the full run's trials.
        sub_units, idx = _subset(req.units, SUB_SIDE)
        cpu_kw = {"units": sub_units}
        if req.timeline is not None:
            cpu_kw["timeline"] = drift_timeline("wdm16-thermal", device="cpu")[1]
        cpu = sweep(sub_req.replace(chunk_size=None, **cpu_kw)).data
        card = sweep(sub_req.replace(units=UnitSamples(*(x.cuda() for x in sub_units)),
                                     chunk_size=None)).data
        _hold_grid(f"{name} card against the CPU on the {SUB_SIDE}x{SUB_SIDE} subset", card,
                   cpu, len(idx))
        if req.scheme is not None and req.timeline is None:
            for f in ("alg_success", "ideal_ok"):
                if not torch.equal(getattr(got, f)[..., idx].cpu(), getattr(cpu, f)):
                    fail(f"{name} {f} differs from the CPU plain path on the subset")
        if isinstance(res, tuple) and hasattr(res, "afp"):
            summary = f"mean CAFP {float(res.cafp.mean())!r}, mean AFP {float(res.afp.mean())!r}"
        elif isinstance(res, tuple):
            summary = (f"final-step mean locked {res.locked[..., -1].tolist()}, "
                       f"probes {res.probes.sum(dim=-1).tolist()}")
        else:
            summary = f"values {[round(v, 4) for v in res.reshape(-1)[:12].tolist()]}"
        print(f"[sweep] {name}: {n_points} points ({run_points} evaluated, chunk {chunk}), "
              f"{ms[name]!r} ms first call, {warm_ms!r} ms/call, per-point loop "
              f"(chunk_size=1) {loop_ms!r} ms; peak {peak[name]} bytes above the start "
              f"against chunk x per-point bytes {min(chunk, run_points) * per_point}; "
              f"{summary} (equal to the {checked} and to the CPU plain path on the "
              f"{SUB_SIDE}x{SUB_SIDE} subset; {time.perf_counter() - wall0:.1f} s of checks)")
    print(f"[sweep] peak device memory of the phase {torch.cuda.max_memory_allocated()} bytes "
          f"(torch.cuda.max_memory_allocated since the last grid's reset)")
    if store is not None:
        store.update({name: (req, out[name], ms[name]) for name, req, _, _ in grids})
    return launches


def phase_records(device: str = "cuda") -> None:
    """``BENCH_sweep.json``'s fig4, fig5, fig14, fig17 and fig19 records,
    recomputed by the port's sweeps on units drawn as the benchmarks drew
    them (24 x 24 at each benchmark's seed, JAX's earlier threefry layout);
    AFP and CAFP as counts of 576 trials, exactly; fig5's min TR within 5e-5."""
    import numpy as np

    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core import api
    from repro_torch.core.sweep import sweep_min_tr, sweep_policy, sweep_scheme

    path = ROOT / "BENCH_sweep.json"
    if not path.is_file():
        fail("BENCH_sweep.json is not beside this script")
    records = {r["name"]: r["derived"] for r in json.loads(path.read_text())["records"]}
    t = RECORD_SIDE ** 2

    def units(cfg, fig):
        return api.make_units(cfg, RECORD_SEEDS[fig], RECORD_SIDE, RECORD_SIDE, device=device,
                              partitionable=False)

    def hold_counts(rec_name, got, want):
        got = np.rint(np.abs(np.asarray(got.cpu(), np.float64)) * t).astype(np.int64)
        want = np.rint(np.asarray(want, np.float64) * t).astype(np.int64)
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"record {rec_name}: counts {got.tolist()} against the record's "
                 f"{want.tolist()}")

    held = {}
    wall0 = time.perf_counter()
    wdm8, wdm16 = WDM_CONFIGS["wdm8-g200"], WDM_CONFIGS["wdm16-g200"]
    fig4 = {"sigma_rlv": rlv_sweep(), "tr_mean": tr_sweep()}
    for case, policy, order in FIG4_CASES:
        cfg = wdm8.with_orders(order)
        hold_counts(f"fig4/{case}", sweep_policy(cfg, units(cfg, "fig4"), policy, fig4),
                    records[f"fig4/{case}"]["shmoo_afp"])
    hold_counts("fig4/LtA-16", sweep_policy(wdm16, units(wdm16, "fig4"), "lta",
                                            {"sigma_rlv": rlv_sweep(), "tr_mean": tr_sweep(16)}),
                records["fig4/LtA-16"]["shmoo_afp"])
    held["fig4"] = len(FIG4_CASES) + 1
    worst = 0.0
    for key, base in WDM_CONFIGS.items():
        rlvs = np.array(FIG5_RLV_X) * base.grid.grid_spacing
        for case, policy, order in FIG4_CASES[:4]:
            cfg = base.with_orders(order)
            got = sweep_min_tr(cfg, units(cfg, "fig5"), policy, {"sigma_rlv": rlvs})
            want = np.asarray(records[f"fig5/{key}/{case}"]["min_tr"], np.float64)
            err = float(np.abs(np.asarray(got.cpu(), np.float64) - want).max())
            worst = max(worst, err)
            if not err <= 5e-5:
                fail(f"record fig5/{key}/{case}: min TR {got.tolist()} against "
                     f"{want.tolist()} (|diff| {err})")
            held["fig5"] = held.get("fig5", 0) + 1
    fig14 = {"sigma_rlv": rlv_sweep()[:6], "tr_mean": tr_sweep()}
    for order in ("natural", "permuted"):
        cfg = wdm8.with_orders(order)
        for scheme in SCHEMES:
            hold_counts(f"fig14/{order}/{scheme}",
                        sweep_scheme(cfg, units(cfg, "fig14"), scheme, fig14).cafp,
                        records[f"fig14/{order}/{scheme}"]["cafp"])
            held["fig14"] = held.get("fig14", 0) + 1
    for fig, schemes, prefix in (("fig17", FIG17_SCHEMES, "fig17/"),
                                 ("fig19", FIG19_SCHEMES, "fig19/wdm8/")):
        u = units(wdm8, fig)
        for scheme in schemes:
            hold_counts(f"{prefix}{scheme}",
                        sweep_scheme(wdm8, u, scheme, {"tr_mean": tr_sweep()}).cafp,
                        records[f"{prefix}{scheme}"]["cafp_vs_ideal_lta"])
            held[fig] = held.get(fig, 0) + 1
    for fig, n in held.items():
        extra = f" (max |min TR - record| {worst!r})" if fig == "fig5" else ""
        print(f"[records] {fig}: {n} BENCH_sweep.json records held, exact as counts of "
              f"{t} trials{extra}")
    print(f"[records] {time.perf_counter() - wall0:.1f} s")
    wall0 = time.perf_counter()
    for fig, n in records_fabric(device).items():
        how = ({"fig21": "its grids after the records' rounding to 4 decimals",
                "fig22": "per-step link means at 2 decimals, fabric steps at 4, its gates and "
                         "the no-fault parity"}[fig])
        print(f"[records] {fig}: {n} BENCH_sweep.json records held ({how})")
    print(f"[records] fabric records {time.perf_counter() - wall0:.1f} s")


def fig21_axes(cfg):
    import numpy as np

    return {"comb_coupling": np.array([0.0, 1.0], np.float32),
            "tr_mean": np.array(FIG21_TRS_X, np.float32) * cfg.grid.fsr}


def fig22_1k_timeline(cfg, spec, device=None):
    """``fig22_fabric_chaos.py``'s ``--full`` timeline: 3 steps across the
    1,008-link fabric, a 0.2-spacing thermal ramp, link 100 flapped down
    for one step at step 1."""
    from repro_torch.fabric import make_fabric_timeline

    return make_fabric_timeline(spec, 3, cfg.grid.n_ch, thermal=0.2 * cfg.grid.grid_spacing,
                                events=((1, "link_flap", 100, 1),), device=device)


def _unit_subset(units, idx):
    """The units of links ``idx`` alone, on the CPU."""
    from repro_torch.fabric import FabricUnits

    return FabricUnits(*(u[list(idx)].cpu().contiguous() for u in units))


def _subset_spec(spec, n_links):
    """A route-less spec of the same comb group over ``n_links`` links: the
    per-link paths read only the comb group (the units carry the group draws
    gathered per link)."""
    from repro_torch.fabric import FabricSpec

    return FabricSpec(pods=2, links_per_pair=n_links, comb_group=spec.comb_group)


def phase_fabric_kernels(seed: int) -> dict:
    """Phase 2 at the fabric paths' shapes: ``table_build`` at fig21's 2,016
    WDM16 trials with a per-link (T, N, N) mask of a chaos step, dead links
    all-False rows; ``match`` with the all-zero rows of dead rings and
    links; ``probe`` on the empty tables of dead links; ``feasibility`` at
    the same 2,016 trials; and the interconnect's warm-repair tables: the
    runtime's per-link-comb fabric with a 2-D (2K, N) mask whose dead links
    (``RUNTIME_DEAD``) give all-False rows, and ``probe`` on them.  All
    exactly against the plain versions."""
    import numpy as np
    import torch

    from repro_torch.configs.fabric import FABRIC_CONFIGS
    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core.matching import adjacency_bitmask
    from repro_torch.core.reach import as_f32, reach_matrix
    from repro_torch.fabric import (FabricSpec, instantiate_links, make_fabric_timeline,
                                    make_fabric_units)
    from repro_torch.fabric.chaos import _drifted, _visibility
    from repro_torch.kernels.bitmask_match import perfect_matching, perfect_matching_plain
    from repro_torch.kernels.feasibility import feasibility, feasibility_plain
    from repro_torch.kernels.probe import masked_research, masked_research_plain
    from repro_torch.kernels.table_build import build_tables, build_tables_plain

    errs = {"table_build": [], "match": [], "probe": [], "feasibility": []}
    cfg_key, spec = FABRIC_CONFIGS["fabric1k-wdm16"]
    cfg = WDM_CONFIGS[cfg_key]
    n, k = cfg.grid.n_ch, spec.n_links
    gen = torch.Generator().manual_seed(seed)
    dead_links = torch.randperm(k, generator=gen)[:50].tolist()
    events = [(1, "link_kill", l) for l in dead_links]
    events += [(1, "ring_kill", int(l), int(e), int(c)) for l, e, c in zip(
        torch.randint(0, k, (200,), generator=gen), torch.randint(0, 2, (200,), generator=gen),
        torch.randint(0, n, (200,), generator=gen))]
    events += [(1, "lane_kill", int(l), int(c)) for l, c in zip(
        torch.randint(0, k, (200,), generator=gen), torch.randint(0, n, (200,), generator=gen))]
    events += [(1, "comb_kill", 3)]
    tl = make_fabric_timeline(spec, 2, n, thermal=0.2 * cfg.grid.grid_spacing, events=events)
    step = type(tl)(*(a[1] for a in tl))
    units = make_fabric_units(cfg, spec, seed)
    sys_ = _drifted(cfg, instantiate_links(cfg, spec, units), step)
    vis = _visibility(step, n)
    dead_rows = int((~vis.any(dim=2).any(dim=1)).sum())
    for tr_x in FIG21_TRS_X:
        tr_mean = tr_x * cfg.grid.fsr
        tr = as_f32(tr_mean, sys_.tr_unit.device) * sys_.tr_unit
        args = (sys_.laser, sys_.ring, sys_.fsr, tr)
        kw = dict(max_alias=cfg.max_fsr_alias, max_entries=3 * n)
        got = build_tables(*args, visible=vis, **kw)
        want = build_tables_plain(*(a.cpu() for a in args), visible=vis.cpu(), **kw)
        for tag, g, w in zip(("delta", "wl", "n_valid"), got, want):
            compare(f"table_build fabric1k TR={tr_x} FSR {tag}", g, w, errs["table_build"])
        empty = int((got[2].reshape(-1, 2 * n) == 0).all(dim=1).sum())
        if empty < len(dead_links):
            fail(f"table_build fabric1k: {empty} links with empty tables, "
                 f"{len(dead_links)} links dead")
        print(f"[kernels] table_build fabric1k TR={tr_x} FSR: T={args[0].shape[0]} with a "
              f"(T, N, N) mask, all False on {dead_rows} trials ({len(dead_links)} dead links "
              f"and a dead comb); exact ({empty} links with empty tables)")
        # probe on those tables: C = 1 and 4 rows, half the lines taken
        wl_all = got[1]
        taken = (torch.rand(wl_all.shape[0], n, generator=gen) < 0.5).cuda()
        for c in (1, 4):
            wl = wl_all[:, :c].contiguous()
            floor = torch.randint(0, 3 * n + 1, (wl.shape[0], c), generator=gen,
                                  dtype=torch.int32).cuda()
            g = masked_research(wl, taken, floor)
            w = masked_research_plain(wl, taken, floor)
            compare(f"probe fabric1k C={c} first", g[0], w[0], errs["probe"])
            compare(f"probe fabric1k C={c} found", g[1], w[1], errs["probe"])
            dead = (got[2][:, :c] == 0)
            if bool(g[1][dead].any()):
                fail(f"probe fabric1k C={c}: found an entry in an empty table")
            print(f"[kernels] probe fabric1k TR={tr_x} FSR C={c}: T={wl.shape[0]} exact "
                  f"({int(dead.sum())} rows of empty tables, none found)")
        # match on the live bus: dead rings and dead links are all-zero rows
        lane = step.lane_alive.repeat_interleave(2, dim=0)
        ring = step.ring_alive.reshape(-1, n)
        link = step.link_alive.repeat_interleave(2)
        reach = (reach_matrix(sys_, tr_mean) & lane[:, None, :] & ring[:, :, None]
                 & link[:, None, None])
        adj = adjacency_bitmask(reach)
        g, w = perfect_matching(adj), perfect_matching_plain(adj)
        compare(f"match fabric1k TR={tr_x} FSR match_wl", g[0], w[0], errs["match"])
        compare(f"match fabric1k TR={tr_x} FSR ok", g[1], w[1], errs["match"])
        print(f"[kernels] match fabric1k TR={tr_x} FSR: T={adj.shape[0]} exact "
              f"({int((adj == 0).sum())} all-zero rows, {int(g[1].sum())} perfect)")
    got = feasibility(*sys_, cfg.s)
    want = feasibility_plain(*(x.cpu() for x in sys_), cfg.s)
    for tag, g, w in zip(("ltd", "ltc"), got, want):
        compare(f"feasibility fabric1k {tag}", g, w, errs["feasibility"])
    print(f"[kernels] feasibility fabric1k: T={sys_.laser.shape[0]} bit-exact")

    # The interconnect's warm repair: the runtime's per-link-comb fabric with
    # links 100 and 1,007 dead, a 2-D (2K, N) mask of all-False rows 2k, 2k+1.
    rt_spec = FabricSpec(pods=spec.pods, links_per_pair=spec.links_per_pair, comb_group="link")
    rt_sys = instantiate_links(cfg, rt_spec, make_fabric_units(cfg, rt_spec, seed))
    alive = np.ones(k, bool)
    alive[list(RUNTIME_DEAD)] = False
    vis2 = torch.from_numpy(np.repeat(alive, 2)).cuda()[:, None].expand(-1, n).contiguous()
    dead_rows = [r for l in RUNTIME_DEAD for r in (2 * l, 2 * l + 1)]
    tr = as_f32(FIG21_TRS_X[0] * cfg.grid.fsr, rt_sys.tr_unit.device) * rt_sys.tr_unit
    args = (rt_sys.laser, rt_sys.ring, rt_sys.fsr, tr)
    kw = dict(max_alias=cfg.max_fsr_alias, max_entries=3 * n)
    got = build_tables(*args, visible=vis2, **kw)
    want = build_tables_plain(*(a.cpu() for a in args), visible=vis2.cpu(), **kw)
    for tag, g, w in zip(("delta", "wl", "n_valid"), got, want):
        compare(f"table_build runtime 2-D mask {tag}", g, w, errs["table_build"])
    if bool(got[2][dead_rows].any()) or int((got[2] == 0).all(dim=1).sum()) < len(dead_rows):
        fail("table_build runtime 2-D mask: the dead links' tables are not empty")
    print(f"[kernels] table_build runtime fabric (comb per link) TR={FIG21_TRS_X[0]} FSR: "
          f"T={args[0].shape[0]} with a 2-D (T, N) mask, rows {dead_rows} all False; exact "
          f"(their tables empty)")
    taken = (torch.rand(got[1].shape[0], n, generator=gen) < 0.5).cuda()
    for c in (1, 4):
        wl = got[1][:, :c].contiguous()
        floor = torch.randint(0, 3 * n + 1, (wl.shape[0], c), generator=gen,
                              dtype=torch.int32).cuda()
        floor[dead_rows] = 0
        g = masked_research(wl, taken, floor)
        w = masked_research_plain(wl, taken, floor)
        compare(f"probe runtime C={c} first", g[0], w[0], errs["probe"])
        compare(f"probe runtime C={c} found", g[1], w[1], errs["probe"])
        if bool(g[1][dead_rows].any()):
            fail(f"probe runtime C={c}: found an entry in a dead link's empty table")
        print(f"[kernels] probe runtime fabric C={c}: T={wl.shape[0]} exact (the dead "
              f"links' {len(dead_rows)} rows of empty tables, none found)")
    return {key: max(v) for key, v in errs.items()}


def phase_draw_kernel(seed: int) -> float:
    """The draw kernel (``threefry_draw``) against its plain version on the
    CPU in each of its three modes (raw words, uniform [1, 16), normal times
    2048 ** -0.5), on ragged blocks: a whole 1,000,003-element vector, a
    block of a (3, 1031, 997) tensor, one of a 4-D (2, 5, 129, 67) tensor,
    and the last 11 rows of a (70001, 70001) tensor, whose counters pass
    2**32 (the high counter word).  Raw words and uniforms bit for bit,
    normals within ``DRAW_F32_ULP``.  Returns the max |diff|."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels.threefry import (
        BITS,
        NORMAL,
        NORMAL_LO,
        UNIFORM,
        threefry_draw,
        threefry_plain,
    )

    t0 = time.perf_counter()
    cases = (((1_000_003,), None, None),
             ((3, 1031, 997), (1, 17, 5), (2, 1000, 991)),
             ((2, 5, 129, 67), (1, 1, 3, 0), (1, 4, 125, 67)),
             ((70_001, 70_001), (69_990, 0), (11, 70_001)))
    modes = ((BITS, {}), (UNIFORM, dict(lo=1.0, hi=16.0)),
             (NORMAL, dict(lo=NORMAL_LO, hi=1.0, scale=2048 ** -0.5)))
    errs, gap, n_diff, n = [], 0, 0, 0
    for key, (shape, start, length) in zip(prng.split(prng.key_from_seed(seed + 26), 4), cases):
        length = shape if length is None else length
        for mode, kw in modes:
            want = threefry_plain(key, shape, start, length, mode=mode, **kw)
            got = threefry_draw(torch.empty(length, dtype=want.dtype, device="cuda"), key,
                                shape, start, mode=mode, **kw)
            torch.cuda.synchronize()
            name = f"threefry mode {mode} {shape} block {start} + {length}"
            if mode != NORMAL:
                compare(name, got, want, errs)
                continue
            got = got.cpu()
            g = ulp_gap(got, want)
            if not g <= DRAW_F32_ULP or not torch.isfinite(got).all():
                fail(f"{name}: {g} ulp from the plain version (bound {DRAW_F32_ULP})")
            errs.append(float((got.double() - want.double()).abs().max()))
            gap, n_diff, n = max(gap, g), n_diff + int((bits(got) != bits(want)).sum()), \
                n + got.numel()
    print(f"[draw] kernel against its plain version on the CPU, 3 modes x 4 ragged blocks: "
          f"raw words and uniforms bit for bit; normals {n_diff} of {n} elements differ, "
          f"largest gap {gap} ulp (bound {DRAW_F32_ULP}); max |diff| {max(errs)!r}; "
          f"{time.perf_counter() - t0:.1f} s")
    return max(errs)


def draw_timing(seed: int) -> tuple:
    """The draw kernel's times at the main path's shapes: one super-block of
    internlm2-1.8b's stacked ``wq`` (2,048 x 2,048 normals: the block a
    rank draws at a (2, 2048, 2048) leaf's second index) for the kernels
    line, beside its bound (4 bytes an element written; ``NORMAL_FLOPS``
    float32 operations an element) and its plain version on the CPU (one
    call, host clock); and the whole (92544, 2048) embedding by CUDA events
    only."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels.threefry import NORMAL, NORMAL_LO, threefry_draw, threefry_plain

    key = prng.key_from_seed(seed)
    kw = dict(mode=NORMAL, lo=NORMAL_LO, hi=1.0, scale=2048 ** -0.5)
    shape, start, length = (2, 2048, 2048), (1, 0, 0), (1, 2048, 2048)
    out = torch.empty(length, device="cuda")
    fn = lambda: threefry_draw(out, key, shape, start, **kw)  # noqa: E731
    ms, call_ms = device_ms(fn, 20, "threefry_kernel"), cuda_ms(fn, 20)
    t0 = time.perf_counter()
    threefry_plain(key, shape, start, length, **kw)
    plain_ms = (time.perf_counter() - t0) * 1e3
    n = math.prod(length)
    bound, by = bound_ms(4 * n, NORMAL_FLOPS * n)
    emb = torch.empty((92544, 2048), device="cuda")
    emb_ms = cuda_ms(lambda: threefry_draw(emb, key, emb.shape, **kw), 5)
    emb_bound, emb_by = bound_ms(4 * emb.numel(), NORMAL_FLOPS * emb.numel())
    print(f"[time] threefry normal {length} of {shape}: kernel {ms!r} ms on the device, "
          f"{call_ms!r} ms per wrapper call, plain {plain_ms!r} ms (CPU), bound {bound!r} ms "
          f"({by}); the (92544, 2048) embedding: {emb_ms!r} ms a call, bound {emb_bound!r} ms "
          f"({emb_by})")
    del emb, out
    torch.cuda.empty_cache()
    return ms, call_ms, plain_ms, bound, by


def _hold_links(name, got, want):
    """Per-link fields (tensors or named tuples of them) equal exactly."""
    import torch

    for f, g, w in zip(got._fields, got, want):
        if g is None or f == "fabric":
            continue
        g, w = g.detach().cpu(), w.detach().cpu()
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            fail(f"{name} {f}: differs from the CPU plain path "
                 f"({g.dtype}{tuple(g.shape)} against {w.dtype}{tuple(w.shape)})")


def phase_fabric(seed: int, store: dict | None = None) -> dict:
    """The fabric path: ``bringup`` on FABRIC_1K (WDM16, 1,008 links) for
    seq_retry, vtrs_ssm and protocol_lta and on FABRIC_10K (10,080 links,
    pod-shared combs) for vtrs_ssm and protocol_lta; fig21's grid through
    ``sweep(SweepRequest(fabric=...))`` for the three schemes; with the
    launch counts set to 0 just before and read just after.  Then each grid
    against the same grid at ``chunk_size=1``, fig21's constraints-off
    parity on all 1,008 links (one flat ``oblivious_arbitrate`` over the
    core ``instantiate`` of every link), and per-link records of a link
    subset against the CPU plain path run on those links alone.  ``store``
    receives each bring-up's ``FabricResult``, and their wall ms under
    ``"ms"``, for ``phase_mesh``."""
    import torch

    from repro_torch.configs.fabric import FABRIC_CONFIGS
    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core.api import oblivious_arbitrate
    from repro_torch.core.sampling import SystemBatch, UnitSamples, instantiate
    from repro_torch.core.sweep import SweepRequest, sweep
    from repro_torch.fabric import bringup, make_fabric_units
    from repro_torch.fabric.bringup import _eval_links
    from repro_torch.core.variations import Variations

    cells = []
    for key, schemes in (("fabric1k-wdm16", FIG21_SCHEMES),
                         ("fabric10k-wdm16", ("vtrs_ssm", "protocol_lta"))):
        cfg_key, spec = FABRIC_CONFIGS[key]
        for scheme in schemes:
            cells.append((key, WDM_CONFIGS[cfg_key], spec, scheme))
    cfg1k_key, spec1k = FABRIC_CONFIGS["fabric1k-wdm16"]
    cfg1k = WDM_CONFIGS[cfg1k_key]
    axes = fig21_axes(cfg1k)
    tr0 = float(axes["tr_mean"][0])
    units1k = make_fabric_units(cfg1k, spec1k, seed)

    wrappers = reset_launches()
    out, ms, n_probe = {}, {}, {}
    for key, cfg, spec, scheme in cells:
        out[key, scheme], ms[key, scheme], n_probe[key, scheme] = timed_call(
            lambda: bringup(cfg, spec, tr_mean=tr0, scheme=scheme, seed=seed))
    for scheme in FIG21_SCHEMES:
        req = SweepRequest(cfg=cfg1k, units=units1k, scheme=scheme, fabric=spec1k, axes=axes)
        out["grid", scheme], ms["grid", scheme], n_probe["grid", scheme] = timed_call(
            lambda: sweep(req).data)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[fabric] launches on the fabric path: {launches}")
    for k in ("table_build", "feasibility", "match", "probe"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the fabric path")

    for key, cfg, spec, scheme in cells:
        res = out[key, scheme]
        k, n = spec.n_links, cfg.grid.n_ch
        if res.ev.wl.shape != (k, 2, n) or res.ev.wl.device.type != "cuda":
            fail(f"{key} {scheme}: records {tuple(res.ev.wl.shape)} on {res.ev.wl.device}")
        for f in res.stats._fields:
            x = float(getattr(res.stats, f))
            if not 0.0 <= x <= 1.0:
                fail(f"{key} {scheme} {f} = {x} outside [0, 1]")
        t0 = time.perf_counter()
        idx = tuple(j % k for j in FABRIC_SUBSET)
        sub = _unit_subset(res.units, idx)
        ref = _eval_links(cfg, _subset_spec(spec, len(idx)), scheme,
                          Variations(tr_mean=tr0), sub)
        got = type(res.ev)(*(a[list(idx)] for a in res.ev))
        _hold_links(f"{key} {scheme} links {idx[0]}..{idx[-1]}", got, ref)
        s = res.stats
        print(f"[fabric] {key} bringup {scheme} TR={tr0!r}: {k} links ({2 * k} trials), "
              f"{ms[key, scheme]!r} ms/call, {n_probe[key, scheme]} probe launches; "
              f"link_up={float(s.link_up)!r} cafp={float(s.cafp)!r} afp={float(s.afp)!r} "
              f"matched={float(s.matched)!r} bandwidth={float(s.bandwidth)!r} "
              f"route_up={float(s.route_up)!r} route_cont={float(s.route_cont)!r} "
              f"(LinkEval of links {idx[:3]}..{idx[-3:]} ({len(idx)}) equal to the CPU "
              f"plain path on those links alone; {time.perf_counter() - t0:.1f} s of checks)")

    for scheme in FIG21_SCHEMES:
        t0 = time.perf_counter()
        grid = out["grid", scheme]
        req = SweepRequest(cfg=cfg1k, units=units1k, scheme=scheme, fabric=spec1k, axes=axes)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        one = sweep(req.replace(chunk_size=1)).data
        torch.cuda.synchronize()
        loop_ms = (time.perf_counter() - w0) * 1e3
        _hold_grid(f"fig21 {scheme} grid chunk_size=1 against auto", one, grid, spec1k.n_links)
        for f in grid._fields:
            g = getattr(grid, f)
            if g.shape != (2, 2) or g.device.type != "cuda" or not bool(torch.isfinite(g).all()):
                fail(f"fig21 {scheme} {f}: {tuple(g.shape)} on {g.device}")
        # the grid's point (coupling 0, TR 0.40 FSR) is the bring-up above,
        # which drew the same units
        for f in grid._fields:
            if not torch.equal(getattr(grid, f)[0, 0],
                               getattr(out["fabric1k-wdm16", scheme].stats, f)):
                fail(f"fig21 {scheme} {f}: grid point (0, 0) differs from bringup")
        print(f"[fabric] fig21 grid {scheme}: 4 points x {2 * spec1k.n_links} trials, "
              f"{ms['grid', scheme]!r} ms/grid ({n_probe['grid', scheme]} probe launches), "
              f"per-point loop (chunk_size=1) {loop_ms!r} ms; link_up "
              f"{grid.link_up.tolist()} cafp {grid.cafp.tolist()} (equal to the per-point "
              f"loop and, at (0, 0), to bringup; {time.perf_counter() - t0:.1f} s)")

    # Constraints-off parity on all 1,008 links: bringup equals the core
    # instantiate of each link (L = 1 laser, R = 2 rings), stacked, and one
    # flat oblivious_arbitrate over the 2,016 trials.
    t0 = time.perf_counter()
    res = out["fabric1k-wdm16", "vtrs_ssm"]
    u = res.units
    per = [instantiate(cfg1k, UnitSamples(u.go[j:j + 1, None], u.llv[j:j + 1], u.rlv[j],
                                          u.fsr[j], u.tr[j])) for j in range(spec1k.n_links)]
    flat = SystemBatch(*(torch.cat(x) for x in zip(*per)))
    for f, a, b in zip(flat._fields, flat, res.system):
        if not torch.equal(bits(a), bits(b)):
            fail(f"fig21 parity: system {f} differs from the per-link core instantiate")
    asg = oblivious_arbitrate(cfg1k, flat, tr0, "vtrs_ssm")
    if not (torch.equal(asg.wl.view(-1, 2, cfg1k.grid.n_ch), res.ev.wl)
            and torch.equal(asg.entry.view(-1, 2, cfg1k.grid.n_ch), res.ev.entry)):
        fail("fig21 parity: bringup differs from one flat oblivious_arbitrate")
    print(f"[fabric] fig21 constraints-off parity: {spec1k.n_links} links of bringup vtrs_ssm "
          f"bit-identical to one flat oblivious_arbitrate over {2 * spec1k.n_links} trials "
          f"({time.perf_counter() - t0:.1f} s)")
    if store is not None:
        store.update({key: out[key] for key in out if key[0] != "grid"})
        store["ms"] = ms
    return launches


def _chaos_cells():
    """(scenario, scheme) pairs of fig22's default mode."""
    return [(name, scheme) for name in FIG22_SCENARIOS
            for scheme in FIG22_SCHEMES.get(name, ("vtrs_ssm",))]


def phase_chaos(seed: int, store: dict | None = None) -> dict:
    """The chaos path: the four fig22 scenarios with the records' schemes,
    warm and cold (6 steps, 48 WDM16 links), ``tiny-flap`` warm and cold,
    and the 1,008-link 3-step timeline of ``fig22_fabric_chaos.py --full``
    warm with vtrs_ssm, with the launch counts set to 0 just before and read
    just after.  Then per-step per-link fields against the CPU plain path
    (all 48 links of mid-linkflap/vtrs_ssm, warm and cold; a link subset of
    the 1,008 with link 100), and the no-fault parity on the card.  ``store``
    receives every run's (state, stats) for ``phase_obs`` and ``phase_mesh``,
    and their wall ms under ``"ms"``."""
    import torch

    from repro_torch.configs.fabric import FABRIC_CONFIGS, chaos_timeline
    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.fabric import (FabricTimeline, bringup, make_fabric_timeline,
                                    make_fabric_units, run_fabric_timeline)

    runs = []
    for name, scheme in _chaos_cells() + [("tiny-flap", "vtrs_ssm")]:
        cfg, spec, tl = chaos_timeline(name)
        runs.append((name, scheme, cfg, spec, tl, make_fabric_units(cfg, spec, seed)))
    cfg_key, spec1k = FABRIC_CONFIGS["fabric1k-wdm16"]
    cfg1k = WDM_CONFIGS[cfg_key]
    tl1k = fig22_1k_timeline(cfg1k, spec1k)
    units1k = make_fabric_units(cfg1k, spec1k, seed)

    wrappers = reset_launches()
    out, ms, n_probe = {}, {}, {}
    for name, scheme, cfg, spec, tl, units in runs:
        for warm in (True, False):
            out[name, scheme, warm], ms[name, scheme, warm], n_probe[name, scheme, warm] = \
                timed_call(lambda: run_fabric_timeline(cfg, units, spec, tl, scheme=scheme,
                                                       warm=warm))
    out["1k"], ms["1k"], n_probe["1k"] = timed_call(
        lambda: run_fabric_timeline(cfg1k, units1k, spec1k, tl1k, scheme="vtrs_ssm"))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[chaos] launches on the chaos path: {launches}")
    for k in ("table_build", "feasibility", "match", "probe"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the chaos path")

    mean = lambda x: [round(v, 4) for v in x.double().mean(dim=1).tolist()]  # noqa: E731
    for name, scheme, cfg, spec, tl, units in runs:
        for warm in (True, False):
            t0 = time.perf_counter()
            state, cs = out[name, scheme, warm]
            s, k, n = tl.n_steps, spec.n_links, cfg.grid.n_ch
            if cs.wl.shape != (s, k, 2, n) or state.lock.shape != (2 * k, n):
                fail(f"{name} {scheme}: wl {tuple(cs.wl.shape)}, state {tuple(state.lock.shape)}")
            if int(cs.locked.max()) > 2 * n or int(cs.probes[0].abs().sum()) != 0:
                fail(f"{name} {scheme}: locked or step-0 probes out of range")
            checked = ""
            if (name, scheme) in (("mid-linkflap", "vtrs_ssm"), ("tiny-flap", "vtrs_ssm")):
                _, _, tl_cpu = chaos_timeline(name, device="cpu")
                u_cpu = type(units)(*(x.cpu() for x in units))
                ref_state, ref = run_fabric_timeline(cfg, u_cpu, spec, tl_cpu, scheme=scheme,
                                                     warm=warm)
                _hold_links(f"{name} {scheme} warm={warm}", cs, ref)
                _hold_links(f"{name} {scheme} warm={warm} final state", state, ref_state)
                _hold_grid(f"{name} {scheme} warm={warm} FabricStats", cs.fabric, ref.fabric, k)
                checked = f"; all {k} links per step and the final state equal to the CPU plain path"
            print(f"[chaos] {name} {scheme} {'warm' if warm else 'cold'}: {k} links x {s} steps, "
                  f"{ms[name, scheme, warm]!r} ms/timeline, {n_probe[name, scheme, warm]} probe "
                  f"launches; per-step mean probes {mean(cs.probes)}, locked {mean(cs.locked)}, "
                  f"broken {mean(cs.broken)}, feasible {mean(cs.feasible)}, bandwidth "
                  f"{[round(v, 4) for v in cs.fabric.bandwidth.tolist()]}{checked} "
                  f"({time.perf_counter() - t0:.1f} s of checks)")

    t0 = time.perf_counter()
    state, cs = out["1k"]
    idx = [j % spec1k.n_links for j in FABRIC_SUBSET]
    sub_tl = FabricTimeline(*(a[:, idx].cpu() for a in tl1k))
    sub_spec = _subset_spec(spec1k, len(idx))
    ref_state, ref = run_fabric_timeline(cfg1k, _unit_subset(units1k, idx), sub_spec, sub_tl,
                                         scheme="vtrs_ssm")
    got = cs._replace(**{f: getattr(cs, f)[:, idx] for f in cs._fields
                         if f not in ("fabric", "health")})
    _hold_links("1k chaos timeline link subset", got, ref)
    rows = [r for j in idx for r in (2 * j, 2 * j + 1)]
    _hold_links("1k chaos final state link subset",
                type(state)(*(x[rows] for x in state)), ref_state)
    if bool((cs.wl[1, 100] >= 0).any()) or int(cs.locked[2, 100]) == 0:
        fail("1k chaos: link 100 not dark at step 1 or not re-locked at step 2")
    print(f"[chaos] fabric1k flap timeline vtrs_ssm warm: {spec1k.n_links} links x 3 steps, "
          f"{ms['1k']!r} ms/timeline, {n_probe['1k']} probe launches; bandwidth "
          f"{cs.fabric.bandwidth.tolist()}, per-step mean probes {mean(cs.probes)} (per-link "
          f"fields of links {idx[:3]}..{idx[-3:]} ({len(idx)}, link 100 among them) equal to "
          f"the CPU plain path; {time.perf_counter() - t0:.1f} s of checks)")

    # No-fault parity on the card: a quiet 6-step timeline on mid-linkflap's
    # fabric; step 0 is bringup bit for bit, later steps spend nothing.
    cfg, spec, tl = chaos_timeline("mid-linkflap")
    quiet = make_fabric_timeline(spec, tl.n_steps, cfg.grid.n_ch)
    _, cs = run_fabric_timeline(cfg, make_fabric_units(cfg, spec, seed), spec, quiet)
    ref = bringup(cfg, spec, scheme="vtrs_ssm", seed=seed)
    if not torch.equal(cs.wl[0], ref.ev.wl):
        fail("no-fault parity: step 0 locks differ from bringup")
    for f in cs.fabric._fields:
        if not torch.equal(getattr(cs.fabric, f)[0], getattr(ref.stats, f)):
            fail(f"no-fault parity: step-0 {f} differs from bringup")
    if int(cs.probes[1:].sum()) != 0 or not torch.equal(cs.wl[1:], cs.wl[:1].expand_as(cs.wl[1:])):
        fail("no-fault parity: quiet steps spent probes or moved locks")
    print(f"[chaos] no-fault parity: {spec.n_links} links x {tl.n_steps} quiet steps, step 0 "
          f"bit-identical to bringup, no probe spent after it")
    if store is not None:
        store.update(out)
        store["ms"] = ms
    return launches


def _runtime_cells():
    """(config key, cfg, tr_mean) of each ``RUNTIME_POINTS`` entry."""
    from repro_torch.configs.wdm import WDM_CONFIGS

    cells = []
    for key, tr_nm, tr_fsr in RUNTIME_POINTS:
        cfg = WDM_CONFIGS[key]
        cells.append((key, cfg, tr_nm if tr_fsr is None else tr_fsr * cfg.grid.fsr))
    return cells


def _runtime_sequence(cfg, tr, seed, device=None, timer=None):
    """The interconnect runtime's sequence on FABRIC_1K's 8 pods x 36 links:
    bringup, rearbitrate, inject_link_failure(RUNTIME_DEAD), rearbitrate,
    expected_failure_rates.  ``timer`` wraps each call (``timed_call``)."""
    from repro_torch.optics import interconnect as ic

    timer = timer or (lambda fn: (fn(), None, None))
    steps = {}
    steps["bringup"] = timer(lambda: ic.bringup(8, 36, cfg, tr_mean=tr, scheme="vtrs_ssm",
                                                seed=seed, device=device))
    fab0 = steps["bringup"][0]
    steps["rearbitrate"] = timer(lambda: ic.rearbitrate(fab0, cfg))
    fab1 = steps["rearbitrate"][0][0]
    steps["inject"] = timer(lambda: ic.inject_link_failure(fab1, list(RUNTIME_DEAD)))
    hurt = steps["inject"][0]
    steps["rearbitrate after inject"] = timer(lambda: ic.rearbitrate(hurt, cfg))
    steps["expected_failure_rates"] = timer(lambda: ic.expected_failure_rates(
        cfg, tr, "vtrs_ssm", seed, device=device))
    return steps


def _fabric_states(steps):
    """(label, FabricState, rounds) of each runtime step that yields one."""
    return [("bringup", steps["bringup"][0], None),
            ("rearbitrate", *steps["rearbitrate"][0]),
            ("inject", steps["inject"][0], None),
            ("rearbitrate after inject", *steps["rearbitrate after inject"][0])]


def phase_interconnect(seed: int) -> dict:
    """The interconnect runtime at full width: FABRIC_1K's 8 pods x 36 links
    = 1,008 links with a comb per link (what ``optics.interconnect.bringup``
    builds), vtrs_ssm, at each ``RUNTIME_POINTS`` entry: bringup,
    rearbitrate, inject_link_failure of links 100 and 1,007, rearbitrate
    again and expected_failure_rates, each timed, with the launch counts set
    to 0 just before and read just after.  Then the runtime's invariants
    (killed links down with broken lock rows, no survivor loses lanes,
    links healthy at bring-up untouched) and every step against the CPU
    plain path run on all 1,008 links: every ``LinkHealth``, the rounds, the
    handle's lock state and ``link_alive``, and the failure rates.  (A link
    subset is not exact here: ``rearbitrate`` stops when no degraded record
    of the whole fabric changed, so its passes depend on every link.)"""
    import numpy as np
    import torch

    cells = _runtime_cells()
    wrappers = reset_launches()
    runs = {key: _runtime_sequence(cfg, tr, seed, timer=timed_call) for key, cfg, tr in cells}
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[interconnect] launches on the interconnect path: {launches}")
    for k in ("table_build", "feasibility", "probe"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the interconnect path")

    for key, cfg, tr in cells:
        t0 = time.perf_counter()
        steps = runs[key]
        n = cfg.grid.n_ch
        states = _fabric_states(steps)
        fab0, fab1, hurt, fab2 = (st for _, st, _ in states)
        r1, r2 = states[1][2], states[3][2]
        for label, st, _ in states:
            if len(st.links) != 1008 or st.handle.state.lock.shape != (2016, n) \
                    or st.handle.state.lock.device.type != "cuda":
                fail(f"interconnect {key} {label}: {len(st.links)} links, state "
                     f"{tuple(st.handle.state.lock.shape)} on {st.handle.state.lock.device}")
        for st in (hurt, fab2):
            for i in RUNTIME_DEAD:
                if (st.links[i].lanes_up, st.links[i].failure) != (0, "link_down"):
                    fail(f"interconnect {key}: killed link {i} reads {st.links[i]}")
            if st.handle.link_alive is None or st.handle.link_alive[list(RUNTIME_DEAD)].any() \
                    or int((~st.handle.link_alive).sum()) != len(RUNTIME_DEAD):
                fail(f"interconnect {key}: link_alive {st.handle.link_alive}")
        dead_rows = fab2.handle.state.lock.view(-1, 2, n)[list(RUNTIME_DEAD)]
        if r2 > 0 and bool((dead_rows >= 0).any()):
            fail(f"interconnect {key}: a killed link kept a lock through a warm pass")
        if r2 == 0 and not torch.equal(fab2.handle.state.lock, fab1.handle.state.lock):
            fail(f"interconnect {key}: a rearbitrate of no pass moved a lock")
        for i in range(1008):
            if fab1.links[i].lanes_up < fab0.links[i].lanes_up or (
                    i not in RUNTIME_DEAD and fab2.links[i].lanes_up < fab1.links[i].lanes_up):
                fail(f"interconnect {key}: link {i} lost lanes")
            if not fab0.links[i].degraded:
                keep = (fab0.links[i].lanes_up, fab0.links[i].spectral_shift)
                for st in (fab1,) + (() if i in RUNTIME_DEAD else (fab2,)):
                    if (st.links[i].lanes_up, st.links[i].spectral_shift) != keep:
                        fail(f"interconnect {key}: healthy link {i} was touched")
        t_cpu = time.perf_counter()
        ref = _runtime_sequence(cfg, tr, seed, device="cpu")
        cpu_s = time.perf_counter() - t_cpu
        for (label, got, g_r), (_, want, w_r) in zip(states, _fabric_states(ref)):
            if g_r != w_r or [dataclasses.asdict(l) for l in got.links] != \
                    [dataclasses.asdict(l) for l in want.links]:
                fail(f"interconnect {key} {label}: LinkHealth or rounds ({g_r} against "
                     f"{w_r}) differ from the CPU plain path")
            _hold_links(f"interconnect {key} {label} handle state", got.handle.state,
                        want.handle.state)
            if not (got.handle.link_alive is None and want.handle.link_alive is None) \
                    and not np.array_equal(got.handle.link_alive, want.handle.link_alive):
                fail(f"interconnect {key} {label}: link_alive differs from the CPU")
        rates, ref_rates = steps["expected_failure_rates"][0], ref["expected_failure_rates"][0]
        if rates != ref_rates:
            fail(f"interconnect {key} expected_failure_rates {rates} against {ref_rates}")
        deg = [len(st.degraded_links()) for _, st, _ in states]
        times = ", ".join(f"{label} {ms!r} ms ({n_p} probe launches)"
                          for label, (_, ms, n_p) in steps.items())
        print(f"[interconnect] {key} TR={tr!r} vtrs_ssm, 1008 links (2016 trials): degraded "
              f"links after bringup/rearbitrate/inject/rearbitrate {deg}, rounds {r1} and "
              f"{r2}, bandwidth_fraction {fab0.bandwidth_fraction!r} -> "
              f"{fab1.bandwidth_fraction!r}; rates {rates}; {times} (every LinkHealth, the "
              f"rounds, the handle state and the rates equal to the CPU plain path on all "
              f"1,008 links, {cpu_s:.1f} s of it; {time.perf_counter() - t0:.1f} s of checks)")
    return launches


def phase_campaign(seed: int, full: dict) -> dict:
    """Campaign checkpoints: wdm16-thermal and wdm16-hotswap at N_SIDE x
    N_SIDE trials, warm, run to ``CAMPAIGN_SPLIT``, the state saved with
    ``save_campaign`` and restored onto the card with ``restore_campaign``,
    then the tail; with the launch counts set to 0 just before and read just
    after.  The restored state equals the saved one, and head + tail equal
    ``full`` (``phase_temporal``'s uninterrupted warm runs) exactly."""
    import tempfile

    import torch

    from repro_torch.configs.wdm import drift_timeline
    from repro_torch.core import api
    from repro_torch.core.temporal import (restore_campaign, run_timeline, save_campaign,
                                           slice_timeline)

    cells = []
    for name in DRIFT_CELLS:
        cfg, tl = drift_timeline(name)
        cells.append((name, cfg, tl, api.make_units(cfg, seed, N_SIDE, N_SIDE),
                      {"tr_mean": TEMPORAL_TR_X * cfg.grid.grid_spacing}))

    wrappers = reset_launches()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, cfg, tl, units, var in cells:
            t, n = N_SIDE * N_SIDE, cfg.grid.n_ch
            ckpt = Path(d) / name
            head = timed_call(lambda: run_timeline(cfg, units, slice_timeline(
                tl, 0, CAMPAIGN_SPLIT), var))
            save = timed_call(lambda: save_campaign(ckpt, CAMPAIGN_SPLIT, head[0][0]))
            restored = timed_call(lambda: restore_campaign(ckpt, t, n))
            tail = timed_call(lambda: run_timeline(cfg, units, slice_timeline(
                tl, CAMPAIGN_SPLIT), var, init_state=restored[0][1]))
            out[name] = head, save, restored, tail
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[campaign] launches on the campaign path: {launches}")
    for k in ("probe", "table_build", "match"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the campaign path")

    for name, cfg, tl, units, var in cells:
        (head, h_ms, h_p), (_, s_ms, _), ((step, resumed), r_ms, _), (tail, t_ms, t_p) = out[name]
        final, stats = full[name]
        if step != CAMPAIGN_SPLIT:
            fail(f"campaign {name}: restored step {step}")
        for f, g, w in zip(resumed._fields, resumed, head[0]):
            if g.device.type != "cuda" or g.dtype != w.dtype or not torch.equal(g, w):
                fail(f"campaign {name}: restored {f} differs from the saved state")
        for f, g, w in zip(final._fields, tail[0], final):
            if not torch.equal(g, w):
                fail(f"campaign {name}: resumed final {f} differs from the uninterrupted run")
        for f, h, tt, w in zip(stats._fields, head[1], tail[1], stats):
            if not torch.equal(torch.cat([h, tt]), w):
                fail(f"campaign {name}: head + tail {f} differs from the uninterrupted run")
        print(f"[campaign] {name} T={N_SIDE * N_SIDE} split at step {CAMPAIGN_SPLIT} of "
              f"{tl.n_steps}: head {h_ms!r} ms ({h_p} probe launches), save_campaign "
              f"{s_ms!r} ms, restore_campaign {r_ms!r} ms, tail {t_ms!r} ms ({t_p} probe "
              f"launches); restored state equal to the saved one, head + tail equal to the "
              f"uninterrupted warm run (final state and per-step stats)")
    return launches


def phase_mesh(seed: int, sweeps: dict, fabric: dict, chaos: dict) -> dict:
    """The multi-device paths on the card, card against card: the size-1
    ``make_sweep_mesh()`` and placeholder meshes of ``MESH_SIZES`` x cuda:0,
    each bit for bit against the unsharded run, with the launch counts set
    to 0 just before the mesh calls and read just after.  fig14's ``seq``
    grid at ``chunk_size=5`` (15 chunks: a 2-way mesh leaves an empty one)
    and fig5's WDM32 ``min_tr("lta")`` grid at ``chunk_size=3`` (the
    ``bottleneck`` path) against unsharded runs at the same chunk size;
    fig19's ``protocol_lta`` grid on the 2-way mesh at ``chunk_size=6``,
    FABRIC_1K ``bringup`` for vtrs_ssm and protocol_lta at ``link_chunk=256``
    and one FABRIC_MID chaos timeline with ``health=True`` against
    ``phase_sweep``'s, ``phase_fabric``'s and ``phase_chaos``'s unsharded
    runs (``sweeps``, ``fabric``, ``chaos``; at their own chunk sizes, which
    the engine's results do not depend on).  Then a CPU-saved campaign
    checkpoint of the chaos run's final state restored with ``shardings``
    onto cuda:0, the reference's public surface imported from the port, and
    one ``sigma_rlv=`` evaluator call: one ``DeprecationWarning``, the
    result equal to the ``Variations`` form.  On one card the mesh times
    measure the split's overhead, not a multi-device gain."""
    import importlib
    import tempfile
    import warnings

    import numpy as np
    import torch

    from repro_torch.checkpoint import store as ckpt
    from repro_torch.configs.fabric import FABRIC_CONFIGS, chaos_timeline
    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core import api
    from repro_torch.core.protocol import ProtocolState, cold_state
    from repro_torch.core.sweep import _leaves, sweep
    from repro_torch.core.temporal import save_campaign
    from repro_torch.core.variations import Variations
    from repro_torch.fabric import bringup, make_fabric_units, run_fabric_timeline
    from repro_torch.launch import SweepMesh, make_sweep_mesh
    from repro_torch.obs.health import health_codes

    cuda0 = torch.device("cuda", 0)
    one = make_sweep_mesh()
    if one.size != torch.cuda.device_count() or one.devices[0] != cuda0:
        fail(f"make_sweep_mesh() gave {one.devices}")
    meshes = [(f"make_sweep_mesh() (size {one.size})", one)] + [
        (f"{k} x cuda:0", SweepMesh((cuda0,) * k)) for k in MESH_SIZES]

    # The unsharded runs at the mesh runs' chunk sizes (new settings), timed.
    grids = []
    for name, chunk, on in (("fig14 wdm8 natural seq", 5, meshes),
                            ("fig5 wdm32 lta min_tr", 3, meshes),
                            ("fig19 wdm8 protocol_lta", 6, meshes[1:2])):
        req, res, ms = sweeps[name]
        if not name.startswith("fig19"):  # fig19: phase_sweep's run (automatic chunk size)
            res, ms, _ = timed_call(lambda: sweep(req.replace(chunk_size=chunk)).data)
        grids.append((name, req.replace(chunk_size=chunk), res, ms, on))
    cfg_key, spec1k = FABRIC_CONFIGS["fabric1k-wdm16"]
    cfg1k = WDM_CONFIGS[cfg_key]
    tr0 = float(fig21_axes(cfg1k)["tr_mean"][0])
    name, scheme, link_chunk = MESH_CHAOS
    cfg_c, spec_c, tl_c = chaos_timeline(name)
    units_c = make_fabric_units(cfg_c, spec_c, seed)

    wrappers = reset_launches()
    runs = []
    for name_g, req, want, ms, on in grids:
        for label, mesh in on:
            got, mesh_ms, _ = timed_call(lambda: sweep(req.replace(mesh=mesh)).data)
            runs.append((f"{name_g} chunk_size={req.chunk_size}", label, got, want, mesh_ms, ms))
    for scheme_b in ("vtrs_ssm", "protocol_lta"):
        want = fabric["fabric1k-wdm16", scheme_b]
        for label, mesh in meshes:
            got, mesh_ms, _ = timed_call(lambda: bringup(
                cfg1k, spec1k, tr_mean=tr0, scheme=scheme_b, seed=seed,
                link_chunk=MESH_LINK_CHUNK, mesh=mesh))
            runs.append((f"fabric1k-wdm16 bringup {scheme_b} link_chunk={MESH_LINK_CHUNK}",
                         label, (got.ev, got.stats, got.state, got.system),
                         (want.ev, want.stats, want.state, want.system), mesh_ms,
                         fabric["ms"]["fabric1k-wdm16", scheme_b]))
    state_u, cs_u = chaos[name, scheme, True]
    want_c = (state_u, cs_u._replace(health=health_codes(
        cs_u.locked, cs_u.probes, cs_u.feasible, tl_c.link_alive, cfg_c.grid.n_ch)))
    for label, mesh in meshes:
        got, mesh_ms, _ = timed_call(lambda: run_fabric_timeline(
            cfg_c, units_c, spec_c, tl_c, scheme=scheme, health=True, link_chunk=link_chunk,
            mesh=mesh))
        runs.append((f"{name} chaos {scheme} warm health=True link_chunk={link_chunk}", label,
                     got, want_c, mesh_ms, chaos["ms"][name, scheme, True]))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[mesh] launches on the mesh path: {launches}")
    for k in ARBITRATION_KERNELS:
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the mesh path")

    for what, label, got, want, mesh_ms, ms in runs:
        for leaf in _leaves(got):
            if leaf.device != cuda0:
                fail(f"{what} on {label}: a result on {leaf.device}")
        _same(f"{what} on {label} against the unsharded run", got, want)
        print(f"[mesh] {what} on {label}: {mesh_ms!r} ms (unsharded {ms!r} ms); "
              f"bit-identical to the unsharded run")

    # A CPU-saved campaign checkpoint restored onto the card with shardings.
    state = runs[-1][2][0]
    saved = ProtocolState(*(x.cpu() for x in state))
    with tempfile.TemporaryDirectory() as d:
        save_campaign(d, 6, saved)
        target = cold_state(saved.lock.shape[0], saved.lock.shape[1], "cpu")
        restored, r_ms, _ = timed_call(lambda: ckpt.restore(
            d, 6, target, shardings=ProtocolState(cuda0, "cuda:0", cuda0, "cuda")))
    for f, g, w in zip(saved._fields, restored, saved):
        if g.device.type != "cuda" or g.dtype != w.dtype or not torch.equal(g.cpu(), w):
            fail(f"restore(shardings=): {f} on {g.device} differs from the saved leaf")
    print(f"[mesh] restore(shardings=cuda:0) of a CPU-saved campaign checkpoint "
          f"({saved.lock.shape[0]} x {saved.lock.shape[1]} state): {r_ms!r} ms; every leaf "
          f"on the card and equal to the saved one")

    # The reference's public surface, and a deprecated sigma_rlv= call.
    core = importlib.import_module("repro_torch.core")
    fab = importlib.import_module("repro_torch.fabric")
    missing = [n for n in SURFACE_CORE if not hasattr(core, n)]
    missing += [n for n in SURFACE_FABRIC if not hasattr(fab, n)]
    configs = importlib.import_module("repro_torch.configs")
    if missing or not (configs.WDM_CONFIGS and configs.FABRIC_CONFIGS):
        fail(f"the port lacks {missing} of the reference's surface")
    cfg = WDM_CONFIGS["wdm8-g200"]
    units = api.make_units(cfg, seed, N_SIDE, N_SIDE)
    rlv = float(np.float32(2.24))
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        legacy = core.evaluate_scheme(cfg, units, "vtrs_ssm", TR, sigma_rlv=rlv)
    dep = [w for w in record if issubclass(w.category, DeprecationWarning)]
    if len(dep) != 1 or Path(dep[0].filename).resolve() != Path(__file__).resolve():
        fail(f"sigma_rlv=: {[(str(w.message), w.filename) for w in dep]}")
    _same("evaluate_scheme(sigma_rlv=) against its Variations form", legacy,
          core.evaluate_scheme(cfg, units, "vtrs_ssm", variations=Variations(
              tr_mean=TR, sigma_rlv=rlv)))
    print(f"[mesh] surface: {len(SURFACE_CORE)} names of repro_torch.core and "
          f"{len(SURFACE_FABRIC)} of repro_torch.fabric import; evaluate_scheme(sigma_rlv=) "
          f"warned once ({dep[0].category.__name__}) and equals the Variations form "
          f"(CAFP {float(legacy.cafp)!r})")
    return launches


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _rows(tree, idx, dim=0):
    """The trials ``idx`` along ``dim`` of every tensor of a (named, nested)
    tuple, on the CPU."""
    if isinstance(tree, tuple):
        return type(tree)(*(_rows(x, idx, dim) for x in tree)) if hasattr(tree, "_fields") \
            else tuple(_rows(x, idx, dim) for x in tree)
    return None if tree is None else tree.index_select(dim, idx.to(tree.device)).cpu()


def _same(name, got, want):
    """Every tensor of two (named, nested) tuples equal exactly (float32 bit
    for bit), None leaves alike."""
    import torch

    if isinstance(got, tuple):
        if not isinstance(want, tuple) or len(got) != len(want):
            fail(f"{name}: structures differ")
        for i, (g, w) in enumerate(zip(got, want)):
            _same(f"{name}.{got._fields[i] if hasattr(got, '_fields') else i}", g, w)
        return
    if got is None or want is None:
        if got is not want:
            fail(f"{name}: one side is None")
        return
    g, w = got.detach().cpu(), want.detach().cpu()
    if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(
            g.view(torch.int32) if g.dtype == torch.float32 else g,
            w.view(torch.int32) if w.dtype == torch.float32 else w):
        fail(f"{name} differs ({g.dtype}{tuple(g.shape)} against {w.dtype}{tuple(w.shape)})")


def phase_obs(seed: int, temporal: dict, chaos: dict) -> dict:
    """The observability path at full width, with the launch counts set to 0
    just before and read just after: the flight recorder in the protocol
    engine (``run_protocol(trace=128)``, ``protocol_lta``'s settings, 10,000
    trials at WDM16 TR 3.487, fig19's mid point, and WDM32 TR 8.96) and in a
    timeline (``run_timeline(trace=64)`` warm on wdm16-hotswap); fig19's
    WDM16 ``seq_retry`` failure taxonomy (``explain_residuals``, seed 21,
    JAX's earlier threefry layout, the TR points ``OBS_TAX_POINTS``, depth
    1, cap 128); the
    chaos health matrix (``health=True``) on fig22's FABRIC_MID scenarios
    warm and cold and on the 1,008-link flap timeline; fig14's ``vtrs_ssm``
    grid and fig21's ``bringup`` under ``PhaseRecorder(measure_memory=True)``.
    Then: every traced output equal to the trace-off one (``temporal`` and
    ``chaos`` hold the earlier phases' runs), buffers and codes equal to the
    CPU plain path on the 20 x 20 subset and the checked links, ``counts``
    summing to ``n``, no ``unknown`` residual, ``down`` exactly where a link
    is dead, the recorded grid and bring-up unchanged with their watermarks
    inside the budget, and a manifest of it all rendered by the report."""
    import tempfile

    import torch

    from repro_torch.configs.fabric import FABRIC_CONFIGS, chaos_timeline
    from repro_torch.configs.wdm import WDM_CONFIGS, drift_timeline
    from repro_torch.core import api
    from repro_torch.core.protocol import run_protocol
    from repro_torch.core.relation import chain_spec
    from repro_torch.core.sampling import instantiate
    from repro_torch.core.search_table import build_search_tables
    from repro_torch.core.sweep import SweepRequest, sweep
    from repro_torch.core.temporal import run_timeline
    from repro_torch.fabric import (FabricTimeline, bringup, make_fabric_units,
                                    run_fabric_timeline)
    from repro_torch.obs import PhaseRecorder, TraceBuffer, use_recorder
    from repro_torch.obs.manifest import RunManifest
    from repro_torch.obs.report import render_report
    from repro_torch.obs.taxonomy import explain_residuals

    cfg8, cfg16, cfg32 = (WDM_CONFIGS[k] for k in ("wdm8-g200", "wdm16-g200", "wdm32-g200"))
    trs16 = tr_sweep(16, cfg16.grid.grid_spacing)
    engine = []
    for cfg, tr in ((cfg16, float(trs16[2])), (cfg32, TR)):
        units = api.make_units(cfg, seed, N_SIDE, N_SIDE)
        tables = build_search_tables(instantiate(cfg, units), tr, max_alias=cfg.max_fsr_alias)
        engine.append((f"wdm{cfg.grid.n_ch} TR={tr!r}", cfg, tr, units, tables))
    hot_cfg, hot_tl = drift_timeline("wdm16-hotswap")
    hot_units = api.make_units(hot_cfg, seed, N_SIDE, N_SIDE)
    hot_var = {"tr_mean": TEMPORAL_TR_X * hot_cfg.grid.grid_spacing}
    tax_units = api.make_units(cfg16, RECORD_SEEDS["fig19"], N_SIDE, N_SIDE,
                               partitionable=False)
    tax_trs = trs16[list(OBS_TAX_POINTS)]
    health_runs = []
    for name, scheme in _chaos_cells():
        cfg, spec, tl = chaos_timeline(name)
        health_runs.append((name, scheme, cfg, spec, tl, make_fabric_units(cfg, spec, seed)))
    cfg_key, spec1k = FABRIC_CONFIGS["fabric1k-wdm16"]
    cfg1k = WDM_CONFIGS[cfg_key]
    tl1k = fig22_1k_timeline(cfg1k, spec1k)
    units1k = make_fabric_units(cfg1k, spec1k, seed)
    req14 = SweepRequest(cfg=cfg8, units=api.make_units(cfg8, seed, N_SIDE, N_SIDE),
                         scheme="vtrs_ssm",
                         axes={"sigma_rlv": rlv_sweep()[:6], "tr_mean": tr_sweep()})
    tr21 = float(fig21_axes(cfg1k)["tr_mean"][0])

    wrappers = reset_launches()
    out, ms, n_probe = {}, {}, {}
    for name, cfg, tr, units, tables in engine:
        out[name], ms[name], n_probe[name] = timed_call(lambda: run_protocol(
            tables, chain_spec(cfg.s), with_stats=True, with_state=True, trace=OBS_CAP))
    out["timeline"], ms["timeline"], n_probe["timeline"] = timed_call(
        lambda: run_timeline(hot_cfg, hot_units, hot_tl, hot_var, trace=OBS_TIMELINE_CAP))
    out["tax"], ms["tax"], n_probe["tax"] = timed_call(lambda: explain_residuals(
        cfg16, tax_units, tax_trs, scheme="seq_retry", depth=1, trace_cap=OBS_CAP))
    for name, scheme, cfg, spec, tl, units in health_runs:
        for warm in (True, False):
            key = name, scheme, warm
            out[key], ms[key], n_probe[key] = timed_call(lambda: run_fabric_timeline(
                cfg, units, spec, tl, scheme=scheme, warm=warm, health=True))
    out["1k"], ms["1k"], n_probe["1k"] = timed_call(lambda: run_fabric_timeline(
        cfg1k, units1k, spec1k, tl1k, scheme="vtrs_ssm", health=True))
    rec = PhaseRecorder(measure_memory=True)
    with use_recorder(rec):
        out["fig14"], ms["fig14"], _ = timed_call(lambda: sweep(req14).data)
        out["fig21"], ms["fig21"], _ = timed_call(
            lambda: bringup(cfg1k, spec1k, tr_mean=tr21, scheme="vtrs_ssm", seed=seed))
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[obs] launches on the obs path: {launches}")
    for k in ("probe", "table_build", "match", "feasibility"):
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the obs path")
    smi = card()

    # The traced engine: outcome unchanged, ring honest, equal to the CPU.
    for name, cfg, tr, units, tables in engine:
        t0 = time.perf_counter()
        spec = chain_spec(cfg.s)
        *traced, buf = out[name]
        off, off_ms, _ = timed_call(lambda: run_protocol(tables, spec, with_stats=True,
                                                         with_state=True))
        _same(f"engine {name}: trace on against off", tuple(traced), off)
        if not torch.equal(buf.counts.sum(dim=1, dtype=torch.int32), buf.n):
            fail(f"engine {name}: counts do not sum to n")
        sub_units, idx = _subset(units, SUB_SIDE)
        sub_tables = build_search_tables(instantiate(cfg, sub_units), tr,
                                         max_alias=cfg.max_fsr_alias)
        ref = run_protocol(sub_tables, spec, with_stats=True, with_state=True, trace=OBS_CAP)
        _same(f"engine {name}: the CPU plain path on the subset",
              _rows(out[name], torch.from_numpy(idx)), ref)
        n = buf.n.double()
        print(f"[obs] engine protocol_lta {name} T={N_SIDE * N_SIDE} cap {OBS_CAP}: trace off "
              f"{off_ms!r} ms/call, trace on {ms[name]!r} ms/call ({ms[name] / off_ms:.3f}x; "
              f"{n_probe[name]} probe launches) on {smi}; events mean {float(n.mean())!r}, max "
              f"{int(buf.n.max())}, {int((buf.n > OBS_CAP).sum())} trials overflowed, by kind "
              f"{buf.counts.sum(dim=0).tolist()} (assignment, stats and state equal to trace "
              f"off; ev, n and counts equal to the CPU plain path on the {SUB_SIDE}x{SUB_SIDE} "
              f"subset; {time.perf_counter() - t0:.1f} s of checks)")

    # The traced timeline.
    t0 = time.perf_counter()
    final, stats, bufs = out["timeline"]
    _same("timeline: trace on against off", (final, stats), temporal["wdm16-hotswap"])
    if not torch.equal(bufs.counts.sum(dim=-1, dtype=torch.int32), bufs.n):
        fail("timeline: counts do not sum to n")
    idx_t = torch.from_numpy(_subset(hot_units, SUB_SIDE)[1])
    _same("timeline: the CPU plain path on the subset",
          (_rows(final, idx_t), _rows(stats, idx_t, 1), _rows(bufs, idx_t, 1)),
          temporal["cpu", "wdm16-hotswap"])
    off_ms = temporal["ms", "wdm16-hotswap"]
    print(f"[obs] timeline wdm16-hotswap warm T={N_SIDE * N_SIDE} cap {OBS_TIMELINE_CAP}: "
          f"trace off {off_ms!r} ms/call ([temporal]), trace on {ms['timeline']!r} ms/call "
          f"({ms['timeline'] / off_ms:.3f}x; {n_probe['timeline']} probe launches) on {smi}; "
          f"events per step {bufs.n.sum(dim=1).tolist()} (final state and stats equal to "
          f"trace off, buffers (S, T, cap, 4) equal to the CPU plain path on the subset; "
          f"{time.perf_counter() - t0:.1f} s of checks)")

    # fig19's WDM16 seq_retry taxonomy.
    t0 = time.perf_counter()
    tax = out["tax"]
    if tax["unknown"] != 0 or tax["residual_total"] != sum(tax["histogram"].values()):
        fail(f"taxonomy: unknown {tax['unknown']}, histogram {tax['histogram']}")
    sub_units, idx = _subset(tax_units, SUB_SIDE)
    ref = explain_residuals(cfg16, sub_units, tax_trs, scheme="seq_retry", depth=1,
                            trace_cap=OBS_CAP)
    pos = {int(i): p for p, i in enumerate(idx)}
    for p_card, p_cpu in zip(tax["points"], ref["points"]):
        got = {pos[i]: c for i, c in zip(p_card["trial_index"], p_card["codes"]) if i in pos}
        if got != dict(zip(p_cpu["trial_index"], p_cpu["codes"])):
            fail(f"taxonomy TR={p_card['tr_mean']}: codes differ from the CPU on the subset")
    print(f"[obs] taxonomy fig19 wdm16 seq_retry T={N_SIDE * N_SIDE} x TR points "
          f"{[round(float(v), 4) for v in tax_trs]} (points {list(OBS_TAX_POINTS)} of 12), "
          f"depth 1, cap {OBS_CAP}: {ms['tax']!r} ms ({n_probe['tax']} probe launches); "
          f"{tax['residual_total']} residuals {tax['histogram']}, unknown {tax['unknown']}; "
          f"per point {[p['residual_trials'] for p in tax['points']]} (codes equal to the CPU "
          f"plain path on the {SUB_SIDE}x{SUB_SIDE} subset; "
          f"{time.perf_counter() - t0:.1f} s of checks)")

    # The chaos health matrix.
    for name, scheme, cfg, spec, tl, units in health_runs:
        for warm in (True, False):
            t0 = time.perf_counter()
            key = name, scheme, warm
            state, cs = out[key]
            _same(f"health {key}: chaos against health=False",
                  (state, cs._replace(health=None)), chaos[key])
            h = cs.health
            if h.shape != (tl.n_steps, spec.n_links) or h.dtype != torch.int8:
                fail(f"health {key}: {h.dtype}{tuple(h.shape)}")
            if not torch.equal(h == 0, ~tl.link_alive):
                fail(f"health {key}: down differs from link_alive")
            checked = ""
            if (name, scheme) == ("mid-linkflap", "vtrs_ssm"):
                u_cpu = type(units)(*(x.cpu() for x in units))
                _, ref = run_fabric_timeline(cfg, u_cpu, spec, chaos_timeline(name, "cpu")[2],
                                             scheme=scheme, warm=warm, health=True)
                _same(f"health {key}: the CPU plain path", h, ref.health)
                checked = f", codes of all {spec.n_links} links equal to the CPU plain path"
            print(f"[obs] health {name} {scheme} {'warm' if warm else 'cold'}: "
                  f"{ms[key]!r} ms/timeline; per step "
                  f"{[[int((r == c).sum()) for c in range(5)] for r in h]} links by code "
                  f"(down, hopeless, degraded, relocking, healthy){checked} "
                  f"({time.perf_counter() - t0:.1f} s of checks)")
    t0 = time.perf_counter()
    state, cs = out["1k"]
    _same("health 1k: chaos against health=False", (state, cs._replace(health=None)),
          chaos["1k"])
    if not torch.equal(cs.health == 0, ~tl1k.link_alive):
        fail("health 1k: down differs from link_alive")
    idx = [j % spec1k.n_links for j in FABRIC_SUBSET]
    _, ref = run_fabric_timeline(cfg1k, _unit_subset(units1k, idx), _subset_spec(spec1k, len(idx)),
                                 FabricTimeline(*(a[:, idx].cpu() for a in tl1k)),
                                 scheme="vtrs_ssm", health=True)
    _same("health 1k: the CPU plain path on the link subset", cs.health[:, idx], ref.health)
    print(f"[obs] health fabric1k flap timeline vtrs_ssm warm: {ms['1k']!r} ms/timeline; per "
          f"step {[[int((r == c).sum()) for c in range(5)] for r in cs.health]} links by code "
          f"(codes of links {idx[:3]}..{idx[-3:]} ({len(idx)}) equal to the CPU plain path; "
          f"{time.perf_counter() - t0:.1f} s of checks)")

    # The phase recorder around fig14's grid and fig21's bring-up.
    _same("recorder: fig14 vtrs_ssm grid against no recorder", out["fig14"], sweep(req14).data)
    bare = bringup(cfg1k, spec1k, tr_mean=tr21, scheme="vtrs_ssm", seed=seed)
    _same("recorder: fig21 bringup against no recorder",
          (out["fig21"].ev, out["fig21"].stats, out["fig21"].state),
          (bare.ev, bare.stats, bare.state))
    spans = rec.phase_fields()
    mem = {m["name"]: m for m in rec.memory_fields()}
    plans = {n["name"]: n for n in rec.notes if n["name"].endswith(".plan")}
    for label in ("sweep", "bringup"):
        m = mem.get(f"memory.{label}.temp")
        if label not in spans or f"{label}.plan" not in plans or m is None \
                or not 0.0 < m["frac"] < 1.0:
            fail(f"recorder {label}: span {spans.get(label)}, plan {plans.get(label + '.plan')}, "
                 f"watermark {m}")
    print(f"[obs] recorder fig14 vtrs_ssm grid {ms['fig14']!r} ms (span "
          f"{spans['sweep']['ms']!r} ms; watermark {mem['memory.sweep.temp']['bytes']} bytes, "
          f"{mem['memory.sweep.temp']['frac']!r} of the budget; plan {plans['sweep.plan']}); "
          f"fig21 bringup {ms['fig21']!r} ms (span {spans['bringup']['ms']!r} ms; watermark "
          f"{mem['memory.bringup.temp']['bytes']} bytes, {mem['memory.bringup.temp']['frac']!r} "
          f"of the budget) on {smi}; both equal to the calls without a recorder")

    # A manifest of it all, rendered.
    with tempfile.TemporaryDirectory() as d:
        with RunManifest.create(d, label="chip-smoke-obs", card=smi) as man:
            for name, *_ in engine:
                summary = {k: v for k, v in tax.items() if k != "points"} \
                    if name.startswith("wdm16") else None
                man.record_trace(out[name][-1], scope=f"protocol_lta {name}", taxonomy=summary)
            man.record_trace(TraceBuffer(*(x.flatten(0, 1) for x in bufs)),
                             scope="timeline wdm16-hotswap warm, steps x trials")
            man.record_phases(rec, scope="fig14 vtrs_ssm + fig21 bringup")
            for name, scheme, *_ in health_runs:
                for warm in (True, False):
                    man.record_health(out[name, scheme, warm][1].health,
                                      scope=f"{name} {scheme} {'warm' if warm else 'cold'}")
            man.record_health(out["1k"][1].health, scope="fabric1k flap")
        report = render_report(man.path)
    for section in ("trace [protocol_lta wdm16", "taxonomy[seq_retry]", "phases [fig14",
                    "sweep.temp", "bringup.temp", "health [mid-linkflap vtrs_ssm warm]",
                    "health [fabric1k flap]"):
        if section not in report:
            fail(f"report: no {section!r} section")
    lines = report.splitlines()
    print(f"[obs] manifest of {len(lines)} report lines rendered with the trace, phases and "
          f"health sections; its first lines:")
    for line in lines[:12]:
        print(f"[obs]   {line[:160]}")
    return launches


def _lm_tree(tree, fn):
    """``fn`` on every tensor of an LM parameter tree or batch."""
    if isinstance(tree, dict):
        return {k: _lm_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_lm_tree(v, fn) for v in tree)
    return fn(tree)


def _lm_diff(name, got, want):
    """max |got - want| of two logit tensors (or lists of them), on the CPU;
    fails on a shape mismatch or a value that is not finite."""
    import torch

    if isinstance(got, list):
        return max(_lm_diff(f"{name} {i}", g, w) for i, (g, w) in enumerate(zip(got, want)))
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    if g.shape != w.shape or not torch.isfinite(g).all() or not torch.isfinite(w).all():
        fail(f"{name}: {tuple(g.shape)} against {tuple(w.shape)}, or not finite")
    return float((g - w).abs().max())


def _lm_hold(name, got, want, atol=LM_TOL, rtol=LM_TOL):
    """``got`` within ``atol`` + ``rtol`` x |want| of ``want`` everywhere;
    returns the max |difference|."""
    import torch

    err = _lm_diff(name, got, want)
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    bad = int((torch.abs(g - w) > atol + rtol * w.abs()).sum())
    if bad:
        fail(f"{name}: {bad} of {g.numel()} values differ by more than {atol!r} + "
             f"{rtol} x |reference| (max {err!r})")
    return err


def _lm_within_spread(name, err, spread):
    """A bf16 forward through many layers amplifies rounding: a full-width
    difference is held to the spread the same computation shows when 1 % of
    its embedding entries move by about two bf16 ulps (``_lm_perturbed``)."""
    if not err <= LM_SPREAD_X * spread:
        fail(f"{name}: max |diff| {err!r} passes {LM_SPREAD_X} x the spread {spread!r} "
             f"of a bf16-sized perturbation of the input")


def _lm_perturbed(params, seed):
    """``params`` with 1 % of the embedding entries scaled by 1 + 2^-7
    (about two bf16 ulps), chosen by ``seed``."""
    import torch

    e = params["embed"]
    g = torch.Generator(device=e.device).manual_seed(seed)
    hit = torch.rand(e.shape, generator=g, device=e.device) < 0.01
    return dict(params, embed=torch.where(hit, e * (1 + 2 ** -7), e))


def _lm_run(params, cfg, tokens, max_len, n_decode, feed=None, extra=None):
    """``prefill`` and ``n_decode`` ``decode_step``s: (each call's logits on
    the CPU, the tokens fed).  Greedy unless ``feed`` names the tokens."""
    from repro_torch.models import model as M

    lg, st = M.prefill(params, cfg, tokens, max_len, extra_embeds=extra)
    out, fed = [lg.float().cpu()], []
    for i in range(n_decode):
        nxt = lg.argmax(-1, keepdim=True).cpu() if feed is None else feed[i]
        fed.append(nxt)
        lg, st = M.decode_step(params, cfg, st, nxt.to(lg.device))
        out.append(lg.float().cpu())
    return out, fed


def _lm_gap(params, cfg, tokens, max_len, extra=None):
    """max |decode step after prefill(tokens[:, :-1]) - prefill(tokens)|,
    the next-token logits both ways."""
    from repro_torch.models import model as M

    _, st = M.prefill(params, cfg, tokens[:, :-1], max_len, extra_embeds=extra)
    dec, _ = M.decode_step(params, cfg, st, tokens[:, -1:])
    full, _ = M.prefill(params, cfg, tokens, max_len, extra_embeds=extra)
    return _lm_diff(f"{cfg.name} decode against prefill", dec, full)


def _lm_block_ratio(name, cfg, blk, card_blk, h, pos, seed):
    """One super-block on the card and on the CPU, on the CPU's input ``h``:
    (the largest over tokens of |card - CPU| / |noised - CPU|, the CPU's
    output), each norm over the token's features, where "noised" is the
    CPU's block on ``h`` with every entry scaled by 1 + e 2^-8 (e uniform
    in [-1, 1) by ``seed``) and rounded back to bf16: a rounding of the
    input, whose effect on each token (an MoE gate near a tie, cancellation
    in a sum) is the scale the card's own rounding is held to."""
    import torch

    from repro_torch.models import model as M

    hc, _ = M._super_block(h, blk, cfg, pos)
    g = torch.Generator().manual_seed(seed)
    e = torch.rand(h.shape, generator=g) * 2 - 1
    hn, _ = M._super_block((h.float() * (1 + e * 2 ** -8)).to(h.dtype), blk, cfg, pos)
    hg, _ = M._super_block(h.cuda(), card_blk, cfg, pos.cuda())
    _lm_diff(name, hg, hc)
    c = hc.float()
    err = (hg.float().cpu() - c).norm(dim=-1)
    spread = (hn.float() - c).norm(dim=-1)
    ratio = torch.where(spread > 0, err / spread, torch.where(err > 0, math.inf, 0.0))
    return float(ratio.max()), hc


def _lm_layers(name, cfg, cpu, card, tokens, seed):
    """Each super-block on the card against the CPU on the same input (the
    CPU's hidden state), every token within ``LM_BLOCK_X`` x the spread of
    a bf16 rounding of that input (``_lm_block_ratio``); the head (final
    norm, ``lm_head``) within ``LM_TOL``: no amplification across layers.
    Returns the worst block's ratio."""
    from repro_torch.models import layers
    from repro_torch.models import model as M

    h = M.embed_inputs(cpu, cfg, tokens)
    pos = M._positions(*tokens.shape, "cpu")
    worst = 0.0
    for s in range(M._n_super(cpu["blocks"])):
        ratio, hc = _lm_block_ratio(f"{name} super-block {s}", cfg,
                                    M._super_params(cpu["blocks"], s),
                                    M._super_params(card["blocks"], s), h, pos, seed + s)
        if not ratio <= LM_BLOCK_X:
            fail(f"{name} super-block {s}: a token's |card - CPU| is {ratio!r} x its spread "
                 f"under a bf16 rounding of the block's input, past {LM_BLOCK_X}")
        worst = max(worst, ratio)
        h = hc
    head_c = (layers.rms_norm(h, cpu["final_norm"]) @ cpu["lm_head"].to(M.COMPUTE)).float()
    head_g = (layers.rms_norm(h.cuda(), card["final_norm"]) @ card["lm_head"].to(M.COMPUTE))
    _lm_hold(f"{name} head", head_g.float(), head_c)
    return worst


class _MoEStatsTap:
    """Records the ``MoEStats`` of every ``layers.moe_ffn`` call while open
    (the serving path drops them); the numbers are unchanged."""

    def __enter__(self):
        from repro_torch.models import layers

        self.stats, self._orig = [], layers.moe_ffn

        def tapped(*args, **kwargs):
            y, stats = self._orig(*args, **kwargs)
            self.stats.append(stats)
            return y, stats

        layers.moe_ffn = tapped
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers

        layers.moe_ffn = self._orig


def phase_lm(seed: int) -> dict:
    """The LM serving path (``repro_torch.models``) on the card, with the
    launch counts set to 0 just before and read just after (it runs none of
    the five arbitration kernels: the reference computes its LM with XLA
    ops; its parameters are drawn on the card by ``threefry``).

    1. Each smoke config (``configs.get_smoke``), drawn on the card and
       copied to the CPU: ``loss_fn`` (B 2, L 32), ``prefill`` (B 2, L 16,
       ``extra_embeds`` for the frontend arch, max_len L + frontend + 8) and
       3 ``decode_step``s fed the CPU's greedy tokens, card against the CPU
       plain path within ``LM_TOL``; decode after prefill against a longer
       prefill, the card's max gap within ``LM_TOL`` of the CPU's own.
    2. ``LM_CELLS`` at full width: each wave of prompts prefilled as one
       batch and decoded greedily, timed on the host clock synchronised on
       both ends (prefill ms, decode ms per step, tokens/s, peak
       ``max_memory_allocated`` against the parameter bytes); for a cell
       without MoE (whose re-prefill would drop other copies) the last
       decode step against a re-prefill of prompt + generated tokens.  Then
       card against CPU on the same parameters: every super-block on the
       CPU's hidden state (``_lm_layers``), and ``prefill`` + 3 decode steps
       at B 1, L 64 (16 for the MoE cell) at the depth the cell names.
       Full-width differences are held to the spread of a bf16-sized
       perturbation (``_lm_within_spread``), and super-blocks to that of a
       bf16 rounding of their input (``_lm_block_ratio``), both measured in
       the same run.
    """
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import ARCH_IDS, get_config, get_smoke
    from repro_torch.models import model as M

    wrappers = reset_launches()
    t_phase = time.perf_counter()
    worst = 0.0
    for arch in ARCH_IDS:
        cfg = get_smoke(arch)
        card = M.init_params(seed, cfg)
        cpu = _lm_tree(card, lambda t: t.cpu())
        gen = torch.Generator().manual_seed(seed + 1)
        tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen)
        extra = (torch.randn((2, cfg.frontend_len, cfg.d_model), generator=gen) * 0.02
                 if cfg.frontend_len else None)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        if extra is not None:
            batch["extra_embeds"] = extra
        cl, caux = M.loss_fn(cpu, cfg, batch)
        gl, gaux = M.loss_fn(card, cfg, _lm_tree(batch, lambda t: t.cuda()))
        errs = [_lm_hold(f"{arch} loss", gl, cl)] + \
            [_lm_hold(f"{arch} {k}", gaux[k], caux[k]) for k in ("ce", "aux")]
        max_len = 16 + cfg.frontend_len + 8
        want, feed = _lm_run(cpu, cfg, tokens[:, :16], max_len, 3, extra=extra)
        got, _ = _lm_run(card, cfg, tokens[:, :16].cuda(), max_len, 3, feed,
                         None if extra is None else extra.cuda())
        errs += [_lm_hold(f"{arch} prefill and decode {i}", g, w)
                 for i, (g, w) in enumerate(zip(got, want))]
        # decode after prefill against a longer prefill: decode and prefill
        # round differently in bf16 (and a top-1 routing choice can move), so
        # the card's gap is held to the CPU plain path's own
        gap, cgap = (_lm_gap(params, cfg, tokens[:1, :17].to(dev), max_len,
                             None if extra is None else extra[:1].to(dev))
                     for params, dev in ((card, "cuda"), (cpu, "cpu")))
        if not gap <= cgap + LM_TOL:
            fail(f"{arch}: decode against prefill on the card {gap!r} passes the CPU's "
                 f"{cgap!r} by more than {LM_TOL}")
        worst = max(worst, *errs)
        print(f"[lm] {arch} smoke: loss {float(gl)!r} (CPU {float(cl)!r}); card against "
              f"CPU max |diff| {max(errs)!r} (loss, prefill, 3 decode steps); decode "
              f"against prefill max |diff| {gap!r} on the card, {cgap!r} on the CPU")
    print(f"[lm] smoke configs: {time.perf_counter() - t_phase:.1f} s, card against CPU "
          f"max |diff| {worst!r} (rtol = atol = {LM_TOL})")

    for arch, depth, waves, n_decode, cpu_depth in LM_CELLS:
        t_cell = time.perf_counter()
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth * len(cfg.pattern))
        params = M.init_params(seed, cfg)
        n_bytes = sum(t.numel() * t.element_size() for _, t in M._leaves(params))
        gen = torch.Generator(device="cuda").manual_seed(seed + 2)
        # a short warm-up call (allocator, cuBLAS handles), not timed
        _lm_run(params, cfg, torch.zeros((1, 16), dtype=torch.int64, device="cuda"), 17, 1)
        for b, length in waves:
            prompts = torch.randint(0, cfg.vocab, (b, length), generator=gen, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with _MoEStatsTap() as tap:
                logits, state = M.prefill(params, cfg, prompts, length + n_decode)
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = []
            for _ in range(n_decode):
                out.append(logits.argmax(-1, keepdim=True))
                logits, state = M.decode_step(params, cfg, state, out[-1])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            peak = torch.cuda.max_memory_allocated()
            pre_ms, dec_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3 / n_decode
            if tap.stats:      # a re-prefill drops other copies: no consistency check
                fr = [float(st.dropped_frac) for st in tap.stats]
                check = f"prefill MoE dropped fraction {fr!r}"
            else:
                seq = torch.cat([prompts] + out, dim=1)
                again, _ = M.prefill(params, cfg, seq, length + n_decode)
                moved, _ = M.prefill(_lm_perturbed(params, seed + 4), cfg, seq,
                                     length + n_decode)
                cons = _lm_diff(f"{arch} {b}x{length} decode against re-prefill", logits, again)
                spread = _lm_diff(f"{arch} {b}x{length} perturbed re-prefill", moved, again)
                _lm_within_spread(f"{arch} {b}x{length} decode against re-prefill", cons,
                                  spread)
                check = (f"last decode step against a re-prefill of prompt + generated "
                         f"tokens: max |diff| {cons!r} (perturbed re-prefill {spread!r})")
                del again, moved
            print(f"[lm] {arch} {len(cfg.pattern) * M._n_super(params['blocks'])} layers, "
                  f"{b} x {length} prompts: prefill {pre_ms!r} ms "
                  f"({b * length / (t1 - t0)!r} tokens/s), decode {dec_ms!r} ms a step "
                  f"({b * n_decode / (t2 - t1)!r} tokens/s) over {n_decode} steps; peak "
                  f"{peak} bytes allocated ({peak - base} above the {base} before the wave), "
                  f"parameters {n_bytes} bytes; {check}")
            del logits, state, out, prompts
        # card against CPU on the same parameters
        cpu = _lm_tree(params, lambda t: t.cpu())
        length = 16 if cfg.n_experts else 64
        tokens = torch.randint(0, cfg.vocab, (1, length),
                               generator=torch.Generator().manual_seed(seed + 3))
        t_layers = time.perf_counter()
        layer_x = _lm_layers(arch, cfg, cpu, params, tokens, seed + 6)
        t_layers = time.perf_counter() - t_layers
        ccfg, ccpu, ccard = cfg, cpu, params
        if cpu_depth is not None:
            ccfg = dataclasses.replace(cfg, n_layers=cpu_depth * len(cfg.pattern))
            ccpu, ccard = (dict(p, blocks=[{k: v[:cpu_depth] for k, v in blk.items()}
                                           for blk in p["blocks"]]) for p in (cpu, params))
        want, feed = _lm_run(ccpu, ccfg, tokens, length + 3, 3)
        got, _ = _lm_run(ccard, ccfg, tokens.cuda(), length + 3, 3, feed)
        moved, _ = _lm_run(_lm_perturbed(ccpu, seed + 5), ccfg, tokens, length + 3, 3, feed)
        err = _lm_diff(f"{arch} card against CPU", got, want)
        spread = _lm_diff(f"{arch} perturbed CPU", moved, want)
        _lm_within_spread(f"{arch} card against CPU, {ccfg.n_layers} layers", err, spread)
        print(f"[lm] {arch} card against CPU: every super-block on the CPU's input, each "
              f"token within {LM_BLOCK_X} x its spread under a bf16 rounding of that input "
              f"(worst {layer_x!r}; {t_layers:.1f} s), head within {LM_TOL}; "
              f"{ccfg.n_layers} layers, B 1, L {length}, prefill and 3 decode steps: max "
              f"|diff| {err!r}, the CPU's own under a bf16-sized perturbation {spread!r}; "
              f"cell {time.perf_counter() - t_cell:.1f} s")
        del params, cpu, ccpu, ccard
        gc.collect()
        torch.cuda.empty_cache()
    launches = {k: w.launches for k, w in wrappers.items()}
    if not launches["threefry"] or any(launches[k] for k in ARBITRATION_KERNELS):
        fail(f"the LM path launched arbitration kernels it does not run, or drew its "
             f"parameters without the draw kernel: {launches}")
    print(f"[lm] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def _tail_block(shape, limit: int = DRAW_HOLD) -> tuple[tuple, tuple]:
    """The last counters of a tensor of ``shape`` as a block (start, length)
    of at most ``limit`` elements: whole trailing dimensions where they fit,
    the last rows of the first one that does not, the last index before."""
    start, length = [], []
    for i, d in enumerate(shape):
        inner = math.prod(shape[i + 1:])
        if inner * d <= limit:
            return tuple(start) + (0,) * (len(shape) - i), tuple(length) + tuple(shape[i:])
        n = max(1, min(d, limit // inner))
        start.append(d - n)
        length.append(n)
        if inner <= limit:
            return tuple(start) + (0,) * (len(shape) - i - 1), tuple(length) + shape[i + 1:]
    return tuple(start), tuple(length)


def _draw_hold(label: str, params, cfg, seed) -> None:
    """Every leaf of a card draw (``init_params(seed, cfg)`` on the card)
    against the CPU plain version of the same counters: the leaf's last
    ``DRAW_HOLD`` counters (``_tail_block``) drawn again on the CPU by
    ``init_leaf``.  Ones and zeros exact, float32 leaves within
    ``DRAW_F32_ULP``, bf16 leaves within ``DRAW_BF16_ULP``."""
    import torch

    from repro_torch.models import model as M

    t0 = time.perf_counter()
    gaps, worst_abs, n = {}, 0.0, 0
    for (name, leaf), (kname, key) in zip(M._leaves(params), M._leaves(M.leaf_keys(seed, cfg))):
        if name != kname:
            fail(f"{label}: leaf {name} against key {kname}")
        shape = tuple(leaf.shape)
        start, length = _tail_block(shape)
        got = leaf[tuple(slice(a, a + m) for a, m in zip(start, length))].cpu()
        want = M.init_leaf(name, shape, leaf.dtype, key, start=start, length=length,
                           device="cpu")
        gap = ulp_gap(got, want)
        bound = 0 if ("norm" in name or name in ("D", "conv_b", "dt_bias")) else \
            DRAW_BF16_ULP if leaf.dtype == torch.bfloat16 else DRAW_F32_ULP
        if not gap <= bound or not torch.isfinite(got).all():
            fail(f"{label}: {name} {shape} drawn on the card is {gap} ulp from the CPU's draw "
                 f"of counters {start} + {length} (bound {bound})")
        key_dt = str(leaf.dtype).replace("torch.", "")
        gaps[key_dt] = max(gaps.get(key_dt, 0), gap)
        worst_abs = max(worst_abs, float((got.double() - want.double()).abs().max()))
        n += got.numel()
    print(f"[draw] {label}: every leaf's last counters (at most {DRAW_HOLD} a leaf, {n} in "
          f"all) drawn on the card against the CPU plain version: largest gap in ulps by "
          f"dtype {gaps}, max |diff| {worst_abs!r}; {time.perf_counter() - t0:.1f} s")


#: The training phase (``phase_train``): smoke steps at (B, L); internlm2-1.8b
#: whole through the Trainer as ``launch/train.py --production`` wires it
#: (seq 2,048, global batch 4, 2 microbatches, 4 steps, a link failure drawn
#: with probability 0.5 a step); the depth-2 full-width card-against-CPU
#: step at (1, 64); mamba2-130m whole for the resume (B 4, L 1,024, 3 steps,
#: split after 2); one full-width qwen3-moe-235b-a22b super-block, 2 steps
#: at (4, 512).
TRAIN_SMOKE_BATCH = (4, 32)
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 4, 2048, 4
#: The internlm2 Trainer's seed (its fabric draws, parameters and link
#: events): its bring-up meets a link with two rings on one line
#: (``dup_lock``), which the warm repair relocks through protocol rounds,
#: launching ``probe``.  At TR 8.96 the 8 links come up whole at seeds 0-157,
#: and a link event changes only the health record (as in the reference),
#: so its repair finds every lock valid and runs no protocol round.
TRAIN_FABRIC_SEED = 158
TRAIN_RESUME = ("mamba2-130m", 4, 1024, 3, 2)
TRAIN_MOE = ("qwen3-moe-235b-a22b", 4, 512, 2)
#: Card against CPU in a train step: each gradient leaf and first moment
#: within 8 % of the leaf's max |value| (16 % for the second moment, a
#: square; each updated parameter within 2 lr): both run the backward in bf16, whose rounding
#: (2^-8 a product input) the two devices' GEMMs accumulate in other orders;
#: the port against the reference on the CPU shows up to 7.0 % (mamba2's
#: SSD, ``tests/test_torch_train.py``).
TRAIN_GRAD_TOL = 0.08
#: The resumed run's last loss against the uninterrupted run's: the
#: embedding backward accumulates with atomics on CUDA (``index_put_``), so
#: the two runs' step-2 parameters may differ in the last bits (deterministic
#: algorithms are left off, as a user runs).
TRAIN_RESUME_TOL = 1e-2
#: H100 SXM data sheet: bf16 dense tensor-core rate.
PEAK_BF16_PER_S = 989e12


def _train_flops(cfg, tokens: int, seq: int) -> float:
    """Model FLOPs of one train step (forward + backward, no recompute):
    6 x the parameters that multiply (all but the embedding table) x
    tokens, plus the attention products, 12 x layers x heads x head_dim x
    seq x tokens (scores and values, forward and backward, every tile)."""
    from repro_torch.models import model as M

    n = M.count_params(cfg, active_only=True) - cfg.vocab * cfg.d_model
    n_attn = sum(1 for b in cfg.pattern if b.mixer == "attn") * cfg.n_super
    return 6.0 * n * tokens + 12.0 * n_attn * cfg.n_heads * cfg.head_dim * seq * tokens


def _grads(params, cfg, batch):
    """(loss, gradient leaves) of ``loss_fn`` on ``batch``, in
    ``tree_leaves`` order."""
    import torch

    from repro_torch.distributed.steps import _grad_tree
    from repro_torch.models import model as M

    tree, leaves = _grad_tree(params)
    with torch.enable_grad():
        loss, _ = M.loss_fn(tree, cfg, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)


def _train_hold(name, got, want, tol, atol=0.0):
    """Each leaf of ``got`` within ``tol`` x the max |value| of ``want``'s
    leaf + ``atol``; returns the worst leaf's max |diff| over its bound."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        err = _lm_diff(f"{name} leaf {i}", g, w)
        bound = tol * (float(w.detach().float().abs().max()) or 1.0) + atol
        if not err <= bound:
            fail(f"{name} leaf {i} {tuple(w.shape)}: max |diff| {err!r} passes its bound "
                 f"{bound!r} ({tol} x max |value| + {atol!r})")
        worst = max(worst, err / bound)
    return worst


def _train_step_once(params, cfg, opt_cfg, batch):
    """One train step at one microbatch (``make_train_step``'s body), with
    its gradients kept: (loss, grads, params, OptState), all updated in
    place."""
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_unflatten

    opt = adamw.init(opt_cfg, params)
    loss, grads = _grads(params, cfg, batch)
    adamw.apply(opt_cfg, params, tree_unflatten(params, grads), opt)
    return loss, grads, params, opt


def phase_train(seed: int) -> dict:
    """The training path (``repro_torch.optim``, ``distributed.steps``,
    ``data.pipeline``, ``runtime.trainer``) on the card, with the launch
    counts set to 0 just before and read just after: the trainer's fabric
    bring-up and link repairs launch ``feasibility``, ``table_build`` and
    ``probe``, and its fresh start ``threefry``.

    1. Each smoke config, drawn on the card and copied to the CPU: the
       loss and every gradient leaf of ``loss_fn`` at ``TRAIN_SMOKE_BATCH``,
       then one ``make_train_step(n_microbatch=2)``: loss within ``LM_TOL``,
       gradients and moments within ``TRAIN_GRAD_TOL`` of each leaf's max
       (twice it for the second moment), updated parameters within 2 lr,
       card against the CPU plain path.
    2. internlm2-1.8b whole (fp32 parameters and moments, ``remat="full"``)
       through ``Trainer`` as ``launch/train.py --production`` wires it:
       ``bringup_fabric`` (2 pods, 8 links, seed ``TRAIN_FABRIC_SEED``),
       ``TokenPipeline``, 4 steps of
       2 microbatches, a link failure with probability 0.5 a step, no
       checkpoint.  Per step: s/step, tokens/s, grad_norm, loss; the peak
       ``max_memory_allocated`` against the state's bytes, the model FLOPs
       a step (``_train_flops``) and their share of the bf16 dense peak.
    3. internlm2 at depth 2 (full width), B 1, L 64: one train step card
       against CPU on the same parameters and batch: the loss within
       ``LM_TOL``, gradients and updated parameters within ``LM_SPREAD_X`` x
       the spread of a bf16-sized perturbation (``_lm_perturbed``) measured
       in the same run.
    4. mamba2-130m whole: 3 steps in one Trainer run; then 2 steps, a save,
       a new Trainer whose ``init_state`` resumes at step 2 (params and
       optimizer state bit for bit), and 1 more step, the last loss within
       ``TRAIN_RESUME_TOL`` of the uninterrupted run's.
    5. One full-width qwen3-moe-235b-a22b super-block (bf16 parameters,
       moments and accumulation; the MoE backward through ``index_copy_``):
       2 steps, finite losses, bf16 moments.
    """
    import dataclasses
    import gc
    import itertools
    import tempfile

    import torch

    from repro_torch.configs import ARCH_IDS, get_config, get_smoke
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    wrappers = reset_launches()
    t_phase = time.perf_counter()
    opt_smoke = adamw.AdamWConfig(lr_peak=1e-3, warmup_steps=1, decay_steps=10)
    worst = 0.0
    for arch in ARCH_IDS:
        cfg = get_smoke(arch)
        card = M.init_params(seed, cfg)
        cpu = _lm_tree(card, lambda t: t.cpu())
        gen = torch.Generator().manual_seed(seed + 1)
        b, length = TRAIN_SMOKE_BATCH
        tokens = torch.randint(0, cfg.vocab, (b, length), generator=gen)
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        if cfg.frontend_len:
            batch["extra_embeds"] = torch.randn((b, cfg.frontend_len, cfg.d_model),
                                                generator=gen) * 0.02
        on_card = _lm_tree(batch, lambda t: t.cuda())
        (cl, cg), (gl, gg) = _grads(cpu, cfg, batch), _grads(card, cfg, on_card)
        _lm_hold(f"{arch} train loss", gl, cl)
        errs = [_train_hold(f"{arch} gradient", gg, cg, TRAIN_GRAD_TOL)]
        step = steps.make_train_step(cfg, opt_smoke, 2)
        copt, gopt = adamw.init(opt_smoke, cpu), adamw.init(opt_smoke, card)
        _, _, cm = step(cpu, copt, batch)
        _, _, gm = step(card, gopt, on_card)
        _lm_hold(f"{arch} train step loss", gm["loss"], cm["loss"])
        # a first Adam step moves each entry by lr x the sign of its gradient:
        # where the two gradients differ in sign, the entries differ by 2 lr
        lr = float(cm["lr"])
        errs += [_train_hold(f"{arch} {what}", tree_leaves(g), tree_leaves(c), tol, atol)
                 for what, g, c, tol, atol in (
                     ("updated parameter", card, cpu, 0.0, 2 * lr + 1e-6),
                     ("first moment", gopt.mu, copt.mu, TRAIN_GRAD_TOL, 0.0),
                     ("second moment", gopt.nu, copt.nu, 2 * TRAIN_GRAD_TOL, 0.0))]
        worst = max(worst, *errs)
        print(f"[train] {arch} smoke: loss {float(gl)!r} (CPU {float(cl)!r}); train step "
              f"loss {float(gm['loss'])!r} (CPU {float(cm['loss'])!r}), grad_norm "
              f"{float(gm['grad_norm'])!r} (CPU {float(cm['grad_norm'])!r}); worst leaf's "
              f"max |diff| over its bound: gradients {errs[0]!r}, updated parameters "
              f"{errs[1]!r}, moments {errs[2]!r} / {errs[3]!r}")
    print(f"[train] smoke configs: {time.perf_counter() - t_phase:.1f} s, worst leaf's max "
          f"|diff| over its bound {worst!r}")

    # 2. internlm2-1.8b whole through the Trainer
    t_cell = time.perf_counter()
    cfg = get_config("internlm2-1.8b")
    opt_cfg = adamw.AdamWConfig(warmup_steps=max(TRAIN_STEPS // 10, 1), decay_steps=TRAIN_STEPS,
                                moment_dtype=cfg.moment_dtype)
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS + 1, ckpt_dir=d,
                             log_every=1, link_failure_prob_per_step=0.5,
                             seed=TRAIN_FABRIC_SEED)
        trainer = Trainer(cfg, tcfg, opt_cfg, "cuda", steps.make_train_step(cfg, opt_cfg, 2),
                          None, None)
        t0 = time.perf_counter()
        fabric = trainer.bringup_fabric()
        bring_ms = (time.perf_counter() - t0) * 1e3
        bring_rounds = trainer.rearb_rounds
        data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=seed))
        try:
            t0 = time.perf_counter()
            batches = iter(data)
            first = next(batches)
            first_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = trainer.init_state()
            torch.cuda.synchronize()
            init_ms = (time.perf_counter() - t0) * 1e3
            init_peak = torch.cuda.max_memory_allocated()
            state = trainer.fit(state, itertools.chain([first], batches))
            torch.cuda.synchronize()
        finally:
            data.close()
        peak = torch.cuda.max_memory_allocated()
        if any(p.name.startswith("step_") for p in Path(d).iterdir()):
            fail("internlm2-1.8b: the Trainer wrote a checkpoint it was not asked for")
    p_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state.params))
    m_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(state.opt_state.mu) + tree_leaves(state.opt_state.nu))
    a_bytes = sum(t.numel() * torch.finfo(getattr(torch, cfg.accum_dtype)).bits // 8
                  for t in tree_leaves(state.params))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _train_flops(cfg, tokens, TRAIN_SEQ)
    losses = [m["loss"] for m in trainer.metrics_log]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"internlm2-1.8b training losses {losses!r}")
    if len(fabric.links) != 8 or not 0.0 < trainer.fabric.bandwidth_fraction <= 1.0:
        fail(f"internlm2-1.8b: fabric of {len(fabric.links)} links at bandwidth fraction "
             f"{trainer.fabric.bandwidth_fraction!r}")
    print(f"[train] internlm2-1.8b {cfg.n_layers} layers, Trainer seed {TRAIN_FABRIC_SEED}: "
          f"fabric bring-up {bring_ms!r} ms ({len(fabric.links)} links, {bring_rounds} repair "
          f"rounds, bandwidth fraction {fabric.bandwidth_fraction!r}); "
          f"first batch of {TRAIN_BATCH} x {TRAIN_SEQ} tokens {first_ms!r} ms; fresh start "
          f"(init_state: the draw kernel and zero moments) {init_ms!r} ms, peak {init_peak} "
          f"bytes allocated")
    for m in trainer.metrics_log:
        print(f"[train] internlm2-1.8b step {m['step']}: {m['sec_per_step']!r} s/step, "
              f"{tokens / m['sec_per_step']!r} tokens/s, grad_norm {m['grad_norm']!r}, "
              f"loss {m['loss']!r}, {100 * flops / m['sec_per_step'] / PEAK_BF16_PER_S!r} % of "
              f"the bf16 dense peak")
    print(f"[train] internlm2-1.8b: peak {peak} bytes allocated; parameters {p_bytes} + "
          f"moments {m_bytes} = {p_bytes + m_bytes} bytes of state, + the accumulator and "
          f"one microbatch's gradients {2 * a_bytes} = {p_bytes + m_bytes + 2 * a_bytes}; "
          f"model FLOPs a step {flops!r}; link events: {trainer.rearb_rounds} repair rounds, "
          f"{trainer.straggler_events} straggler steps; cell "
          f"{time.perf_counter() - t_cell:.1f} s")
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 3. depth 2 at full width, card against CPU
    t_cell = time.perf_counter()
    cfg2 = dataclasses.replace(get_config("internlm2-1.8b"), n_layers=2)
    card = M.init_params(seed, cfg2)
    _draw_hold("internlm2-1.8b depth 2", card, cfg2, seed)
    cpu = _lm_tree(card, lambda t: t.cpu())
    moved = _lm_tree(_lm_perturbed(card, seed + 5), lambda t: t.cpu())
    tokens = torch.randint(0, cfg2.vocab, (1, 64), generator=torch.Generator().manual_seed(seed))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    gl, gg, gp, _ = _train_step_once(card, cfg2, opt_cfg, _lm_tree(batch, lambda t: t.cuda()))
    t_cpu = time.perf_counter()
    cl, cg, cp, _ = _train_step_once(cpu, cfg2, opt_cfg, batch)
    ml, mg, mp, _ = _train_step_once(moved, cfg2, opt_cfg, batch)
    t_cpu = time.perf_counter() - t_cpu
    rel = lambda got, want: max(_lm_diff("depth 2", g, w) / (float(w.abs().max()) or 1.0)  # noqa: E731
                                for g, w in zip(got, want))
    # the loss, a mean over 64 positions, averages a perturbation's effects
    # out: it is held within LM_TOL, as the smoke configs' losses are
    _lm_hold("internlm2-1.8b depth 2 train step loss", gl, cl)
    checks = (("gradients", rel(gg, cg), rel(mg, cg)),
              ("updated parameters", rel(tree_leaves(gp), tree_leaves(cp)),
               rel(tree_leaves(mp), tree_leaves(cp))))
    for what, err, spread in checks:
        _lm_within_spread(f"internlm2-1.8b depth 2 train step {what}", err, spread)
    print(f"[train] internlm2-1.8b 2 layers, B 1, L 64, one train step card against CPU: "
          f"loss {float(gl)!r} (CPU {float(cl)!r}, perturbed {float(ml)!r}); " +
          "; ".join(f"{what} {err!r} (the CPU's own under a bf16-sized perturbation "
                    f"{spread!r})" for what, err, spread in checks) +
          f" (worst leaf's max |diff| / max |value|); the two CPU steps {t_cpu:.1f} s; "
          f"cell {time.perf_counter() - t_cell:.1f} s")
    del cpu, moved, card, gg, gp, cg, cp, mg, mp
    gc.collect()
    torch.cuda.empty_cache()

    # 4. mamba2-130m whole: resume from a checkpoint
    t_cell = time.perf_counter()
    arch, b, length, n_steps, split = TRAIN_RESUME
    cfg = get_config(arch)
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, decay_steps=n_steps, moment_dtype=cfg.moment_dtype)

    def run(d, total, state=None, skip=0):
        tcfg = TrainerConfig(total_steps=total, ckpt_every=split, ckpt_dir=d, log_every=1,
                             seed=seed)
        tr = Trainer(cfg, tcfg, opt_cfg, "cuda", steps.make_train_step(cfg, opt_cfg, 2), None,
                     None)
        data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=length, global_batch=b,
                                        seed=seed))
        try:
            batches = iter(data)
            for _ in range(skip):
                next(batches)
            state = tr.fit(tr.init_state() if state is None else state, batches)
        finally:
            data.close()
        return tr, state

    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        whole, _ = run(d1, n_steps)
        head, saved = run(d2, split)
        t0 = time.perf_counter()
        resumed = Trainer(cfg, TrainerConfig(ckpt_dir=d2), opt_cfg, "cuda", None).init_state()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if resumed.step != split:
            fail(f"{arch}: resumed at step {resumed.step}, not {split}")
        for what, got, want in (("parameters", resumed.params, saved.params),
                                ("optimizer state", resumed.opt_state, saved.opt_state)):
            for g, w in zip(tree_leaves(got), tree_leaves(want)):
                if g.device != w.device or g.dtype != w.dtype or not torch.equal(g, w):
                    fail(f"{arch}: restored {what} differ from the saved ones")
        ckpt_bytes = sum(f.stat().st_size for f in Path(d2).rglob("*.npz"))
        del saved
        tail, _ = run(d2, n_steps, resumed, skip=split)
    want, got = whole.metrics_log[-1]["loss"], tail.metrics_log[-1]["loss"]
    if not abs(got - want) <= TRAIN_RESUME_TOL:
        fail(f"{arch}: resumed step {n_steps} loss {got!r} against {want!r} uninterrupted")
    print(f"[train] {arch} {cfg.n_layers} layers, {b} x {length}: uninterrupted losses "
          f"{[m['loss'] for m in whole.metrics_log]!r}; split at {split}: losses "
          f"{[m['loss'] for m in head.metrics_log + tail.metrics_log]!r}, resumed last loss "
          f"within {abs(got - want)!r} (bound {TRAIN_RESUME_TOL}); checkpoint {ckpt_bytes} "
          f"bytes, restored bit for bit in {restore_ms!r} ms; s/step "
          f"{[m['sec_per_step'] for m in whole.metrics_log]!r}; cell "
          f"{time.perf_counter() - t_cell:.1f} s")
    del whole, head, tail, resumed
    gc.collect()
    torch.cuda.empty_cache()

    # 5. one full-width qwen3-moe super-block, bf16 moments
    t_cell = time.perf_counter()
    arch, b, length, n_steps = TRAIN_MOE
    cfg = dataclasses.replace(get_config(arch), n_layers=1)
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, decay_steps=n_steps, moment_dtype=cfg.moment_dtype)
    params = M.init_params(seed, cfg)
    _draw_hold(f"{arch} 1 super-block", params, cfg, seed)
    opt = adamw.init(opt_cfg, params)
    step = steps.make_train_step(cfg, opt_cfg, 2)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    for _ in range(n_steps):
        tokens = torch.randint(0, cfg.vocab, (b, length), generator=gen, device="cuda")
        t0 = time.perf_counter()
        _, _, m = step(params, opt, {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)})
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0, float(m["loss"]), float(m["grad_norm"])))
    dts = {t.dtype for t in tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu)}
    if dts != {torch.bfloat16} or not all(math.isfinite(v) for _, l, g in out for v in (l, g)):
        fail(f"{arch} super-block: dtypes {dts}, steps {out!r}")
    print(f"[train] {arch} 1 of 94 super-blocks, {b} x {length}, bf16 parameters, moments "
          f"and accumulation: (s/step, loss, grad_norm) {out!r}; peak "
          f"{torch.cuda.max_memory_allocated()} bytes; cell {time.perf_counter() - t_cell:.1f} s")
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    launches = {k: w.launches for k, w in wrappers.items()}
    missed = [k for k in ("feasibility", "table_build", "probe", "threefry") if not launches[k]]
    if missed:
        fail(f"the training path launched no {missed}: {launches}")
    print(f"[train] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s")
    return launches


#: The distribution phase (``phase_dist``): internlm2-1.8b whole through the
#: sharded Trainer on a 1 x 1 mesh at ``phase_train``'s settings (4 x 2,048,
#: 2 microbatches), 2 steps; the a2a MoE of one full-width qwen3-moe
#: super-block at 1 x 256 tokens; the production dry-run cells (arch, shape,
#: multi-pod, moe_impl).
DIST_STEPS = 2
DIST_MOE_TOKENS = (1, 256)
DIST_CELLS = (("internlm2-1.8b", "train_4k", False, None),
              ("internlm2-1.8b", "train_4k", True, None),
              ("qwen3-moe-235b-a22b", "train_4k", False, "gather"),
              ("qwen3-moe-235b-a22b", "train_4k", False, "a2a"))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dist(seed: int) -> dict:
    """The distribution layer (``distributed.ctx`` / ``sharding`` /
    ``hlo_walk`` / ``analysis``, ``launch.mesh`` / ``dryrun``, the sharded
    ``Trainer``, ``moe_ffn_a2a``) on the card, with the launch counts set to
    0 just before and read just after: the sharded Trainer's fabric bring-up
    and repairs launch ``feasibility``, ``table_build`` and ``probe``, and
    its fresh start ``threefry`` (each rank drawing its own blocks).

    a. A one-rank process group (NCCL for the card, gloo for the CPU; this
       phase creates it and destroys it) and ``make_host_mesh()``, a 1 x 1
       mesh over cuda:0.  internlm2-1.8b whole through the ``Trainer`` with
       ``param_shardings`` / ``opt_shardings`` (DTensor parameters and
       moments) at ``phase_train``'s settings for ``DIST_STEPS`` steps, and
       the unsharded ``Trainer`` on the same seeds: losses and updated
       parameters bit for bit (deterministic algorithms on for both, so
       that the embedding backward accumulates in one order).
    b. ``moe_ffn_a2a`` of one full-width qwen3-moe-235b-a22b super-block on
       that mesh, held against the same function on a 1 x 1 CPU mesh within
       ``LM_TOL``; the walker sees its two all-to-alls.
    c. The dry run of (a)'s cell on a fake 1-rank world: its parameter and
       optimizer argument bytes equal the real state's exactly; its
       predicted peak beside (a)'s ``max_memory_allocated``.
    d. ``DIST_CELLS`` dry-run at production size on fake worlds of 256 and
       512 ranks of device type cuda: each record's roofline terms and
       collective bytes.
    """
    import gc
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed import ctx, hlo_walk, sharding, steps
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_leaves

    wrappers = reset_launches()
    t_phase = time.perf_counter()
    dist.init_process_group("cpu:gloo,cuda:nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device_type="cuda")
        cpu_mesh = make_host_mesh(device_type="cpu")
        print(f"[dist] one-rank world: {mesh} and {cpu_mesh}")

        # a. the sharded Trainer against the unsharded one
        t_cell = time.perf_counter()
        cfg = get_config("internlm2-1.8b")
        opt_cfg = adamw.AdamWConfig(warmup_steps=1, decay_steps=TRAIN_STEPS,
                                    moment_dtype=cfg.moment_dtype)
        psh = sharding.param_shardings(cfg, mesh)
        osh = sharding.opt_shardings(psh, sharding.replicated(mesh))

        def run(where, shardings):
            with tempfile.TemporaryDirectory() as d:
                tcfg = TrainerConfig(total_steps=DIST_STEPS, ckpt_every=DIST_STEPS + 1,
                                     ckpt_dir=d, log_every=1, link_failure_prob_per_step=0.5,
                                     seed=TRAIN_FABRIC_SEED)
                tr = Trainer(cfg, tcfg, opt_cfg, where, steps.make_train_step(cfg, opt_cfg, 2),
                             *shardings)
                tr.bringup_fabric()
                data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                                global_batch=TRAIN_BATCH, seed=seed))
                try:
                    # peaks above what was resident before (the sharded run
                    # starts with the unsharded run's parameters kept)
                    torch.cuda.synchronize()
                    resident = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    state = tr.init_state()
                    torch.cuda.synchronize()
                    init_peak = torch.cuda.max_memory_allocated() - resident
                    torch.cuda.reset_peak_memory_stats()
                    state = tr.fit(state, iter(data))
                    torch.cuda.synchronize()
                finally:
                    data.close()
            return tr, state, (init_peak, torch.cuda.max_memory_allocated() - resident)

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            plain_tr, plain_state, plain_peak = run("cuda", (None, None))
            plain_params = [t.detach() for t in tree_leaves(plain_state.params)]
            del plain_state
            gc.collect()
            torch.cuda.empty_cache()
            tr, state, peak = run(mesh, (psh, osh))
        finally:
            torch.use_deterministic_algorithms(False)
        got = [t.full_tensor() if ctx.is_dtensor(t) else t for t in tree_leaves(state.params)]
        if not all(ctx.is_dtensor(t) for t in tree_leaves(state.params) +
                   tree_leaves(state.opt_state.mu)):
            fail("the sharded Trainer's parameters and moments are not all DTensors")
        losses = [m["loss"] for m in tr.metrics_log]
        plain_losses = [m["loss"] for m in plain_tr.metrics_log]
        same = [torch.equal(g, w) for g, w in zip(got, plain_params)]
        if losses != plain_losses or not all(same):
            fail(f"the 1 x 1 sharded Trainer differs from the unsharded one: losses "
                 f"{losses!r} against {plain_losses!r}; {same.count(False)} of "
                 f"{len(same)} parameter leaves differ")
        p_bytes = sum(t.numel() * t.element_size() for t in got)
        m_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in tree_leaves(state.opt_state.mu) + tree_leaves(state.opt_state.nu))
        step = state.opt_state.step
        step_bytes = (step.to_local() if ctx.is_dtensor(step) else step).element_size()
        print(f"[dist] (a) internlm2-1.8b whole, {TRAIN_BATCH} x {TRAIN_SEQ}, 2 microbatches, "
              f"remat full, Trainer seed {TRAIN_FABRIC_SEED} on the 1 x 1 mesh: losses "
              f"{losses!r} equal the unsharded Trainer's {plain_losses!r}; all {len(same)} "
              f"updated parameter leaves bit for bit; s/step sharded "
              f"{[m['sec_per_step'] for m in tr.metrics_log]!r}, unsharded "
              f"{[m['sec_per_step'] for m in plain_tr.metrics_log]!r}; peak "
              f"max_memory_allocated above the resident bytes (init_state, steps) sharded "
              f"{peak}, unsharded {plain_peak}; cell "
              f"{time.perf_counter() - t_cell:.1f} s")
        real_state = p_bytes + m_bytes + step_bytes
        del state, tr, plain_tr, plain_params, got
        gc.collect()
        torch.cuda.empty_cache()

        # b. the a2a MoE of one full-width qwen3-moe super-block
        t_cell = time.perf_counter()
        mcfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"), n_layers=1,
                                   moe_impl="a2a")
        blk = M.init_params(seed, mcfg)["blocks"][0]
        p = {k: blk[k][0].to(M.COMPUTE) for k in ("router", "w_gate", "w_up", "w_down")}
        b, length = DIST_MOE_TOKENS
        gen = torch.Generator(device="cuda").manual_seed(seed + 7)
        x = torch.randn((b, length, mcfg.d_model), generator=gen, device="cuda").to(M.COMPUTE)

        def a2a(m, p, x):
            rules = {k: sharding.NamedSharding(m, ("model", None, None) if k != "router"
                                               else (None, None)) for k in p}
            pd = sharding.shard_tree(p, rules)
            xd = sharding.shard_leaf(x, sharding.NamedSharding(m, ("data", None, None)))
            walker = hlo_walk.Walker()
            with ctx.activation_axes(m), walker:
                y, st = layers.moe_ffn_a2a(xd, pd, mcfg)
            return y.full_tensor(), st, walker.cost

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, st, cost = a2a(mesh, p, x)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        y_cpu, st_cpu, _ = a2a(cpu_mesh, {k: v.cpu() for k, v in p.items()}, x.cpu())
        cpu_ms = (time.perf_counter() - t0) * 1e3
        err = _lm_hold("qwen3-moe a2a MoE", y, y_cpu)
        aux_err = _lm_hold("qwen3-moe a2a aux loss", st.aux_loss.full_tensor(),
                           st_cpu.aux_loss.full_tensor())
        if cost.per_collective_ops.get("all-to-all") != 2:
            fail(f"moe_ffn_a2a ran {cost.per_collective_ops} collectives, not two all-to-alls")
        print(f"[dist] (b) qwen3-moe-235b-a22b super-block moe_ffn_a2a, {b} x {length} tokens, "
              f"E {mcfg.n_experts} k {mcfg.top_k}, 1 x 1 mesh: card against a 1 x 1 CPU mesh "
              f"max |diff| {err!r} (LM_TOL {LM_TOL}), aux loss {aux_err!r}; collectives "
              f"{cost.per_collective_ops}; {card_ms!r} ms on the card (first call), "
              f"{cpu_ms!r} ms on the CPU; cell {time.perf_counter() - t_cell:.1f} s")
        del p, x, y, y_cpu, blk
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # c. the dry run of (a)'s cell on a fake 1-rank world
    t_cell = time.perf_counter()
    dryrun.fake_world(1, "cuda")
    try:
        cell = ShapeCell("train_2k_b4", "train", TRAIN_SEQ, TRAIN_BATCH)
        rec, _ = dryrun.trace_cell(cfg, cell, make_host_mesh(device_type="cuda"),
                                   n_micro_override=2)
    finally:
        dist.destroy_process_group()
    mem = rec["memory"]
    if mem["parameter_bytes"] + mem["optimizer_bytes"] != real_state:
        fail(f"the dry run's parameter + optimizer bytes {mem['parameter_bytes']} + "
             f"{mem['optimizer_bytes']} are not the real state's {real_state}")
    print(f"[dist] (c) dry run of (a)'s cell on a fake 1-rank world: arguments "
          f"{mem['argument_size_in_bytes']} bytes (parameters {mem['parameter_bytes']} + "
          f"optimizer {mem['optimizer_bytes']} = the real state's {real_state}, inputs "
          f"{mem['input_bytes']}); predicted peak temp {mem['temp_size_in_bytes']} + arguments "
          f"= {dryrun.bytes_per_device(rec)} bytes against (a)'s steps' max_memory_allocated "
          f"{peak[1]}; "
          f"roofline {rec['roofline']['step_time_lower_bound_s']!r} s a step "
          f"({rec['roofline']['dominant']}) against (a)'s measured s/step; trace "
          f"{rec['trace_s']} s; cell {time.perf_counter() - t_cell:.1f} s")

    # d. production-size dry runs
    for arch, shape, multi, impl in DIST_CELLS:
        t_cell = time.perf_counter()
        over = {"moe_impl": impl} if impl else None
        rec, _ = dryrun.lower_cell(arch, shape, multi, cfg_overrides=over, device_type="cuda",
                                   variant=impl or "baseline")
        if rec["status"] != "ok":
            fail(f"dry run {arch} {shape} {'multi' if multi else 'single'}: {rec}")
        r = rec["roofline"]
        print(f"[dist] (d) dry run {arch} x {shape} {rec['mesh']} ({rec['n_devices']} ranks"
              f"{', moe_impl ' + impl if impl else ''}): compute {r['compute_s']!r} s, memory "
              f"{r['memory_s']!r} s, collective {r['collective_s']!r} s, dominant "
              f"{r['dominant']}, roofline fraction {r['roofline_fraction']!r}; collective wire "
              f"bytes {rec['collectives']['wire_bytes']}; ops {rec['collectives']['ops']}; "
              f"memory/device {dryrun.bytes_per_device(rec)} bytes; trace {rec['trace_s']} s; "
              f"cell {time.perf_counter() - t_cell:.1f} s")
    if dist.is_initialized():
        dist.destroy_process_group()

    launches = {k: w.launches for k, w in wrappers.items()}
    missed = [k for k in ("feasibility", "table_build", "probe", "threefry") if not launches[k]]
    if missed:
        fail(f"the distribution path launched no {missed}: {launches}")
    print(f"[dist] launches {launches}; phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def _means(a, places=2):
    """(S, K) per-link stat -> per-step link means, rounded, as fig22 does."""
    import numpy as np

    return [round(float(v), places) for v in np.asarray(a.cpu(), np.float32).mean(axis=1)]


def records_fabric(device: str = "cuda") -> dict:
    """``BENCH_sweep.json``'s fig21 and fig22 records from units drawn as the
    benchmarks drew them (seed 33, JAX's earlier threefry layout): fig21's
    ``link_up``, ``cafp``, ``matched``, ``route_up``, ``route_cont`` and
    ``bandwidth`` grids after the records' rounding to 4 decimals; fig22's
    per-step link means at 2 decimals, its fabric-level steps at 4, its
    gates, and the no-fault parity.  The records' ``link_chunk``,
    ``point_bytes`` and ``chunk_budget`` describe the reference's XLA memory
    accounting and are not held."""
    import numpy as np

    from repro_torch.configs.fabric import FABRIC_CONFIGS, chaos_timeline
    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core.sweep import SweepRequest, sweep
    from repro_torch.fabric import bringup, make_fabric_timeline, make_fabric_units
    from repro_torch.fabric import run_fabric_timeline

    records = {r["name"]: r["derived"]
               for r in json.loads((ROOT / "BENCH_sweep.json").read_text())["records"]}
    held = {}
    r4 = lambda x: np.round(np.asarray(x.cpu(), np.float32), 4).tolist()  # noqa: E731

    def hold(rec_name, field, got, want):
        if got != want:
            fail(f"record {rec_name} {field}: {got} against the record's {want}")
        held.setdefault(rec_name.split("/")[0], set()).add(rec_name)

    cfg_key, spec = FABRIC_CONFIGS["fabric1k-wdm16"]
    cfg = WDM_CONFIGS[cfg_key]
    units = make_fabric_units(cfg, spec, FABRIC_SEED, device, partitionable=False)
    for scheme in FIG21_SCHEMES:
        name = f"fig21/wdm16-1k/{scheme}"
        rec = records[name]
        res = sweep(SweepRequest(cfg=cfg, units=units, scheme=scheme, fabric=spec,
                                 axes=fig21_axes(cfg))).data
        for field in ("link_up", "cafp", "matched", "route_up", "route_cont", "bandwidth"):
            hold(name, field, r4(getattr(res, field)), rec[field])
    res = bringup(cfg, spec, tr_mean=float(fig21_axes(cfg)["tr_mean"][0]), scheme="vtrs_ssm",
                  seed=FABRIC_SEED, device=device, partitionable=False)
    hold("fig21/wdm16-1k/vtrs_ssm", "bringup link_up at (0, 0)", r4(res.stats.link_up),
         records["fig21/wdm16-1k/vtrs_ssm"]["link_up"][0][0])

    # fig22: the no-fault parity on mid-linkflap's fabric, then each
    # scenario warm and cold.
    cfg, spec, tl = chaos_timeline("mid-linkflap", device=device)
    units = make_fabric_units(cfg, spec, FABRIC_SEED, device, partitionable=False)
    quiet = make_fabric_timeline(spec, tl.n_steps, cfg.grid.n_ch, device=device)
    _, cs = run_fabric_timeline(cfg, units, spec, quiet)
    ref = bringup(cfg, spec, seed=FABRIC_SEED, device=device, partitionable=False)
    parity = (bool((cs.wl[0] == ref.ev.wl).all()) and int(cs.probes[1:].sum()) == 0
              and all(bool((getattr(cs.fabric, f)[0] == getattr(ref.stats, f)).all())
                      for f in cs.fabric._fields))
    hold("fig22/parity", "bit_identical", parity, records["fig22/parity"]["bit_identical"])
    hold("fig22/parity", "parity_links", spec.n_links, records["fig22/parity"]["parity_links"])
    for name, scheme in _chaos_cells():
        rec_name = f"fig22/{name}/{scheme}"
        rec = records[rec_name]
        cfg, spec, tl = chaos_timeline(name, device=device)
        units = make_fabric_units(cfg, spec, FABRIC_SEED, device, partitionable=False)
        _, warm = run_fabric_timeline(cfg, units, spec, tl, scheme=scheme, warm=True)
        _, cold = run_fabric_timeline(cfg, units, spec, tl, scheme=scheme, warm=False)
        feas = np.asarray(warm.feasible.cpu(), bool)[1:]
        wp = np.asarray(warm.probes.cpu(), np.float32)[1:]
        cp = np.asarray(cold.probes.cpu(), np.float32)[1:]
        bw = np.asarray(warm.fabric.bandwidth.cpu(), np.float32)
        got = {
            "feasible_frac": _means(warm.feasible), "warm_probes": _means(warm.probes),
            "cold_probes": _means(cold.probes), "warm_broken": _means(warm.broken),
            "warm_churn": _means(warm.churn), "warm_locked": _means(warm.locked),
            "cold_locked": _means(cold.locked),
            "bandwidth": [round(float(v), 4) for v in bw],
            "feasible_warm_probes": round(float(wp[feas].mean()), 2),
            "feasible_cold_probes": round(float(cp[feas].mean()), 2),
            "warm_wins_probes": bool(wp[feas].mean() < cp[feas].mean()),
            "warm_locked_ge_cold": bool(int(warm.locked[-1].sum()) >= int(cold.locked[-1].sum())),
            "bandwidth_recovered": bool(float(bw[-1]) >= float(bw[0]) - 1e-6),
        }
        for field in ("route_up", "route_served", "route_bandwidth", "matched"):
            got[field] = [round(float(v), 4) for v in getattr(warm.fabric, field).tolist()]
        for field, value in got.items():
            hold(rec_name, field, value, rec[field])
    return {fig: len(names) for fig, names in held.items()}


def phase_timing(seed: int) -> dict:
    """Kernel and plain-version times on the card at the main paths' shapes,
    WDM8, WDM16 (the temporal path's) and WDM32; ``probe`` at C = 1 and 4
    rows of real tables (E = 3N), half the lines taken, floors in [0, N].
    Each kernel: device ms per launch (profiler), ms per wrapper call (CUDA
    events), plain ms per call."""
    import torch

    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core.api import make_units
    from repro_torch.core.matching import adjacency_bitmask
    from repro_torch.core.reach import as_f32, reach_matrix, scaled_residual
    from repro_torch.core.sampling import instantiate
    from repro_torch.kernels.bitmask_match import (
        bottleneck_threshold,
        bottleneck_threshold_plain,
        perfect_matching,
        perfect_matching_plain,
    )
    from repro_torch.kernels.feasibility import feasibility, feasibility_plain
    from repro_torch.kernels.probe import masked_research, masked_research_plain
    from repro_torch.kernels.table_build import build_tables, build_tables_plain

    def timed(kernel, fn, plain, reps, plain_reps, cost):
        return (device_ms(fn, reps, kernel), cuda_ms(fn, reps),
                cuda_ms(plain, plain_reps), *bound_ms(*cost))

    def timed_match(label, adj):
        """The ``match`` row, its operations counted by ``match_search`` on
        these inputs, whose ``match_wl`` the kernel's must equal."""
        found, n_ops, levels, steps = match_search(adj)
        if not torch.equal(torch.tensor(found, dtype=torch.int32), perfect_matching(adj)[0].cpu()):
            fail(f"match {label}: the kernel differs from the serial search")
        t, n = adj.shape
        print(f"[time] match {label}: the search on these inputs (host counts, "
              f"{t * n} rings): BFS levels a ring, level 0 counted, mean "
              f"{1 + sum(levels) / len(levels)!r} max {1 + max(levels)}; walk-back steps "
              f"mean {sum(steps) / len(steps)!r} max {max(steps)}; {n_ops} operations")
        return timed("match_kernel", lambda: perfect_matching(adj),
                     lambda: perfect_matching_plain(adj), 20, 2, match_cost(t, n, n_ops))

    rows = {}
    for key in ("wdm8-g200", "wdm16-g200", "wdm32-g200"):
        cfg = WDM_CONFIGS[key]
        n = cfg.grid.n_ch
        sys_ = instantiate(cfg, make_units(cfg, seed, N_SIDE, N_SIDE))
        t = sys_.n_trials
        rows["feasibility", key] = timed(
            "feasibility_kernel", lambda: feasibility(*sys_, cfg.s),
            lambda: feasibility_plain(*sys_, cfg.s), 50, 10, feasibility_cost(t, n))
        tr = as_f32(TR, sys_.tr_unit.device) * sys_.tr_unit
        kw = dict(max_alias=cfg.max_fsr_alias, max_entries=3 * n)
        args = (sys_.laser, sys_.ring, sys_.fsr, tr)
        n_j = 2 * cfg.max_fsr_alias + 1
        rows["table_build", key] = timed(
            "table_build_kernel", lambda: build_tables(*args, **kw),
            lambda: build_tables_plain(*args, **kw), 20, 3,
            table_cost(t, n, min(3 * n, n * n_j), n_j))
        names = ["feasibility", "table_build", "match", "bottleneck", "probe C=1",
                 "probe C=4"]
        rows["match", key] = timed_match(f"{key} TR={TR}",
                                         adjacency_bitmask(reach_matrix(sys_, TR)))
        if key == "wdm16-g200":  # the temporal path's TR: 32 of the smoke's 66 launches
            tr_t = TEMPORAL_TR_X * cfg.grid.grid_spacing
            names.append(f"match TR={tr_t!r}")
            rows[names[-1], key] = timed_match(
                f"{key} TR={tr_t!r}", adjacency_bitmask(reach_matrix(sys_, tr_t)))
        w = scaled_residual(sys_)
        rows["bottleneck", key] = timed(
            "bottleneck_kernel", lambda: bottleneck_threshold(w),
            lambda: bottleneck_threshold_plain(w), 20, 1, bottleneck_cost(t, n))
        wl_all = build_tables(*args, **kw)[1]
        gen = torch.Generator().manual_seed(seed + n)
        taken = (torch.rand(t, n, generator=gen) < 0.5).cuda()
        for c in (1, 4):
            wl = wl_all[:, :c].contiguous()
            floor = torch.randint(0, n + 1, (t, c), generator=gen, dtype=torch.int32).cuda()
            n_bytes, n_ops, row_bytes = probe_cost(wl, taken, floor,
                                                   *masked_research(wl, taken, floor))
            rows[f"probe C={c}", key] = timed(
                "probe_kernel", lambda: masked_research(wl, taken, floor),
                lambda: masked_research_plain(wl, taken, floor), 50, 20, (n_bytes, n_ops))
            print(f"[time] probe C={c} {key}: bound counts {n_bytes} bytes of the sectors "
                  f"it scans ({row_bytes} with whole rows: {bound_ms(row_bytes, 0)[0]!r} ms)")
        for kname in names:
            ms, call_ms, plain, bound, by = rows[kname, key]
            print(f"[time] {kname} {key} T={t}: kernel {ms!r} ms on the device, "
                  f"{call_ms!r} ms per wrapper call, plain {plain!r} ms, "
                  f"bound {bound!r} ms ({by})")
    return rows


def _trace(label: str, call, cold_ms: float, walls: list) -> None:
    """One more ``call`` traced by ``torch.profiler``: its kernels' summed
    device time against the untraced warm wall times (the device's busy
    share), the kernel launches, and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels, launches = [], 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            kernels.append((e.self_device_time_total, e.count, e.key))
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            launches += e.count
    busy_ms = sum(k[0] for k in kernels) / 1e3
    print(f"[profile] {label}: cold {cold_ms!r} ms, warm {walls!r} ms untraced; device busy "
          f"{busy_ms!r} ms traced ({100 * busy_ms / max(walls):.2f}-"
          f"{100 * busy_ms / min(walls):.2f} % of the warm wall times), {launches} kernel "
          f"launches, {sum(k[1] for k in kernels)} kernels traced")
    ranked = sorted(kernels, reverse=True)
    shown = ranked[:8] + [k for k in ranked[8:] if "probe_kernel" in k[2]]
    for dev_us, count, key in shown:
        print(f"[profile]   {dev_us / 1e3!r} ms in {count} x {key[:90]}")


def phase_lm_controls(n_seeds: int) -> None:
    """``--lm-controls N``: the readings behind ``LM_BLOCK_X``.  For each
    serving cell (``LM_CELLS``) at seeds 0 .. N - 1, drawn and tokenised as
    ``phase_lm`` does: the sound card's worst super-block ratio
    (``_lm_layers``, which fails past the bound), then super-block 0's
    ratio with the card's parameters faulted: every leaf x (1 + 2^-6), and
    one leaf (the router, else a gate, else the first matrix) x (1 + 2^-4)
    and x (1 + 2^-6).  A fault whose ratio passes ``LM_BLOCK_X`` is one
    the check catches."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    def scaled(blk, f, only=None):
        return [{k: v * f if only in (None, k) else v for k, v in d.items()} for d in blk]

    for arch, depth, _, _, _ in LM_CELLS:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth * len(cfg.pattern))
        for seed in range(n_seeds):
            card = M.init_params(seed, cfg)
            cpu = _lm_tree(card, lambda t: t.cpu())
            length = 16 if cfg.n_experts else 64
            tokens = torch.randint(0, cfg.vocab, (1, length),
                                   generator=torch.Generator().manual_seed(seed + 3))
            sound = _lm_layers(arch, cfg, cpu, card, tokens, seed + 6)
            h = M.embed_inputs(cpu, cfg, tokens)
            pos = M._positions(*tokens.shape, "cpu")
            blk, card_blk = (M._super_params(p["blocks"], 0) for p in (cpu, card))
            mats = [k for k, v in card_blk[0].items() if v.dim() >= 2]
            one = next((k for k in mats if "router" in k or "gate" in k), mats[0])
            faults = {"every leaf x (1 + 2^-6)": scaled(card_blk, 1 + 2 ** -6),
                      f"{one} x (1 + 2^-4)": scaled(card_blk, 1 + 2 ** -4, one),
                      f"{one} x (1 + 2^-6)": scaled(card_blk, 1 + 2 ** -6, one)}
            read = {label: _lm_block_ratio(f"{arch} {label}", cfg, blk, faulted, h, pos,
                                           seed + 6)[0]
                    for label, faulted in faults.items()}
            print(f"[controls] {arch} seed {seed}: sound worst {sound!r} (bound {LM_BLOCK_X}); "
                  f"super-block 0 faulted {read!r}", flush=True)
            del card, cpu, faults
            gc.collect()
            torch.cuda.empty_cache()


def phase_profile(seed: int) -> None:
    """Where the time goes (``--profile``).  ``evaluate_scheme`` for
    protocol_lta at TR 8.96 and protocol_lta_h1 at fig19's TR 3.436 (WDM8
    natural, 10,000 trials); then the LM serving path: ``prefill`` of 4
    prompts and one greedy ``decode_step`` after it, on internlm2-1.8b and
    mamba2-130m whole (4 x 2,048) and one full-width super-block of
    qwen3-moe-235b-a22b (4 x 512); then one ``make_train_step`` of
    internlm2-1.8b whole (4 x 2,048, 2 microbatches).  Each a cold first
    call and three warm calls untraced, then one warm call traced
    (``_trace``)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.wdm import WDM_CONFIGS
    from repro_torch.core import api
    from repro_torch.models import model as M

    cfg = WDM_CONFIGS["wdm8-g200"]
    units = api.make_units(cfg, seed, N_SIDE, N_SIDE)
    for scheme, tr in (("protocol_lta", TR), ("protocol_lta_h1", low_tr())):
        call = lambda: api.evaluate_scheme(cfg, units, scheme, tr)  # noqa: E731
        cold_ms = timed_call(call)[1]
        _trace(f"evaluate_scheme wdm8-g200/natural {scheme} TR={tr!r}", call, cold_ms,
               [timed_call(call)[1] for _ in range(3)])
    for arch, depth, waves, n_decode, _ in LM_CELLS:
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth * len(cfg.pattern))
        params = M.init_params(seed, cfg)
        b, length = waves[0]
        prompts = torch.randint(0, cfg.vocab, (b, length), device="cuda",
                                generator=torch.Generator(device="cuda").manual_seed(seed))
        logits, state = M.prefill(params, cfg, prompts, length + n_decode)
        nxt = logits.argmax(-1, keepdim=True)
        for what, call in (
                (f"prefill {b} x {length}",
                 lambda: M.prefill(params, cfg, prompts, length + n_decode)),
                (f"decode_step at {length}, B {b}",
                 lambda: M.decode_step(params, cfg, state, nxt))):
            cold_ms = timed_call(call)[1]
            _trace(f"{arch} {cfg.n_layers} layers {what}", call, cold_ms,
                   [timed_call(call)[1] for _ in range(3)])
        del params, prompts, logits, state, nxt
        gc.collect()
        torch.cuda.empty_cache()
    # one train step of internlm2-1.8b whole, as phase_train's Trainer runs it
    from repro_torch.distributed import steps
    from repro_torch.optim import adamw

    cfg = get_config("internlm2-1.8b")
    opt_cfg = adamw.AdamWConfig(warmup_steps=1, decay_steps=10, moment_dtype=cfg.moment_dtype)
    params = M.init_params(seed, cfg)
    opt = adamw.init(opt_cfg, params)
    step = steps.make_train_step(cfg, opt_cfg, 2)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(seed))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    call = lambda: step(params, opt, batch)  # noqa: E731
    cold_ms = timed_call(call)[1]
    _trace(f"internlm2-1.8b {cfg.n_layers} layers train_step {TRAIN_BATCH} x {TRAIN_SEQ}, "
           f"2 microbatches", call, cold_ms, [timed_call(call)[1] for _ in range(3)])


def run_group(name: str, seed: int) -> int:
    """``--group NAME``: the phases of ``PHASE_GROUPS[name]`` in order, then
    their launches, a JSON object by phase on a line of its own."""
    runs = {k: {} for k in ("temporal", "sweep", "fabric", "chaos")}
    phases = {
        "main": phase_main, "lta": phase_lta, "protocol": phase_protocol,
        "temporal": lambda s: phase_temporal(s, N_SIDE, runs["temporal"]),
        "sweep": lambda s: phase_sweep(s, runs["sweep"]),
        "fabric": lambda s: phase_fabric(s, runs["fabric"]),
        "chaos": lambda s: phase_chaos(s, runs["chaos"]),
        "interconnect": phase_interconnect,
        "campaign": lambda s: phase_campaign(s, runs["temporal"]),
        "mesh": lambda s: phase_mesh(s, runs["sweep"], runs["fabric"], runs["chaos"]),
        "obs": lambda s: phase_obs(s, runs["temporal"], runs["chaos"]),
        "lm": phase_lm, "train": phase_train, "dist": phase_dist,
    }
    import torch

    launches = {}
    for phase in PHASE_GROUPS[name]:
        t_phase = time.perf_counter()
        launches[phase] = phases[phase](seed)
        # the groups share the card's memory: hand back what the phase cached
        torch.cuda.empty_cache()
        print(f"[env] phase {phase} {time.perf_counter() - t_phase:.1f} s", flush=True)
    print(GROUP_RESULT + json.dumps(launches))
    return 0


def start_groups(seed: int) -> dict:
    """One process for each of ``PHASE_GROUPS``, its output to a log under
    ``build/chip_smoke``: {name: (process, log path)}."""
    logs = ROOT / "build" / "chip_smoke"
    logs.mkdir(parents=True, exist_ok=True)
    groups = {}
    for name in PHASE_GROUPS:
        path = logs / f"{name}.log"
        with open(path, "w") as out:
            groups[name] = (subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--group", name,
                 "--seed", str(seed)], stdout=out, stderr=subprocess.STDOUT, cwd=ROOT), path)
    return groups


def finish_groups(groups: dict) -> dict:
    """Wait for the groups, print each one's output as it ends, and fail as
    soon as one fails; each kernel's launches summed over the paths (a
    phase run in two groups counted once)."""
    per_phase, pending = {}, dict(groups)
    while pending:
        for name, (proc, path) in list(pending.items()):
            if proc.poll() is None:
                continue
            del pending[name]
            text = path.read_text()
            print(text, end="" if text.endswith("\n") else "\n", flush=True)
            if proc.returncode != 0:
                fail(f"phase group {name} exited with {proc.returncode}")
            result = [line for line in text.splitlines() if line.startswith(GROUP_RESULT)]
            if not result:
                fail(f"phase group {name} printed no result")
            for phase, counts in json.loads(result[-1][len(GROUP_RESULT):]).items():
                per_phase.setdefault(phase, counts)
        time.sleep(0.5)
    missing = {p for g in PHASE_GROUPS.values() for p in g} - set(per_phase)
    if missing:
        fail(f"phases {sorted(missing)} reported no launches")
    first = next(iter(per_phase.values()))
    return {k: sum(p[k] for p in per_phase.values()) for k in first}


def stop_groups(groups: dict) -> None:
    """Kill any group still running (after a failure) and reap them all."""
    for proc, _ in groups.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true",
                        help="build, then trace protocol and LM calls (no checks, no "
                             "result line)")
    parser.add_argument("--lm-controls", type=int, default=0, metavar="N",
                        help="build, then read each serving cell's super-block bound at "
                             "seeds 0 .. N-1, sound and with faulted parameters (no result "
                             "line)")
    parser.add_argument("--group", choices=sorted(PHASE_GROUPS), help=argparse.SUPPRESS)
    args = parser.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch is not beside this script")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke run needs a CUDA card")
    if args.group:
        return run_group(args.group, args.seed)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}; "
          f"host {host_launch_us()!r} us a tiny op")

    t_start = time.perf_counter()
    phase_build()
    if args.profile:
        phase_profile(args.seed)
        print(f"[env] wall time {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.lm_controls:
        phase_lm_controls(args.lm_controls)
        print(f"[env] wall time {time.perf_counter() - t_start:.1f} s")
        return 0
    groups = start_groups(args.seed)
    try:
        t_kernels = time.perf_counter()
        max_err = phase_kernels(args.seed)
        max_err.update(phase_matching(args.seed))
        max_err.update(phase_probe(args.seed))
        print(f"[env] kernel checks {time.perf_counter() - t_kernels:.1f} s")
        t_flat = time.perf_counter()
        for k, v in phase_flat_grids(args.seed).items():
            max_err[k] = max(max_err[k], v)
        print(f"[env] flattened-grid kernel checks {time.perf_counter() - t_flat:.1f} s")
        t_fab = time.perf_counter()
        for k, v in phase_fabric_kernels(args.seed).items():
            max_err[k] = max(max_err[k], v)
        print(f"[env] fabric-shape kernel checks {time.perf_counter() - t_fab:.1f} s")
        t_draw = time.perf_counter()
        max_err["threefry"] = phase_draw_kernel(args.seed)
        print(f"[env] draw kernel checks {time.perf_counter() - t_draw:.1f} s")
        t_rec = time.perf_counter()
        phase_records()
        torch.cuda.empty_cache()
        print(f"[env] phase_records {time.perf_counter() - t_rec:.1f} s")
        t_paths = time.perf_counter()
        launches = finish_groups(groups)
        print(f"[env] paths done {time.perf_counter() - t_paths:.1f} s after the checks "
              f"beside them, {time.perf_counter() - t_start:.1f} s into the run")
    finally:
        stop_groups(groups)
    print(f"[env] launches over the main, LtA, protocol, temporal, sweep, fabric, chaos, "
          f"interconnect, campaign, mesh, obs, LM, training and distribution paths: "
          f"{launches}")
    t_timing = time.perf_counter()
    rows = phase_timing(args.seed)
    print(f"[env] kernel timing {time.perf_counter() - t_timing:.1f} s")
    t_draw = time.perf_counter()
    draw_row = draw_timing(args.seed)
    print(f"[env] draw kernel timing {time.perf_counter() - t_draw:.1f} s")
    print(f"[env] wall time {time.perf_counter() - t_start:.1f} s")

    smi = card()
    kernels = []
    for kname, source, replaces in (
        ("feasibility", "src/repro_torch/kernels/csrc/feasibility.cu",
         "src/repro/kernels/feasibility.py:28"),
        ("table_build", "src/repro_torch/kernels/csrc/table_build.cu",
         "src/repro/kernels/table_build.py:108"),
        ("match", "src/repro_torch/kernels/csrc/match.cu",
         "src/repro/kernels/bitmask_match.py:52"),
        ("bottleneck", "src/repro_torch/kernels/csrc/bottleneck.cu",
         "src/repro/kernels/bitmask_match.py:125"),
        ("probe", "src/repro_torch/kernels/csrc/probe.cu",
         "src/repro/kernels/probe.py:37"),
    ):
        # probe: its most frequent call, one table row (C = 1).
        ms, call_ms, plain, bound, by = rows[kname + (" C=1" if kname == "probe" else ""),
                                             "wdm32-g200"]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err[kname],
            "ms": ms, "call_ms": call_ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
    # the draw kernel replaces no TPU kernel: the reference draws with XLA ops
    ms, call_ms, plain, bound, by = draw_row
    kernels.append({
        "name": "threefry", "route": "cuda", "source": "src/repro_torch/kernels/csrc/threefry.cu",
        "replaces": "none (src/repro/models/model.py:27 draws with jax.random's XLA ops)",
        "launches": launches["threefry"], "max_abs_err": max_err["threefry"],
        "ms": ms, "call_ms": call_ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
