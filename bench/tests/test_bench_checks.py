"""The check that decides ``correct``: on the CPU at a small size, the
program's answers read 0 against the reference and the bfloat16 control
does not; and a run with the timed path broken underneath comes out not
correct, for each fault a cell can have (one card: no exchange between
chips to leave out)."""
import importlib
from pathlib import Path

import pytest
import torch

import control
import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 11
CELLS = ["wdm8.fig14-ltc-schemes", "wdm16.fig4-lta-ideal", "wdm8.fig19-protocol",
         "wdm16.fig14-vtrs-ssm"]


#: Units a side: the protocol's outcomes need more trials before bfloat16
#: flips one (its CAFP is near 0 and its ideal's threshold sharp).
SIZE = {"wdm8.fig19-protocol": 16}


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell):
    size = SIZE.get(cell, 8)
    r = control.readings(cell, SEED, device="cpu", n_laser=size, n_ring=size)
    assert r["program"] == [0, 0]
    assert sum(r["control"]) > 0
    assert r["answers"] > 0


def _half_batch(monkeypatch):
    """The trial mean taken over the first half of each point's trials."""
    sw = importlib.import_module("repro_torch.core.sweep")

    orig = sw._trial_mean
    monkeypatch.setattr(sw, "_trial_mean", lambda x, n: orig(x[..., : x.shape[-1] // 2], n // 2))


def _answer_altered(monkeypatch):
    """One trial of every point answered wrongly where it is produced."""
    sw = importlib.import_module("repro_torch.core.sweep")

    def point_heads(units, total):
        t = units.u_rlv.shape[0] * units.u_go.shape[0]
        return torch.arange(0, total, t)

    orig_scheme, orig_policy = sw.scheme_trials, sw.policy_trial_min_tr

    def scheme_trials(cfg, units, scheme, var):
        r = orig_scheme(cfg, units, scheme, var)
        alg = r.alg_success.clone()
        heads = point_heads(units, alg.shape[0])
        alg[heads] = ~alg[heads]
        return r._replace(alg_success=alg)

    def policy_trial_min_tr(cfg, units, policy, var):
        m = orig_policy(cfg, units, policy, var).clone()
        m[point_heads(units, m.shape[0])] = 0.0
        return m

    monkeypatch.setattr(sw, "scheme_trials", scheme_trials)
    monkeypatch.setattr(sw, "policy_trial_min_tr", policy_trial_min_tr)


def _state_unchanged(monkeypatch):
    """The protocol's phases hand back the state they were given."""
    pr = importlib.import_module("repro_torch.core.protocol")

    monkeypatch.setattr(pr, "_probe_phase", lambda tables, order, state, *a, **k: state)
    monkeypatch.setattr(pr, "_augment_phase", lambda tables, state, *a, **k: state)


FAULTS = [(cell, fault) for cell in CELLS for fault in (_half_batch, _answer_altered)]
FAULTS.append(("wdm8.fig19-protocol", _state_unchanged))


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    size = SIZE.get(cell, 8)
    result, checks = harness.run_cell(ROOT, cell, SEED, 0.01, False, 0.0, device="cpu",
                                      n_laser=size, n_ring=size)
    assert result["attempted"] >= 1
    assert result["correct"] is False, checks
