"""The plain reference agrees with itself on a tiny grid: points one at a
time and in one batch, the LtA bound's shortcut and a plain binary search,
and the LtC and LtA ideals' order."""
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from reference import model as ref
from reference import prng

ROOT = Path(__file__).resolve().parents[2]


def deployment(name):
    return ref.Deployment.from_config(json.loads((ROOT / f"bench/configs/{name}.json").read_text()))


def units(n_ch, seed=2 ** 33 + 7, size=6):
    return prng.unit_sets(seed, 1, n_ch, size, size)[0]


@pytest.mark.parametrize("scheme", ["seq", "rs_ssm", "vtrs_ssm", "protocol_lta"])
@pytest.mark.parametrize("order", ["natural", "permuted"])
def test_points_alone_and_batched_agree(scheme, order):
    dep = deployment("wdm8-g200")
    u, s = units(8), ref.order(order, 8)
    sigmas = np.array([0.5, 2.0, 4.0], np.float32) * np.float32(1.12)
    trs = np.array([2.0, 5.0, 8.0], np.float32)
    alone = []
    for sg, tr in zip(sigmas, trs):
        sys_ = ref.instantiate(dep, u, s, sg, dtype=torch.float32, device="cpu")
        alone.append(ref.scheme_trials(dep, sys_, s, scheme,
                                       torch.full((sys_.laser.shape[0],), float(tr))))
    sys_ = ref.concat([ref.instantiate(dep, u, s, sg, dtype=torch.float32, device="cpu")
                       for sg in sigmas])
    batched = ref.scheme_trials(dep, sys_, s, scheme, torch.from_numpy(np.repeat(trs, 36)))
    for field in ref.TrialOutcomes._fields:
        assert torch.equal(torch.cat([getattr(a, field) for a in alone]), getattr(batched, field))


def _bottleneck_by_search(w):
    """Binary search over every trial's sorted weights, with no shortcut."""
    t, n, _ = w.shape
    cand = torch.sort(w.reshape(t, n * n), dim=1).values
    rows = torch.arange(t)
    lo, hi = torch.zeros(t, dtype=torch.long), torch.full((t,), n * n - 1)
    for _ in range(math.ceil(math.log2(n * n)) + 1):
        mid = (lo + hi) // 2
        ok = ref.perfect(w <= cand[rows, mid][:, None, None])
        lo, hi = torch.where(ok, lo, mid + 1), torch.where(ok, mid, hi)
    return cand[rows, hi]


@pytest.mark.parametrize("name, n, sigma", [("wdm8-g200", 8, 0.28), ("wdm8-g200", 8, 8.96),
                                            ("wdm16-g200", 16, 2.24)])
def test_lta_shortcut_equals_the_plain_search(name, n, sigma):
    dep = deployment(name)
    sys_ = ref.instantiate(dep, units(n, size=5), ref.order("natural", n), np.float32(sigma),
                           dtype=torch.float32, device="cpu")
    assert torch.equal(ref.lta_min_tr(sys_), _bottleneck_by_search(ref.scaled_residual(sys_)))


def test_ltc_success_implies_lta_success():
    """Lock-to-Cyclic is one assignment of Lock-to-Any, so its least TR
    bounds LtA's from above on every trial."""
    dep = deployment("wdm8-g200")
    sys_ = ref.instantiate(dep, units(8, size=8), ref.order("natural", 8), np.float32(2.24),
                           dtype=torch.float32, device="cpu")
    assert bool((ref.lta_min_tr(sys_) <= ref.ltc_min_tr(sys_, ref.order("natural", 8))).all())
