"""The port's public surface (``repro_torch``) against the JAX reference's
(``repro``), and the deprecated ``sigma_*=`` keyword shims, on the CPU.

* The surface gate: every reference module with a port counterpart is read
  (its source, with ``ast``: nothing of it is imported) for the public names
  it defines, re-exports from its own package (in an ``__init__``) or lists
  in ``__all__``; each must exist in the counterpart, save the exemptions
  named below, each with its reason.
* ``core.sweep.AXIS_NAMES`` is live, ``core.protocol.masked_first_entry``
  equals the reference's exactly, and ``fabric.instantiate_link`` equals the
  reference's one-link form bit for bit in both threefry layouts.
* The shims, as the reference's ``tests/test_variations.py`` checks them, on
  both packages and the same seeded units: one ``DeprecationWarning`` that
  names this file, results bit-identical to the ``Variations`` form (and
  to the reference's un-jitted bodies: counts exactly, floats bit for bit
  where the reference's eager arithmetic is the port's, the AFP/CAFP shares
  within 1e-7, ROADMAP queue 3), and "specified twice" when an axis is
  given both ways.
"""
import ast
import dataclasses
import importlib
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import fabric as jcfab  # noqa: E402
from repro.configs import wdm as jwdm  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import protocol as jproto  # noqa: E402
from repro.core import sampling as jsamp  # noqa: E402
from repro.core.variations import Variations as JVariations  # noqa: E402
from repro import fabric as jfab  # noqa: E402
from repro_torch import fabric as tfab  # noqa: E402
from repro_torch.convert import config_from_fields, units_from_numpy  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import variations as tvar  # noqa: E402
from repro_torch.core.sampling import instantiate  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

#: Reference names the port does not carry, by module, each with its reason.
EXEMPT = {
    # ROADMAP "Need no port": the port is eager, so the jit split has no
    # counterpart; policy_trial_min_tr stands in for the last.
    "core.api": {"evaluate_policy_impl", "evaluate_scheme_impl", "policy_min_tr_impl",
                 "policy_trial_min_tr_impl"},
    # ROADMAP "Need no port": a per-trial oracle loop of the reference.
    "core.relation": {"relation_search_loop"},
    # ROADMAP "Need no port": a VMEM tiling plan and the dense oracle (the
    # port's plain table_build equals it bit for bit).
    "core.search_table": {"MergePlan", "merge_plan", "build_search_tables_dense"},
    # ROADMAP "Need no port": kernels/ops.py's backend= dispatch, which the
    # reference's kernels package re-exports; the wrappers stand in.
    "kernels": {"build_tables", "perfect_matching"},
    # The Pallas entry points, for which the port's wrappers stand in, and
    # the TPU block constants.
    "kernels.bitmask_match": {"TRIAL_BLOCK", "bottleneck_pallas", "match_pallas"},
    "kernels.feasibility": {"TRIAL_BLOCK", "feasibility_pallas"},
    "kernels.probe": {"research_pallas"},
    "kernels.table_build": {"BIG", "TRIAL_BLOCK", "table_pallas"},
    # Until the distribution slice: an all-to-all MoE dispatch over a device
    # mesh (moe_impl="a2a" raises NotImplementedError naming that slice).
    "models.layers": {"moe_ffn_a2a"},
    # Until ROADMAP queue 1 item 5 (distribution): the 2-D meshes of the LM-era scaffolding.
    "launch.mesh": {"make_production_mesh", "make_host_mesh", "data_axes"},
}

#: Names a reference module serves without defining them: a live module
#: attribute, and a sibling's constant it imports and uses by that name.
EXTRA = {"core.sweep": {"AXIS_NAMES"}, "core.ssm": {"RI_PHI"}}


def _module_name(rel: Path) -> str:
    parts = rel.with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _public_names(path: Path) -> set:
    """Top-level public definitions and assignments, ``__all__`` entries and,
    in an ``__init__``, names imported from the package's own modules."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    names.add(target.id)
                    if target.id == "__all__":
                        names |= {c.value for c in ast.walk(node.value)
                                  if isinstance(c, ast.Constant) and isinstance(c.value, str)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and node.level and path.name == "__init__.py":
            names |= {a.asname or a.name for a in node.names}
    return {n for n in names if not n.startswith("_")}


#: Reference module name ("" for the package) -> its source, where the port
#: has the same file.
COUNTERPARTS = {_module_name(p.relative_to(REF)): p for p in sorted(REF.rglob("*.py"))
                if (PORT / p.relative_to(REF)).exists()}


def test_counterparts_cover_the_ported_layers():
    for mod in ("core", "core.api", "core.sweep", "configs", "fabric", "fabric.sampling",
                "launch.mesh", "checkpoint.store", "obs.phase", "optics.interconnect",
                "models.config", "models.layers", "models.model", "configs.archs",
                "configs.shapes", "launch.serve", "optim.adamw", "optim.compression",
                "distributed.steps", "data.pipeline", "runtime.trainer", "launch.train"):
        assert mod in COUNTERPARTS, mod
    assert set(EXEMPT) | set(EXTRA) <= set(COUNTERPARTS)


@pytest.mark.parametrize("mod", sorted(COUNTERPARTS), ids=lambda m: m or "repro")
def test_surface_gate(mod):
    port = importlib.import_module(".".join(filter(None, ("repro_torch", mod))))
    exempt = EXEMPT.get(mod, set())
    want = (_public_names(COUNTERPARTS[mod]) | EXTRA.get(mod, set())) - exempt
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, f"repro_torch.{mod} lacks {missing}"
    # an exemption the port has since implemented, or one the reference no
    # longer defines, is stale
    stale = sorted(n for n in exempt if hasattr(port, n))
    assert not stale, f"repro_torch.{mod} now has exempt names {stale}"
    unknown = sorted(exempt - _public_names(COUNTERPARTS[mod]))
    assert not unknown, f"repro.{mod} does not define exempt names {unknown}"


def test_core_reexports_every_reference_name():
    """``from repro_torch.core import <name>`` for each of the reference's
    62 re-exports, and the package-level config registries."""
    names = _public_names(REF / "core" / "__init__.py")
    assert len(names) == 62
    core = importlib.import_module("repro_torch.core")
    for name in sorted(names):
        exec(f"from repro_torch.core import {name}", {})
        assert getattr(core, name) is not None, name
    from repro_torch.configs import FABRIC_CONFIGS, WDM_CONFIGS

    assert sorted(WDM_CONFIGS) == sorted(jwdm.WDM_CONFIGS)
    assert sorted(FABRIC_CONFIGS) == sorted(jcfab.FABRIC_CONFIGS)
    assert "instantiate_link" in tfab.__all__


def test_chip_smoke_imports_the_whole_surface():
    """``chip_smoke.py`` (which cannot import the reference) lists the
    surface it imports on the card; the list is the reference's."""
    import sys

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    assert set(chip_smoke.SURFACE_CORE) == _public_names(REF / "core" / "__init__.py")
    assert set(chip_smoke.SURFACE_FABRIC) == set(jfab.__all__)


def test_axis_names_is_live(monkeypatch):
    sweep_mod = importlib.import_module("repro_torch.core.sweep")
    monkeypatch.setattr(tvar, "_AXIS_REGISTRY", dict(tvar._AXIS_REGISTRY))
    before = sweep_mod.AXIS_NAMES
    assert before == tvar.axis_names() and "sigma_rlv" in before
    tvar.register_axis("surface_probe_axis", lambda cfg: 0.0)
    assert sweep_mod.AXIS_NAMES == before + ("surface_probe_axis",)
    with pytest.raises(AttributeError):
        sweep_mod.NOT_AN_AXIS_LIST  # noqa: B018


def test_constants_match_reference():
    from repro.core import relation as jrel
    from repro.core import search_table as jst
    from repro_torch.core import search_table as tst
    from repro_torch.core import ssm as tssm

    assert np.float32(tst.SENTINEL) == np.float32(jst.SENTINEL) == np.float32(np.inf)
    assert int(tssm.RI_PHI) == int(jrel.RI_PHI)


@pytest.mark.parametrize("t,c,e,n_lines", [(37, 1, 24, 8), (20, 5, 48, 16), (9, 3, 7, 4)])
def test_masked_first_entry_equals_reference(t, c, e, n_lines):
    from repro_torch.core import masked_first_entry

    rng = np.random.default_rng(t * 100 + c)
    wl = rng.integers(-1, n_lines + 2, (t, c, e)).astype(np.int32)  # ids >= L route to no line
    taken = rng.random((t, n_lines)) < 0.4
    floor = rng.integers(-1, e + 3, (t, c)).astype(np.int32)
    want = jproto.masked_first_entry(jnp.asarray(wl), jnp.asarray(taken), jnp.asarray(floor))
    got = masked_first_entry(torch.from_numpy(wl), torch.from_numpy(taken),
                             torch.from_numpy(floor))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("comb_group", ["link", "bundle"])
def test_instantiate_link_equals_reference(comb_group, partitionable):
    jspec = dataclasses.replace(jcfab.FABRIC_TINY, comb_group=comb_group)
    tspec = tfab.FabricSpec(**dataclasses.asdict(jspec))
    jcfg = jwdm.WDM8_G200
    tcfg = config_from_fields(**dataclasses.asdict(jcfg))
    with jax.threefry_partitionable(partitionable):
        ju = jfab.make_fabric_units(jcfg, jspec, 11)
    tu = tfab.make_fabric_units(tcfg, tspec, 11, device="cpu", partitionable=partitionable)
    over = {"comb_coupling": np.float32(0.5)} if comb_group != "link" else {}
    for k in (0, jspec.n_links - 1):
        with jax.disable_jit():
            want = jfab.instantiate_link(jcfg, jspec, jax.tree_util.tree_map(lambda a: a[k], ju),
                                         JVariations(**over))
        got = tfab.instantiate_link(tcfg, tspec, tfab.FabricUnits(*(u[k] for u in tu)),
                                    tvar.Variations(**over))
        for f, g, w in zip(got._fields, got, want):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape == (2, 8), f
            np.testing.assert_array_equal(g.numpy().view(np.int32), w.view(np.int32),
                                          err_msg=f)


# --------------------------------------------------- deprecated shims ---

def _units(seed=4, n=5):
    jcfg = jwdm.WDM8_G200
    ju = japi.make_units(jcfg, seed, n, n)
    tu = units_from_numpy(*(np.asarray(a) for a in ju), device="cpu")
    return jcfg, ju, config_from_fields(**dataclasses.asdict(jcfg)), tu


def _one_warning(record):
    dep = [w for w in record if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1, [str(w.message) for w in dep]
    assert "Variations" in str(dep[0].message)
    assert dep[0].filename == __file__, dep[0].filename
    return dep[0]


def _equal(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32 else g,
                           w.view(torch.int32) if w.dtype == torch.float32 else w)


def test_instantiate_legacy_kwargs_warn_and_match_variations():
    _, ju, tcfg, tu = _units()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        legacy = instantiate(tcfg, tu, sigma_rlv=2.0, sigma_go=1.0)
    assert "sigma_go" in str(_one_warning(record).message)
    _equal(legacy, instantiate(tcfg, tu, tvar.Variations(sigma_rlv=2.0, sigma_go=1.0)))
    with pytest.warns(DeprecationWarning):
        ref = jsamp.instantiate(jwdm.WDM8_G200, ju, sigma_rlv=2.0, sigma_go=1.0)
    for f, g, w in zip(legacy._fields, legacy, ref):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32), err_msg=f)
    for mod, units in ((tvar, tu), (None, ju)):
        with pytest.raises(ValueError, match="specified twice"):
            with pytest.warns(DeprecationWarning):
                if mod is None:
                    jsamp.instantiate(jwdm.WDM8_G200, units, JVariations(sigma_rlv=2.0),
                                      sigma_rlv=3.0)
                else:
                    instantiate(tcfg, units, tvar.Variations(sigma_rlv=2.0), sigma_rlv=3.0)


def test_evaluator_legacy_kwargs_bit_identical():
    jcfg, ju, tcfg, tu = _units()
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        legacy = tapi.evaluate_scheme(tcfg, tu, "seq", 5.0, sigma_rlv=2.0)
    _one_warning(record)
    _equal(legacy, tapi.evaluate_scheme(
        tcfg, tu, "seq", variations=tvar.Variations(tr_mean=5.0, sigma_rlv=2.0)))
    with pytest.warns(DeprecationWarning):
        ref = japi.evaluate_scheme_impl(jcfg, ju, "seq", 5.0, sigma_rlv=2.0)
    t = tu.u_rlv.shape[0] * tu.u_go.shape[0]
    for f in ("alg_success", "ideal_ok"):
        np.testing.assert_array_equal(getattr(legacy, f).numpy(), np.asarray(getattr(ref, f)))
    for f in ("afp", "cafp", "lock_err", "order_err"):
        g, w = float(getattr(legacy, f)), float(np.asarray(getattr(ref, f)))
        assert round(g * t) == round(w * t) and abs(g - w) <= 1e-7, f

    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        m_legacy = tapi.policy_min_tr(tcfg, tu, "ltc", sigma_rlv=2.0, fsr_mean=8.0)
    assert "fsr_mean" in str(_one_warning(record).message)
    _equal(m_legacy, tapi.policy_min_tr(tcfg, tu, "ltc",
                                        tvar.Variations(sigma_rlv=2.0, fsr_mean=8.0)))
    with pytest.warns(DeprecationWarning):
        m_ref = japi.policy_min_tr_impl(jcfg, ju, "ltc", sigma_rlv=2.0, fsr_mean=8.0)
    np.testing.assert_array_equal(m_legacy.numpy().view(np.int32),
                                  np.asarray(m_ref).view(np.int32))


@pytest.mark.parametrize("fn", ["evaluate_policy", "policy_trial_min_tr", "evaluate_scheme",
                                "policy_min_tr"])
def test_each_evaluator_warns_once_at_the_call_site(fn):
    _, _, tcfg, tu = _units(n=3)
    target = "vtrs_ssm" if fn == "evaluate_scheme" else "lta"
    kw = dict(sigma_tr_frac=0.05, sigma_llv_frac=0.1, sigma_fsr_frac=0.02, sigma_go=1.5)
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        legacy = getattr(tapi, fn)(tcfg, tu, target, **kw)
    _one_warning(record)
    _equal(legacy, getattr(tapi, fn)(tcfg, tu, target, variations=tvar.Variations(**kw)))
    with pytest.raises(ValueError, match="specified twice"):
        with pytest.warns(DeprecationWarning):
            getattr(tapi, fn)(tcfg, tu, target, variations={"sigma_go": 1.0}, sigma_go=2.0)


def test_merge_legacy_overrides_matches_reference():
    from repro.core import variations as jvar

    assert tvar.LEGACY_SIGMA_KWARGS == jvar.LEGACY_SIGMA_KWARGS
    with warnings.catch_warnings(record=True) as record:
        warnings.simplefilter("always")
        same = tvar.merge_legacy_overrides(None, dict.fromkeys(tvar.LEGACY_SIGMA_KWARGS),
                                           caller="x")
    assert len(same) == 0 and not record
    with pytest.warns(DeprecationWarning) as want:
        jvar.merge_legacy_overrides(None, {"sigma_rlv": 1.0, "fsr_mean": 7.0}, caller="f")
    with pytest.warns(DeprecationWarning) as got:
        merged = tvar.merge_legacy_overrides(None, {"sigma_rlv": 1.0, "fsr_mean": 7.0},
                                             caller="f")
    assert str(got[0].message) == str(want[0].message)
    assert dict(merged.items()) == {"fsr_mean": 7.0, "sigma_rlv": 1.0}
