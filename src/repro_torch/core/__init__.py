"""Core wavelength-arbitration library (the paper's contribution): the main
path, the protocol engine, temporal re-arbitration and the sweep engine.

Public API re-exports, the reference's ``repro.core`` names in its groups::

    from repro_torch.core import Variations, evaluate_scheme, make_units

The kernel wrappers (``repro_torch.kernels``) import core helpers, so this
package starts initializing before any of them: ``repro_torch/__init__.py``
imports it first.
"""
from .grid import (  # noqa: F401
    POLICIES,
    ArbitrationConfig,
    DWDMGrid,
    VariationModel,
    natural_order,
    permuted_order,
    wdm_config,
)
from .variations import (  # noqa: F401
    AxisSpec,
    Variations,
    axis_names,
    axis_spec,
    register_axis,
)
from .sampling import (  # noqa: F401
    SystemBatch,
    UnitSamples,
    draw_unit_samples,
    instantiate,
    sample_systems,
)
from .reach import reach_matrix, scaled_residual, tuning_residual  # noqa: F401
from .api import (  # noqa: F401
    SCHEME_POLICY,
    SCHEMES,
    EvalResult,
    SchemeSpec,
    evaluate_policy,
    evaluate_scheme,
    make_protocol,
    make_seq_retry,
    make_units,
    oblivious_arbitrate,
    policy_min_tr,
    register_scheme,
    register_scheme_family,
    registered_schemes,
    scheme_spec,
    shmoo,
)
from .protocol import (  # noqa: F401
    ProtocolState,
    ProtocolStats,
    cold_state,
    masked_first_entry,
    revalidate_state,
    run_protocol,
    run_protocol_trace,
)
from .temporal import (  # noqa: F401
    TemporalStats,
    Timeline,
    make_timeline,
    restore_campaign,
    run_timeline,
    save_campaign,
    slice_timeline,
)
from .sweep import (  # noqa: F401
    SweepRequest,
    SweepResult,
    sweep,
    sweep_grid,
    sweep_grid_reference,
    sweep_min_tr,
    sweep_policy,
    sweep_reference,
    sweep_scheme,
)
from .outcomes import Outcome, classify  # noqa: F401
from .ssm import Assignment  # noqa: F401
