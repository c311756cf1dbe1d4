"""The optical interconnect runtime (``interconnect``): fabric bring-up
records, link death and warm re-arbitration over the fabric layer."""
from .interconnect import (  # noqa: F401
    FabricState,
    LinkHealth,
    bringup,
    expected_failure_rates,
    rearbitrate,
)
