"""Reserved entry point: arbitration as a service.

The generic-LM request loop (``--arch`` configs, prefill/decode) is not
served from here: in the reference it lives with the rest of the LM stack
under ``examples/legacy_lm/``, and the port's LM serving path is the
library API of ``repro_torch.models.model`` (``init_params``, ``prefill``,
``decode_step``).  This module is reserved for a request loop whose units
are arbitration evaluations (sweep requests, fabric bring-ups) rather than
LM tokens.
"""
from __future__ import annotations


def main():
    raise SystemExit(
        "repro_torch.launch.serve: the LM request loop is the reference's "
        "examples/legacy_lm/ (the port's LM serving path is the library API "
        "repro_torch.models.model: init_params, prefill, decode_step); "
        "this entry point is reserved for arbitration-as-a-service."
    )


if __name__ == "__main__":
    main()
