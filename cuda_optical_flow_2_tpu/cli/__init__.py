"""cli subpackage."""

from __future__ import annotations

import dataclasses

__all__ = ["xla_only"]


def xla_only(config):
    """``config`` with the hand-written kernel turned off (``--no-pallas``).

    Only the LK and DIS configs select a kernel; the other families' configs
    come back unchanged.
    """
    if hasattr(config, "use_pallas"):
        return dataclasses.replace(config, use_pallas=False)
    return config
