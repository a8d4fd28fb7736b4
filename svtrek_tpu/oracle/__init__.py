"""Scalar oracle: an exact, slow re-statement of the reference semantics.

The reference binary cannot be built in this environment (its htslib
submodule is empty and no system htslib exists), so this package is the
executable specification the device kernels are property-tested against.
Every function documents the reference file:line it models.  This is a
fresh implementation of the *semantics*, not a translation of the C code.
"""
from .refine import (
    consensus_pos,
    consensus_lengths,
    extract_candidates,
    refine_task,
    lower_bound,
    upper_bound,
    window_scan,
)

__all__ = [
    "consensus_pos",
    "consensus_lengths",
    "extract_candidates",
    "refine_task",
    "lower_bound",
    "upper_bound",
    "window_scan",
]
