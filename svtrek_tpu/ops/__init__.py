"""Device compute kernels (JAX/XLA)."""
from .consensus import consensus_pos_batch, consensus_lengths_batch
from .cigar import extract_read_candidates, group_candidates_by_window
from .audit_step import audit_refine_step, AuditBatch
from .window_scan import window_scan_batch

__all__ = [
    "consensus_pos_batch",
    "consensus_lengths_batch",
    "extract_read_candidates",
    "group_candidates_by_window",
    "audit_refine_step",
    "AuditBatch",
    "window_scan_batch",
]
