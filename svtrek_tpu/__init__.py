"""svtrek_tpu — an accelerated structural-variant audit + discovery engine.

A from-scratch framework with the capabilities of the reference SVTrek
(single-binary C tool; see SURVEY.md): `audt` mode refines imprecise SV
breakpoints in a VCF against long-read BAM evidence; `disc` mode discovers
SVs from pangenome graph alignments (GFA+GAF+FASTQ).

Architecture (batched device kernels, not a port):
- io/       host-side parsers & writers (BGZF/BAM/BAI/VCF/GFA/GAF/FASTQ)
- oracle/   exact scalar semantics (executable spec for parity testing)
- ops/      batched JAX/XLA kernels (CIGAR walk, consensus, POA)
- pipeline/ host→device batching drivers for both modes
- parallel/ jax.sharding mesh + multi-chip step
- native/   C fast paths (BGZF/BAM region fetch) via ctypes
"""
# NOTE: all kernels are int32-only by design — the reference's uint64
# cluster totals (refinement.c:59) are reproduced exactly with a
# wrap-safe int32 delta-sum formulation (ops/consensus.py), so 64-bit
# integers are never needed and jax_enable_x64 stays off.

__version__ = "0.1.0"
