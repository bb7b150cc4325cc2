"""leon_tpu — an accelerator-native, reference-free FASTA/FASTQ compressor.

A from-scratch JAX/XLA re-design of the Leon algorithm
(reference: GATB/leon, /root/reference/README.md:9-15 — probabilistic
de Bruijn graph in a Bloom filter, reads encoded as anchor + bifurcation
lists). See SURVEY.md for the structural analysis and FORMAT.md for the
container spec.

Package layout:
  ops/      device compute: k-mer extraction, counting, Bloom, graph walk
  models/   entropy-coding models (order-0 tables, rANS)
  codecs/   stream codecs: entropy framing, headers, qualities
  io/       banks (FASTA/FASTQ/gz parse+write) and the container format
  parallel/ multi-device sharding (mesh pipeline, multi-process runs)
  utils/    varints, bit packing, stats
"""

__version__ = "0.1.0"

from leon_tpu.config import LeonConfig  # noqa: F401
