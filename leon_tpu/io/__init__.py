"""I/O layer: sequence banks (FASTA/FASTQ/gz) and the .leon container.

Device-oriented re-design of the reference's L2 data plane ([R] gatb-core
bank/impl/* and tools/storage/impl/*; SURVEY.md §2.3): IBank iterators
become block-structured host parsers feeding fixed-shape device batches,
and the HDF5 Storage container becomes the flat sectioned format of
FORMAT.md (the oracle is decompressed-byte equality, never container
equality — /root/reference/scripts/simple_test.sh:62).
"""
