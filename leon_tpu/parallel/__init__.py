"""Multi-chip / multi-host parallel layer.

The reference is single-process multicore (SURVEY.md §2.4: GATB Dispatcher
threads + disk partitions; no MPI/NCCL anywhere). The scaling story here
replaces that with a flat 1-D device mesh:

- data parallel: read batches sharded over mesh axis "d" (the analog of
  Dispatcher blocks, /root/reference/README.md:47-48 -nb-cores)
- k-mer count partials: device-local sort/count, host exact merge
  (multi-host: process allgather over DCN — the analog of DSK's disk
  partition exchange)
- Bloom build: solid-kmer list sharded over devices, per-device bit
  scatter, all-to-all word-range OR, replicated bitset in device memory
- encode: embarrassingly parallel over lanes with the replicated bitset
"""
