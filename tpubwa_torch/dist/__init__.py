"""Sharding of a run's reads across processes (SURVEY.md §5.8).

``records`` shards FASTQ/FASTA inputs by record index (``mem --shard
I/N``), with a sidecar index of record offsets; ``sharding`` holds the
byte-range shards of a plain FASTQ and the merge of per-shard SAM files.
"""
