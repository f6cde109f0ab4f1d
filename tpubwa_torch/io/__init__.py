from .fastq import FastqReader, read_fastq_batch, Read

__all__ = ["FastqReader", "read_fastq_batch", "Read"]
