from .build import BntSeq, SeqAnn, Amb, LRand48, fasta2bnt, read_fasta
from .fmindex import FMIndex, OCC_INTERVAL, SA_INTV

__all__ = ["BntSeq", "SeqAnn", "Amb", "LRand48", "fasta2bnt", "read_fasta",
           "FMIndex", "OCC_INTERVAL", "SA_INTV"]
