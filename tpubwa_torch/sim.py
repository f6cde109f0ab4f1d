"""wgsim-style genome/read simulation (bench + test corpus).

Upstream lineage: lh3/wgsim — the simulator historically used to
validate bwa-mem itself (SURVEY.md §4).  Two additions beyond wgsim:

1. ``repeat_genome_codes`` builds a synthetic genome with REAL repeat
   structure — interspersed SINE/LINE-like families, satellite tandem
   arrays, segmental duplications — because uniform-random text has
   essentially no high-occ seeds, so ``max_occ`` subsampling, deep
   backward stacks, XA emission and MAPQ=0 paths (the expensive parts
   of real data) go unexercised at benchmark scale (round-2 verdict,
   missing #3).  Human-calibrated defaults: ~10% SINE, ~14% LINE,
   ~3% satellite, ~2% segmental duplication (GRCh38 is ~45-50%
   repeat-derived overall; this model keeps the classes that stress an
   aligner).

2. ``make_bench_bnt`` wraps the codes into a multi-contig BntSeq with
   N-gap records and an optional diverged ALT contig (is_alt=1), so
   coordinate folding, rid assignment and ALT-aware primary selection
   all run at benchmark scale.

Everything is seeded-rng deterministic.
"""
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["repeat_genome_codes", "make_bench_bnt", "simulate_pe",
           "simulate_se"]


def _scatter_copies(g: np.ndarray, unit: np.ndarray, m: int,
                    div, rng, lens=None) -> None:
    """Insert ``m`` copies of ``unit`` at random offsets, each copy
    mutated at per-copy divergence ``div`` (scalar or (lo, hi)).
    ``lens`` optionally truncates each copy (5'-truncated LINEs)."""
    if m <= 0:
        return
    L = len(unit)
    n = len(g)
    pos = rng.integers(0, n - L, m)
    if lens is None:
        lens = np.full(m, L)
    if np.isscalar(div):
        dv = np.full(m, float(div))
    else:
        # young-skewed: repeat expansions are bursts, so copy
        # divergence piles up near the young end (quadratic ramp)
        dv = div[0] + (div[1] - div[0]) * rng.random(m) ** 2
    # vectorized in chunks: copies laid out as an (chunk, L) block,
    # mutated wholesale, then scattered with a flat fancy index
    CH = max(1, min(m, 1 << 18))
    ar = np.arange(L)
    for s in range(0, m, CH):
        e = min(s + CH, m)
        blk = np.broadcast_to(unit, (e - s, L)).copy()
        mut = rng.random((e - s, L)) < dv[s:e, None]
        nm = int(mut.sum())
        if nm:
            blk[mut] = (blk[mut] + rng.integers(1, 4, nm)) % 4
        keep = ar[None, :] < lens[s:e, None]
        idx = (pos[s:e, None] + ar)[keep]
        g[idx] = blk[keep]


def repeat_genome_codes(n: int, rng,
                        sine_frac: float = 0.10,
                        line_frac: float = 0.14,
                        sat_frac: float = 0.03,
                        segdup_frac: float = 0.02) -> np.ndarray:
    """Synthetic genome (uint8 codes 0..3) with repeat structure."""
    g = rng.integers(0, 4, n, dtype=np.int64).astype(np.uint8) \
        if n < (1 << 20) else _rand_codes(n, rng)
    # SINE family: 300 bp consensus (Alu-like) with SUBFAMILY
    # structure — real Alu subfamilies (AluY etc.) hold thousands of
    # near-identical copies, which is what saturates max_occ and
    # forces seed subsampling.  4 subfamilies at 2-8% from the family
    # consensus; copies at 0.3-10% from their subfamily.
    sine = rng.integers(0, 4, 300).astype(np.uint8)
    m_sine = int(n * sine_frac / 300)
    for sf in range(4):
        cons = sine.copy()
        mut = rng.random(300) < rng.uniform(0.02, 0.08)
        nm = int(mut.sum())
        cons[mut] = (cons[mut] + rng.integers(1, 4, nm)) % 4
        _scatter_copies(g, cons, m_sine // 4, (0.003, 0.10), rng)
    # LINE family: 5 kb consensus, most copies 5' truncated (L1-like)
    line = rng.integers(0, 4, 5000).astype(np.uint8)
    m_line = int(n * line_frac / 2500)      # mean copy len ~2.5 kb
    if m_line:
        lens = rng.integers(300, 5001, m_line)
        _scatter_copies(g, line, m_line, (0.01, 0.20), rng, lens=lens)
    # satellite: 171 bp motif tiled in tandem runs (alpha-like)
    sat = rng.integers(0, 4, 171).astype(np.uint8)
    sat_runs = int(n * sat_frac / (171 * 60))
    for _ in range(sat_runs):
        reps = int(rng.integers(20, 120))
        arr = np.tile(sat, reps)
        mut = rng.random(len(arr)) < 0.02
        nm = int(mut.sum())
        arr[mut] = (arr[mut] + rng.integers(1, 4, nm)) % 4
        p = int(rng.integers(0, n - len(arr)))
        g[p:p + len(arr)] = arr
    # segmental duplications: 50-300 kb blocks copied at 1-2% divergence
    total_sd = int(n * segdup_frac)
    placed = 0
    while placed < total_sd and n > 1_000_000:
        ln = int(rng.integers(50_000, 300_000))
        src = int(rng.integers(0, n - ln))
        dst = int(rng.integers(0, n - ln))
        blk = g[src:src + ln].copy()
        mut = rng.random(ln) < rng.uniform(0.01, 0.02)
        nm = int(mut.sum())
        blk[mut] = (blk[mut] + rng.integers(1, 4, nm)) % 4
        g[dst:dst + ln] = blk
        placed += ln
    return g


def _rand_codes(n: int, rng) -> np.ndarray:
    """Memory-lean uniform codes for multi-Gbp n (avoids the int64
    intermediate of rng.integers at 8 bytes/base)."""
    out = np.empty(n, np.uint8)
    CH = 1 << 26
    for s in range(0, n, CH):
        e = min(s + CH, n)
        out[s:e] = rng.integers(0, 4, e - s, dtype=np.uint8)
    return out


def make_bench_bnt(n_bp: int, rng, realistic: bool = True,
                   contig_bp: int = 128_000_000,
                   alt_frac: float = 0.004, n_gaps_per_contig: int = 2):
    """BntSeq for benchmarking: multi-contig, optional repeat
    structure, N-gap .amb records, and one diverged ALT contig."""
    from .index.build import Amb, BntSeq, SeqAnn
    codes = (repeat_genome_codes(n_bp, rng) if realistic
             else _rand_codes(n_bp, rng))
    anns: List[SeqAnn] = []
    ambs: List[Amb] = []
    off = 0
    cid = 0
    while off < n_bp:
        ln = min(contig_bp, n_bp - off)
        anns.append(SeqAnn(name=f"chr{cid + 1}", anno="", offset=off,
                           length=ln, n_ambs=0))
        off += ln
        cid += 1
    if realistic:
        for a in anns:
            na = 0
            for _ in range(n_gaps_per_contig):
                gl = int(rng.integers(100, 10_000))
                gp = a.offset + int(rng.integers(0, max(1, a.length
                                                        - gl)))
                # codes stay random under the gap (bwa's lrand48 fill
                # behavior); the .amb record marks it
                ambs.append(Amb(offset=gp, length=gl))
                na += 1
            a.n_ambs = na
        ambs.sort(key=lambda m: m.offset)
    bnt = BntSeq(l_pac=n_bp, anns=anns, ambs=ambs, seed=11,
                 codes=codes)
    if realistic and alt_frac > 0 and n_bp >= 1_000_000:
        # ALT contig: a diverged copy of a chr1 slice appended at the
        # end (multi-contig + is_alt primary-selection paths)
        ln = int(n_bp * alt_frac)
        src = int(rng.integers(0, anns[0].length - ln))
        blk = codes[src:src + ln].copy()
        mut = rng.random(ln) < 0.01
        nm = int(mut.sum())
        blk[mut] = (blk[mut] + rng.integers(1, 4, nm)) % 4
        anns[-1].length -= ln               # carve space: keep l_pac
        alt = SeqAnn(name="chr1_alt", anno="", is_alt=1,
                     offset=n_bp - ln, length=ln, n_ambs=0)
        anns.append(alt)
        codes[n_bp - ln:] = blk
        # The N-gap ambs above were placed against the PRE-carve contig
        # lengths; any record now inside (or straddling into) the ALT
        # slot would leave .amb/.ann metadata inconsistent with contig
        # boundaries (ADVICE r3).  Reassign whole records to chr1_alt,
        # truncate straddlers at the boundary; the carved contig's
        # n_ambs shrinks accordingly.  codes are untouched, so cached
        # bench corpora built before this fix stay byte-identical
        # unless a gap actually hit the last alt_frac of the genome.
        carved = anns[-2]
        for m in ambs:
            if m.offset >= alt.offset:      # wholly inside the ALT slot
                carved.n_ambs -= 1
                alt.n_ambs += 1
            elif m.offset + m.length > alt.offset:   # straddler
                m.length = alt.offset - m.offset
        bnt = BntSeq(l_pac=n_bp, anns=anns, ambs=ambs, seed=11,
                     codes=codes)
    return bnt


def _mutate_read(r: np.ndarray, rng, snp: float, indel: float,
                 read_len: int, frag: np.ndarray, start: int):
    """SNPs + small indels (wgsim-style), length preserved by
    consuming extra template bases from ``frag`` after ``start``."""
    mut = rng.random(read_len) < snp
    nm = int(mut.sum())
    if nm:
        r[mut] = (r[mut] + rng.integers(1, 4, nm)) % 4
    if indel <= 0 or rng.random() >= indel * read_len:
        return r
    p = int(rng.integers(5, read_len - 10))
    ln = int(rng.integers(1, 5))
    if rng.random() < 0.5:                  # deletion in read
        tail = frag[start + read_len:start + read_len + ln]
        if len(tail) == ln:
            r = np.concatenate([r[:p], r[p + ln:], tail])
    else:                                   # insertion in read
        ins = rng.integers(0, 4, ln).astype(np.uint8)
        r = np.concatenate([r[:p], ins, r[p:read_len - ln]])
    return r[:read_len]


def simulate_pe(bnt_or_codes, n_pairs: int, read_len: int, rng,
                snp: float = 0.008, indel: float = 0.0004,
                qual: bool = True, insert_mean: int = 350,
                insert_std: int = 30, prefix: str = "p") -> list:
    """FR pairs sampled from the genome with SNPs, indels and phred
    qualities.  Returns interleaved Read objects (R1, R2, ...).
    Contig boundaries are respected when a BntSeq is passed."""
    from .io.fastq import Read
    if hasattr(bnt_or_codes, "codes"):
        codes = bnt_or_codes.codes
        anns = [a for a in bnt_or_codes.anns if not a.is_alt]
    else:
        codes = bnt_or_codes
        anns = None
    L = len(codes)
    out = []
    isizes = np.maximum(rng.normal(insert_mean, insert_std,
                                   n_pairs).astype(int),
                        read_len * 2 + 12)
    if anns is not None:
        # sample contigs by length, positions within the contig
        lens = np.array([a.length for a in anns], np.float64)
        cidx = rng.choice(len(anns), n_pairs, p=lens / lens.sum())
    for i in range(n_pairs):
        isize = int(isizes[i])
        if anns is not None:
            a = anns[int(cidx[i])]
            lo, hi = a.offset, a.offset + a.length - isize - 8
            if hi <= lo:
                lo, hi = 0, L - isize - 8
        else:
            lo, hi = 0, L - isize - 8
        pos = int(rng.integers(lo, hi))
        frag = codes[pos:pos + isize + 8]
        r1 = _mutate_read(frag[:read_len].copy(), rng, snp, indel,
                          read_len, frag, 0)
        r2t = _mutate_read(frag[isize - read_len:isize].copy(), rng,
                           snp, indel, read_len, frag,
                           isize - read_len)
        r2 = (3 - r2t)[::-1].copy()
        q1 = q2 = None
        if qual:
            q1 = (rng.integers(20, 41, read_len) + 33).astype(np.uint8) \
                .tobytes().decode()
            q2 = (rng.integers(20, 41, read_len) + 33).astype(np.uint8) \
                .tobytes().decode()
        out.append(Read(name=f"{prefix}{i}", seq=r1, qual=q1))
        out.append(Read(name=f"{prefix}{i}", seq=r2, qual=q2))
    return out


def bench_index(genome_mb: int, realistic: bool = False,
                seed: int = 3, cache_dir: Optional[str] = None,
                log=None):
    """Build-or-load a cached benchmark FMIndex.  Cache key encodes
    scale and corpus style (idx64m = uniform, idx64mr = realistic).
    The 3.1 Gbp realistic build takes ~80 min / ~105 GB peak RAM; it
    is built once per machine and reused by bench.py/profile_scale."""
    import os
    import time
    from .index import FMIndex
    if log is None:
        def log(m):
            pass
    if cache_dir is None:
        cache_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "build", "bench-cache")
    os.makedirs(cache_dir, exist_ok=True)
    prefix = os.path.join(
        cache_dir, f"idx{genome_mb}m{'r' if realistic else ''}")
    if os.path.exists(os.path.join(prefix + ".tpubwa.shm", "meta.json")):
        # mmap cache: O(seconds) even at 3.1 Gbp (the npz path decodes
        # + unpacks ~8 GB in-process, ~10 min at that scale)
        t0 = time.time()
        fmi = FMIndex.load_shm(prefix)
        log(f"[bench] shm cache hit {prefix}: {fmi.seq_len} doubled,"
            f" {time.time() - t0:.1f}s")
        return fmi
    if os.path.exists(prefix + ".tpubwa.npz"):
        t0 = time.time()
        fmi = FMIndex.load(prefix)
        log(f"[bench] index cache hit {prefix}: {fmi.seq_len} doubled,"
            f" {time.time() - t0:.1f}s")
        if genome_mb > 256:  # one-time upgrade to the mmap cache
            try:
                fmi.save_shm(prefix)
            except OSError:
                pass
        return fmi
    rng = np.random.default_rng(seed)
    t0 = time.time()
    bnt = make_bench_bnt(genome_mb * 1_000_000, rng,
                         realistic=realistic)
    log(f"[bench] genome generated: {genome_mb} Mbp "
        f"({'realistic' if realistic else 'uniform'}) in "
        f"{time.time() - t0:.0f}s")
    t0 = time.time()
    fmi = FMIndex.build(bnt)
    log(f"[bench] index built in {time.time() - t0:.0f}s (cached at "
        f"{prefix})")
    try:
        fmi.save(prefix)
    except OSError:
        pass
    return fmi


def simulate_se(bnt_or_codes, n_reads: int, read_len: int, rng,
                snp: float = 0.008, indel: float = 0.0004,
                qual: bool = True, prefix: str = "s") -> list:
    """Single-end variant of simulate_pe."""
    pairs = simulate_pe(bnt_or_codes, (n_reads + 1) // 2, read_len,
                        rng, snp=snp, indel=indel, qual=qual,
                        prefix=prefix)
    return pairs[:n_reads]
