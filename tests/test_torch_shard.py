"""tpubwa_torch `mem --shard I/N` (dist/records.py, dist/sharding.py):
the shards cover each file exactly, the merged shards' SAM equals the
port's unsharded run and tpubwa's merged `--shard` output, SE and PE
(with -I), from a plain and a gz FASTQ, and the record sidecar the port
writes is tpubwa's byte for byte.  Tolerance 0."""
import gzip
import io
import os
import shutil

import numpy as np
import pytest

from tpubwa.cli import main_mem as tpubwa_main_mem
from tpubwa.dist import records as jrecords
from tpubwa.dist import sharding as jsharding
from tpubwa_torch.cli import main_index, main_mem, main_merge
from tpubwa_torch.dist.records import (count_records, ensure_sidecar,
                                       shard_readers)
from tpubwa_torch.dist.sharding import (byte_range_shards,
                                        fastq_shard_reader,
                                        merge_shard_files, plan_shards)
from simread import simulate_pairs, simulate_reads, write_fastq


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(55)
    d = tmp_path_factory.mktemp("tshard")
    # three exact copies of a 500-base unit: reads there have tied
    # hits, which mark_primary breaks by the read's global index (and
    # sam_pe by the pair's), so a shard must count from its first record
    unit = rng.integers(0, 4, 500).astype(np.uint8)
    codes = np.concatenate([
        rng.integers(0, 4, 6000).astype(np.uint8), unit,
        rng.integers(0, 4, 3000).astype(np.uint8), unit,
        rng.integers(0, 4, 3000).astype(np.uint8), unit,
        rng.integers(0, 4, 2000).astype(np.uint8)])
    fa = d / "ref.fa"
    fa.write_text(">chrD\n" + "".join("ACGT"[c] for c in codes) + "\n")
    assert main_index([str(fa)]) == 0
    reads = simulate_reads(codes, 60, 100, rng, snp_rate=0.01)
    fq = str(d / "se.fq")
    write_fastq(fq, reads)
    with open(fq, "rb") as src, gzip.open(fq + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    pairs = simulate_pairs(codes, 40, 100, rng)
    fq1, fq2 = str(d / "r1.fq"), str(d / "r2.fq")
    write_fastq(fq1, [(n, s1) for n, s1, s2, *_ in pairs])
    write_fastq(fq2, [(n, s2) for n, s1, s2, *_ in pairs])
    return d, str(fa), fq, fq1, fq2


def _body(text):
    return [l for l in text.splitlines() if not l.startswith("@")]


def _mem(fn, prefix, files, flags=None):
    out = io.StringIO()
    assert fn(["--device", "cpu"] + (flags or []) + [prefix] + files,
              out=out) == 0
    return out.getvalue()


def _merged(fn, tmp_path, tag, prefix, files, n, flags=None):
    """Body of `merge` over the n shards' SAM files of ``fn``'s mem."""
    paths = []
    for i in range(n):
        p = tmp_path / f"{tag}{i}.sam"
        p.write_text(_mem(fn, prefix, files,
                          (flags or []) + ["--shard", f"{i}/{n}"]))
        paths.append(str(p))
    out = tmp_path / f"{tag}.sam"
    assert main_merge(["-o", str(out)] + paths) == 0
    return _body(out.read_text())


def test_byte_range_shards_cover_exactly(setup):
    d, prefix, fq, fq1, fq2 = setup
    names_all = [r.name for r in fastq_shard_reader(
        fq, 0, os.path.getsize(fq))]
    assert len(names_all) == 60
    for n in (1, 2, 3, 5):
        ranges = byte_range_shards(fq, n)
        assert ranges == jsharding.byte_range_shards(fq, n)
        got = []
        for lo, hi in ranges:
            got.extend(r.name for r in fastq_shard_reader(fq, lo, hi))
        assert got == names_all, n
    # two processes of two shards each own shards 0, 2 and 1, 3
    assert [s[0] for s in plan_shards(fq, 1, 2, 2)] == [1, 3]
    assert plan_shards(fq, 1, 2, 2) == jsharding.plan_shards(fq, 1, 2, 2)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_record_shards_cover_exactly(setup, gz):
    d, prefix, fq, fq1, fq2 = setup
    path = fq + ".gz" if gz else fq
    assert count_records(path) == 60
    names_all = [r.name for r in fastq_shard_reader(
        fq, 0, os.path.getsize(fq))]
    for ns in (1, 2, 4, 7):
        got = []
        for i in range(ns):
            (r,) = shard_readers([path], i, ns)
            assert r.global_offset == 60 * i // ns
            got.extend(x.name for x in r)
            r.close()
        assert got == names_all, ns
    # a pair of files: both mates' shards start at the same record
    for i in range(3):
        r1, r2 = shard_readers([fq1, fq2], i, 3)
        assert r1.global_offset == r2.global_offset == 2 * (40 * i // 3)
        assert [x.name for x in r1] == [x.name for x in r2]
    with pytest.raises(ValueError):
        shard_readers([fq], 3, 3)


def test_sidecar_is_tpubwa_s(setup):
    """One FASTQ aligned by both packages shares one sidecar: the
    port's bytes equal tpubwa's, and each package takes the other's."""
    d, prefix, fq, fq1, fq2 = setup
    path = str(d / "side.fq")
    shutil.copy(fq, path)
    side = path + ".tpubwa.fai"
    port_sc = ensure_sidecar(path)
    with open(side, "rb") as fh:
        port_bytes = fh.read()
    os.remove(side)
    jax_sc = jrecords.ensure_sidecar(path)
    with open(side, "rb") as fh:
        assert fh.read() == port_bytes
    assert port_sc == jax_sc
    mtime = os.stat(side).st_mtime_ns
    assert ensure_sidecar(path) == jax_sc
    assert os.stat(side).st_mtime_ns == mtime   # read, not rebuilt


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_sharded_se_equals_unsharded_and_tpubwa(setup, tmp_path, gz):
    d, prefix, fq, fq1, fq2 = setup
    full = _body(_mem(main_mem, prefix, [fq]))
    reads = [fq + ".gz" if gz else fq]
    merged = _merged(main_mem, tmp_path, "port", prefix, reads, 3)
    assert len(merged) >= 60 and merged == full
    if not gz:
        assert _merged(tpubwa_main_mem, tmp_path, "jax", prefix, reads,
                       3) == merged


def test_sharded_pe_with_fixed_insert(setup, tmp_path):
    """PE shards are deterministic when -I pins the insert distribution
    (without it, pestat is per batch, as in stock bwa)."""
    d, prefix, fq, fq1, fq2 = setup
    flags = ["-I", "350,30"]
    full = _body(_mem(main_mem, prefix, [fq1, fq2], flags))
    merged = _merged(main_mem, tmp_path, "port", prefix, [fq1, fq2], 2,
                     flags)
    assert len(merged) >= 80 and merged == full
    assert _merged(tpubwa_main_mem, tmp_path, "jax", prefix, [fq1, fq2],
                   2, flags) == merged


def test_merge_shard_files(setup, tmp_path):
    """The library merge keeps one header and the bodies in shard
    order, as the `merge` command does."""
    d, prefix, fq, fq1, fq2 = setup
    parts = []
    for i in range(2):
        p = tmp_path / f"m{i}.sam"
        p.write_text(f"@HD\tVN:1.6\n@CO\tshard {i}\nr{i}a\nr{i}b\n")
        parts.append(str(p))
    out = tmp_path / "m.sam"
    merge_shard_files(parts, str(out), header="@HD\tVN:1.6\n")
    assert out.read_text() == "@HD\tVN:1.6\nr0a\nr0b\nr1a\nr1b\n"
