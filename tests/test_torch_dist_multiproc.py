"""tpubwa_torch `mem --dist` over processes (torch.distributed, gloo),
mirroring tests/test_dist_multihost.py: two real processes on the CPU,
a shard each, merged on rank 0, give the SAM of one process byte for
byte; a shard killed after its first journaled batch and resumed, then
merged, gives the clean two-process SAM; and the argument errors exit
2 as tpubwa's do."""
import io
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from tpubwa.cli import main_mem as tpubwa_main_mem
from tpubwa_torch.cli import main_index, main_mem, main_merge
from simread import simulate_reads, write_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(55)
    d = tmp_path_factory.mktemp("tmp_dist")
    codes = rng.integers(0, 4, 16000).astype(np.uint8)
    bases = "".join("ACGT"[c] for c in codes)
    fa = d / "ref.fa"
    fa.write_text(">h1\n" + "\n".join(
        bases[i:i + 70] for i in range(0, len(bases), 70)) + "\n")
    assert main_index([str(fa)]) == 0
    reads = simulate_reads(codes, 120, 100, rng, snp_rate=0.01,
                           indel_rate=0.002)
    fq = str(d / "r.fq")
    write_fastq(fq, reads)
    return d, str(fa), fq


def _env(port=None, rank=None, world=None):
    env = dict(os.environ,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    if port is not None:
        env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
    return env


def _launch(args, port, rank, world, cwd):
    return subprocess.Popen(
        [sys.executable, "-m", "tpubwa_torch", "mem", "--dist",
         "--device", "cpu"] + args,
        env=_env(port, rank, world), cwd=cwd, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)


def _wait(procs):
    """Each process's stderr; a process past the timeout is killed (a
    dead peer would hold the others at the barrier)."""
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=TIMEOUT)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return errs


def _body(path):
    with open(path) as fh:
        return [l for l in fh if not l.startswith("@")]


def test_two_process_dist_equals_single(setup):
    d, prefix, fq = setup
    ref = io.StringIO()
    assert main_mem(["--device", "cpu", prefix, fq], out=ref) == 0
    ref_body = [l + "\n" for l in ref.getvalue().splitlines()
                if not l.startswith("@")]
    out = str(d / "dist.sam")
    metrics = str(d / "m0.jsonl")
    port = _free_port()
    procs = [_launch((["--metrics", metrics] if i == 0 else [])
                     + ["-o", out, prefix, fq], port, i, 2, str(d))
             for i in range(2)]
    errs = _wait(procs)
    assert all(p.returncode == 0 for p in procs), errs
    assert _body(out) == ref_body
    s0 = _body(out + ".shard00000")
    s1 = _body(out + ".shard00001")
    assert len(s0) > 0 and len(s1) > 0
    assert s0 + s1 == ref_body
    with open(metrics) as fh:
        done = [json.loads(l) for l in fh
                if json.loads(l)["event"] == "dist_done"]
    assert len(done) == 1
    assert (done[0]["processes"], done[0]["reads"],
            done[0]["per_host"]) == (2, 120, [60, 60])


def test_kill_and_resume_reproduces_sam(setup):
    """Shard 1 of 2 is killed after its first journaled batch and rerun
    with its journal; the merge equals the clean two-process run."""
    d, prefix, fq = setup
    out_clean = str(d / "clean.sam")
    port = _free_port()
    procs = [_launch(["-K", "2000", "-o", out_clean, prefix, fq], port, i,
                     2, str(d)) for i in range(2)]
    errs = _wait(procs)
    assert all(p.returncode == 0 for p in procs), errs

    out_f = str(d / "fault.sam")

    def run_shard(i, kill_after=False):
        cmd = [sys.executable, "-m", "tpubwa_torch", "mem", "--device",
               "cpu", "-K", "2000", "--shard", f"{i}/2", "--journal",
               f"{out_f}.j{i}", "-o", f"{out_f}.shard{i:05d}", prefix, fq]
        p = subprocess.Popen(cmd, env=_env(), cwd=str(d),
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
        if kill_after:
            deadline = time.time() + TIMEOUT
            jp = f"{out_f}.j{i}"
            while time.time() < deadline:
                if os.path.exists(jp) and os.path.getsize(jp) > 0:
                    break
                if p.poll() is not None:
                    break
                time.sleep(0.02)
            if p.poll() is None:
                p.kill()
                p.wait()
                return None
            return p.returncode
        return p.wait(timeout=TIMEOUT)

    assert run_shard(0) == 0
    rc = run_shard(1, kill_after=True)
    if rc is None:  # it was killed mid-run: resume it
        assert run_shard(1) == 0
    else:
        assert rc == 0
    assert main_merge(["-o", out_f, out_f + ".shard00000",
                       out_f + ".shard00001"]) == 0
    assert _body(out_f) == _body(out_clean)


@pytest.mark.parametrize("extra", [["p", "r.fq"],
                                   ["--shard", "0/2", "-o", "x", "p",
                                    "r.fq"]], ids=["no-o", "shard"])
def test_dist_argument_errors_exit_2(extra, capsys):
    """Before any work (and before the device is resolved), as tpubwa's
    ap.error does, with its message."""
    for fn in (main_mem, tpubwa_main_mem):
        with pytest.raises(SystemExit) as e:
            fn(["--dist"] + extra)
        assert e.value.code == 2
    errors = [l.split(": error: ")[1] for l in
              capsys.readouterr().err.splitlines() if ": error: " in l]
    assert len(errors) == 2 and errors[0] == errors[1]
