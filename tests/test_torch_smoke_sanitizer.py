"""chip_smoke's sanitizer phase (3e) on a stand-in compute-sanitizer that
prints what the real one prints: the verdicts need no card."""
import json
import os
import stat

import pytest

import chip_smoke as c

SUMMARY = "========= ERROR SUMMARY: {} errors\n"
INPUTS = "inputs on the card\n"
DONE = f"sanitized {c.SANITIZED_RUNS} instantiations\n"
# the tool failing on torch's first copy to the card, before any kernel
API = ("========= Program hit cudaErrorUnknown (error 999) due to \"unknown "
       "error\" on CUDA API call to cudaMemcpyAsync.\n"
       "=========     Host Frame: at::_ops::to_dtype_layout::call in "
       "libtorch_cpu.so\n")
READ = ("========= Invalid __global__ read of size 8 bytes\n"
        "=========     at extend_kernel<1>+0x1a0\n")


@pytest.fixture
def tool(tmp_path, monkeypatch):
    path = tmp_path / "compute-sanitizer"
    path.write_text('#!/bin/sh\ncat "$STAND_IN_OUT"\nexit "$STAND_IN_RC"\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(c, "_sanitizer", lambda: (str(path), [str(path)]))

    def run(out, rc=0):
        (tmp_path / "out.txt").write_text(out)
        monkeypatch.setenv("STAND_IN_OUT", str(tmp_path / "out.txt"))
        monkeypatch.setenv("STAND_IN_RC", str(rc))
        return c.phase_sanitizer()
    return run


@pytest.mark.parametrize("out,rc,checked", [
    (INPUTS + DONE + SUMMARY.format(0), 0, True),
    # the tool failed before the inputs reached the card: nothing checked
    (API + SUMMARY.format(3), 1, False),
    ("no output at all\n", 1, False),
])
def test_verdict_without_a_kernel_error(tool, capsys, out, rc, checked):
    res = tool(out, rc)
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith("[3e sanitizer] ")
    assert json.loads(line.split(" ", 2)[2]) == res
    for kind in ("memcheck", "initcheck"):
        assert res[kind]["checked_all"] is checked
        assert ("did_not_check" in res[kind]) is not checked
    if out.startswith(API):
        assert res["memcheck"]["errors"] == 3
        assert "cudaErrorUnknown" in res["memcheck"]["did_not_check"][0]


@pytest.mark.parametrize("out", [
    INPUTS + READ + SUMMARY.format(1),           # a kernel of ours
    INPUTS + SUMMARY.format(0),                  # the child failed
])
def test_error_after_the_inputs_fails(tool, out):
    with pytest.raises(AssertionError, match="compute-sanitizer memcheck"):
        tool(out, 1)


def test_missing_tool_is_printed_not_passed(monkeypatch, capsys):
    monkeypatch.setattr(c, "_sanitizer",
                        lambda: (None, ["PATH", "/cuda/bin/x"]))
    assert c.phase_sanitizer() == {"found": False,
                                   "searched": ["PATH", "/cuda/bin/x"]}
    assert (capsys.readouterr().out
            == "[sanitizer] not found: PATH, /cuda/bin/x\n")


def test_search_order(monkeypatch, tmp_path):
    from tpubwa_torch.device import _build
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    found, searched = c._sanitizer()
    cuda = str(tmp_path / "cuda")
    assert found is None and searched == [
        "PATH", os.path.join(cuda, "bin", "compute-sanitizer"),
        os.path.join(cuda, "compute-sanitizer", "compute-sanitizer")]
    second = tmp_path / "cuda" / "compute-sanitizer" / "compute-sanitizer"
    second.parent.mkdir(parents=True)
    second.write_text("#!/bin/sh\n")
    second.chmod(0o755)
    assert c._sanitizer()[0] == str(second)
