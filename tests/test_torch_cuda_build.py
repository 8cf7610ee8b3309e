"""The port's CUDA build (``ops/cuda_build.py``) on the CPU, with no ``nvcc``:
the ctypes signatures against the source's ``extern "C"`` declarations,
the search for ``nvcc``, concurrent first builds, and where builds go."""

import ctypes
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.ops import cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_C_KINDS = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _extern_c(source: str):
    """{function: (return type, [parameter types])} from ``extern "C"``
    definitions, parameter names dropped."""
    out = {}
    for ret, name, params in re.findall(r'extern "C"\s+([\w\s*]+?)\s*(\w+)\s*\(([^)]*)\)',
                                        source):
        types = []
        for p in (q.strip() for q in params.split(",")):
            if p in ("", "void"):
                continue
            types.append(p if "*" in p else " ".join(p.split()[:-1]))
        out[name] = (ret.strip(), types)
    return out


def _ctype(c_type: str):
    return ctypes.c_void_p if "*" in c_type else _C_KINDS[c_type]


@pytest.mark.parametrize("name", sorted(cuda_build.SIGNATURES))
def test_argtypes_match_the_extern_c_declarations(name):
    decls = _extern_c((cuda_build.CSRC / f"{name}.cu").read_text())
    sigs = cuda_build.SIGNATURES[name]
    assert set(decls) == set(sigs)
    for fn, (ret, params) in decls.items():
        restype, argtypes = sigs[fn]
        assert len(argtypes) == len(params), fn
        assert argtypes == [_ctype(p) for p in params], fn
        # Every pointer and the stream go through as c_void_p, never a C int.
        assert all(a is ctypes.c_void_p for a, p in zip(argtypes, params) if "*" in p)
        assert restype is (ctypes.c_char_p if ret == "const char*" else _ctype(ret)), fn


def test_missing_nvcc_raises_naming_the_search(tmp_path):
    env = {"CUDA_HOME": str(tmp_path / "cuda"), "PATH": str(tmp_path / "bin")}
    with pytest.raises(cuda_build.NvccNotFound) as err:
        cuda_build.find_nvcc(env, default_bin=tmp_path / "default")
    msg = str(err.value)
    for place in ("$CUDA_HOME/bin", "$CUDA_PATH (unset)", "PATH", str(tmp_path / "default")):
        assert place in msg


def test_nvcc_search_order(tmp_path):
    def fake(d):
        d.mkdir(parents=True)
        (d / "nvcc").write_text("#!/bin/sh\n")
        (d / "nvcc").chmod(0o755)
        return str(d / "nvcc")

    home, path_bin, default = (fake(tmp_path / n / "bin") for n in ("home", "path", "dflt"))
    env = {"CUDA_HOME": str(tmp_path / "home"), "PATH": os.path.dirname(path_bin)}
    assert cuda_build.find_nvcc(env, default_bin=os.path.dirname(default)) == home
    env.pop("CUDA_HOME")
    assert cuda_build.find_nvcc(env, default_bin=os.path.dirname(default)) == path_bin
    env["PATH"] = str(tmp_path / "empty")
    assert cuda_build.find_nvcc(env, default_bin=os.path.dirname(default)) == default


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_BIN", tmp_path / "none")
    with pytest.raises(cuda_build.NvccNotFound, match="searched"):
        cuda_build.build("fused_ce", build_root=tmp_path / "kernels")
    assert not (tmp_path / "kernels").exists()


# A stand-in for nvcc: notes that it ran, writes its output in two halves with
# a pause between (a reader of a non-atomic build would see half a file), and
# prints a ptxas-style line.
_STUB = textwrap.dedent("""\
    #!/bin/sh
    out=""
    prev=""
    for a in "$@"; do
      if [ "$prev" = "-o" ]; then out="$a"; fi
      prev="$a"
    done
    echo "$$" >> "$STUB_RUNS"
    printf 'first-half-' > "$out"
    sleep 0.5
    printf 'second-half' >> "$out"
    echo "ptxas info    : Used 12 registers" >&2
    """)

# One build process: load cuda_build.py alone (stdlib only), wait for the
# other one to start, then build.
_BUILD_PROC = textwrap.dedent("""\
    import importlib.util, os, sys, time
    path, stub, root, me, other = sys.argv[1:]
    spec = importlib.util.spec_from_file_location("cuda_build", path)
    cb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cb)
    open(me, "w").close()
    deadline = time.time() + 30
    while not os.path.exists(other):
        assert time.time() < deadline, "the other build process never started"
        time.sleep(0.01)
    lib = cb.build("fused_ce", nvcc=stub, build_root=root)
    print(lib)
    """)


def _stub(tmp_path):
    stub = tmp_path / "nvcc_stub.sh"
    stub.write_text(_STUB)
    stub.chmod(0o755)
    return stub


def test_concurrent_first_builds_make_one_whole_library(tmp_path):
    stub, root, runs = _stub(tmp_path), tmp_path / "kernels", tmp_path / "runs.txt"
    env = dict(os.environ, STUB_RUNS=str(runs))
    ready = [tmp_path / "ready0", tmp_path / "ready1"]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_PROC, cuda_build.__file__, str(stub), str(root),
         str(ready[i]), str(ready[1 - i])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for i in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    lib = cuda_build.library_path("fused_ce", root)
    assert {o[0].strip() for o in outs} == {str(lib)}
    assert lib.read_text() == "first-half-second-half"
    assert len(runs.read_text().split()) == 1  # one process compiled
    report = cuda_build.report_path("fused_ce", root)
    assert "Used 12 registers" in report.read_text()
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        ["build.lock", lib.name, report.name])  # no temporary file left


def test_built_library_is_reused_and_a_failed_build_leaves_none(tmp_path, monkeypatch):
    stub, root, runs = _stub(tmp_path), tmp_path / "kernels", tmp_path / "runs.txt"
    monkeypatch.setenv("STUB_RUNS", str(runs))
    lib = cuda_build.build("fused_ce", nvcc=str(stub), build_root=root)
    assert cuda_build.build("fused_ce", nvcc=str(stub), build_root=root) == lib
    assert len(runs.read_text().split()) == 1
    shutil.rmtree(root)
    bad = tmp_path / "nvcc_fails.sh"
    bad.write_text("#!/bin/sh\necho 'error: no' >&2\nexit 3\n")
    bad.chmod(0o755)
    with pytest.raises(cuda_build.BuildError, match="error: no"):
        cuda_build.build("fused_ce", nvcc=str(bad), build_root=root)
    assert not lib.exists() and not list(lib.parent.glob("*.tmp"))


def test_build_flags_target_sm90a_without_fast_math():
    flags = " ".join(cuda_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-Xptxas -v" in flags and "fast_math" not in flags


def test_build_directory_is_ignored_by_git(tmp_path):
    """The library's path, relative to the repository, is one that the
    repository's .gitignore ignores (checked in a scratch git repository
    that holds only that .gitignore)."""
    if shutil.which("git") is None:
        pytest.fail("git is needed to read .gitignore's rules")
    rel = os.path.relpath(cuda_build.library_path("fused_ce"), REPO)
    assert not rel.startswith("..")
    shutil.copy(os.path.join(REPO, ".gitignore"), tmp_path / ".gitignore")
    subprocess.run(["git", "init", "-q", str(tmp_path)], check=True)
    for path in (rel, os.path.relpath(cuda_build.report_path("fused_ce"), REPO)):
        proc = subprocess.run(["git", "-C", str(tmp_path), "check-ignore", "-q", path])
        assert proc.returncode == 0, f"{path} is not ignored"


def test_cuda_path_imports_no_triton():
    """The wrappers reach the CUDA build and never the Triton module."""
    import ast

    for mod in ("fused_loss.py", "cuda_build.py"):
        tree = ast.parse((cuda_build.CSRC.parent / "ops" / mod).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [f"{n.module}" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        names += [a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                  for a in n.names]
        assert not [n for n in names if n and "triton" in n], mod
