"""The port's native host kernels (``utils/native.py``) against the JAX
package's: the same ``csrc/cil_host.cpp`` built with the same flags, so on
one machine the port's C++ herding equals JAX's C++ herding and the port's
numpy herding equals JAX's numpy herding, index for index; the row gather
equals JAX's and numpy's; ``CIL_TPU_NO_NATIVE=1`` forces numpy; and the
build lands in its own ``build/host/<hash>/`` under an ``fcntl`` lock."""

import os
import textwrap
import threading

import numpy as np
import pytest

from a_pytorch_tutorial_to_class_incremental_learning_tpu.data import memory as jmemory
from a_pytorch_tutorial_to_class_incremental_learning_tpu.utils import native as jnative
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.data import memory as tmemory
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.telemetry import CompileWatch
from a_pytorch_tutorial_to_class_incremental_learning_tpu_torch.utils import native as tnative


def _features(case):
    rng = np.random.RandomState(7)
    if case == "random":
        return rng.randn(500, 64).astype(np.float32), 20
    # Every row twice: exact ties, which both paths break to the first index.
    base = rng.randn(250, 64).astype(np.float32)
    return np.concatenate([base, base]), 20


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert tnative.native_available(), "the port could not build csrc/cil_host.cpp"
    assert jnative.native_available(), "the JAX loader could not build csrc/cil_host.cpp"


@pytest.mark.parametrize("case", ["random", "duplicated"])
def test_herding_equals_jax_native_to_native_and_numpy_to_numpy(case):
    feats, nb = _features(case)
    port_native = tnative.herd_barycenter_native(feats, nb)
    jax_native = jnative.herd_barycenter_native(feats, nb)
    port_numpy = tmemory.herd_barycenter(feats, nb, allow_native=False)
    jax_numpy = jmemory.herd_barycenter(feats, nb, allow_native=False)
    assert port_native is not None and port_native.dtype == np.int64
    np.testing.assert_array_equal(port_native, jax_native)
    np.testing.assert_array_equal(port_numpy, jax_numpy)
    # The memory's default is the native path.
    np.testing.assert_array_equal(tmemory.herd_barycenter(feats, nb), port_native)
    assert len(set(port_native.tolist())) == nb
    if case == "duplicated":
        for order in (port_native, port_numpy):
            picked = order.tolist()
            # Of two equal rows the first is picked before its twin.
            for i in picked:
                if i >= 250:
                    assert i - 250 in picked[:picked.index(i)]


@pytest.mark.parametrize("prefer_native", [True, False])
def test_memory_equals_jax_memory(prefer_native):
    feats, _ = _features("random")
    rng = np.random.RandomState(3)
    x = rng.randint(0, 256, (500, 4, 4, 3)).astype(np.uint8)
    y = np.repeat(np.arange(10), 50).astype(np.int64)
    jmem = jmemory.RehearsalMemory(memory_size=60, prefer_native=prefer_native)
    tmem = tmemory.RehearsalMemory(memory_size=60, prefer_native=prefer_native)
    for mem in (jmem, tmem):
        mem.add(x[:250], y[:250], None, feats[:250])
        mem.add(x, y, None, feats)  # re-ranks the old classes, shrinks the quota
    for a, b in zip(jmem.get(), tmem.get()):
        np.testing.assert_array_equal(a, b)


def test_gather_rows_equals_jax_and_numpy():
    rng = np.random.RandomState(2)
    src = rng.randint(0, 256, (500, 32, 32, 3)).astype(np.uint8)
    idx = rng.randint(0, 500, 1024)
    got = tnative.gather_rows(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, jnative.gather_rows(src, idx))
    assert tnative.gather_u8_native(src, idx) is not None
    # Out of range: refused by the kernel, so the numpy path raises.
    assert tnative.gather_u8_native(src, np.array([500])) is None
    objs = np.asarray(["a", "b", "c"], object)  # not uint8: numpy's gather
    np.testing.assert_array_equal(tnative.gather_rows(objs, np.array([2, 0])), objs[[2, 0]])


def test_no_native_env_forces_numpy(monkeypatch):
    monkeypatch.setenv("CIL_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_load_attempted", False)
    assert tnative.load_native() is None and not tnative.native_available()
    feats, nb = _features("random")
    assert tnative.herd_barycenter_native(feats, nb) is None
    np.testing.assert_array_equal(tmemory.herd_barycenter(feats, nb),
                                  jmemory.herd_barycenter(feats, nb, allow_native=False))
    src = np.arange(24, dtype=np.uint8).reshape(6, 4)
    assert tnative.gather_u8_native(src, np.array([1])) is None
    np.testing.assert_array_equal(tnative.gather_rows(src, np.array([5, 0])), src[[5, 0]])


# A stand-in compiler: answers the version query the build hash asks, and
# otherwise records its run, then writes its output in two halves with a
# pause between, so an unlocked concurrent build would read (or replace) a
# half-written library.
_STUB = textwrap.dedent("""\
    #!/bin/sh
    if [ "$1" = "-dumpfullversion" ]; then echo 0.0-stub; exit 0; fi
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
    """)


def test_concurrent_builds_land_once_under_the_lock(tmp_path, monkeypatch):
    stub, root, runs = tmp_path / "cxx_stub.sh", tmp_path / "build" / "host", tmp_path / "runs"
    stub.write_text(_STUB)
    stub.chmod(0o755)
    monkeypatch.setenv("STUB_RUNS", str(runs))
    watch = CompileWatch.install()
    before = watch.snapshot()
    paths, errors = [], []

    def build():
        try:
            paths.append(tnative.build(cxx=str(stub), build_root=root))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and len(paths) == 2 and paths[0] == paths[1]
    lib = paths[0]
    assert lib == tnative.library_path(root, str(stub))
    assert lib.parent.parent == root and lib.name == "libcilhost.so"
    assert lib.read_text() == "first-half-second-half"
    assert len(runs.read_text().split()) == 1  # one compile
    assert sorted(os.listdir(lib.parent)) == ["build.lock", "libcilhost.so"]
    # One build and one library found built (the waiting thread's).
    delta = CompileWatch.delta(before, watch.snapshot())
    assert (delta["compiles"], delta["cache_hits"]) == (2, 1)
    # A source or flag edit builds elsewhere; nothing lands in csrc/.
    assert "csrc" not in lib.parts


def test_the_real_build_is_the_repository_library():
    lib = tnative.library_path()
    assert lib.exists() and lib.parts[-4:-2] == ("build", "host")
    assert tnative.load_native()._name == str(lib)
