"""The launch contract of ``slr_torch.kernels.build`` on the CPU.

``expect`` is held to its refusals on fake CUDA tensors (metadata only, no
card). ``bind``, ``launch`` and ``check_status`` run against a stand-in
library that g++ builds from a few lines of C: it types like a kernel
library, echoes the device index and stream a launch passes, and returns
the status it is given. No module of ``slr_torch/kernels`` other than
``build.py`` types an entry point or reads a stream.
"""

import ctypes
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from slr_torch import observability as obs
from slr_torch.kernels import build

STAND_IN = r"""
extern "C" {
const char* slr_cuda_error_string(int e) {
  return e == 700 ? "an illegal memory access was encountered" : "unknown error";
}
int slr_echo(int status, long long* seen, int device, void* stream) {
  seen[0] = device;
  seen[1] = (long long)stream;
  return status;
}
long long slr_size(int n) { return 3LL * n; }
}
"""
STREAM = 0x5EED
COUNTER = "launches.stand_in"


@pytest.fixture(scope="module")
def fake():
    """Fake tensors: (2, 3) float32 on cuda:0, the same on cuda:1, and a
    transposed (non-contiguous) one on cuda:0."""
    with FakeTensorMode():
        return (torch.empty((2, 3), device="cuda:0"), torch.empty((2, 3), device="cuda:1"),
                torch.empty((3, 2), device="cuda:0").t())


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """The stand-in library bound as a kernel library is, on a fake stream."""
    src = tmp_path / "stand_in.cpp"
    src.write_text(STAND_IN)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "build_library", lambda name: build.build_host_library(src))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: SimpleNamespace(cuda_stream=STREAM))
    i64p = ctypes.POINTER(ctypes.c_longlong)
    return build.bind("stand_in", {
        "slr_echo": (ctypes.c_int, [ctypes.c_int, i64p, ctypes.c_int, ctypes.c_void_p]),
        "slr_size": (ctypes.c_longlong, [ctypes.c_int]),
    })


def _count():
    return obs.snapshot().counts.get(COUNTER, 0)


def test_expect_accepts_matching_tensors(fake):
    a, _, _ = fake
    build.expect("K", (a, (2, 3), torch.float32), (a, (2, 3), torch.float32))


@pytest.mark.parametrize("case,match", [
    ("cpu", "needs CUDA tensors"),
    ("dtype", "do not match"),
    ("shape", "do not match"),
    ("non_contiguous", "contiguous: False"),
    ("two_devices", "one device"),
])
def test_expect_refuses(fake, case, match):
    a, other_card, transposed = fake
    want = {"cpu": [(torch.zeros(2, 3), (2, 3), torch.float32)],
            "dtype": [(a, (2, 3), torch.int32)],
            "shape": [(a, (3, 2), torch.float32)],
            "non_contiguous": [(a, (2, 3), torch.float32), (transposed, (2, 3), torch.float32)],
            "two_devices": [(a, (2, 3), torch.float32), (other_card, (2, 3), torch.float32)]}
    with pytest.raises(ValueError, match=match):
        build.expect("K", *want[case])


def test_bind_types_every_entry_point_once(stand_in):
    lib = stand_in()
    assert stand_in() is lib
    assert lib.slr_size(7) == 21 and lib.slr_size.restype is ctypes.c_longlong
    assert lib.slr_cuda_error_string(700) == b"an illegal memory access was encountered"


def test_launch_passes_device_and_stream_and_counts_once(stand_in):
    lib, seen = stand_in(), (ctypes.c_longlong * 2)()
    before = _count()
    build.launch(lib, "slr_echo", "K9", torch.device("cuda", 3), 0, seen, counter=COUNTER)
    assert list(seen) == [3, STREAM]
    assert _count() == before + 1
    build.launch(lib, "slr_echo", "K9", torch.device("cuda", 0), 0, seen)
    assert _count() == before + 1


def test_launch_raises_the_error_string_and_counts_nothing(stand_in):
    lib, seen = stand_in(), (ctypes.c_longlong * 2)()
    before = _count()
    with pytest.raises(RuntimeError, match="^K9 kernel launch failed: an illegal memory "
                                           "access was encountered$"):
        build.launch(lib, "slr_echo", "K9", torch.device("cuda", 0), 700, seen,
                     counter=COUNTER)
    assert _count() == before


def test_check_status(stand_in):
    lib = stand_in()
    build.check_status(lib, "K9 layout", 0)
    with pytest.raises(RuntimeError, match="K9 layout kernel launch failed: unknown error"):
        build.check_status(lib, "K9 layout", 1)


@pytest.mark.parametrize("module", ["band_nn", "crossing", "fused_scan", "icp", "obj_text",
                                    "pose_graph", "unwrap_scan", "wavefront"])
def test_only_build_types_entry_points_and_reads_streams(module):
    src = (Path(build.__file__).parent / f"{module}.py").read_text()
    for word in ("argtypes", "restype", "cuda_stream", "slr_cuda_error_string",
                 "count(\"launches."):
        assert word not in src, f"{module}.py: {word}"


def test_an_edited_header_rebuilds(tmp_path, monkeypatch):
    """A library's hash covers the headers its source may include: an
    unchanged pair loads the first build, an edited header builds anew."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    src, header = tmp_path / "k.cpp", tmp_path / "k.cuh"
    header.write_text("#define K 1\n")
    src.write_text('#include "k.cuh"\nextern "C" int k() { return K; }\n')
    command = ("g++", *build.HOST_FLAGS)
    first, _ = build._compile(src, "k", command, [header])
    again, log = build._compile(src, "k", command, [header])
    assert again == first and log == ""
    header.write_text("#define K 2\n")
    second, _ = build._compile(src, "k", command, [header])
    assert second != first and ctypes.CDLL(str(second)).k() == 2
