"""The boundary to the hand-written kernels (``kernels``): the declared
entry points against the ``extern "C"`` prototypes of ``csrc/*.cu``, and
the one launch path with a faked library, device guard and stream."""
import contextlib
import ctypes
import re
import types

import pytest
import torch

from forest_benchmarking_tpu_torch import kernels

_PROTOTYPE = re.compile(r'extern "C"\s+([\w\s*]+?)\s*(\w+)\s*\(([^)]*)\)')


def _prototypes():
    """{function: (source stem, return type, parameter types)} of every
    ``extern "C"`` function in ``csrc/*.cu``."""
    found = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        for ret, name, params in _PROTOTYPE.findall(src.read_text()):
            types_ = [re.sub(r"\s*\w+$", "", p.strip()).replace(" *", "*")
                      for p in params.split(",")]
            found[name] = (src.stem, ret.replace(" *", "*"), types_)
    return found


def _kind(c_type: str):
    """The ctypes kind a C parameter or return type is passed as."""
    if c_type == "const ApgSchedule*":
        return ctypes.POINTER(kernels.ApgSchedule)
    if c_type == "const char*":
        return ctypes.c_char_p
    if c_type.endswith("*"):
        return ctypes.c_void_p
    assert c_type == "int", c_type
    return ctypes.c_int


def test_every_extern_c_function_is_declared():
    assert sorted(_prototypes()) == sorted(kernels.ENTRIES)


@pytest.mark.parametrize("entry", sorted(kernels.ENTRIES))
def test_declared_entry_matches_its_prototype(entry):
    """Source, argument kinds in order (a launch function's stream last)
    and result kind of the table equal the prototype's."""
    stem, argtypes, restype = kernels.ENTRIES[entry]
    src_stem, ret, params = _prototypes()[entry]
    assert stem == src_stem
    assert argtypes == [_kind(p) for p in params]
    assert restype == _kind(ret)
    if entry.endswith("_launch"):
        assert params[-1] == "void*" and restype is ctypes.c_int


LAUNCHES = sorted(e for e in kernels.ENTRIES if e.endswith("_launch"))


@pytest.mark.parametrize("entry", LAUNCHES)
def test_launch_passes_the_stream_and_raises_on_a_cuda_error(monkeypatch,
                                                             entry):
    """The launch function gets the arguments and then the current stream,
    read under the device guard; 0 returns, any other code raises a
    RuntimeError naming the kernel and carrying cudaGetErrorString."""
    calls, guard = [], []
    codes = iter([0, 2])

    def fn(*args):
        calls.append(args)
        return next(codes)

    @contextlib.contextmanager
    def device(dev):
        guard.append(dev)
        yield
        guard.append(None)

    def current_stream(*args):
        assert args == () and guard[-1] == "cuda:1"
        return types.SimpleNamespace(cuda_stream=0xABC)

    lib = types.SimpleNamespace(**{
        entry: fn, "fbt_cuda_error_string": lambda code: {
            2: b"out of memory"}[code]})
    monkeypatch.setattr(kernels, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    assert kernels.launch(entry, "cuda:1", 7, 8) is None
    kernel = entry.removesuffix("_launch")
    with pytest.raises(RuntimeError, match=(
            rf"^{kernel} kernel launch failed: CUDA error 2 "
            rf"\(out of memory\)$")):
        kernels.launch(entry, "cuda:1", 9)
    assert calls == [(7, 8, 0xABC), (9, 0xABC)]
    assert guard == ["cuda:1", None] * 2

