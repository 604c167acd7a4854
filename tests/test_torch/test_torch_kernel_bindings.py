"""The ctypes bindings of the kernel libraries (``ops/_cuda.py``) on the CPU.

ctypes does not check a declaration against the C function: an argument
list that disagrees with its prototype (a ``c_int`` where C reads ``long
long``, one pointer too few) is undefined behaviour on the card, not an
error.  So each library's table ``EXPORTS`` is held here to the
``extern "C"`` prototypes of its source in ``csrc/`` (with the
``PYRAYT_*_ARGS`` macros expanded), :func:`library` to the table, and the
launch helper :func:`call` to its contract on a fake library."""

import contextlib
import ctypes
import re
import types

import pytest
import torch

from pyrayt_tpu_torch.ops import _cuda

STEMS = [name[:-3] for name in _cuda.KERNEL_SOURCES]
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "const char*": ctypes.c_char_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int, "double": ctypes.c_double}


def c_type(decl: str):
    """The ctypes type of a C declaration without its name ("const void* x",
    "long long", "int")."""
    return C_TYPES[re.sub(r"\s*\*\s*", "* ", decl).strip()]


def prototypes(stem: str):
    """``{export: (argtypes, restype)}`` of the ``extern "C"`` block of
    ``csrc/<stem>.cu``."""
    text = (_cuda._CSRC_DIR / f"{stem}.cu").read_text()
    macros = {name: body.replace("\\\n", " ") for name, body in
              re.findall(r"#define (PYRAYT_\w+_ARGS)\s+((?:.*\\\n)*.*)", text)}
    block = text[text.index('extern "C" {'):text.index('}  // extern "C"')]
    block = re.sub(r"//.*", "", block)
    for name, body in macros.items():
        block = re.sub(r"\b" + name + r"\b", body, block)
    found = {}
    for ret, name, params in re.findall(r"([\w\s*]+?)\b(pyrayt_\w+)\s*\(([^)]*)\)\s*\{", block):
        decls = [p.strip() for p in params.split(",") if p.strip()]
        # drop each parameter's name: the last identifier of its declaration
        args = tuple(c_type(re.sub(r"\w+$", "", d)) for d in decls)
        found[name] = (args, c_type(ret))
    return found


def table(stem: str):
    return {name: signature for entry, signature in _cuda.EXPORTS[stem].items()
            for name in _cuda._builds(entry)}


def test_the_table_names_every_library():
    assert sorted(_cuda.EXPORTS) == sorted(STEMS)


@pytest.mark.parametrize("stem", STEMS)
def test_table_matches_the_c_prototypes(stem):
    """Same exports, the same type at every position, the same return type."""
    expected = prototypes(stem)
    got = table(stem)
    assert sorted(got) == sorted(expected)
    for name, (args, restype) in expected.items():
        assert tuple(got[name][0]) == args, name
        assert got[name][1] == restype, name
    assert any(name.endswith("_error_string") for name in got)  # read by ``call``


@pytest.mark.parametrize("stem", STEMS)
def test_library_declares_every_export(monkeypatch, stem):
    """``library`` loads the library that ``build_kernels`` names and sets
    ``argtypes`` and ``restype`` of every export of the table."""

    class FakeCDLL:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            return self.__dict__.setdefault(name, types.SimpleNamespace())

    monkeypatch.setattr(_cuda, "build_kernels", lambda: {stem: (f"/lib/{stem}.so", 0.0, "")})
    monkeypatch.setattr(ctypes, "CDLL", FakeCDLL)
    lib = _cuda.library.__wrapped__(stem)
    assert lib.path == f"/lib/{stem}.so"
    for name, (args, restype) in prototypes(stem).items():
        assert tuple(getattr(lib, name).argtypes) == args, name
        assert getattr(lib, name).restype == restype, name


class FakeLibrary:
    """Records each launch; every launch returns ``code``, and the error
    string names the export that made it."""

    def __init__(self, code):
        self.code = code
        self.calls = []

    def __getattr__(self, name):
        if name.endswith("_error_string"):
            return lambda err: f"{name} of {err}".encode()
        return lambda *args: self.calls.append((name, args)) or self.code


def test_call_passes_pointers_nulls_the_suffix_and_the_stream(monkeypatch):
    fake = FakeLibrary(0)
    devices = []

    @contextlib.contextmanager
    def device(dev):
        devices.append(dev)
        yield

    monkeypatch.setattr(_cuda, "library", lambda stem: fake)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=77))
    t = torch.zeros(3, dtype=torch.float64)
    _cuda.call("wide_grad", "pyrayt_staged_tail", torch.float64, "cpu", t, 5, None, 2.5)
    _cuda.call("wide_grad", "pyrayt_staged_tail", torch.float32, "cpu", t.float(), 0, None, 1.0)
    assert [name for name, _ in fake.calls] == ["pyrayt_staged_tail_f64", "pyrayt_staged_tail_f32"]
    assert fake.calls[0][1] == (t.data_ptr(), 5, None, 2.5, 77)
    assert fake.calls[1][1][1:] == (0, None, 1.0, 77)
    assert devices == ["cpu", "cpu"]

    fake.code = 700
    for stem, export, error_string in (("fused_trace", "pyrayt_fused_trace", "pyrayt_error_string"),
                                       ("wide_fused_grad", "pyrayt_wide_fused_bwd",
                                        "pyrayt_wide_fused_error_string")):
        with pytest.raises(RuntimeError, match=f"{export}_f32 .*{error_string} of 700"):
            _cuda.call(stem, export, torch.float32, "cpu", t)
