"""pyrayt_tpu_torch/API.md covers the port's public API: every name in the
``__all__`` of every public module of the package appears there as a
whole word (tests/test_docs/test_api_coverage.py does the same for the
JAX package and docs/api.md)."""

import importlib
import pathlib
import pkgutil
import re

import pytest

import pyrayt_tpu_torch

DOC = pathlib.Path(pyrayt_tpu_torch.__file__).resolve().parent / "API.md"


def public_modules():
    names = ["pyrayt_tpu_torch"]
    for info in pkgutil.walk_packages(pyrayt_tpu_torch.__path__, "pyrayt_tpu_torch."):
        if not any(part.startswith("_") for part in info.name.split(".")):
            names.append(info.name)
    return names


def test_the_walk_finds_the_ported_modules():
    found = set(public_modules())
    for name in ("pyrayt_tpu_torch.render.renderers", "pyrayt_tpu_torch.debug",
                 "pyrayt_tpu_torch.analysis.aberrations", "pyrayt_tpu_torch.core.homogeneous"):
        assert name in found


@pytest.mark.parametrize("module", public_modules())
def test_every_public_name_is_documented(module):
    doc = DOC.read_text()
    missing = [name for name in getattr(importlib.import_module(module), "__all__", [])
               if re.search(r"\b" + re.escape(name) + r"\b", doc) is None]
    assert not missing, f"{module}: {missing} missing from {DOC.name}"
