"""The port's packaging: every source file it reads at run time (the CUDA
kernels it builds with nvcc and the C++ mask library it builds with g++)
is package data of the wheel, and the port has its own console script."""

import fnmatch
import tomllib
from pathlib import Path

import pytest

from cl4wsis_tpu_torch.data import native
from cl4wsis_tpu_torch.ops import kernels

REPO = Path(__file__).resolve().parents[1]
PKG = "cl4wsis_tpu_torch"


def _pyproject():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


RUNTIME_SOURCES = [kernels.CSRC_DIR / s for s in kernels.SOURCES] + [
    native.SOURCE]


@pytest.mark.parametrize("source", RUNTIME_SOURCES, ids=lambda p: p.name)
def test_runtime_source_is_package_data(source):
    """The source exists in the checkout and matches one of the package's
    package-data globs (a wheel without it cannot build its library)."""
    rel = source.relative_to(REPO / PKG).as_posix()
    globs = _pyproject()["tool"]["setuptools"]["package-data"][PKG]
    assert source.is_file()
    assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)


def test_port_is_packaged_with_its_entry_point():
    cfg = _pyproject()
    include = cfg["tool"]["setuptools"]["packages"]["find"]["include"]
    assert any(fnmatch.fnmatch(PKG, g) for g in include)
    assert cfg["project"]["scripts"]["cl4wsis-train-torch"] == \
        "cl4wsis_tpu_torch.cli.main:main"
