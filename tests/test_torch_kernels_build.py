"""The CUDA build cache of the PyTorch port: a library's path is a digest of its
source, of every header under `csrc/` and of the nvcc flags, so an edit to any of
them builds a new library instead of loading a stale one. Needs no nvcc."""
import shutil

import pytest

from mammodissect_torch.ops import kernels


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, copy)
    monkeypatch.setattr(kernels, "CSRC", copy)
    return copy


def test_every_kernel_source_is_in_csrc():
    for name in kernels.KERNEL_SOURCES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
    assert (kernels.CSRC / "hopper_ptx.cuh").is_file()


@pytest.mark.parametrize("edit", ["existing header", "new .h header", "source", "flags"])
@pytest.mark.parametrize("name", kernels.KERNEL_SOURCES)
def test_library_path_changes_with_what_the_build_reads(csrc, monkeypatch, name, edit):
    before = kernels.library_path(name)
    assert kernels.library_path(name) == before  # deterministic
    if edit == "existing header":
        header = csrc / "hopper_ptx.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
    elif edit == "new .h header":
        (csrc / "extra.h").write_text("#pragma once\n")
    elif edit == "source":
        src = csrc / f"{name}.cu"
        src.write_text(src.read_text() + "\n// edited\n")
    else:
        monkeypatch.setattr(kernels, "NVCC_FLAGS", (*kernels.NVCC_FLAGS, "-lineinfo"))
    after = kernels.library_path(name)
    assert after != before
    assert after.parent == before.parent and after.name.startswith(f"lib{name}_")


def test_library_path_ignores_files_that_are_not_headers(csrc):
    before = kernels.library_path("mbconv_expand_dw")
    (csrc / "notes.txt").write_text("not read by nvcc")
    assert kernels.library_path("mbconv_expand_dw") == before


def test_the_shared_bf16_header_rebuilds_both_libraries_that_include_it(csrc):
    """Kernel 2 and kernel 3 compute the bf16 program's BatchNorm and SiLU from one
    header: an edit to it builds both anew."""
    names = ("mbconv_expand_dw", "bn_epilogue")
    for name in names:
        assert '#include "bf16_xla.cuh"' in (csrc / f"{name}.cu").read_text()
    before = [kernels.library_path(name) for name in names]
    header = csrc / "bf16_xla.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(kernels.library_path(name) != path for name, path in zip(names, before))
