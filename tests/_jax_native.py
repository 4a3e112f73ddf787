"""The JAX package's native library (`mammodissect/native/`), built for this process
alone, for the port's tests that compare float pixels with the JAX package's.

The JAX package builds `fastimage.cpp` in place, beside its source, the first time it
is used, with no lock and no atomic rename. When several pytest workers collect the
suite at once, each starts g++ on that one path; a worker that loads the file while
another still writes it caches `None`, and its float resize then falls back to PIL,
which antialiases when it shrinks. A port test that holds its pixels to such a
worker's JAX resize at 1e-5 would fail for a fault that is not the port's.

`jax_native_lib()` points the JAX loader at a path that only this process writes,
drops what the loader cached, and calls the loader's own `get_lib()`: JAX's `_build`
compiles JAX's source with JAX's flags, and JAX's `_bind` declares the argument
types. The library is built once per process and stays loaded: it is JAX's own
library, from its own source and flags, the one JAX would have loaded had its build
not raced. A test module that compares float pixels with the JAX package imports the
`jax_native` fixture and names it in those tests."""
import os

import pytest

from mammodissect import native

_private_so = None


def jax_native_lib(directory: str):
    """JAX's native library, built into `directory` and loaded on the first call of
    this process; later calls return it. Fails, naming g++, when the library cannot
    be built or loaded."""
    global _private_so
    with native._lock:
        if _private_so is None:
            os.makedirs(directory, exist_ok=True)
            _private_so = os.path.join(directory, "_fastimage.so")
            native._SO, native._tried, native._lib = _private_so, False, None
    lib = native.get_lib()
    assert lib is not None, (
        f"g++ could not build the JAX package's native library into {_private_so}; "
        "its float resize would fall back to PIL")
    return lib


@pytest.fixture(scope="session")
def jax_native(tmp_path_factory):
    """The JAX package's float resize goes through its native library, built in this
    worker's temporary directory."""
    return jax_native_lib(str(tmp_path_factory.mktemp("jax_native")))
