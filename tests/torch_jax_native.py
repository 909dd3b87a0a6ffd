"""A private build of the JAX package's native library for the port's
tests that compare against it.

`tpusph.utils.native.get_lib` compiles `native/sphnative.cpp` in place, to
`native/build/libsphnative.so` under no private name, so test workers that
build it at once can load each other's half-written file and get `None`.
The fixture `jax_native` points the loader at a file under this worker's
own temporary directory for the duration of one test (`monkeypatch`
restores the module afterwards): the loader's own code then compiles the
unchanged source into a file that no other worker touches, and
`native/build/` is left to the JAX package's own tests.
"""

from __future__ import annotations

import pytest

LIBRARY = "libsphnative (native/sphnative.cpp, built by tpusph.utils.native)"


@pytest.fixture
def jax_native(tmp_path_factory, monkeypatch):
    """`tpusph.utils.native` with its library at a path of this worker's
    (built by the first test that asks, loaded again by the others)."""
    from tpusph.utils import native

    folder = tmp_path_factory.getbasetemp() / "jax_native"
    folder.mkdir(exist_ok=True)
    monkeypatch.setattr(native, "_SO", str(folder / "libsphnative.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    return native
