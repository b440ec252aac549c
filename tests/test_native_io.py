"""Native C++ npy writer tests: byte-compatibility with numpy's format."""

import os
import subprocess
import sys

import numpy as np
import pytest

from msm_tpu.io import native, npy


@pytest.fixture(scope="session", autouse=True)
def native_lib():
    """The library builds from native/msm_io.cpp on first use; decided
    here (not at import) so every worker collects the same tests."""
    if not native.available():
        pytest.skip("native library could not be built (no C++ compiler?)")


def test_concurrent_builds_install_a_complete_library(tmp_path):
    """Parallel first-use builds (e.g. one per test worker) each compile to
    their own temporary name and rename into place: afterwards the library
    loads and writes byte-identical npy files."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        paths = list(pool.map(lambda _: native.build(), range(4)))
    assert len(set(paths)) == 1 and os.path.exists(paths[0])
    mine = f".libmsm_io.{os.getpid()}."
    leftovers = [
        f for f in os.listdir(os.path.dirname(paths[0])) if f.startswith(mine)
    ]
    assert leftovers == []
    # a fresh process loads the freshly installed library
    code = (
        "import numpy as np; from msm_tpu.io import native; "
        "assert native.available(); "
        f"native.write_npy({str(tmp_path / 'r')!r}, np.arange(6.0))"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
    with open(tmp_path / "r", "rb") as f:
        np.testing.assert_array_equal(np.lib.format.read_array(f), np.arange(6.0))


@pytest.mark.parametrize(
    "lib_age, stale",
    [(None, True), (-100, False), (+100, True)],
    ids=["missing", "newer-than-source", "older-than-source"],
)
def test_library_rebuilt_when_stale(tmp_path, monkeypatch, lib_age, stale):
    """A library older than native/msm_io.cpp (or none) is rebuilt on
    first use; a newer one is loaded as it is."""
    monkeypatch.setattr(native, "_native_dir", lambda: str(tmp_path))
    src = tmp_path / "msm_io.cpp"
    src.write_text("// source\n")
    lib = tmp_path / "libmsm_io.so"
    if lib_age is not None:
        lib.write_bytes(b"")
        t = os.path.getmtime(src)
        os.utime(lib, (t - lib_age, t - lib_age))
    assert native.is_stale(str(lib)) is stale


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("shape", [(16, 16, 16, 1), (8, 1, 1, 1), (32, 32, 1, 1)])
def test_native_pair_matches_numpy(tmp_path, rng, dtype, shape):
    arr = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)
    native.write_complex_pair(str(tmp_path / "n"), arr)

    # python reference writer
    with open(tmp_path / "p_real", "wb") as f:
        np.lib.format.write_array(f, np.ascontiguousarray(arr.real), version=(1, 0))
    with open(tmp_path / "p_imag", "wb") as f:
        np.lib.format.write_array(f, np.ascontiguousarray(arr.imag), version=(1, 0))

    for plane in ("_real", "_imag"):
        got = open(tmp_path / f"n{plane}", "rb").read()
        ref = open(tmp_path / f"p{plane}", "rb").read()
        assert got == ref, f"native npy bytes differ for {plane}"

    back = npy.load_complex_pair(str(tmp_path / "n"), dtype)
    np.testing.assert_array_equal(back, arr)


def test_native_real_npy(tmp_path, rng):
    arr = rng.standard_normal((4, 5, 6)).astype(np.float32)
    native.write_npy(str(tmp_path / "r"), arr)
    with open(tmp_path / "r", "rb") as f:
        back = np.lib.format.read_array(f)
    np.testing.assert_array_equal(back, arr)
    assert back.dtype == np.float32


def test_pair_roundtrip_large(tmp_path, rng):
    arr = (
        rng.standard_normal((64, 64, 64, 1)) + 1j * rng.standard_normal((64, 64, 64, 1))
    ).astype(np.complex64)
    npy.write_complex_pair(str(tmp_path / "big"), arr)
    back = npy.load_complex_pair(str(tmp_path / "big"), np.complex64)
    np.testing.assert_array_equal(back, arr)


def test_native_read_complex_pair_roundtrip(tmp_path, rng):
    """Native reader: both planes stream into one interleaved buffer;
    byte-identical to the numpy fallback for f32 and f64 pairs."""
    from msm_tpu.io import native
    from msm_tpu.io.npy import load_complex_pair, write_complex_pair

    assert native.can_read()
    for dtype, cdtype in ((np.float64, np.complex128), (np.float32, np.complex64)):
        arr = (
            rng.standard_normal((6, 5, 4, 1)) + 1j * rng.standard_normal((6, 5, 4, 1))
        ).astype(cdtype)
        base = str(tmp_path / f"grid_{dtype.__name__}")
        write_complex_pair(base, arr)
        got = load_complex_pair(base, dtype=cdtype)
        assert got.dtype == cdtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, arr)
        # cross-precision request falls back to the numpy path
        up = load_complex_pair(base, dtype=np.complex128)
        np.testing.assert_allclose(up, arr.astype(np.complex128))
