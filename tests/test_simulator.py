"""End-to-end driver tests: dumps on disk in the reference layout, batched
vs sequential equivalence, resume-from-checkpoint, aliasing policy.

Counterpart of the reference's `test.sh` feature-matrix smoke runs plus the
`--test` dry-run flag (`simulator/src/main.rs:16,59`)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from msm_tpu import config as cfg
from msm_tpu import simulator
from msm_tpu.io.npy import load_complex_pair


def _toml(tmp_path, seeds="1 to 3", dumps=4, size=8, name="e2e"):
    return cfg.parse_toml_str(
        f"""
axis_length = 30
final_sim_time = 1.0
cfl = 0.5
num_data_dumps = {dumps}
total_mass = 1e8
hbar_ = 0.05
sim_name = "{name}"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 3
size = {size}

[ics]
type = "SphericalTophat"
radius = 5.0
slope = 50
delta = 10

[sampling]
seeds = "{seeds}"
scheme = "Husimi"
"""
    )


def test_e2e_batched_run(tmp_path):
    toml = _toml(tmp_path)
    root = str(tmp_path / "sim-data")
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root)
    # 3 stream dirs + MFT dir, each with dumps 0..=4
    dirs = sorted(os.listdir(root))
    assert dirs == ["e2e", "e2e-stream00001", "e2e-stream00002", "e2e-stream00003"]
    for d in dirs:
        for i in range(5):
            base = os.path.join(root, d, f"psi_{i:05d}")
            psi = load_complex_pair(base)
            assert psi.shape == (8, 8, 8, 1)
            norm = np.sum(np.abs(psi) ** 2) * (30 / 8) ** 3
            assert norm == pytest.approx(1.0, rel=1e-6)
        assert os.path.exists(os.path.join(root, d, "manifest.json"))


def test_batched_matches_sequential(tmp_path):
    toml = _toml(tmp_path, seeds="[5]", dumps=2)
    root_a = str(tmp_path / "a")
    root_b = str(tmp_path / "b")
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root_a)
    simulator.run_config(
        toml, dtype=jnp.complex128, data_root=root_b, batch_streams=False
    )
    for d in ("e2e", "e2e-stream00005"):
        for i in range(3):
            a = load_complex_pair(os.path.join(root_a, d, f"psi_{i:05d}"))
            b = load_complex_pair(os.path.join(root_b, d, f"psi_{i:05d}"))
            np.testing.assert_allclose(a, b, atol=1e-12)


def test_test_only_makes_no_dumps(tmp_path):
    toml = _toml(tmp_path)
    root = str(tmp_path / "sim-data")
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root, test_only=True)
    # run_config in test mode constructs state but writes nothing
    if os.path.isdir(root):
        for d in os.listdir(root):
            assert not any(
                f.startswith("psi_") for f in os.listdir(os.path.join(root, d))
            )


def test_resume_matches_uninterrupted(tmp_path):
    toml = cfg.parse_toml_dict(
        {
            "axis_length": 30,
            "final_sim_time": 1.0,
            "cfl": 0.5,
            "num_data_dumps": 4,
            "total_mass": 1e8,
            "hbar_": 0.05,
            "sim_name": "resume",
            "k2_cutoff": 0.95,
            "alias_threshold": 0.5,
            "dims": 2,
            "size": 16,
            "ics": {"type": "SphericalTophat", "radius": 5.0, "slope": 50, "delta": 10},
        }
    )
    p = cfg.resolve_parameters(toml)
    root_full = str(tmp_path / "full")
    root_res = str(tmp_path / "res")

    simulator.run_single(p, jnp.complex128, data_root=root_full)

    # partial run: stop after 2 dumps by shrinking num_data_dumps... instead
    # run fully, delete later dumps + rewind manifest, then resume.
    simulator.run_single(p, jnp.complex128, data_root=root_res)
    d = os.path.join(root_res, "resume")
    for i in (3, 4):
        os.remove(os.path.join(d, f"psi_{i:05d}_real"))
        os.remove(os.path.join(d, f"psi_{i:05d}_imag"))
    from msm_tpu.io.checkpoint import load_manifest, write_manifest

    psi2 = load_complex_pair(os.path.join(d, "psi_00002"))
    write_manifest(d, current_dumps=2, time=0.5, n_steps=2)
    simulator.run_single(p, jnp.complex128, data_root=root_res, resume=True)

    for i in range(5):
        a = load_complex_pair(os.path.join(root_full, "resume", f"psi_{i:05d}"))
        b = load_complex_pair(os.path.join(d, f"psi_{i:05d}"))
        np.testing.assert_allclose(a, b, atol=1e-10)


def test_batched_resume_matches_uninterrupted(tmp_path):
    """Resume of a batched ensemble from manifests must reproduce the
    uninterrupted trajectory exactly."""
    toml = _toml(tmp_path, seeds="1 to 2", dumps=4)
    root_full = str(tmp_path / "full")
    root_res = str(tmp_path / "res")

    simulator.run_config(toml, dtype=jnp.complex128, data_root=root_full)
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root_res)

    # rewind every run to dump 2: delete later dumps, rewrite manifests
    from msm_tpu.io.checkpoint import load_manifest, write_manifest

    dirs = ["e2e", "e2e-stream00001", "e2e-stream00002"]
    for d in dirs:
        full = os.path.join(root_res, d)
        for i in (3, 4):
            os.remove(os.path.join(full, f"psi_{i:05d}_real"))
            os.remove(os.path.join(full, f"psi_{i:05d}_imag"))
        m = load_manifest(full)
        write_manifest(
            full, current_dumps=2, time=0.5, tau=m["tau"], a=m["a"], n_steps=2
        )

    simulator.run_config(toml, dtype=jnp.complex128, data_root=root_res, resume=True)

    for d in dirs:
        for i in range(5):
            a = load_complex_pair(os.path.join(root_full, d, f"psi_{i:05d}"))
            b = load_complex_pair(os.path.join(root_res, d, f"psi_{i:05d}"))
            np.testing.assert_allclose(a, b, atol=1e-10, err_msg=f"{d} dump {i}")


def test_mesh_auto_matches_single_device(tmp_path):
    """run_config with mesh=auto over 8 virtual devices reproduces the
    single-device ensemble bit-for-bit (MeshStepper path in the driver)."""
    toml = _toml(tmp_path, seeds="1 to 3", dumps=3)  # 4 runs: divides mesh
    root_a = str(tmp_path / "single")
    root_b = str(tmp_path / "mesh")
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root_a)
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root_b, mesh="auto")
    for d in sorted(os.listdir(root_a)):
        for i in range(4):
            a = load_complex_pair(os.path.join(root_a, d, f"psi_{i:05d}"))
            b = load_complex_pair(os.path.join(root_b, d, f"psi_{i:05d}"))
            np.testing.assert_allclose(a, b, atol=1e-11, err_msg=f"{d} dump {i}")


def test_output_potential_batched(tmp_path):
    toml = cfg.parse_toml_str(
        """
axis_length = 30
final_sim_time = 0.5
cfl = 0.5
num_data_dumps = 2
total_mass = 1e8
hbar_ = 0.05
sim_name = "pot"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 2
size = 8
output_potential = true

[ics]
type = "SphericalTophat"
radius = 5.0
slope = 50
delta = 10

[sampling]
seeds = "[1]"
scheme = "Husimi"
"""
    )
    root = str(tmp_path / "sim-data")
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root)
    for d in ("pot", "pot-stream00001"):
        for i in range(3):
            phi = load_complex_pair(os.path.join(root, d, f"potential_{i:05d}"))
            assert phi.shape == (8, 8, 1, 1)
            assert np.all(phi.imag == 0.0)
            assert np.abs(phi.real).max() > 0.0


def test_strict_alias_raises(tmp_path):
    """--strict-alias restores the reference's abort semantics."""
    from msm_tpu.errors import FourierAliasingError

    toml = cfg.parse_toml_dict(
        {
            "axis_length": 30,
            "final_sim_time": 10.0,
            "cfl": 0.9,
            "num_data_dumps": 4,
            "total_mass": 5e11,  # violent collapse -> aliasing
            "hbar_": 0.01,
            "sim_name": "alias",
            "k2_cutoff": 0.5,
            "alias_threshold": 1e-8,
            "dims": 2,
            "size": 16,
            "ics": {"type": "SphericalTophat", "radius": 5.0, "slope": 50, "delta": 100},
        }
    )
    p = cfg.resolve_parameters(toml)
    with pytest.raises(FourierAliasingError, match="probability mass"):
        simulator.run_single(
            p, jnp.complex128, data_root=str(tmp_path), strict_alias=True
        )
    # non-strict: freezes and returns
    state = simulator.run_single(
        p, jnp.complex128, data_root=str(tmp_path / "b"), strict_alias=False
    )
    assert bool(np.asarray(state.aliased))


def test_e2e_1d_and_kspace_ics(tmp_path):
    """1-D grids and the ColdGaussKSpace family through the full driver."""
    toml = cfg.parse_toml_dict(
        {
            "axis_length": 60.0,
            "final_sim_time": 2.0,
            "cfl": 0.5,
            "num_data_dumps": 3,
            "total_mass": 1e9,
            "ntot": 1e6,
            "hbar_": 0.05,
            "sim_name": "oned",
            "k2_cutoff": 0.95,
            "alias_threshold": 0.9,
            "dims": 1,
            "size": 64,
            "ics": {
                "type": "ColdGaussKSpace",
                "mean": [0.0],
                "std": [0.2],
                "phase_seed": 11,
            },
            "sampling": {"seeds": "[2, 9]", "scheme": "Poisson"},
        }
    )
    root = str(tmp_path / "sim-data")
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root)
    for d in ("oned", "oned-stream00002", "oned-stream00009"):
        for i in range(4):
            psi = load_complex_pair(os.path.join(root, d, f"psi_{i:05d}"))
            assert psi.shape == (64, 1, 1, 1)
            norm = np.sum(np.abs(psi) ** 2) * (60.0 / 64)
            # Poisson sampling carries shot noise in the norm (~1/sqrt(n));
            # the MFT stays exactly normalized
            tol = 1e-6 if d == "oned" else 1e-2
            assert norm == pytest.approx(1.0, rel=tol)
    # Poisson-sampled streams differ from the MFT and from each other
    a = load_complex_pair(os.path.join(root, "oned-stream00002", "psi_00000"))
    b = load_complex_pair(os.path.join(root, "oned-stream00009", "psi_00000"))
    m = load_complex_pair(os.path.join(root, "oned", "psi_00000"))
    assert np.abs(a - m).max() > 1e-6
    assert np.abs(a - b).max() > 1e-6


def test_remote_storage_backend_wired(tmp_path):
    """A [remote_storage_parameters] table routes grid dumps through the
    ObjectBackend: flat keys, seed-rotated accounts (io.rs:352-465,
    simulation_object.rs:1186-1205); manifests stay local for resume."""
    text = f"""
axis_length = 30
final_sim_time = 0.5
cfl = 0.5
num_data_dumps = 2
total_mass = 1e8
hbar_ = 0.05
sim_name = "rsrun"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 2
size = 8

[ics]
type = "ColdGauss"
mean = [15.0, 15.0]
std = [4.0, 4.0]

[sampling]
seeds = "[1, 2]"
scheme = "Wigner"

[remote_storage_parameters]
keypair = "dev.json"
storage_account = "streams"
"""
    toml = cfg.parse_toml_str(text)
    root = str(tmp_path / "d")
    # pre-provision two matching accounts on the "drive": rotation by seed
    remote = tmp_path / "d" / "remote-storage"
    for acc in ("streams-a", "streams-b"):
        (remote / acc).mkdir(parents=True)
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root)

    # grids land in seed-rotated account namespaces under flat keys
    for seed, acc in ((1, "streams-b"), (2, "streams-a")):
        for dump in range(3):
            base = remote / acc / f"rsrun-stream{seed:05d}_psi_{dump:05d}"
            psi = load_complex_pair(str(base))
            assert psi.shape == (8, 8, 1, 1)
    # MFT (no seed) uses the first account
    assert (remote / "streams-a" / "rsrun_psi_00000_real").exists()
    # no local psi dumps; manifests still local
    assert not os.path.exists(os.path.join(root, "rsrun", "psi_00000_real"))
    assert os.path.exists(os.path.join(root, "rsrun", "manifest.json"))

    # --ignore-remote-storage (use_remote_storage=False) restores local dumps
    root2 = str(tmp_path / "d2")
    simulator.run_config(
        toml, dtype=jnp.complex128, data_root=root2, use_remote_storage=False
    )
    assert os.path.exists(os.path.join(root2, "rsrun", "psi_00002_real"))


def test_mesh_auto_pads_nondivisible_batch(tmp_path):
    """mesh=auto with a run count that divides nothing: the batch is padded
    internally (extra MFT rows, dumps discarded) instead of raising
    'pad the seed list' (round-1 behavior)."""
    toml = cfg.parse_toml_str(
        """
axis_length = 30
final_sim_time = 1.0
cfl = 0.5
num_data_dumps = 2
total_mass = 1e8
hbar_ = 0.05
sim_name = "pad"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 1
size = 64

[ics]
type = "ColdGauss"
mean = [15.0]
std = [4.0]

[sampling]
seeds = "1 to 4"
scheme = "Wigner"
"""
    )  # 5 runs over 8 devices: 1-D cannot shard space -> padded to 8
    root_a, root_b = str(tmp_path / "a"), str(tmp_path / "b")
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root_a)
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root_b, mesh="auto")
    for name in ["pad"] + [f"pad-stream{s:05d}" for s in range(1, 5)]:
        for dump in range(3):
            a = load_complex_pair(os.path.join(root_a, name, f"psi_{dump:05d}"))
            b = load_complex_pair(os.path.join(root_b, name, f"psi_{dump:05d}"))
            np.testing.assert_allclose(a, b, atol=1e-11)
    # no padded-row directories leak
    assert not any("stream00005" in d for d in os.listdir(root_b))


def test_interval_block_matches_single(tmp_path, monkeypatch):
    """k-interval blocking (stepper.evolve_intervals / MSM_INTERVAL_BLOCK)
    is a pure dispatch-amortization: dumps, potentials and manifests are
    identical to the one-interval loop. k=3 over 4 dumps also exercises
    the post-finish no-op rows of the final block."""
    import dataclasses
    import json

    toml = dataclasses.replace(
        _toml(tmp_path, seeds="[2]", dumps=4), output_potential=True
    )
    roots = {}
    for k in ("1", "3"):
        monkeypatch.setenv("MSM_INTERVAL_BLOCK", k)
        roots[k] = str(tmp_path / f"k{k}")
        simulator.run_config(toml, dtype=jnp.complex128, data_root=roots[k])
    for d in ("e2e", "e2e-stream00002"):
        for i in range(5):
            for field in ("psi", "potential"):
                a = load_complex_pair(os.path.join(roots["1"], d, f"{field}_{i:05d}"))
                b = load_complex_pair(os.path.join(roots["3"], d, f"{field}_{i:05d}"))
                np.testing.assert_array_equal(a, b)
        ma = json.load(open(os.path.join(roots["1"], d, "manifest.json")))
        mb = json.load(open(os.path.join(roots["3"], d, "manifest.json")))
        ma.pop("wall_time_ms"), mb.pop("wall_time_ms")
        assert ma == mb


def test_mesh_interval_block_matches_single(tmp_path, monkeypatch):
    """Interval blocking on a device MESH (MeshStepper.evolve_intervals):
    kblock>1 over the 8-virtual-device mesh produces dumps, potentials and
    manifests identical to the one-interval mesh loop (jnp.fft pencil
    path)."""
    import dataclasses
    import json

    toml = dataclasses.replace(
        _toml(tmp_path, seeds="[2, 5]", dumps=4, size=16, name="meshblk"),
        output_potential=True,
    )
    roots = {}
    for k in ("1", "3"):
        monkeypatch.setenv("MSM_INTERVAL_BLOCK", k)
        roots[k] = str(tmp_path / f"meshk{k}")
        simulator.run_config(
            toml, dtype=jnp.complex128, data_root=roots[k], mesh="auto"
        )
    for d in ("meshblk", "meshblk-stream00002", "meshblk-stream00005"):
        for i in range(5):
            for field in ("psi", "potential"):
                a = load_complex_pair(os.path.join(roots["1"], d, f"{field}_{i:05d}"))
                b = load_complex_pair(os.path.join(roots["3"], d, f"{field}_{i:05d}"))
                np.testing.assert_array_equal(a, b)
        ma = json.load(open(os.path.join(roots["1"], d, "manifest.json")))
        mb = json.load(open(os.path.join(roots["3"], d, "manifest.json")))
        ma.pop("wall_time_ms"), mb.pop("wall_time_ms")
        assert ma == mb
