"""Config layer tests: seeds DSL, TOML ingestion, parameter resolution.

Mirrors the reference's seeds-DSL tests (`common/src/parameters.rs:121-144`)
and TOML round-trip test (`simulator/src/utils/io.rs:248-326`), plus
ingestion of fixtures that mirror the reference's shipped tomls
(tests/fixtures/, values per SURVEY.md §6).
"""

import math
import os

import pytest

from msm_tpu import config as cfg
from msm_tpu.constants import HBAR, LITTLE_H_TO_BIG_H

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
REFERENCE_TOMLS = (
    "spherical-tophat.toml",
    "spherical-tophat-cosmo.toml",
    "planeWave3d_e10_sym.toml",
)
TOPHAT = os.path.join(FIXTURES, "spherical-tophat.toml")


def test_seeds_range_inclusive():
    assert cfg.parse_seeds("0..=55") == tuple(range(56))


def test_seeds_to():
    assert cfg.parse_seeds("0 to 55") == tuple(range(56))


def test_seeds_comma_separated():
    assert cfg.parse_seeds("[1, 3]") == (1, 3)
    assert cfg.parse_seeds("1, 3") == (1, 3)


def test_seeds_plain_list():
    assert cfg.parse_seeds([4, 5, 6]) == (4, 5, 6)


def test_seeds_invalid():
    with pytest.raises(ValueError):
        cfg.parse_seeds("no numbers here")


def test_seeds_malformed_rejected():
    # digit runs embedded in garbage must NOT silently become a seed list
    # (the reference's scrape panics on these too, parameters.rs:183-193)
    for bad in ("garbage7text9", "1; 3", "1 3", "[1, x]", "[]", "1,,3"):
        with pytest.raises(ValueError):
            cfg.parse_seeds(bad)
    # trailing comma and whitespace are tolerated
    assert cfg.parse_seeds("[1, 2, 3,]") == (1, 2, 3)
    assert cfg.parse_seeds(" 7 ") == (7,)


@pytest.mark.parametrize("name", REFERENCE_TOMLS)
def test_reads_reference_tomls(name):
    toml = cfg.read_toml(os.path.join(FIXTURES, name))
    assert toml.size % 2 == 0
    assert toml.dims in (1, 2, 3)
    params = cfg.resolve_parameters(toml)
    assert params.dx > 0
    assert params.dk == params.dx


def test_plane3d_fixture_parses_as_shipped():
    """The plane-wave config's unused num_streams key and its remote-storage
    and cosmology tables parse (tomls/planeWave3d_e10_sym.toml shape)."""
    toml = cfg.read_toml(os.path.join(FIXTURES, "planeWave3d_e10_sym.toml"))
    assert toml.size == 16 and toml.dims == 3
    assert toml.sampling.scheme == "Wigner"
    assert toml.sampling.seeds == tuple(range(1, 17))
    assert toml.cosmology is not None and toml.cosmology.z0 == 99.0
    assert toml.remote_storage_parameters.storage_account == "streams"
    assert isinstance(toml.ics, cfg.UserSpecified)


def test_tophat_example_values():
    toml = cfg.read_toml(TOPHAT)
    assert toml.axis_length == 30
    assert toml.hbar_ == 0.05
    assert toml.sampling.scheme == "Husimi"
    assert toml.sampling.seeds == tuple(range(1, 11))
    assert isinstance(toml.ics, cfg.SphericalTophat)
    assert toml.ics.radius == 5.0
    p = cfg.resolve_parameters(toml)
    assert p.dx == pytest.approx(30 / 16)
    # hbar_ specified => particle_mass = HBAR / hbar_
    assert p.particle_mass == pytest.approx(HBAR / 0.05)


def test_pmass_priority_ntot_over_particle_mass():
    toml = cfg.read_toml(os.path.join(FIXTURES, "planeWave3d_e10_sym.toml"))
    # ntot specified: particle_mass = total_mass / ntot, hbar_ from toml
    pm, hb = cfg.determine_pmass_hbar(toml)
    assert pm == pytest.approx(3e16 / 1e10)
    assert hb == 0.01


def test_pmass_requires_some_spec():
    toml = cfg.read_toml(TOPHAT)
    bad = cfg.TomlParameters(
        **{
            **{f.name: getattr(toml, f.name) for f in toml.__dataclass_fields__.values()},
            "hbar_": None,
            "particle_mass": None,
            "ntot": None,
        }
    )
    with pytest.raises(ValueError):
        cfg.determine_pmass_hbar(bad)


def test_supercomoving_boxsize():
    cosmo = cfg.CosmologyConfig(
        omega_matter_now=1.0, omega_radiation_now=0.0, h=1e-7, z0=99.0
    )
    hbar_ = 0.01
    L = 60.0
    expected = (
        math.sqrt(math.sqrt(1.5 * 1.0 * (1e-7 * LITTLE_H_TO_BIG_H) ** 2) / hbar_)
        * L
        * 100.0
    )
    assert cfg.get_supercomoving_boxsize(hbar_, cosmo, L) == pytest.approx(expected)


def test_stream_iteration_names_and_mft():
    toml = cfg.read_toml(TOPHAT)
    runs = list(cfg.iter_stream_parameters(toml))
    assert len(runs) == 11  # 10 seeds + MFT
    assert runs[0].sim_name == "spherical-tophat-stream00001"
    assert runs[0].sampling.seed == 1
    assert runs[0].sampling.scheme == "Husimi"
    assert runs[-1].sim_name == "spherical-tophat"
    assert runs[-1].sampling is None
    assert cfg.stream_count(toml) == 11


def test_cosmology_validation():
    with pytest.raises(ValueError):
        cfg.CosmologyConfig(
            omega_matter_now=0.9, omega_radiation_now=0.2, h=0.7, z0=1.0
        )
    with pytest.raises(ValueError):
        cfg.CosmologyConfig(
            omega_matter_now=0.7, omega_radiation_now=0.0, h=0.7, z0=-1.0
        )


def test_grid_axis_convention():
    toml = cfg.read_toml(TOPHAT)
    p = cfg.resolve_parameters(toml)
    # x (config axis 0) is the fastest-varying (last) array axis
    assert p.grid_axis(0) == 2
    assert p.grid_axis(2) == 0
    assert p.dump_shape == (16, 16, 16, 1)
