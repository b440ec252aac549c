"""Statistical validation of the stream ensemble against MFT.

Counterpart of `simulator/check_var.py:25-54` (P4 in SURVEY.md):
for a combined ensemble, compare <|psi|^2> against the MFT density and
report the per-cell mean/variance of n * (<|psi|^2> - |psi_mft|^2) dV —
which for correct sampling statistics has mean ~ O(1) (scheme-dependent
count offset) and variance consistent with the particle-number shot noise.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import TomlParameters, determine_pmass_hbar, read_toml
from ..io.npy import load_complex_pair


def ensemble_count_excess(
    combined_dir: str,
    mft_dir: str,
    dump: int,
    n_tot: float,
    dv: float,
) -> dict[str, float]:
    """mean/var of n * (<|psi|^2> - |psi_mft|^2) dV over cells.

    (check_var.py computes exactly this pair of moments.)
    """
    psi2 = load_complex_pair(os.path.join(combined_dir, f"psi2_{dump:05d}")).real
    psi_mft = load_complex_pair(os.path.join(mft_dir, f"psi_{dump:05d}"))
    excess = n_tot * (np.squeeze(psi2) - np.abs(np.squeeze(psi_mft)) ** 2) * dv
    return {
        "mean": float(np.mean(excess)),
        "var": float(np.var(excess)),
        "max_abs": float(np.abs(excess).max()),
    }


def check_toml(
    toml: TomlParameters, data_root: str = "sim-data", dump: int | None = None
) -> dict[str, float]:
    particle_mass, _ = determine_pmass_hbar(toml)
    n_tot = toml.total_mass / particle_mass
    dv = (toml.axis_length / toml.size) ** toml.dims
    if dump is None:
        dump = toml.num_data_dumps
    base = os.path.join(data_root, toml.sim_name)
    return ensemble_count_excess(
        base + "-combined", base, dump, n_tot, dv
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--toml", required=True)
    parser.add_argument("--data-root", default="sim-data")
    parser.add_argument("--dump", type=int, default=None)
    args = parser.parse_args(argv)
    stats = check_toml(read_toml(args.toml), args.data_root, args.dump)
    print(
        f"count excess: mean = {stats['mean']:.6g}, var = {stats['var']:.6g}, "
        f"max|.| = {stats['max_abs']:.6g}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
