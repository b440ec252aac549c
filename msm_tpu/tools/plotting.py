"""Visualization tools for simulation dumps and combined quantities.

Counterpart of the reference's plot scripts (SURVEY.md §2.2):

- `density_frames` / movie: per-dump projected |psi|^2 and |psi_k|^2 image
  frames (reference `simulator/plot.py:16-128`).
- `density_panels`: 4-panel figure — projected density, momentum density,
  potential, radial density profile (reference `simulator/plotDensities.py`).
- `radial_profile`: radial mass profile about the box center.
- `plot_q_series`: Q(dump) time series from the combined output
  (reference `synthesizer/plotqs.py`).

All functions take the dump directory layout produced by the simulator and
return matplotlib figures (Agg backend; no display required). Movies are
written as an image-sequence directory (mp4 assembly needs an encoder the
image may not ship; the frames are drop-in compatible with ffmpeg).
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402

from ..io.npy import load_complex_pair  # noqa: E402


def load_dump(sim_dir: str, dump: int, field: str = "psi") -> np.ndarray:
    """Load one dump as a squeezed complex grid."""
    arr = load_complex_pair(os.path.join(sim_dir, f"{field}_{dump:05d}"))
    return np.squeeze(arr)


def count_dumps(sim_dir: str, field: str = "psi") -> int:
    return len(glob.glob(os.path.join(sim_dir, f"{field}_*_real")))


def _project(density: np.ndarray) -> np.ndarray:
    """Project a 1/2/3-D density to <=2-D for imaging (sum over z)."""
    if density.ndim == 3:
        return density.sum(axis=0)
    return density


def density_frame(
    sim_dir: str, dump: int, kspace: bool = False, log_scale: bool = True
):
    """One |psi|^2 (or |psi_k|^2) frame (reference plot.py:16-63)."""
    psi = load_dump(sim_dir, dump)
    if kspace:
        psi = np.fft.fftshift(np.fft.fftn(psi, norm="ortho"))
    dens = _project(np.abs(psi) ** 2)
    fig, ax = plt.subplots(figsize=(6, 5))
    if dens.ndim == 1:
        ax.plot(dens)
        ax.set_yscale("log" if log_scale else "linear")
    else:
        img = np.log10(dens + 1e-30) if log_scale else dens
        im = ax.imshow(img, origin="lower", cmap="viridis", interpolation="none")
        fig.colorbar(im, ax=ax)
    ax.set_title(f"{'|psi_k|^2' if kspace else '|psi|^2'} dump {dump}")
    fig.tight_layout()
    return fig


def density_movie_frames(
    sim_dir: str, out_dir: str, kspace: bool = False, max_dumps: Optional[int] = None
) -> list[str]:
    """Write per-dump png frames (ffmpeg-ready; reference plot.py:65-128)."""
    os.makedirs(out_dir, exist_ok=True)
    n = count_dumps(sim_dir)
    if max_dumps is not None:
        n = min(n, max_dumps)
    paths = []
    for dump in range(n):
        fig = density_frame(sim_dir, dump, kspace)
        path = os.path.join(out_dir, f"frame_{dump:05d}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        paths.append(path)
    return paths


def _ffmpeg_available() -> bool:
    """Whether an mp4 encoder is reachable (imageio-ffmpeg plugin or a
    system ffmpeg binary)."""
    import shutil

    try:
        import imageio_ffmpeg  # noqa: F401

        return True
    except ImportError:
        return shutil.which("ffmpeg") is not None


def _ffmpeg_exe() -> Optional[str]:
    """Path to an ffmpeg binary: imageio-ffmpeg's bundled one if the module
    imports (its binary is NOT on PATH), else a system `ffmpeg`."""
    import shutil

    try:
        import imageio_ffmpeg

        return imageio_ffmpeg.get_ffmpeg_exe()
    except Exception:
        return shutil.which("ffmpeg")


def _encode_mp4_ffmpeg(frames: list[str], out_path: str, fps: int) -> None:
    """Encode png frames to mp4 by invoking an ffmpeg binary directly (used
    when imageio's mp4 plugin path fails, e.g. a plugin/kwarg mismatch)."""
    import os as _os
    import subprocess

    exe = _ffmpeg_exe()
    if exe is None:
        raise FileNotFoundError("no ffmpeg binary available")
    pattern = os.path.join(_os.path.dirname(frames[0]), "frame_%05d.png")
    subprocess.run(
        [
            exe, "-y", "-framerate", str(fps), "-i", pattern,
            "-pix_fmt", "yuv420p", out_path,
        ],
        check=True,
        capture_output=True,
    )


def density_movie(
    sim_dir: str,
    out_path: str,
    kspace: bool = False,
    fps: int = 10,
    max_dumps: Optional[int] = None,
) -> str:
    """Assemble the per-dump frames into a movie.

    The reference wrote mp4 via imageio+ffmpeg (`simulator/plot.py:53-65`);
    this does the same whenever an ffmpeg encoder is available (`.mp4`
    output path, or any path when only GIF is impossible). Without ffmpeg
    (this environment ships imageio but no encoder) a `.mp4` request falls
    back to the sibling `.gif` container and says so in the returned path.
    """
    import imageio.v3 as iio

    want_mp4 = out_path.lower().endswith(".mp4")
    have_ffmpeg = _ffmpeg_available()
    if want_mp4 and not have_ffmpeg:
        out_path = out_path[:-4] + ".gif"
        want_mp4 = False

    with __import__("tempfile").TemporaryDirectory() as tmp:
        frames = density_movie_frames(sim_dir, tmp, kspace, max_dumps)
        if want_mp4:
            images = [iio.imread(f) for f in frames]
            try:
                iio.imwrite(out_path, images, fps=fps)
                return out_path
            except Exception:
                try:
                    _encode_mp4_ffmpeg(frames, out_path, fps)
                    return out_path
                except Exception:
                    # no working encoder after all (e.g. imageio-ffmpeg
                    # imports but ships no binary): fall back to GIF like
                    # the no-ffmpeg path instead of crashing. Remove any
                    # partially-written mp4 so a corrupt file is not
                    # mistaken for valid output.
                    if os.path.exists(out_path):
                        os.remove(out_path)
                    out_path = out_path[:-4] + ".gif"
        else:
            images = [iio.imread(f) for f in frames]
    iio.imwrite(out_path, images, duration=1000 // fps, loop=0)
    return out_path


def radial_profile(
    density: np.ndarray, axis_length: float, n_bins: int = 32
) -> tuple[np.ndarray, np.ndarray]:
    """Radial mass profile about the box center (reference plot.py radial
    profile / plotDensities.py:120-160)."""
    dims = density.ndim
    size = density.shape[0]
    dx = axis_length / size
    x = (2.0 * np.arange(size) + 1.0) * dx / 2.0 - axis_length / 2.0
    r2 = np.zeros((1,) * dims)
    for ax in range(dims):
        shape = [1] * dims
        shape[ax] = size
        r2 = r2 + (x**2).reshape(shape)
    r = np.sqrt(r2).ravel()
    w = density.ravel() * dx**dims
    edges = np.linspace(0.0, axis_length / 2.0, n_bins + 1)
    mass, _ = np.histogram(r, bins=edges, weights=w)
    centers = 0.5 * (edges[1:] + edges[:-1])
    return centers, mass


def density_panels(
    sim_dir: str,
    dump: int,
    axis_length: float,
    hbar_: float,
    total_mass: float = 1.0,
):
    """4-panel diagnostic: projected rho, momentum density, potential,
    radial rho(R) (reference plotDensities.py:34-194)."""
    psi = load_dump(sim_dir, dump)
    dens = np.abs(psi) ** 2 * total_mass

    # momentum density: Im(conj(psi) grad psi) * hbar_ along first axis
    grad = np.gradient(psi, axis_length / psi.shape[0], axis=-1)
    mom = hbar_ * np.imag(np.conj(psi) * grad) * total_mass

    fig, axes = plt.subplots(2, 2, figsize=(10, 8))
    im0 = axes[0, 0].imshow(
        np.log10(_project(dens) + 1e-30), origin="lower", cmap="viridis"
    )
    axes[0, 0].set_title("log10 projected density")
    fig.colorbar(im0, ax=axes[0, 0])

    im1 = axes[0, 1].imshow(_project(mom), origin="lower", cmap="RdBu")
    axes[0, 1].set_title("projected momentum density")
    fig.colorbar(im1, ax=axes[0, 1])

    pot_path = os.path.join(sim_dir, f"potential_{dump:05d}_real")
    if os.path.exists(pot_path):
        phi = np.squeeze(load_complex_pair(os.path.join(sim_dir, f"potential_{dump:05d}")).real)
        im2 = axes[1, 0].imshow(_project(phi), origin="lower", cmap="magma")
        axes[1, 0].set_title("potential")
        fig.colorbar(im2, ax=axes[1, 0])
    else:
        axes[1, 0].text(0.5, 0.5, "no potential dump", ha="center")
        axes[1, 0].set_axis_off()

    r, m = radial_profile(dens, axis_length)
    axes[1, 1].plot(r, m)
    axes[1, 1].set_xlabel("R")
    axes[1, 1].set_ylabel("mass in shell")
    axes[1, 1].set_title("radial profile")
    fig.suptitle(f"dump {dump}")
    fig.tight_layout()
    return fig


def plot_q_series(combined_dir: str, name: str = "Qx"):
    """Q(dump) time series from `{combined}/Qx_real` (plotqs.py:1-27)."""
    series = load_complex_pair(os.path.join(combined_dir, name)).real.ravel()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(series)
    ax.set_xlabel("dump")
    ax.set_ylabel(name)
    ax.set_title(f"{name} vs dump")
    fig.tight_layout()
    return fig
