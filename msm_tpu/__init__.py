"""msm_tpu: a Multi-Stream Method engine in JAX.

A ground-up JAX/XLA implementation of the capabilities of the reference
MSM code (Schrodinger-Poisson evolution of gravitating scalar fields with
quantum corrections via stream ensembles), designed around one jitted KDK
program over a (stream, space...) array on a device mesh, rather than a
per-seed loop of device calls. Runs on NVIDIA GPUs (cuFFT through XLA).

Public surface:
  config      - TOML schema (reference-compatible), parameter resolution
  grid        - k-grids, spectral grids, normalization
  ops         - FFTs and phase rotations
  models      - initial conditions + quantum sampling schemes
  stepper     - the split-step integrator and in-jit evolve loops
  simulator   - single-run and batched-ensemble drivers
  synthesis   - ensemble reductions (online + offline combiner)
  cosmo       - flat-LCDM scale factor, tau <-> t machinery
  parallel    - device mesh, sharded ensemble/spatial execution
  io          - npy pair dumps, async writer, checkpoints
"""

from . import config, constants, cosmo, errors, grid  # noqa: F401
from .config import (  # noqa: F401
    SimulationParameters,
    TomlParameters,
    iter_stream_parameters,
    read_toml,
    resolve_parameters,
)
from .stepper import SimState, StepConsts, Stepper  # noqa: F401

__version__ = "0.1.0"
