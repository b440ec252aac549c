"""Real multi-process test: two jax.distributed processes run the batched
ensemble over a global mesh; each writes only the streams it owns, and the
union of dumps must match a single-process run exactly.

This is the distributed test the reference never had (its MPI path does not
even compile as committed, SURVEY.md §4)."""

import os
import subprocess
import sys

import numpy as np
import pytest

# 2-process rendezvous with hard deadlines: slow AND contention-fragile
# (280 s worker timeout) - keep out of the fast lane
pytestmark = pytest.mark.slow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import os, sys
proc_id = int(sys.argv[1]); root = sys.argv[2]; port = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=proc_id
)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 8

import jax.numpy as jnp
from msm_tpu import config as cfg, simulator

toml = cfg.parse_toml_str('''
axis_length = 30
final_sim_time = 1.0
cfl = 0.5
num_data_dumps = 3
total_mass = 1e8
ntot = 1e6
hbar_ = 0.05
sim_name = "mh"
k2_cutoff = 0.95
alias_threshold = 0.5
dims = 3
size = 8

[ics]
type = "SphericalTophat"
radius = 5.0
slope = 50
delta = 10

[sampling]
seeds = "1 to 7"
scheme = "Wigner"
''')
simulator.run_config(
    toml, dtype=jnp.complex128, data_root=root, mesh="auto",
    online_synthesis=True,
)

# distributed offline synthesis: dumps split by process, post-combine
# scalar series gathered across processes (lib.rs:467-583) — Qx must be
# complete with NO separate --post-only pass
import numpy as np
from msm_tpu import synthesis
from msm_tpu.io.npy import load_complex_pair
online = load_complex_pair(root + "/mh-combined/Qx").copy()
series = synthesis.synthesize_toml(
    toml, data_root=root, dtype=jnp.complex128, multihost=True
)
assert "Qx" in series and series["Qx"].shape == (4, 1, 1, 1), series.keys()
np.testing.assert_allclose(series["Qx"], online, atol=1e-10)
if proc_id == 0:
    offline = load_complex_pair(root + "/mh-combined/Qx")
    np.testing.assert_allclose(offline, online, atol=1e-10)
print(f"proc {proc_id} done", flush=True)
"""


def test_two_process_ensemble(tmp_path):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    root_mh = str(tmp_path / "mh")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), root_mh, str(port)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        outs.append(out.decode())
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i][-3000:]}"

    # single-process reference
    from msm_tpu import config as cfg
    from msm_tpu import simulator, synthesis
    from msm_tpu.io.npy import load_complex_pair
    import jax.numpy as jnp

    toml = cfg.parse_toml_str(WORKER.split("'''")[1])
    root_ref = str(tmp_path / "ref")
    simulator.run_config(toml, dtype=jnp.complex128, data_root=root_ref)
    synthesis.synthesize_toml(toml, data_root=root_ref, dtype=jnp.complex128)

    dirs = ["mh"] + [f"mh-stream{s:05d}" for s in range(1, 8)]
    for d in dirs:
        for dump in range(4):
            got = load_complex_pair(os.path.join(root_mh, d, f"psi_{dump:05d}"))
            want = load_complex_pair(os.path.join(root_ref, d, f"psi_{dump:05d}"))
            np.testing.assert_allclose(
                got, want, atol=1e-11, err_msg=f"{d} dump {dump}"
            )
    # online-combined output (written by process 0) matches offline combine
    for dump in range(4):
        got = load_complex_pair(
            os.path.join(root_mh, "mh-combined", f"psi2_{dump:05d}")
        )
        want = load_complex_pair(
            os.path.join(root_ref, "mh-combined", f"psi2_{dump:05d}")
        )
        np.testing.assert_allclose(got, want, atol=1e-11)
