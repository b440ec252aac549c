"""Cluster job generation for the offline synthesizer.

Counterpart of `synthesizer/gen_sbatch.py:6-51` (P6): generate
(and optionally submit) one SLURM batch job per dump range so analysis of a
large ensemble fans out across a cluster. The reference emitted one job per
dump; ranges are configurable here, and each job invokes
`python -m msm_tpu synthesize --dump-range lo:hi` (a final `post` job
evaluates the Qx series once all field combines exist).
"""

from __future__ import annotations

import argparse
import os
import subprocess


SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --output={log_dir}/{name}.out
#SBATCH --cpus-per-task={cpus}
#SBATCH --time={walltime}
#SBATCH --partition={partition}

cd {workdir}
{python} -m msm_tpu synthesize --toml {toml} --data-root {data_root} {extra}
"""


def generate_jobs(
    toml_path: str,
    num_dumps: int,
    out_dir: str = "sbatch",
    dumps_per_job: int = 1,
    cpus: int = 4,
    walltime: str = "12:00:00",
    partition: str = "normal",
    data_root: str = "sim-data",
    workdir: str = ".",
    python: str = "python",
    submit: bool = False,
) -> list[str]:
    """Write one sbatch script per dump range + one post-combine job."""
    os.makedirs(out_dir, exist_ok=True)
    log_dir = os.path.join(out_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)

    scripts = []
    for lo in range(0, num_dumps + 1, dumps_per_job):
        hi = min(lo + dumps_per_job - 1, num_dumps)
        name = f"msm-syn-{lo:05d}-{hi:05d}"
        body = SBATCH_TEMPLATE.format(
            name=name,
            log_dir=log_dir,
            cpus=cpus,
            walltime=walltime,
            partition=partition,
            workdir=workdir,
            python=python,
            toml=toml_path,
            data_root=data_root,
            extra=f"--dump-range {lo}:{hi}",
        )
        path = os.path.join(out_dir, f"{name}.sbatch")
        with open(path, "w") as f:
            f.write(body)
        scripts.append(path)

    post = SBATCH_TEMPLATE.format(
        name="msm-syn-post",
        log_dir=log_dir,
        cpus=cpus,
        walltime="1:00:00",
        partition=partition,
        workdir=workdir,
        python=python,
        toml=toml_path,
        data_root=data_root,
        extra="--post-only",
    )
    post_path = os.path.join(out_dir, "msm-syn-post.sbatch")
    with open(post_path, "w") as f:
        f.write(post)
    scripts.append(post_path)

    if submit:
        for path in scripts:
            subprocess.run(["sbatch", path], check=True)
    return scripts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--toml", required=True)
    parser.add_argument("--num-dumps", type=int, required=True)
    parser.add_argument("--out", default="sbatch")
    parser.add_argument("--dumps-per-job", type=int, default=1)
    parser.add_argument("--cpus", type=int, default=4)
    parser.add_argument("--walltime", default="12:00:00")
    parser.add_argument("--partition", default="normal")
    parser.add_argument("--submit", action="store_true")
    args = parser.parse_args(argv)
    scripts = generate_jobs(
        args.toml,
        args.num_dumps,
        args.out,
        args.dumps_per_job,
        args.cpus,
        args.walltime,
        args.partition,
        submit=args.submit,
    )
    print(f"wrote {len(scripts)} job scripts to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
