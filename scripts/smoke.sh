#!/usr/bin/env bash
# Feature-matrix smoke test (counterpart of the reference's test.sh:1-14):
# simulate + synthesize the shipped examples across the feature matrix —
# static / expanding x offline / online synthesis — on the CPU backend,
# with the dump counts cut so the whole matrix takes a few minutes. Run
# from anywhere; writes into a temp dir.
set -euo pipefail

ROOT="$(cd "$(dirname "$0")/.." && pwd)"
WORK="$(mktemp -d)"
trap 'rm -rf "$WORK"' EXIT
cd "$WORK"

# examples/ cut to 16^3 and 4 dumps (same physics, smaller scale)
for name in tophat-collapse cold-gauss-cosmo; do
  sed -e 's/^size .*/size = 16/' -e 's/^num_data_dumps .*/num_data_dumps = 4/' \
      -e 's/^final_sim_time .*/final_sim_time = 2/' \
      "$ROOT/examples/$name.toml" > "$name.toml"
done

run() {
  env JAX_PLATFORMS=cpu PYTHONPATH="$ROOT" "$@"
}

echo "== static + offline synthesis =="
run python -m msm_tpu simulate --toml tophat-collapse.toml
run python -m msm_tpu synthesize --toml tophat-collapse.toml

echo "== static + online synthesis =="
run python -m msm_tpu simulate --toml tophat-collapse.toml \
    --data-root sim-online --online-synthesis

echo "== expanding (cosmology table) =="
run python -m msm_tpu simulate --toml cold-gauss-cosmo.toml

echo "== fast-dt + resume dry paths =="
run python -m msm_tpu simulate --toml tophat-collapse.toml \
    --data-root sim-fast --fast-dt
run python -m msm_tpu simulate --toml tophat-collapse.toml \
    --data-root sim-fast --resume   # everything checkpointed: no-op restart

echo "== test-only construction =="
run python -m msm_tpu simulate --toml tophat-collapse.toml \
    --data-root sim-test --test

echo "SMOKE OK"
