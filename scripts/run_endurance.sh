#!/usr/bin/env bash
# Full-scale endurance run: 331 ants / 54,615 bls / 1536 ch / 8 poltimes,
# shared-batched packing, mixed comps precision, checkpointed + supervised.
#
# Ingredients (docs/DESIGN.md):
#   --loss_block_ngrps 2048     bounds the loss's activation transients
#                               (flagged runs carry the full bf16 weights
#                               cube and use a smaller block)
#   --steps_per_execution 40    keeps single device executions short
#   --checkpoint_every 500      bounds lost work after a crash
#   --patience 500              freeze a slice after 500 steps without a
#                               new loss minimum and return the tracked
#                               argmin (use_min) instead of burning the
#                               budget orbiting the plateau
#   --prep_cache                the host prep runs once; supervised
#                               relaunches reload it
#   calamity_tpu.supervisor     classifies device failures as transient,
#                               waits for the device probe, relaunches; the
#                               child resumes from the latest checkpoint
#
# Device times for this configuration on a GPU are not measured yet. The
# compile cache is JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache.
#
# Usage:  bash scripts/run_endurance.sh [prep_cache_dir] [checkpoint_dir]
set -euo pipefail
cd "$(dirname "$0")/.."

PREP=${1:-runs/prep_cache_nt8}
CKPT=${2:-runs/ck_endurance}

export PYTHONPATH="$PWD:${PYTHONPATH:-}"

# fill the prep cache first (host-only; safe while the device is busy/down)
python examples/hera_full_demo.py --prep_only --prep_cache "$PREP" \
    --ntimes 8 --backend cpu

exec python -m calamity_tpu.supervisor -- \
    python examples/hera_full_demo.py \
    --ntimes 8 --time_parallel \
    --prep_cache "$PREP" \
    --checkpoint_dir "$CKPT" \
    --checkpoint_every 500 \
    --steps_per_execution 40 \
    --loss_block_ngrps 2048 \
    --patience 500 \
    --maxsteps 2000 --tol 1e-11
