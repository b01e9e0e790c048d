#!/bin/bash
# Accuracy runs of the PyTorch port at the JAX package's two other BASELINE
# configurations (BASELINE.json "configs" 3 and 4), each to its 0.98 bar on
# the card, with the JAX package's own flags and data recipes:
#
#   scaled  canvas 100, LSTM 512, VAE latent 100, batch 1024, the z_pres
#           prior annealed at the batch-64 pace in data seen (--anneal-iters
#           190 --anneal-hold 940), on a 29k/1k max-2-digit set at canvas
#           100 (RESULTS.md, "Round-4 scaled config trains";
#           harder_runs/ledgers/r4_scaled_train.json)
#   harder  5 attention steps, max 3 digits, a learned background started
#           from the data (--learn-background --bg-init data), hold 15000,
#           on generate_multi_mnist --max-digits 3 --images-per-digit 10000
#           --test-set-size 1000 --bg-kind noise --bg-max-intensity 0.6
#           (scripts/run_bg_r4.sh, harder_runs/ledgers/r4_bg0.6_init_cnn.json)
#
# Digits: real MNIST in mnist_data/ when present, else the committed pool
# air_tpu_torch/assets/synthetic_mnist_60000_seed0.npz (the generator says
# which). Run from the repository root, on a machine with a card:
#
#   bash scripts/config_accuracy_torch.sh [scaled|harder|both] [extra flags]
#
# Extra flags go to both training runs (for a rehearsal on the CPU:
# PER_STRATUM=12 TEST=6 bash scripts/config_accuracy_torch.sh both
# --device cpu --rnn-units 16 --batch-size 8 --steps 4). SCALED_GEN adds
# flags to the scaled set's generator (digits drawn larger, for one:
# SCALED_GEN="--min-width-scale 2 --max-width-scale 2 --min-height-scale 2
# --max-height-scale 2"). Each run's log and its eval lines go to
# chiprun_out/config_accuracy/; the data sets and the run folders
# (gitignored) are made anew.
set -euo pipefail
which=${1:-both}
shift || true
per=${PER_STRATUM:-10000}
test=${TEST:-1000}
out=chiprun_out/config_accuracy
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    2>/dev/null | tee "$out/card.txt" || true

run() {   # name data-folder flags...
  local name=$1 data=$2; shift 2
  echo "=== $name $(date -u +%FT%TZ) ==="
  local t0=$SECONDS
  python -m air_tpu_torch.training \
      --train-data "$data/common.airrec" --test-data "$data/test.airrec" \
      --results-folder "air_results_$name" --overwrite-results 1 \
      --device-data --img-every 1000000000 --grad-every 0 \
      --save-every 1000000000 --stop-at-accuracy 0.98 "$@" \
      > "$out/$name.log" 2>&1 || { tail -40 "$out/$name.log"; exit 1; }
  grep -E "^\[eval @|training has ended|restart" "$out/$name.log" \
      | tee "$out/$name.evals"
  echo "$name: $((SECONDS - t0)) s of training (generation apart)"
  # each eval's accuracy and mean steps by digit count
  python - "air_results_$name/summary/metrics.jsonl" \
      > "$out/$name.by_count" <<'PY'
import json, sys
for line in open(sys.argv[1]):
    rec = json.loads(line)
    keys = sorted(k for k in rec if k.startswith(("test/digit_acc_",
                                                  "test/steps_")))
    if keys:
        print(rec["step"], " ".join(f"{k[5:]}={rec[k]:.3f}" for k in keys))
PY
  tail -3 "$out/$name.by_count"
}

if [[ $which == scaled || $which == both ]]; then
  t0=$SECONDS
  rm -rf scaled_100_data
  # shellcheck disable=SC2086  # SCALED_GEN is a list of flags
  python -m air_tpu_torch.generate_multi_mnist --canvas-size 100 \
      --images-per-digit "$per" --test-set-size "$test" \
      --out-folder scaled_100_data ${SCALED_GEN:-} | tail -3
  echo "scaled data: $((SECONDS - t0)) s"
  run scaled scaled_100_data --canvas-size 100 --rnn-units 512 \
      --vae-latent 100 --batch-size 1024 --anneal-iters 190 \
      --anneal-hold 940 --eval-every 500 --log-every 500 --steps 12000 "$@"
fi
if [[ $which == harder || $which == both ]]; then
  t0=$SECONDS
  rm -rf harder_bg0.6_data
  python -m air_tpu_torch.generate_multi_mnist --max-digits 3 \
      --images-per-digit "$per" --test-set-size "$test" --bg-kind noise \
      --bg-max-intensity 0.6 --out-folder harder_bg0.6_data | tail -3
  echo "harder data: $((SECONDS - t0)) s"
  run harder harder_bg0.6_data --max-steps 5 --max-digits 3 \
      --anneal-hold 15000 --learn-background --bg-init data \
      --eval-every 2500 --log-every 25000 --steps 120000 "$@"
fi
