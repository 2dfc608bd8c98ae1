#!/usr/bin/env bash
# The port's experiment sweep, the counterpart of examples/run_sweep.sh:
# the synthetic roster at hidden 4 through v6 (rabbit -> degree sort -> ELL
# -> K1) with `python -m gcn_tpu_torch.train_gcn`, the real-data parity gate
# (tests/test_torch_port_real_data.py, which skips when the files are
# absent), then the real datasets whose files `get_dataset` finds under
# $GCN_TPU_DATA. Nothing is downloaded. Writes one artifact
# (gcn_tpu_torch/results/run_sweep.json: each run's test accuracy, final
# loss and wall seconds, stamped with the card) through
# utils/artifacts.py::write_artifact.
#
#   bash gcn_tpu_torch/run_sweep.sh                      # on the card
#   DEVICE=cpu GRAPHS="synth-tiny" ITERS=5 OUT=sweep.json \
#     bash gcn_tpu_torch/run_sweep.sh                    # on the CPU
set -uo pipefail
cd "$(dirname "$0")/.."

HIDDEN="${HIDDEN:-4}"
ITERS="${ITERS:-100}"
VARIANT="${VARIANT:-v6}"
DEVICE="${DEVICE:-cuda}"
GRAPHS="${GRAPHS:-synth-pubmed synth-flickr synth-arxiv synth-reddit}"
REAL="${REAL:-pubmed flickr reddit ppi amazon yelp}"
OUT="${OUT:-gcn_tpu_torch/results/run_sweep.json}"
WORK="$(mktemp -d)"
trap 'rm -rf "$WORK"' EXIT
sweep_failed=0

run() {
  local g="$1" t0 t1 rc
  echo "=== $g (hidden=$HIDDEN, iters=$ITERS, $VARIANT, $DEVICE) ==="
  t0=$(date +%s.%N)
  python -m gcn_tpu_torch.train_gcn -g "$g" -k "$HIDDEN" -i "$ITERS" \
    --variant "$VARIANT" --device "$DEVICE" \
    --history-json "$WORK/$g.json" > "$WORK/$g.out" 2>&1
  rc=$?
  t1=$(date +%s.%N)
  grep -E "^(fit done|Test set results)" "$WORK/$g.out"
  if [ "$rc" -ne 0 ]; then
    echo "[sweep] $g failed (exit $rc)"; tail -5 "$WORK/$g.out"
    sweep_failed=1
  fi
  echo "$g $rc $t0 $t1" >> "$WORK/index"
}

for g in $GRAPHS; do run "$g"; done

# real-data parity gate: exit 5 = nothing collected, 0 = passed or skipped
python -m pytest tests/test_torch_port_real_data.py -q -rs -p no:cacheprovider \
  --noconftest | tail -2
rc=${PIPESTATUS[0]}
if [ "$rc" -ne 0 ] && [ "$rc" -ne 5 ]; then
  echo "[sweep] REAL-DATA PARITY FAILURE (pytest exit $rc)"
  sweep_failed=1
fi

for g in $REAL; do
  python - "$g" <<'PY' || continue
import sys
from gcn_tpu_torch.data import get_dataset
try:
    get_dataset(sys.argv[1])
except (FileNotFoundError, OSError):
    sys.exit(1)
PY
  run "$g"
done

python - "$WORK" "$OUT" "$DEVICE" "$HIDDEN" "$ITERS" "$VARIANT" <<'PY'
import json, os, sys
from gcn_tpu_torch.utils.artifacts import write_artifact
from gcn_tpu_torch.utils.chain_timing import stamp
work, out, device, hidden, iters, variant = sys.argv[1:]
runs = []
for line in open(os.path.join(work, "index")):
    g, rc, t0, t1 = line.split()
    row = {"graph": g, "exit": int(rc), "wall_s": float(t1) - float(t0)}
    path = os.path.join(work, g + ".json")
    if os.path.exists(path):
        h = json.load(open(path))
        row.update(acc_test=h["acc_test"],
                   loss_final=h["history"][-1]["loss_train"])
    runs.append(row)
write_artifact(out, {"hidden": int(hidden), "iters": int(iters),
                     "variant": variant, "runs": runs,
                     "protocol": "python -m gcn_tpu_torch.train_gcn per "
                                 "graph; wall_s is the process's host "
                                 "clock (data, set-up, fit, test)"},
               harness="gcn_tpu_torch/run_sweep.sh",
               schema="run_sweep_torch_v1", extra_meta=stamp(device))
print(f"wrote {out}")
PY
exit "$sweep_failed"
