#!/bin/bash
# Expert parallelism on 4 cards: the port's launcher trains Mistral-8x7B
# at full width at --mesh 2x2 (each model rank 4 of the 8 experts, one
# [C, d] reduce a layer) with 4 and 6 layers, and at --mesh 4x1 (every
# rank all 8 experts, ZeRO-1 over 4) with 3 layers: 4x1 at 4 layers runs
# out of memory in step 1's backward (79.18 GiB cards), and 6 layers
# would need ~99 GB a rank there.  Run from the repository root on a
# machine with 4 GPUs:
#
#     bash scripts/ep_4cards.sh [OUT_DIR [RUN ...]]
#
# RUN is any of mistral4_2x2, mistral6_2x2, mistral3_4x1 (the default:
# all three, in that order) and mistral4_4x1.  SRC (default src) is the
# package directory the launcher is imported from, so the same runs can
# be made with another checkout's port.  Each run is cut after
# RUN_TIMEOUT seconds (default 240).  Its rank-0 output goes to
# OUT_DIR/<run>.log (default chiprun_out/ep4); as it ends the script
# prints the run's wall and one JSON summary (tokens/s over steps 2-5,
# every rank's peak memory, the loss and grad norm of every step), or
# the run's exit code and last error line; last, the card's name and
# power limit.
set -uo pipefail
cd "$(dirname "$0")/.."
OUT=${1:-chiprun_out/ep4}
shift || true
RUNS=("$@")
[ ${#RUNS[@]} -gt 0 ] || RUNS=(mistral4_2x2 mistral6_2x2 mistral3_4x1)
mkdir -p "$OUT"
export PYTHONPATH=${SRC:-src}
ARGS=(--arch mistral-8x7b --steps 5 --capacity 4096 --tokens-per-step 65536
      --context 16384)

for name in "${RUNS[@]}"; do
    case $name in
        mistral4_2x2) opts=(--layers 4 --mesh 2x2) ;;
        mistral6_2x2) opts=(--layers 6 --mesh 2x2) ;;
        mistral3_4x1) opts=(--layers 3 --mesh 4x1) ;;
        mistral4_4x1) opts=(--layers 4 --mesh 4x1) ;;
        *) echo "unknown run $name" >&2; exit 2 ;;
    esac
    t0=$SECONDS
    timeout -k 10 "${RUN_TIMEOUT:-240}" python -m repro_torch.launch.train \
        "${opts[@]}" "${ARGS[@]}" > "$OUT/$name.log" 2> "$OUT/$name.err"
    rc=$?
    echo "$name: rc $rc, $((SECONDS - t0)) s"
    python3 - "$OUT/$name" "$rc" <<'EOF'
import json
import sys

path, rc = sys.argv[1], int(sys.argv[2])
with open(f"{path}.log") as f:
    got = [ln for ln in f if ln.startswith("{")]
if rc or not got:
    with open(f"{path}.err") as f:
        err = [ln.strip() for ln in f if ln.strip()]
    print(json.dumps({"run": path.rsplit("/", 1)[-1], "rc": rc,
                      "last_error": err[-1] if err else ""}))
    sys.exit(0)
r = json.loads(got[-1])
warm = [s for s in r["steps"] if 2 <= s["step"] <= 5]
print(json.dumps({
    "run": path.rsplit("/", 1)[-1], "mesh": r["mesh"],
    "layers": r["layers"], "params_b_rank0": r["params_b"],
    "tokens_per_s_steps_2_5": sum(s["tokens"] for s in warm)
    / sum(s["wall_s"] for s in warm),
    "peak_mem_gb_by_rank": r["peak_mem_gb_by_rank"],
    "warm_ms_per_wave_by_composition_x_c_mult":
    r["warm_ms_per_wave_by_composition_x_c_mult"],
    "steps": [{k: s[k] for k in ("step", "loss", "grad_norm", "waves",
                                  "wall_s")} for s in r["steps"]],
    "zero1_bytes": r["zero1_bytes"]}))
EOF
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
